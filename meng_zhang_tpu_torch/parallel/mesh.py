"""The in-process shard mesh of the sharded drivers (parallel/domain.py,
domain2d.py, domain3d.py).

The JAX drivers run one program per device under `shard_map` and use three
collectives over the mesh axis "dp": `lax.ppermute`, `lax.all_gather` and
`lax.psum`. Here one process holds all D shards, every per-shard tensor
carrying them on its leading axis ([D, ...], on one card or on the CPU),
and the collectives become:

  * ppermute(t, pairs): shard dst receives shard src's block for every
    (src, dst) pair, the JAX call's pairs as the 2-D and 3-D drivers'
    `_perm` builds them; one gather over dim 0 (shards that no pair names
    as a destination receive zeros, as in JAX);
  * ring_shift(t, s): shard i receives shard (i - s) mod D's block, a
    `torch.roll` over dim 0 (`ppermute` with the pairs (i, i + s));
  * all_gather(t): the [D, ...] tensor itself, which every shard reads;
  * psum(t): the sum over dim 0, one value that every shard shares.

So a card runs D shards, and the per-shard work of a step runs as one
batched call over the D shards. The drivers move data between shards
through these calls only, so a backend with one process a card puts the
same calls over torch.distributed.
"""
from __future__ import annotations

import torch


class ShardMesh:
    """D shards in this process, on `device`."""

    def __init__(self, n_shards, device="cuda"):
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the shards on the CPU")
        self._src = {}

    def ppermute(self, t, pairs):
        """[D, ...] -> [D, ...]: row dst of the result is row src of t for
        each (src, dst) in pairs, zeros where no pair ends."""
        key = tuple(pairs)
        if key not in self._src:
            src = [-1] * self.n_shards
            for s, d in key:
                if src[d] >= 0:
                    raise ValueError(f"shard {d} receives twice")
                src[d] = s
            self._src[key] = (torch.tensor([max(s, 0) for s in src],
                                           device=self.device),
                              None if min(src) >= 0 else torch.tensor(
                                  [s >= 0 for s in src], device=self.device))
        idx, got = self._src[key]
        out = t[idx]
        if got is not None:
            out = torch.where(got.view((-1,) + (1,) * (t.dim() - 1)), out,
                              torch.zeros_like(out))
        return out

    def ring_shift(self, t, shift):
        """[D, ...] -> [D, ...]: row i of the result is row (i - shift) mod
        D of t."""
        return torch.roll(t, shift, dims=0)

    def all_gather(self, t):
        return t

    def psum(self, t):
        return t.sum(dim=0)
