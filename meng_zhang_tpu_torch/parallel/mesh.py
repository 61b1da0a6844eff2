"""The in-process shard mesh of the sharded drivers (parallel/domain.py).

The JAX drivers run one program per device under `shard_map` and use three
collectives over the mesh axis "dp": `lax.ppermute` around the ring,
`lax.all_gather` and `lax.psum`. Here one process holds all D shards, every
per-shard tensor carrying them on its leading axis ([D, ...], on one card or
on the CPU), and the three collectives become:

  * ring_shift(t, s): shard i receives shard (i - s) mod D's block, a
    `torch.roll` over dim 0 (`ppermute` with the pairs (i, i + s));
  * all_gather(t): the [D, ...] tensor itself, which every shard reads;
  * psum(t): the sum over dim 0, one value that every shard shares.

So a card runs D shards, and the per-shard work of a step runs as one
batched call over the D shards. A backend with one process a card would put
the same three calls over torch.distributed.
"""
from __future__ import annotations

import torch


class ShardMesh:
    """D shards in this process, on `device`."""

    def __init__(self, n_shards, device="cuda"):
        self.n_shards = int(n_shards)
        self.device = torch.device(device)

    def ring_shift(self, t, shift):
        """[D, ...] -> [D, ...]: row i of the result is row (i - shift) mod
        D of t."""
        return torch.roll(t, shift, dims=0)

    def all_gather(self, t):
        return t

    def psum(self, t):
        return t.sum(dim=0)
