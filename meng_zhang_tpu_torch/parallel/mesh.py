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
batched call over the D shards.

Given a torch.distributed process group of world W (W divides D), the same
calls run across processes (parallel/launch.py starts them): rank r holds
the L = D / W consecutive shards [r L, (r + 1) L), every per-shard tensor
is [L, ...], and

  * ppermute copies the pairs whose both ends are local by an index and
    sends the rest with one `batch_isend_irecv` a call, one message a peer
    (bool travels as uint8 and is cast back);
  * all_gather maps [L, ...] to [D, ...] in global shard order;
  * psum all-gathers the per-shard values and sums them over dim 0 in
    shard order, so that the sum is the in-process one to the bit and the
    same on every rank: the replicated state (box, thermostat chains,
    barostat) stays bitwise equal across the ranks (a rank's partial sum
    over its local shards, the frame evaluation's virial, is summed as
    psum(t[None]): in rank order);
  * any(flag) reads a [L] flag of every shard back as one host bool, the
    same on every rank, so that every rank takes the same rebuild
    decision.

A gloo group's P2P and collectives take host tensors, so on gloo a CUDA
block goes through host memory (several ranks on one card); an NCCL group
moves device tensors (one rank a card). The drivers move data between
shards through these calls only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class ShardMesh:
    """D shards on `device`: all of them in this process, or, with a
    torch.distributed `group`, this rank's n_local = D / W consecutive
    shards from `first` (their global ids `shard_ids`, [L] int64)."""

    def __init__(self, n_shards, device="cuda", group=None):
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the shards on the CPU")
        self.group = group
        self.world, self.rank = 1, 0
        self._stage = False
        if group is not None:
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            if self.n_shards % self.world:
                raise ValueError(f"{self.world} ranks do not divide "
                                 f"{self.n_shards} shards")
            self._peers = [dist.get_global_rank(group, r)
                           for r in range(self.world)]
            # gloo moves host tensors only
            self._stage = dist.get_backend(group) == "gloo" \
                and self.device.type == "cuda"
        self.n_local = self.n_shards // self.world
        self.first = self.rank * self.n_local
        self.shard_ids = torch.arange(self.first, self.first + self.n_local,
                                      device=self.device)
        self._src = {}
        self._routes = {}

    def local(self, t):
        """This rank's rows [first, first + n_local) of a [D, ...] tensor
        or array."""
        return t[self.first:self.first + self.n_local]

    def ppermute(self, t, pairs):
        """[D, ...] -> [D, ...]: row dst of the result is row src of t for
        each (src, dst) in pairs, zeros where no pair ends (global shard
        ids; [L, ...] -> [L, ...] over a group)."""
        if self.group is not None:
            return self._ppermute_dist(t, pairs)
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
        if self.group is not None:
            d = self.n_shards
            return self._ppermute_dist(t, [(i, (i + shift) % d)
                                           for i in range(d)])
        return torch.roll(t, shift, dims=0)

    def all_gather(self, t):
        """[L, ...] -> [D, ...] in global shard order (the tensor itself in
        process)."""
        if self.group is None:
            return t
        send = self._to_wire(t.contiguous())
        bufs = [torch.empty_like(send) for _ in range(self.world)]
        dist.all_gather(bufs, send, group=self.group)
        return self._from_wire(torch.cat(bufs), t)

    def psum(self, t):
        return self.all_gather(t).sum(dim=0)

    def any(self, flag):
        """A host bool: some shard's flag ([L] bool) is set."""
        return bool(self.all_gather(flag).any())

    # ---------- the process-group backend ----------
    def _to_wire(self, t):
        """t as the backend takes it: bool as uint8, on the host for
        gloo."""
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        return t.cpu() if self._stage else t

    def _from_wire(self, w, like):
        return w.to(device=like.device, dtype=like.dtype)

    def _route(self, pairs):
        """(local dst rows, their local src rows, {peer rank: local src
        rows sent there}, {peer rank: local dst rows received from there})
        of a pair list; both ends list a peer's rows in the order of their
        destinations, so one message a peer matches."""
        key = tuple(pairs)
        if key not in self._routes:
            owner = self.n_local
            seen = set()
            loc_dst, loc_src, send, recv = [], [], {}, {}
            for s, d in sorted(key, key=lambda p: p[1]):
                if d in seen:
                    raise ValueError(f"shard {d} receives twice")
                seen.add(d)
                mine_s = s // owner == self.rank
                mine_d = d // owner == self.rank
                if mine_s and mine_d:
                    loc_dst.append(d - self.first)
                    loc_src.append(s - self.first)
                elif mine_s:
                    send.setdefault(d // owner, []).append(s - self.first)
                elif mine_d:
                    recv.setdefault(s // owner, []).append(d - self.first)
            self._routes[key] = (
                torch.tensor(loc_dst, dtype=torch.int64, device=self.device),
                torch.tensor(loc_src, dtype=torch.int64, device=self.device),
                sorted(send.items()), sorted(recv.items()))
        return self._routes[key]

    def _ppermute_dist(self, t, pairs):
        loc_dst, loc_src, send, recv = self._route(pairs)
        out = torch.zeros_like(t)
        if loc_dst.numel():
            out[loc_dst] = t[loc_src]
        ops, bufs = [], []
        for peer, rows in send:
            ops.append(dist.P2POp(dist.isend, self._to_wire(t[rows]),
                                  self._peers[peer], self.group))
        wire = self._to_wire(t[:0])
        for peer, rows in recv:
            buf = torch.empty((len(rows),) + tuple(t.shape[1:]),
                              dtype=wire.dtype, device=wire.device)
            bufs.append((rows, buf))
            ops.append(dist.P2POp(dist.irecv, buf, self._peers[peer],
                                  self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for rows, buf in bufs:
            out[rows] = self._from_wire(buf, t)
        return out
