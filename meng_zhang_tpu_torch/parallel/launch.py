"""Run the sharded drivers across processes: one process a card over NCCL,
or several processes on the CPU (or on one card) over gloo.

Each process holds L = D / W consecutive shards of the D that the driver's
config names (parallel/mesh.py, `ShardMesh(group=...)`); every rank builds
the same driver from the same host data and weights (the potential's numpy
arrays through `models.annp.make_annp`), so each rank builds its own
evaluator, as the JAX drivers run one program a device.

  * `init_mesh(n_shards, backend=None, device=None)`: in a process that
    `torchrun --nproc-per-node N` started (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT): selects the rank's card before any NCCL
    call, creates the default group (NCCL on cards unless `gloo` is named,
    gloo on the CPU) with a timeout of DEFAULT_TIMEOUT s, so that a rank
    left waiting raises instead of hanging, passes a barrier (the first P2P
    call is then not the group's first collective) and returns the mesh.
  * `spawn(fn, world, backend=None, device="cuda", args, timeout)`: starts
    `world` processes with the spawn start method over a FileStore in a
    temporary directory (the backend as init_mesh picks it), runs
    fn(*args) in each and returns rank 0's result with every rank's
    kernel launches and peak device memory; raises when a rank raises or
    dies, or at the timeout, and never returns a partial result (nor any
    result when a rank failed). fn must be importable (a
    module-level function) and return host objects.
  * `run_sharded(ShardRun, distributed)`: one sharded run from host data,
    over the process group (in a spawned or torchrun process) or in this
    process (the reference); `check_collectives`: the distributed mesh's
    calls against the in-process mesh on every rank; `dryrun`: the checks
    of `__graft_entry__.dryrun_multichip` on the synthetic fe potential.
  * `python -m meng_zhang_tpu_torch.parallel.launch --nproc N --shards D
    [--backend gloo|nccl] [--device cpu|cuda]`: the dryrun over N spawned
    processes; rank 0's lines are printed, one "OK" line a check.

On CUDA the kernels are built once in the parent (`ops.kernels.build`)
before the processes start, so the ranks load the same libraries.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from multiprocessing import connection
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import ShardMesh

DEFAULT_TIMEOUT = 120.0      # s: a collective's wait, and spawn's default
KERNELS = ("g_harm", "force_harm", "g_cos", "force_cos", "ni_g", "ni_force")


def _backend(device, backend):
    """The named backend, else NCCL on CUDA and gloo on the CPU; raises
    for CUDA without a card."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "shards on the CPU")
    return backend or ("nccl" if cuda else "gloo")


def _select_device(device, local_rank, backend):
    """The rank's device: on CUDA card local_rank mod the card count (gloo
    ranks may share a card; NCCL takes one card a rank), made current."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "shards on the CPU")
    count = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= count:
        raise RuntimeError(f"NCCL takes one card a rank: local rank "
                           f"{local_rank} with {count} visible card(s); run "
                           "several ranks on one card over gloo")
    dev = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(dev)
    return dev


def _barrier(dev):
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()


def init_mesh(n_shards, backend=None, device=None, timeout=DEFAULT_TIMEOUT):
    """The ShardMesh of n_shards over the default process group, created
    here from torchrun's environment unless this process has one already
    (a `spawn` worker). device: "cuda" (default) or "cpu"."""
    env = os.environ
    if not dist.is_initialized() and not ("RANK" in env
                                          and "WORLD_SIZE" in env):
        raise RuntimeError("init_mesh needs a process that torchrun or "
                           "spawn started: RANK and WORLD_SIZE are not set")
    device = device or "cuda"
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"the process group runs {have}, not {backend}")
        backend = have
    else:
        backend = _backend(device, backend)
    local = int(env.get("LOCAL_RANK", env.get("RANK", "0")))
    dev = _select_device(device, local, backend)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=timedelta(seconds=timeout))
        _barrier(dev)
    return ShardMesh(n_shards, dev, group=dist.group.WORLD)


# ------------------------------------------------------------ spawn
class SpawnResult(NamedTuple):
    result: Any          # rank 0's return value
    launches: list       # each rank's {kernel: launches}
    peak_bytes: list     # each rank's max_memory_allocated (0 on the CPU)
    seconds: list        # each rank's (start: spawn to the group's first
                         # barrier, fn's run)


def _worker(rank, world, backend, device, store, timeout, t0, conn):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        fn, args = pickle.loads(conn.recv_bytes())
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dev = _select_device(device, rank, backend)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout))
        _barrier(dev)
        t1 = time.time()
        out = fn(*args)
        seconds = (t1 - t0, time.time() - t1)
        from ..ops import kernels
        launches = {k: getattr(kernels, k).launches for k in KERNELS}
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        _barrier(dev)
        dist.destroy_process_group()
        msg = ("ok", out if rank == 0 else None, launches, peak, seconds)
    except Exception:             # reported to the parent, which raises
        msg = ("error", traceback.format_exc())
    conn.send_bytes(pickle.dumps(msg))
    conn.close()


def spawn(fn, world, backend=None, device="cuda", args=(),
          timeout=DEFAULT_TIMEOUT):
    """fn(*args) in `world` spawned processes over one process group of
    `backend` (default: NCCL on CUDA, gloo on the CPU); returns
    SpawnResult. Raises RuntimeError with the traceback of the
    first rank that raised (or died), TimeoutError after `timeout` s; the
    other ranks are terminated either way."""
    backend = _backend(device, backend)
    if torch.device(device).type == "cuda":
        from ..ops import kernels
        kernels.build()          # once here, not in every rank
    ctx = mp.get_context("spawn")
    msgs = [None] * world
    procs, conns = [], []
    # (fn, args) go through each rank's pipe once every rank has started: a
    # start whose arguments outgrow the pipe's buffer waits for the child's
    # imports, which would start the ranks one after another
    payload = pickle.dumps((fn, args))
    with tempfile.TemporaryDirectory(prefix="mzt-dist-") as tmp:
        store = os.path.join(tmp, "store")
        try:
            t0 = time.time()
            for rank in range(world):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=_worker, daemon=True, args=(
                    rank, world, backend, device, store,
                    min(timeout, DEFAULT_TIMEOUT), t0, theirs))
                p.start()
                theirs.close()
                procs.append(p)
                conns.append(mine)
            for c in conns:
                c.send_bytes(payload)
            deadline = time.monotonic() + timeout
            pending = set(range(world))
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(pending)} of {world} "
                                       f"did not finish within {timeout} s")
                for c in connection.wait([conns[r] for r in pending], left):
                    r = conns.index(c)
                    try:
                        msg = pickle.loads(c.recv_bytes())
                    except EOFError:
                        procs[r].join(5)
                        raise RuntimeError(
                            f"rank {r} of {world} exited (code "
                            f"{procs[r].exitcode}) without a result") from None
                    if msg[0] == "error":
                        raise RuntimeError(f"rank {r} of {world} raised:\n"
                                           f"{msg[1]}")
                    msgs[r] = msg
                    pending.discard(r)
            for p in procs:
                p.join(30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
            for c in conns:
                c.close()
    return SpawnResult(msgs[0][1], *([m[i] for m in msgs]
                                     for i in range(2, 5)))


# ------------------------------------------------------- sharded runs
@dataclasses.dataclass(frozen=True)
class ShardRun:
    """One sharded run from host data, built alike on every rank and in an
    in-process reference: the driver by the config's type (ShardConfig,
    Shard2DConfig, Shard3DConfig), its model from the potential (model
    "short": FrameShortModel over FusedAnnp or, for a BP potential,
    FusedNi; "annp": AnnpFrameModel over FusedAnnp), n_blocks blocks of
    `run(st, 1)`, then with migrate_rebuild an explicit migrate and
    rebuild."""
    cfg: Any
    pot: Any                     # io.potential.AnnpPotential
    x: np.ndarray                # [N, 3]
    box: np.ndarray              # [3]
    mass: float
    v: Optional[np.ndarray] = None
    model: str = "short"
    dtype: str = "float64"
    pbc: tuple = (True, True, True)     # the model's
    k_short: int = 32
    short_delta: float = 0.4
    cut: Optional[float] = None         # a shrunk descriptor cutoff
    n_blocks: int = 0
    migrate_rebuild: bool = False
    device: str = "cuda"


def build_driver(spec: ShardRun, mesh=None):
    """The driver of spec on `mesh` (default: in this process)."""
    from ..models import annp
    from ..ops.fused_annp import FusedAnnp
    from ..ops.fused_ni import FusedNi
    from . import domain, domain2d, domain3d
    dtype = getattr(torch, spec.dtype)
    cfg, params = annp.make_annp(spec.pot, dtype, spec.device, pbc=spec.pbc)
    if spec.cut is not None:
        cfg = dataclasses.replace(cfg, cut=spec.cut)
    is_ni = spec.pot.sym_coerad is not None
    if spec.model == "short":
        ev = (FusedNi if is_ni else FusedAnnp)(
            cfg, params, k_short=spec.k_short, short_delta=spec.short_delta)
        model = domain.FrameShortModel(ev)
    elif spec.model == "annp" and not is_ni:
        model = domain.AnnpFrameModel(FusedAnnp(cfg, params))
    else:
        raise ValueError(f"unknown model {spec.model!r} for this potential")
    make = {0: domain.ShardedMD, 2: domain2d.ShardedMD2D,
            3: domain3d.ShardedMD3D}[len(getattr(spec.cfg, "mesh_shape",
                                                 ()))]
    box = torch.as_tensor(spec.box, dtype=dtype)
    return make(model, spec.mass, box, spec.cfg, mesh=mesh,
                device=spec.device)


def _same_on_every_rank(mesh, named):
    """Raise unless each tensor is bitwise equal on every rank."""
    for name, t in named:
        g = mesh.all_gather(t.reshape(1, -1))
        if not bool((g == g[:1]).all()):
            raise RuntimeError(f"rank {mesh.rank}: {name} differs between "
                               "the ranks")


def run_sharded(spec: ShardRun, distributed=True):
    """distribute + spec's blocks; returns host values, the same on every
    rank: thermo {field: [n_blocks]}, x, v and f [N, 3] in the original
    atom order, box, pe (shift-free), virial, rebuild_count, migrated,
    overflow and unsafe [D], the mesh's world and n_local, distribute's and
    each block's wall seconds."""
    mesh = init_mesh(spec.cfg.n_devices, device=spec.device) \
        if distributed else None
    md = build_driver(spec, mesh)
    mesh = md.mesh
    dtype = getattr(torch, spec.dtype)
    x = torch.as_tensor(spec.x, dtype=dtype, device=md.device)
    v = None if spec.v is None else torch.as_tensor(spec.v, dtype=dtype,
                                                    device=md.device)
    sync = torch.cuda.synchronize if md.device.type == "cuda" else (
        lambda: None)
    t0 = time.perf_counter()
    st, _ = md.distribute(x, v)
    sync()
    dist_s = time.perf_counter() - t0
    rows, block_s, rebuilds, migrated = [], [], 0, 0
    for _ in range(spec.n_blocks):
        t0 = time.perf_counter()
        st, th = md.run(st, 1)
        sync()
        block_s.append(time.perf_counter() - t0)
        rows.append(th)
        rebuilds += md.rebuild_count
        migrated += md.migrated
    if spec.migrate_rebuild:
        before = md.migrated
        st = md.migrate(st)
        migrated += md.migrated - before
        st = md.rebuild(st)
    overflow, unsafe = md.flags(st)
    if mesh.group is not None:
        _same_on_every_rank(mesh, (
            ("box", st.box), ("v_eps", st.v_eps), ("virial", st.virial),
            ("nhc", torch.cat([st.nhc.xi, st.nhc.v_xi])),
            ("baro_nhc", torch.cat([st.baro_nhc.xi, st.baro_nhc.v_xi])),
            ("flags", torch.stack([overflow.any(), unsafe.any()]))))
    f = md.gather_positions(st._replace(x_loc=st.f_loc))
    v = md.gather_positions(st._replace(x_loc=st.v_loc))

    def host(t):
        return t.detach().double().cpu().numpy()

    thermo = {k: np.concatenate([host(getattr(th, k)) for th in rows])
              for k in rows[0]._fields} if rows else {}
    return {"thermo": thermo, "x": host(md.gather_positions(st)),
            "v": host(v), "f": host(f), "box": host(st.box),
            "pe": float(mesh.psum(st.pe)),
            "virial": host(st.virial), "rebuild_count": rebuilds,
            "migrated": migrated, "overflow": overflow.cpu().numpy(),
            "unsafe": unsafe.cpu().numpy(), "world": mesh.world,
            "n_local": mesh.n_local, "distribute_s": dist_s,
            "block_s": block_s}


def run_each(specs):
    """run_sharded of each spec in turn over the process group."""
    return [run_sharded(spec) for spec in specs]


# ------------------------------------------------- the launcher's checks
def check_collectives(n_shards, device="cuda", fail_rank=None):
    """Every collective of the distributed mesh against the in-process
    mesh on the same [D, ...] tensors, exactly, on every rank: ppermute
    (a ring, the 2-D drivers' pairs, a pair list that leaves a shard
    without a sender; f64, bool and int64), ring_shift +-1, all_gather,
    psum (also of one partial sum a rank) and any. A rank equal to
    fail_rank raises before the collectives (the others wait in them). Returns the names checked."""
    mesh = init_mesh(n_shards, device=device)
    if mesh.rank == fail_rank:
        raise ValueError(f"rank {fail_rank} fails on purpose")
    ref = ShardMesh(n_shards, mesh.device)
    d = n_shards
    gen = torch.Generator().manual_seed(5)
    tensors = {
        "f64": torch.randn((d, 5, 3), generator=gen, dtype=torch.float64),
        "bool": torch.rand((d, 7), generator=gen) > 0.5,
        "int64": torch.randint(-9, 9, (d, 4), generator=gen)}
    tensors = {k: t.to(mesh.device) for k, t in tensors.items()}
    pair_sets = {"ring": [(i, (i + 1) % d) for i in range(d)],
                 "partial": [(i, (i + 1) % d) for i in range(d - 1)][::-1]}
    if d % 2 == 0:
        half = d // 2                  # a (2, d/2) grid's x and y shifts
        pair_sets["grid-x"] = [(i, (i + half) % d) for i in range(d)]
        pair_sets["grid-y"] = [(i, (i // half) * half + (i + 1) % half)
                               for i in range(d)]
    done = []

    def same(name, got, want):
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(f"rank {mesh.rank}: {name} differs from the "
                               "in-process mesh")
        done.append(name)

    for tname, t in tensors.items():
        loc = mesh.local(t)
        for pname, pairs in pair_sets.items():
            same(f"ppermute {pname} {tname}", mesh.ppermute(loc, pairs),
                 mesh.local(ref.ppermute(t, pairs)))
        for s in (1, -1):
            same(f"ring_shift {s} {tname}", mesh.ring_shift(loc, s),
                 mesh.local(ref.ring_shift(t, s)))
        same(f"all_gather {tname}", mesh.all_gather(loc), ref.all_gather(t))
    t = tensors["f64"]
    same("psum f64", mesh.psum(mesh.local(t)), ref.psum(t))
    same("psum int64", mesh.psum(mesh.local(tensors["int64"])),
         ref.psum(tensors["int64"]))
    n_loc = mesh.n_local
    same("psum of the ranks' sums",
         mesh.psum(mesh.local(t).sum(dim=0)[None]),
         torch.stack([t[r * n_loc:(r + 1) * n_loc].sum(dim=0)
                      for r in range(mesh.world)]).sum(dim=0))
    for flag in (torch.zeros(d, dtype=torch.bool, device=mesh.device),
                 torch.arange(d, device=mesh.device) == d - 1):
        if mesh.any(mesh.local(flag)) != ref.any(flag):
            raise RuntimeError(f"rank {mesh.rank}: any differs")
    done.append("any")
    return done


def _thermal_v(n, t, mass, seed):
    """Velocities [n, 3] (A/ps) at temperature t without drift."""
    from ..units import BOLTZ, MVV2E
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v -= v.mean(axis=0)
    t_now = mass * MVV2E * (v * v).sum() / ((3 * n - 3) * BOLTZ)
    return v * np.sqrt(t / t_now)


def dryrun(n_shards, device="cuda"):
    """The checks of `__graft_entry__.dryrun_multichip` on the synthetic
    fe potential at the shipped width in f32 (its cutoff shrunk to 2.6 A,
    skin 0.2 A): 1-D y-coupled NPT with migration and an in-run rebuild,
    then an explicit migrate + rebuild; the frame short list against the
    full-width frame model; the 2-D (2, D/2) grid; the 3-D (2, 2, 2) grid
    at D = 8. Returns rank 0's lines, one "OK" line a check."""
    from ..geometry.lattice import bcc
    from ..testing import synthetic_fe_potential
    from .domain import ShardConfig
    from .domain2d import Shard2DConfig
    from .domain3d import Shard3DConfig
    pot = synthetic_fe_potential(0)
    mass = float(pot.masses[0])
    cut, skin = 2.6, 0.2
    rng = np.random.default_rng(0)
    lines = []

    def scene(cells):
        x, box = bcc(cells)
        return x + rng.normal(scale=0.02, size=x.shape), np.asarray(box)

    def run(cfg, x, box, **kw):
        spec = ShardRun(cfg=cfg, pot=pot, x=x, box=box, mass=mass,
                        dtype="float32", cut=cut, device=device, **kw)
        out = run_sharded(spec)
        if out["overflow"].any() or out["unsafe"].any():
            raise RuntimeError(f"overflow {out['overflow'].tolist()} unsafe "
                               f"{out['unsafe'].tolist()}")
        for key in ("x", "f"):
            if not np.isfinite(out[key]).all():
                raise RuntimeError(f"non-finite {key}")
        return out

    d = n_shards
    cells_x = max(4 * d, int(np.ceil(d * 2 * (cut + skin) / 2.8553)))
    x, box = scene([-(-cells_x // d) * d, 4, 4])
    n = len(x)
    v = _thermal_v(n, 300.0, mass, 1)
    cfg = ShardConfig(n_devices=d, c_loc=n // d, capacity=64, cutoff=cut,
                      skin=skin, dt=0.001, ensemble="npt", t_target=300.0,
                      tau_t=0.1, p_target=(0.0,) * 3,
                      p_couple=(False, True, False), tau_p=1.0,
                      thermo_every=2, migrate_b=8, stale_factor=0.05)
    out = run(cfg, x, box, v=v, model="annp", n_blocks=2,
              migrate_rebuild=True)
    if out["rebuild_count"] < 1:
        raise RuntimeError("no in-run rebuild")
    world = out["world"]
    lines.append(
        f"dryrun OK: {d} shards on {world} ranks ({out['n_local']} a rank), "
        f"{n} atoms, 4 NPT steps (halos, global sums, NHC + MTK, "
        f"{out['rebuild_count']} in-run rebuild(s), migrate + rebuild), "
        f"pe (shift-free) {out['thermo']['pe'][-1]:.4f} eV, "
        f"T {out['thermo']['temp'][-1]:.1f} K")

    full = run(cfg, x, box, model="annp")
    short = run(cfg, x, box, model="short", k_short=32, short_delta=0.2,
                n_blocks=1)
    df = float(np.abs(short["f"] - full["f"]).max())
    if not df < 5e-4:
        raise RuntimeError(f"frame-short forces off by {df:.2e}")
    lines.append(f"dryrun frame-short OK: max|dF| against the full-width "
                 f"frame model {df:.2e}")

    if d >= 4 and d % 2 == 0:
        dy = d // 2
        cells_y = max(6, int(np.ceil(dy * (2 * (cut + skin) + 1.0)
                                     / 2.8553)))
        x2, box2 = scene([8, cells_y, 3])
        n2 = len(x2)
        cfg2 = Shard2DConfig(n_devices=d, mesh_shape=(2, dy), c_loc=n2 // d,
                             cutoff=cut, skin=skin, dt=0.001, thermo_every=2,
                             migrate_b=8)
        out = run(cfg2, x2, box2, v=_thermal_v(n2, 300.0, mass, 2),
                  model="annp", n_blocks=1, migrate_rebuild=True)
        lines.append(f"dryrun 2-D OK: (2, {dy}) grid, {n2} atoms, staged "
                     f"x/y halos + 2-D migrate, pe (shift-free) "
                     f"{out['thermo']['pe'][-1]:.4f} eV")
    if d == 8:
        cells = max(6, int(np.ceil(2 * (2 * (cut + skin) + 1.0) / 2.8553)))
        x3, box3 = scene([cells] * 3)
        x3 = x3[:len(x3) - len(x3) % 8]
        n3 = len(x3)
        cfg3 = Shard3DConfig(n_devices=8, mesh_shape=(2, 2, 2),
                             c_loc=n3 // 8, cutoff=cut, skin=skin, dt=0.001,
                             thermo_every=2, migrate_b=8)
        out = run(cfg3, x3, box3, v=_thermal_v(n3, 300.0, mass, 3),
                  model="annp", n_blocks=1, migrate_rebuild=True)
        lines.append(f"dryrun 3-D OK: (2, 2, 2) grid, {n3} atoms, three "
                     f"staged halo rounds + 3-axis migrate, pe (shift-free) "
                     f"{out['thermo']['pe'][-1]:.4f} eV")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m meng_zhang_tpu_torch.parallel.launch",
        description="The sharded drivers' dryrun over N processes.")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--shards", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"))
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args(argv)
    if a.shards % a.nproc:
        ap.error("--nproc must divide --shards")
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    backend = _backend(a.device, a.backend)
    from meng_zhang_tpu_torch.parallel import launch   # importable by name
    out = launch.spawn(launch.dryrun, a.nproc, backend, a.device,
                       (a.shards, a.device), a.timeout)
    for line in out.result:
        print(line)
    print(f"launch OK: {a.nproc} ranks over {backend} on {a.device}, "
          f"launches {[{k: n for k, n in r.items() if n} for r in out.launches]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
