"""Headline benchmark on one NVIDIA GPU: atom-steps per second of the fe
main path. Counterpart of the root bench.py; prints its one JSON line
{"metric", "value", "unit", "vs_baseline"} on stdout (log lines on
stderr). vs_baseline divides the rate by the reference's aggregate 0.559
steps/s x 152,880 atoms = 85,460 atom-steps/s on 2x RTX A5000.

Default scene: the reference benchmark's 152,880-atom bcc-Fe slab (box
184 x 85.659 x 112.5 A, `boundary m p m`), NPT at 300 K with the
y-coupled barostat (tau_t 0.1, tau_p 1.0 ps), dt 1 fs; skin-list capacity
192, skin 1.2 A, cell capacity 96, the cell grid sized for 0.92 of the box;
FusedAnnp's harmonic short path (Ks 128, short_delta 0.4), refreshed by
compact_short every 10-step thermo block. Its positions are the minimized
scene of artifacts/bench_minimized.npz (key `x`), used whenever their
shape is (152880, 3): the npz's `key` hashes reference files that are not
in the repository, so it is not checked. The shipped .ann is not in the
repository either: the potential is testing.synthetic_fe_potential of the
shipped width, and the metric string says so.

Minimize: only when that npz (or the one `--min-npz` names) is missing or
its shape is wrong, and unminimized positions are at hand (`--data`, the
reference's LAMMPS data file, or main's `scene`): md/minimize.cg_minimize
with the root bench.py's arguments (etol = ftol = 1e-6, max_iter 1000,
dmax 0.1, e_offset n e_shift), skipped when less than 240 s of the budget
are left. The minimized positions are written only to the path `--min-npz`
names, never over the committed artifact. With no usable npz and nothing
to minimize, the run falls back to the synthetic scene, as bench.py does
without its fixture.

Timed window: init_state (seed 4928459, 300 K), one warm-up block and one
forced skin-list rebuild, so that nothing is built for the first time
inside the window; then --steps steps in chunks of 5 thermo blocks, each
fenced by the thermo read-back, against the deadline MZT_BENCH_BUDGET
(seconds from main's start, default 1200): a chunk that would not finish
30 s before it is not started. Rebuilds, overflow and the `unsafe` latch
go to stderr. Overflow raises; any other failure after a chunk was
measured prints the rate of the chunks measured.

--synthetic: bench.py's fallback scene, bcc --n-cells^3 cells (default
24: 27,648 atoms) with 0.03 A Gaussian noise (numpy seed 0), NVE, capacity
256, skin 2.0 A, fully periodic (the all-pairs list where the box holds
fewer than 3 cells of rc + skin a side).

Left out as TPU workarounds: the pair coloring, the colored short list and
its host refresh (the port delivers forces with index_add_), and the
persistent XLA compile cache (the port compiles its kernels once per
checkout, ops/kernels.py).

    python -m meng_zhang_tpu_torch.scripts.bench
    python -m meng_zhang_tpu_torch.scripts.bench --synthetic --steps 100
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit

BASELINE_APS = 0.559 * 152880
SCENE_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "artifacts",
    "bench_minimized.npz")
REF_ATOMS = 152880
BOX = (184.0, 85.659, 112.5)
SEED = 4928459
T_INIT = 300.0
K_SHORT, SHORT_DELTA = 128, 0.4
CELL_CAPACITY = 96
CHUNK_BLOCKS = 5             # thermo blocks between deadline checks
MIN_BUDGET_S = 240.0         # least budget left for a fresh minimize
# per scene: skin-list capacity, skin (A), ensemble, pbc, barostat
# coupling, share of the box the static cell grid is sized for (bench.py
# :206-208, :217-219, :304-306)
SCENES = {
    "reference": dict(capacity=192, skin=1.2, ensemble="npt",
                      pbc=(False, True, False), couple=(False, True, False),
                      dims_share=0.92),
    "synthetic": dict(capacity=256, skin=2.0, ensemble="nve",
                      pbc=(True, True, True), couple=(False, False, False),
                      dims_share=1.0),
}


class BenchRun(NamedTuple):
    record: dict             # the JSON line main() prints
    sim: Any                 # the Simulator
    state: Any               # MDState after the timed window
    rebuilds: int            # skin-list rebuilds in the timed window
    evaluations: int         # force evaluations (init and warm-up included)
    minimized: Any           # md.minimize.CGState of a fresh minimize, or
                             # None
    evaluator: Any           # the FusedAnnp


def md_config(cut, box, scene="reference", thermo=10):
    """The MDConfig of a scene (bench.py's, :130-137): the cell list on a
    grid sized for dims_share of the box, or all pairs where that grid
    would hold fewer than 3 cells a side."""
    from ..md.simulation import MDConfig
    from ..system.neighbors import cell_grid_dims
    s = SCENES[scene]
    dims = cell_grid_dims(np.asarray(box, np.float64) * s["dims_share"],
                          cut + s["skin"])
    cell = min(dims) >= 3
    return MDConfig(dt=0.001, cutoff=cut, skin=s["skin"],
                    capacity=s["capacity"],
                    nbr_method="cell" if cell else "n2",
                    cell_dims=dims if cell else None,
                    cell_capacity=CELL_CAPACITY, ensemble=s["ensemble"],
                    t_target=300.0, tau_t=0.1, p_target=(0.0,) * 3,
                    p_couple=s["couple"], tau_p=1.0, thermo_every=thermo,
                    pbc=s["pbc"], short_every=10, short_skin=SHORT_DELTA)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.bench",
        description="headline fe throughput on one GPU (one JSON line)")
    ap.add_argument("--steps", type=int, default=500,
                    help="timed steps (after the warm-up)")
    ap.add_argument("--thermo", type=int, default=10,
                    help="steps a block; a multiple of the 10-step "
                         "short-list refresh")
    ap.add_argument("--no-minimize", action="store_true",
                    help="measure unminimized positions rather than "
                         "minimize them")
    ap.add_argument("--synthetic", action="store_true",
                    help="the synthetic bcc NVE scene")
    ap.add_argument("--n-cells", type=int, default=24,
                    help="bcc cells a side of the synthetic scene")
    ap.add_argument("--data", default=None,
                    help="LAMMPS data file of the unminimized reference "
                         "scene (the reference's fe_st.dat), minimized "
                         "when no usable npz is found")
    ap.add_argument("--min-npz", default=None,
                    help="minimized positions to read instead of the "
                         "committed artifacts/bench_minimized.npz, and to "
                         "write after a fresh minimize")
    return ap


def _load_minimized(path, n):
    """x [n, 3] from the npz at path, or None (with the reason logged)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            x = np.asarray(z["x"], np.float32)
    except FileNotFoundError:
        log(f"minimize cache: no {path}")
        return None
    except (OSError, KeyError, ValueError) as e:
        log(f"minimize cache: {path} unreadable, {e!r}")
        return None
    if x.shape != (n, 3):
        log(f"minimize cache: {path} holds x of shape {x.shape}, not "
            f"({n}, 3)")
        return None
    return x


def _save_minimized(path, x):
    np.savez_compressed(path, x=np.asarray(x, np.float32))
    log(f"minimize cache: saved {path}")


def _record(metric, aps):
    """bench.py's JSON line, vs_baseline from the printed value."""
    value = round(aps, 1)
    return {"metric": metric, "value": value, "unit": "atom-steps/s",
            "vs_baseline": round(value / BASELINE_APS, 3)}


def main(argv=None, device=None, *, scene=None) -> BenchRun:
    """The benchmark, in f32; `scene` (x [N, 3], box [3] numpy) replaces
    the unminimized reference scene (`--data`), and with it the atom count
    an npz must hold."""
    args = build_parser().parse_args(argv)
    dtype = torch.float32
    from ..md.simulation import Simulator
    from ..models.annp import make_annp
    from ..ops.fused_annp import FusedAnnp
    from ..testing import synthetic_fe_potential
    from ..units import MASS_FE

    deadline = time.monotonic() + float(
        os.environ.get("MZT_BENCH_BUDGET", "1200"))

    def remaining():
        return deadline - time.monotonic()

    dev = resolve_device(device)
    pot = synthetic_fe_potential(0)
    pot_label = ("synthetic fe potential of the shipped width (the shipped "
                 ".ann is absent)")

    # ---- scene ----
    kind, x_np, box_np, x_raw = "synthetic", None, None, None
    if not args.synthetic:
        if scene is None and args.data:
            from ..io.lammps_data import read_data
            d = read_data(args.data)
            scene = (d.x, d.box)
        n_want = REF_ATOMS if scene is None else len(scene[0])
        box_np = np.asarray(BOX if scene is None else scene[1], np.float64)
        x_np = _load_minimized(args.min_npz or SCENE_NPZ, n_want)
        if x_np is None and scene is not None:
            x_raw = np.asarray(scene[0], np.float32)
        if x_np is not None or x_raw is not None:
            kind = "reference"
        else:
            log("reference scene unavailable (no usable npz and no --data "
                "to minimize); falling back to the synthetic scene")
    if kind == "synthetic":
        from ..geometry.lattice import bcc
        x_np, box_np = bcc(args.n_cells)
        x_np = x_np + np.random.default_rng(0).normal(scale=0.03,
                                                      size=x_np.shape)
    n = len(x_np if x_np is not None else x_raw)
    if kind == "synthetic":
        metric = f"bcc-Fe annp NVE throughput, {pot_label}"
    else:
        metric = (f"reference {n}-atom bcc-Fe NPT (in.st_test scene), "
                  f"{pot_label}")
    s = SCENES[kind]
    mcfg, params = make_annp(pot, dtype, dev, pbc=s["pbc"])
    ev = FusedAnnp(mcfg, params, k_short=K_SHORT, short_delta=SHORT_DELTA)
    cfg = md_config(mcfg.cut, box_np, kind, args.thermo)
    evaluations = 0

    def force_fn(xx, bb, nbrs, short):
        nonlocal evaluations
        evaluations += 1
        return ev.energy_forces_short(xx, bb, short)

    sim = Simulator(force_fn, torch.full((n,), MASS_FE, dtype=dtype,
                                         device=dev), cfg,
                    short_build=lambda xx, bb, nbrs: ev.compact_short(
                        xx, bb, nbrs.idx))
    pe_off = n * mcfg.e_shift
    box = torch.as_tensor(box_np, dtype=dtype, device=dev)
    log(f"{kind} scene: {n} atoms, box {np.round(box_np, 3)}, "
        f"{s['ensemble'].upper()}, {cfg.nbr_method} skin list "
        f"(capacity {cfg.capacity}, skin {cfg.skin}), Ks {K_SHORT}, "
        f"short_delta {SHORT_DELTA}; {device_label(dev)}")

    minimized = None
    if x_raw is not None:
        x_np = x_raw
        if args.no_minimize:
            log("minimize: off (--no-minimize)")
        elif remaining() < MIN_BUDGET_S:
            log(f"minimize: SKIPPED ({remaining():.0f} s left < "
                f"{MIN_BUDGET_S:.0f} s); measuring the unminimized scene")
        else:
            from ..md.minimize import cg_minimize
            t0 = time.time()
            x0 = torch.as_tensor(x_raw, dtype=dtype, device=dev)
            nbrs = sim.build_nbrs(x0, box)
            if bool(nbrs.overflow):
                raise RuntimeError("neighbor overflow on the scene to "
                                   "minimize")

            def ef(xx, bb, nbr_idx):
                nonlocal evaluations
                evaluations += 1
                return ev.energy_forces(xx, bb, nbr_idx, want_virial=False)

            minimized = cg_minimize(ef, x0, box, nbrs.idx, etol=1e-6,
                                    ftol=1e-6, max_iter=1000, dmax=0.1,
                                    e_offset=pe_off)
            x_np = minimized.x.cpu().numpy()
            log(f"minimize (cg): {time.time() - t0:.1f} s "
                f"{minimized.n_iter} iters {minimized.n_evals} evals "
                f"stop={minimized.converged} "
                f"pe={float(minimized.pe) + pe_off:.6e}")
            if args.min_npz:
                _save_minimized(args.min_npz, x_np)

    x = torch.as_tensor(x_np, dtype=dtype, device=dev)

    def fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    st = sim.init_state(x, box, seed=SEED, t_init=T_INIT)
    fence()
    log(f"init: {time.time() - t0:.1f} s overflow={bool(st.overflow)} "
        f"(budget left {remaining():.0f} s)")
    if bool(st.overflow):
        raise RuntimeError("neighbor overflow at init_state")
    t0 = time.time()
    st, th = sim.run(st, 1)            # warm-up block
    st = sim.rebuild(st)               # and the rebuild path, once
    float(th.temp[-1])
    fence()
    log(f"warm-up block + rebuild: {time.time() - t0:.1f} s (budget left "
        f"{remaining():.0f} s)")

    # ---- timed window, chunked against the deadline ----
    n_blocks = max(1, args.steps // args.thermo)
    done, wall, rebuilds = 0, 0.0, 0
    try:
        while done < n_blocks:
            nb = min(CHUNK_BLOCKS, n_blocks - done)
            if done > 0 and remaining() < wall / done * nb + 30.0:
                log(f"deadline: stopping after {done}/{n_blocks} blocks")
                break
            t0 = time.time()
            st, th = sim.run(st, nb)
            float(th.temp[-1])         # the thermo read-back fences
            wall += time.time() - t0
            done += nb
            rebuilds += sim.rebuild_count
            if bool(st.overflow):
                raise OverflowError(f"neighbor overflow in the timed window "
                                    f"(block {done})")
    except OverflowError:
        raise
    except Exception as e:
        if not done:
            raise
        log(f"bench died after {done * args.thermo} measured steps: {e!r}")
        rec = _record(metric, n * done * args.thermo / wall)
        emit(rec)
        return BenchRun(rec, sim, st, rebuilds, evaluations, minimized, ev)
    aps = n * done * args.thermo / wall
    log(f"{done * args.thermo} steps in {wall:.2f} s -> {aps:,.0f} "
        f"atom-steps/s  T={float(th.temp[-1]):.1f} K "
        f"PE={float(th.pe[-1]) + pe_off:.6e}  rebuilds={rebuilds} "
        f"overflow={bool(st.overflow)} unsafe={bool(st.unsafe)}")
    rec = _record(metric, aps)
    emit(rec)
    return BenchRun(rec, sim, st, rebuilds, evaluations, minimized, ev)


if __name__ == "__main__":
    main()
