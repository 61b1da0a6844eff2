"""Throughput of the ni (Behler-Parrinello) and ANNA-ADP models on one
NVIDIA GPU. Counterpart of scripts/model_bench.py.

  --model ni   : fcc-Ni, BASELINE.json config 2's melt leg (NVT 1200 K)
                 at 256,000 atoms (40^3 fcc cells, a = 3.52 A, the perfect
                 lattice) from 600 K velocities;
  --model anna : bcc-Fe ANNA-ADP NVE 300 K at 128,000 atoms (40^3 bcc
                 cells), frozen-(d2, q2) forces.

Two force backends each (--backend):

  kernels  (the JAX script's `pallas`): ni through FusedNi (ni_g and
           ni_force; short list at the descriptor cutoff + 0.2 A, Ks
           --k-short, refreshed every 5-step thermo block; the light
           no-virial evaluation on all but each block's last step);
           ANNA through make_anna_fast_fns (phase 1 on g_harm; Ks 72,
           delta 0.2);
  chunked  ni through make_short_chunked_fns (compact_neighbor_rows and the
           chunked functions, on the same kernels); ANNA through the
           reference-shaped energy_forces on the skin list, zero virial
           (its energy carries e_base, so no offset is added).

Cell-list skin neighbors (skin 0.5 A or --skin; capacity 64 and cell
capacity 24 for ni, 96 and 48 for ANNA), velocities drawn at min(T, 600 K)
from seed 4928459, two warm-up blocks, the `unsafe` latch reset, then the
timed window of --steps (default 100). Prints one JSON record on stdout
(log lines on stderr); --out also writes it to a file.

What the port leaves out of the JAX script: the reverse slots of the ni
skin list (`with_rev`: the port delivers partner forces with index_add_
and has no reverse slots), the ANNA fast path's 2048-row chunks (a TPU
memory bound; the port's row chunk, models/anna_adp.ROW_CHUNK, holds the
128,000-atom scene in one), the JAX compilation cache and the artifact
file (`--no-write`: the port writes only at --out). `--chunk` is kept for
the ni chunked backend's signature; the port's chunked functions evaluate
all rows at once.

    python -m meng_zhang_tpu_torch.scripts.model_bench --model ni
    python -m meng_zhang_tpu_torch.scripts.model_bench --model anna \\
        --backend chunked --out anna.json
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit

THERMO = 5
SEED = 4928459
WARMUP_BLOCKS = 2
# per model: default cells, lattice, skin (A), skin-list capacity, cell
# capacity, ensemble, target temperature (scripts/model_bench.py:73-133,
# :157-166; ni's 4.4 A cells hold ~8 atoms, so 24 leaves 3x headroom)
MODELS = {
    "ni": dict(cells=40, skin=0.5, capacity=64, cell_capacity=24,
               ensemble="nvt", t_target=1200.0),
    "anna": dict(cells=40, skin=0.5, capacity=96, cell_capacity=48,
                 ensemble="nve", t_target=300.0),
}
NI_DELTA = 0.2
# bcc-Fe has 58 neighbors within rc + delta = 5.26 A (next shell 5.39 A);
# 72 leaves thermal headroom
ANNA_KS, ANNA_DELTA = 72, 0.2


class BenchRun(NamedTuple):
    record: dict             # the JSON record main() prints
    sim: Any                 # the Simulator
    state: Any               # MDState after the timed window
    x_start: torch.Tensor    # positions init_state started from
    box: torch.Tensor
    evaluations: int         # force evaluations of the run (init included)
    model: tuple             # (model config, params) of the run


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.model_bench",
        description="ni and ANNA-ADP throughput on one GPU")
    ap.add_argument("--model", choices=tuple(MODELS), required=True)
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steps (default 100)")
    ap.add_argument("--cells", type=int, default=None,
                    help="lattice cells a side (default 40)")
    ap.add_argument("--k-short", type=int, default=32,
                    help="ni short-row capacity (solid fcc needs 18 + "
                         "thermal headroom; overflow NaN-poisons)")
    ap.add_argument("--chunk", type=int, default=1024,
                    help="ni chunked backend's chunk (kept for the JAX "
                         "signature)")
    ap.add_argument("--backend", choices=("kernels", "chunked"),
                    default="kernels",
                    help="force path: the hand kernels' fused evaluators "
                         "(the JAX script's `pallas`) or the chunked "
                         "functions")
    ap.add_argument("--skin", type=float, default=None,
                    help="neighbor skin override (rebuild-cadence sweeps)")
    ap.add_argument("--potential", default=None,
                    help=".ann (ni) or .anna (anna) file (default: the "
                         "synthetic potential of the shipped width, "
                         "testing.py)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap


def _ni(args, dtype, dev):
    """(mcfg, params, rc, x, box, mass, e_shift, (force_fn, light,
    short_build), delta, label)."""
    from ..geometry.lattice import fcc
    from ..io.potential import read_ann
    from ..models.annp import (effective_cutoff, make_annp,
                               make_short_chunked_fns)
    from ..ops.fused_ni import FusedNi
    from ..testing import synthetic_ni_potential
    from ..units import MASS_NI
    pot = read_ann(args.potential) if args.potential else \
        synthetic_ni_potential(0)
    mcfg, params = make_annp(pot, dtype, dev)
    rc = effective_cutoff(pot)           # 3.90 A, not the 6.5 A list cut
    x, box = fcc(args.cells or MODELS["ni"]["cells"], a=3.52)
    label = f"fcc-Ni {len(x):,}-atom NVT 1200K melt leg (config 2 scene)"
    if args.backend == "kernels":
        ev = FusedNi(mcfg, params, k_short=args.k_short,
                     short_delta=NI_DELTA)

        def force_fn(xx, bb, nbrs, short):
            return ev.energy_forces_short(xx, bb, short)

        def force_fn_light(xx, bb, nbrs, short):
            e, f = ev.energy_forces_short(xx, bb, short, want_virial=False)
            return e, f, xx.new_zeros(3, 3)

        fns = (force_fn, force_fn_light,
               lambda xx, bb, nbrs: ev.compact_short(xx, bb, nbrs.idx))
    else:
        fns = make_short_chunked_fns(mcfg, params, k_short=args.k_short,
                                     delta=NI_DELTA, chunk=args.chunk)
    return (mcfg, params, rc, x, box, MASS_NI, mcfg.e_shift, fns,
            NI_DELTA, label)


def _anna(args, dtype, dev):
    from ..geometry.lattice import bcc
    from ..io.potential import read_anna
    from ..models import anna_adp
    from ..testing import synthetic_anna_potential
    from ..units import MASS_FE
    pot = read_anna(args.potential) if args.potential else \
        synthetic_anna_potential(0)
    mcfg, params = anna_adp.make_anna(pot, dtype, dev)
    x, box = bcc([args.cells or MODELS["anna"]["cells"]] * 3)
    label = (f"bcc-Fe ANNA-ADP {len(x):,}-atom NVE 300K "
             "(anna-gpu-lammps scene class)")
    if args.backend == "kernels":
        fns = anna_adp.make_anna_fast_fns(mcfg, params, k_short=ANNA_KS,
                                          delta=ANNA_DELTA)
        return (mcfg, params, mcfg.cut, x, box, MASS_FE, mcfg.e_base,
                fns, ANNA_DELTA, label)

    def force_fn(xx, bb, nbrs):
        e, f = anna_adp.energy_forces(mcfg, params, xx, bb, nbrs.idx)
        return e, f, xx.new_zeros(3, 3)

    return (mcfg, params, mcfg.cut, x, box, MASS_FE, 0.0,
            (force_fn, None, None), 0.0, label)


def main(argv=None, device=None, *, dtype=torch.float32) -> BenchRun:
    """The model's run; `dtype` sets the run's precision (float64 for the
    CPU tests)."""
    args = build_parser().parse_args(argv)
    from ..md.simulation import MDConfig, Simulator
    from ..system.neighbors import cell_grid_dims

    dev = resolve_device(device)
    m = MODELS[args.model]
    (mcfg, params, rc, x_np, box_np, mass, e_shift,
     (force_fn, force_fn_light, short_build), delta, label) = \
        (_ni if args.model == "ni" else _anna)(args, dtype, dev)
    n = len(x_np)
    skin = m["skin"] if args.skin is None else args.skin
    log(f"{label}: {n} atoms, box {np.round(box_np, 1)}, rc={rc:.3f}, "
        f"skin={skin}, backend {args.backend}")
    cfg = MDConfig(dt=0.001, cutoff=rc, skin=skin, capacity=m["capacity"],
                   nbr_method="cell",
                   cell_dims=cell_grid_dims(np.asarray(box_np), rc + skin),
                   cell_capacity=m["cell_capacity"], ensemble=m["ensemble"],
                   t_target=m["t_target"], tau_t=0.1, thermo_every=THERMO,
                   stale_factor=0.5,
                   short_every=THERMO if short_build else 0,
                   short_skin=delta)
    sim = Simulator(force_fn, torch.full((n,), mass, dtype=dtype, device=dev),
                    cfg, short_build=short_build,
                    force_fn_light=force_fn_light)
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    box = torch.as_tensor(box_np, dtype=dtype, device=dev)

    t0 = time.time()
    st = sim.init_state(x, box, seed=SEED, t_init=min(m["t_target"], 600.0))
    log(f"init: {time.time() - t0:.1f}s overflow={bool(st.overflow)}")
    if bool(st.overflow):
        raise RuntimeError("neighbor/cell capacity overflow at init_state")
    t0 = time.time()
    st, th = sim.run(st, WARMUP_BLOCKS)
    log(f"warmup: {time.time() - t0:.1f}s T={float(th.temp[-1]):.1f}")
    st = st._replace(unsafe=torch.zeros_like(st.unsafe))

    n_blocks = (args.steps or 100) // THERMO
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    st, th = sim.run(st, n_blocks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    steps = n_blocks * THERMO
    aps = n * steps / wall
    pe_off = n * e_shift
    rec = {
        "model": args.model, "label": label, "atoms": n, "steps": steps,
        "wall_s": wall, "atom_steps_per_s": aps,
        "temp_K": float(th.temp[-1]), "pe_eV": float(th.pe[-1]) + pe_off,
        "rebuilds": sim.rebuild_count, "unsafe": bool(st.unsafe),
        "overflow": bool(st.overflow), "backend": args.backend,
        "dtype": str(dtype).removeprefix("torch."),
        "device": device_label(dev),
    }
    log(f"{steps} steps in {wall:.1f}s -> {aps:,.0f} atom-steps/s"
        f"  T={rec['temp_K']:.1f}K PE={rec['pe_eV']:.6e} eV"
        f"  rebuilds={rec['rebuilds']} overflow={rec['overflow']}"
        f" unsafe={rec['unsafe']}  on {rec['device']}")
    if rec["overflow"]:
        raise RuntimeError("neighbor/cell capacity overflow in the run")
    # NaN-poisoned forces (short-row overflow) cascade into NaN velocities;
    # a later PE can look finite because NaN coordinates mask every pair
    # out, so the temperature is the sentinel
    if not (math.isfinite(rec["temp_K"]) and math.isfinite(rec["pe_eV"])):
        raise RuntimeError("trajectory NaN-poisoned")
    emit(rec, args.out)
    evaluations = 1 + (WARMUP_BLOCKS + n_blocks) * THERMO
    return BenchRun(rec, sim, st, x, box, evaluations, (mcfg, params))


if __name__ == "__main__":
    main()
