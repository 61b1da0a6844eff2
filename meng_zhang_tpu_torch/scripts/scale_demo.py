"""Scale runs of the fe Chebyshev ANNP on one NVIDIA GPU (BASELINE.json
configs 3 and 5). Counterpart of scripts/scale_demo.py.

  --config 500k : 63^3 bcc cells (500,094 atoms), NPT at 300 K and 0 bar,
                  fully periodic, all three axes coupled (config 3, thermal
                  expansion); 200 steps.
  --config 2m   : the symmetric-tilt grain-boundary bicrystal of
                  make_stgb(length_box=(230, 325, 212) f, delete_overlap=2.3)
                  (1,964,085 atoms at --size-scale f = 1), FIRE-relaxed
                  (--no-minimize skips it), then NVE at 300 K (config 5's
                  scene); 100 steps.

Both run FusedAnnp's harmonic short path (the kernels g_harm and
force_harm; short_delta 0.4, the short list refreshed every thermo
interval) through the Simulator: init_state, a warm-up of 10 blocks, the
`unsafe` latch reset (the warm-up's transients are not the measured
window's), then a timed window. The virial is computed only under NPT,
which reads it. Prints one JSON record on stdout (log lines on stderr);
--out also writes it to a file.

Left out, as TPU workarounds of the JAX script: the host refresh of the
short list, the switch to the rev-free compaction (this package's
compaction has no reverse slots), buffer donation, deleting the minimize
epoch's neighbor tables, and the JAX compilation cache.

    python -m meng_zhang_tpu_torch.scripts.scale_demo --config 2m
    python -m meng_zhang_tpu_torch.scripts.scale_demo --config 500k \\
        --out scale_500k.json
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..run import log, resolve_device
from . import device_label, emit, peak_mem_gib

# per configuration (scripts/scale_demo.py:63-100, :150): ensemble, barostat
# coupling, skin (A), skin-list capacity, cell capacity, default steps,
# thermo interval, and the share of the box the static cell grid is sized
# for (NPT may shrink it)
CONFIGS = {
    "500k": dict(ensemble="npt", couple=(True, True, True), skin=1.2,
                 capacity=256, cell_capacity=96, steps=200, thermo=5,
                 dims_share=0.95),
    "2m": dict(ensemble="nve", couple=(False, False, False), skin=0.8,
               capacity=168, cell_capacity=48, steps=100, thermo=10,
               dims_share=1.0),
}
BCC_CELLS = (63, 63, 63)                 # 500,094 atoms
STGB_LENGTH = (230.0, 325.0, 212.0)      # A, grain 1; the box doubles in x
# overlap prune at 2.3 A, ~0.93 of bcc-Fe's nearest-neighbour distance: the
# closer pairs a tighter prune leaves relax faster than the skin allows
STGB_OVERLAP = 2.3
K_SHORT, SHORT_DELTA, STALE_FACTOR = 128, 0.4, 0.5
SEED, T_INIT = 4928459, 300.0
WARMUP_BLOCKS = 10
# the 2m scene's FIRE pre-relaxation (scripts/scale_demo.py:194-196)
FIRE = dict(f_tol=5e-2, dt0=5e-4, dt_max=5e-3, block=10)
FIRE_MAX_ITER = 100


class ScaleRun(NamedTuple):
    record: dict             # the JSON record main() prints
    sim: Any                 # the Simulator
    evaluator: Any           # its FusedAnnp
    state: Any               # MDState after the timed window
    x_start: torch.Tensor    # positions init_state started from (relaxed)
    box: torch.Tensor        # the starting box


def build_scene(config, size_scale=1.0):
    """(x [N, 3], box [3], label): numpy float64 positions and box of a
    configuration; size_scale scales the 2m scene's lengths."""
    if config == "500k":
        from ..geometry.lattice import bcc
        x, box = bcc(list(BCC_CELLS))
        return x, box, (f"bcc-Fe {len(x):,}-atom NPT 300K (thermal "
                        "expansion, config 3)")
    from ..geometry.stgb import make_stgb
    d = make_stgb(length_box=tuple(size_scale * v for v in STGB_LENGTH),
                  delete_overlap=STGB_OVERLAP)
    return d.x, d.box, (f"STGB bcc-Fe {len(d.x):,}-atom NVE 300K (config 5 "
                        "scene)")


def md_config(config, cut, box):
    """The configuration's MDConfig (scripts/scale_demo.py:149-166, less the
    TPU-only with_rev and short_host_refresh): cell grid over dims_share of
    the box at rlist = cut + skin, the short list refreshed every thermo
    interval with short_skin = short_delta."""
    from ..md.simulation import MDConfig
    from ..system.neighbors import cell_grid_dims
    c = CONFIGS[config]
    dims = cell_grid_dims(np.asarray(box) * c["dims_share"], cut + c["skin"])
    return MDConfig(dt=0.001, cutoff=cut, skin=c["skin"],
                    capacity=c["capacity"], nbr_method="cell",
                    cell_dims=dims, cell_capacity=c["cell_capacity"],
                    ensemble=c["ensemble"], t_target=300.0, tau_t=0.1,
                    p_target=(0.0,) * 3, p_couple=c["couple"], tau_p=1.0,
                    thermo_every=c["thermo"], stale_factor=STALE_FACTOR,
                    short_every=c["thermo"], short_skin=SHORT_DELTA)


def make_simulator(ev, mcfg, n, dtype, device):
    """Simulator over the evaluator's short path; the virial only under
    NPT (a zero [3, 3] otherwise)."""
    from ..md.simulation import Simulator
    from ..units import MASS_FE
    want_virial = mcfg.ensemble == "npt"

    def force_fn(xx, bb, nbrs, short):
        out = ev.energy_forces_short(xx, bb, short, want_virial=want_virial)
        if want_virial:
            return out
        return out + (xx.new_zeros(3, 3),)

    return Simulator(
        force_fn, torch.full((n,), MASS_FE, dtype=dtype, device=device),
        mcfg, short_build=lambda xx, bb, nbrs: ev.compact_short(xx, bb,
                                                               nbrs.idx))


def relax(sim, ev, x, box, max_iter=FIRE_MAX_ITER):
    """FIRE on one skin list, each evaluation on a fresh compaction
    (scripts/scale_demo.py:186-196). Returns the FireState."""
    from ..md.minimize import fire_minimize

    def ef(xx, bb, idx):
        return ev.energy_forces_short(xx, bb, ev.compact_short(xx, bb, idx),
                                      want_virial=False)

    return fire_minimize(ef, x, box, sim.build_nbrs(x, box).idx,
                         max_iter=max_iter, **FIRE)


class _Stages:
    """Each stage's peak allocated device memory (GiB): the peak counter is
    reset at every mark, after the device has finished."""

    def __init__(self, dev):
        self.dev, self.peaks = dev, {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def mark(self, name):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.peaks[name] = peak_mem_gib(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch.scripts.scale_demo",
        description="BASELINE.json configs 3 (500k) and 5 (2m) on one GPU")
    ap.add_argument("--config", choices=tuple(CONFIGS), required=True)
    ap.add_argument("--no-minimize", action="store_true",
                    help="skip the FIRE pre-relaxation of the 2m scene")
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steps (default: 200 for 500k, 100 for 2m)")
    ap.add_argument("--size-scale", type=float, default=1.0,
                    help="2m scene linear scale factor")
    ap.add_argument("--potential", default=None,
                    help=".ann file (default: the synthetic fe potential "
                         "of the shipped width, testing.py)")
    ap.add_argument("--out", default=None, help="also write the record here")
    return ap


def main(argv=None, device=None, *, warmup=WARMUP_BLOCKS,
         fire_max_iter=FIRE_MAX_ITER, dtype=torch.float32) -> ScaleRun:
    """The configuration's run; the keywords size a reduced run (the
    warm-up blocks, the 2m scene's FIRE iterations, the dtype)."""
    args = build_parser().parse_args(argv)
    from ..io.potential import read_ann
    from ..models.annp import make_annp
    from ..ops.fused_annp import FusedAnnp
    from ..system.neighbors import max_displacement_sq
    from ..testing import synthetic_fe_potential

    dev = resolve_device(device)
    c = CONFIGS[args.config]
    stages = _Stages(dev)
    t0 = time.time()
    x_np, box_np, label = build_scene(args.config, args.size_scale)
    scene_s = time.time() - t0
    n = len(x_np)
    log(f"{label}: {n} atoms, box {np.round(box_np, 1)} (built in "
        f"{scene_s:.2f} s)")
    pot = read_ann(args.potential) if args.potential else \
        synthetic_fe_potential(0)
    mcfg, params = make_annp(pot, dtype, dev)
    ev = FusedAnnp(mcfg, params, k_short=K_SHORT, short_delta=SHORT_DELTA)
    cfg = md_config(args.config, mcfg.cut, box_np)
    sim = make_simulator(ev, cfg, n, dtype, dev)
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    box = torch.as_tensor(box_np, dtype=dtype, device=dev)
    pe_off = n * mcfg.e_shift

    fire_iters, fire_s, fire_fmax, fire_disp = 0, 0.0, None, None
    if args.config == "2m" and not args.no_minimize:
        t0 = time.time()
        fst = relax(sim, ev, x, box, fire_max_iter)
        fire_disp = float(max_displacement_sq(x, fst.x, box)) ** 0.5
        x = fst.x
        fire_iters, fire_fmax = int(fst.n_iter), float(fst.fmax)
        fire_s = time.time() - t0
        log(f"minimize: {fire_s:.1f}s {fire_iters} iterations "
            f"fmax={fire_fmax:.2e} pe={float(fst.pe) + pe_off:.6e} "
            f"largest move {fire_disp:.3f} A")
        del fst
        stages.mark("fire")

    t0 = time.time()
    st = sim.init_state(x, box, seed=SEED, t_init=T_INIT)
    stages.mark("init")
    init_s = time.time() - t0
    log(f"init: {init_s:.1f}s overflow={bool(st.overflow)}")
    if bool(st.overflow):
        raise RuntimeError("neighbor/cell capacity overflow at init_state")
    t0 = time.time()
    if warmup:
        st, th = sim.run(st, warmup)
        stages.mark("warmup")
        log(f"warmup: {time.time() - t0:.1f}s T={float(th.temp[-1]):.1f}"
            f" unsafe={bool(st.unsafe)}")
    warm_s = time.time() - t0
    # the relaxing grain boundary's first blocks may outrun the skin before
    # a block-end rebuild: those transients belong to the warm-up, so the
    # sticky latch is reset and `unsafe` reports the timed window
    st = st._replace(unsafe=torch.zeros_like(st.unsafe))
    e0 = float(sim.thermo(st).conserved)

    n_blocks = (args.steps or c["steps"]) // c["thermo"]
    t0 = time.time()
    st, th = sim.run(st, n_blocks)
    stages.mark("timed")
    wall = time.time() - t0
    steps = n_blocks * c["thermo"]
    aps = n * steps / wall
    rec = {
        "config": args.config, "label": label, "atoms": n, "steps": steps,
        "wall_s": wall, "atom_steps_per_s": aps,
        "temp_K": float(th.temp[-1]), "press_bar": float(th.press[-1]),
        "pe_eV": float(th.pe[-1]) + pe_off, "vol_A3": float(th.vol[-1]),
        "box_A": st.box.tolist(),
        "drift_eV": float(th.conserved[-1]) - e0,
        "rebuilds": sim.rebuild_count, "overflow": bool(st.overflow),
        "unsafe": bool(st.unsafe),
        "peak_mem_gib": max(stages.peaks.values(), default=None),
        "peak_mem_gib_by_stage": stages.peaks,
        "scene_s": scene_s, "fire_iters": fire_iters, "fire_s": fire_s,
        "fire_fmax": fire_fmax, "fire_max_disp_A": fire_disp,
        "init_s": init_s, "warmup_s": warm_s,
        "dtype": str(dtype).removeprefix("torch."),
        "device": device_label(dev),
    }
    log(f"{steps} steps in {wall:.1f}s -> {aps:,.0f} atom-steps/s"
        f"  T={rec['temp_K']:.1f}K P={rec['press_bar']:.0f} bar"
        f"  PE={rec['pe_eV']:.6e} eV  drift={rec['drift_eV']:.3e} eV"
        f"  rebuilds={rec['rebuilds']} overflow={rec['overflow']}"
        f" unsafe={rec['unsafe']} peak_mem_gib={rec['peak_mem_gib']}"
        f"  on {rec['device']}")
    if rec["overflow"]:
        raise RuntimeError("neighbor/cell capacity overflow in the run")
    emit(rec, args.out)
    return ScaleRun(rec, sim, ev, st, x, box)


if __name__ == "__main__":
    main()
