#!/usr/bin/env python3
"""Bring-up smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives `meng_zhang_tpu_torch` -- never JAX -- through its two main paths:

  * fe Chebyshev ANNP on the reference benchmark scene: the 152,880-atom
    bcc-Fe slab (box 184 x 85.659 x 112.5 A, `boundary m p m`, positions
    from artifacts/bench_minimized.npz), NPT at 300 K with a y-coupled
    barostat, on a synthetic potential of the shipped fe width (npsf 9,
    ntsf 19, nnod 10, rc 6.5 A; meng_zhang_tpu_torch/testing.py);
  * fcc-Ni Behler-Parrinello ANNP on the scene of
    `scripts/model_bench.py --model ni`: 256,000 atoms (fcc 40^3 cells,
    a = 3.52 A, fully periodic), NVT at 1200 K from 600 K velocities, on a
    synthetic potential of the shipped ni width (npsf 3 + ntsf 24, nnod 24,
    Rc 7.3699319 Bohr = 3.90 A).

Phases, each fatal on failure:

  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every ops/csrc/*.cu with nvcc for sm_90a, in parallel;
  3. fe kernels vs their plain PyTorch versions on [P, 128] planes gathered
     from the scene (filler lanes included), in f32 and f64, plus times;
  4. fe evaluator: energy_forces_short through the kernels in f32 against
     the plain path in f64 on the full scene, and the f64 kernel path
     against the autograd model (models/annp.py) on a 250-atom box;
  5. fe main path: init_state + 20 blocks of 10 NPT steps through
     Simulator, one forced skin-list rebuild after the first block; checks
     finite thermo, no overflow / unsafe, and the kernels' launch counts;
  6. ni kernels vs plain on [P, 32] planes of a thermal 256,000-atom box;
  7. ni evaluator: FusedNi in f32 through the kernels against the f64
     plain path on that box, and the f64 kernel path against the autograd
     model on a 256-atom box;
  8. ni main path: init_state + 20 blocks of 5 NVT steps with the light
     (no-virial) force variant on all but each block's last step.

Prints the kernels' JSON record on the line before the last, and as the
last line {"ok": true, "device": {...}}. Run from the repository root:
`python3 chip_smoke.py`.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T_START = time.time()
REPO = os.path.dirname(os.path.abspath(__file__))
SCENE_NPZ = os.path.join(REPO, "artifacts", "bench_minimized.npz")
BOX = (184.0, 85.659, 112.5)
PBC = (False, True, False)          # boundary m p m
COUPLE = (False, True, False)       # y-coupled barostat
SKIN, CAPACITY, CELL_CAPACITY = 1.2, 192, 96
K_SHORT, SHORT_DELTA, SHORT_EVERY, THERMO_EVERY = 128, 0.4, 10, 10
N_BLOCKS, RATE_BLOCKS = 20, 15
SEED = 4928459
# ni scene (scripts/model_bench.py --model ni)
NI_CELLS, NI_A = 40, 3.52
NI_SKIN, NI_CAPACITY, NI_CELL_CAPACITY = 0.5, 64, 24
NI_KS, NI_DELTA, NI_SHORT_EVERY, NI_THERMO_EVERY = 32, 0.2, 5, 5
NI_T, NI_T_INIT, NI_BLOCKS = 1200.0, 600.0, 20
NI_DISP = 0.08      # A per component, the thermal box of phases 6 and 7

# Kernel vs plain, per output, as a fraction of the output's max |value|.
# f32: the longest per-lane sums run over ~400 terms, whose worst-case
# linear rounding growth is 400 * 6e-8 = 2.4e-5; 1e-4 leaves 4x over that.
# f64: the same count at 1.1e-16 gives 4.4e-14; 1e-12 leaves 20x.
REL_BOUND = {torch.float32: 1e-4, torch.float64: 1e-12}
# Evaluator on the full scene, f32 kernel path against the f64 plain path,
# each bound relative to the scale of what it measures. The f32 error has
# one main source: normalisation subtracts a descriptor mean up to ~30 from
# sums whose spread is ~0.1, so the raw sums' f32 rounding (~1e-7 relative)
# reaches ~1e-4 of the normalised network input.
#   dE_per_atom <= 1e-5 * |E/N|: those input errors change per-atom energies
#     by ~1e-6 of |E_i| and mostly cancel in the sum;
#   max_dF <= 1e-3 * max|F|: forces inherit the ~1e-4 input error;
#   max_dW <= 3e-4 * max_ab sum_pairs |dx_a Fj_b|: W inherits the same
#     relative error per pair, and as it is a bias shared by similar atoms
#     it adds up over the pairs instead of cancelling; on an H100 it reads
#     1.4e-4 of that scale, so the bound leaves about 2x. Kernels built
#     with --use_fast_math pass every other gate here and read 4.7e-4;
#   sum_F <= 1e-6 * N * rms|F|: each Fj is added at one end of its pair and
#     subtracted at the other, so only rounding remains; one lost pair would
#     leave ~rms|F| and fail it.
EVAL_REL = {"dE_per_atom": 1e-5, "max_dF": 1e-3, "max_dW": 3e-4,
            "sum_F": 1e-6}
# Small-input reference: the kernel path in f64 against the autograd model
# (models/annp.py, the cos-matrix descriptor definition) on a 250-atom
# periodic thermal bcc box; both are f64, so only rounding separates them.
REF_F_ATOL = 1e-9          # eV/A
REF_E_RTOL = 1e-10
# ni kernel vs plain, per output, as a fraction of the output's max |value|.
# Each G4 column sums ~1000 (p, q) terms per atom (~18 partners inside
# 3.90 A, ~300 ordered pairs, x2 lambda x4 zeta within an eta group): worst-
# case linear rounding growth is 1000 * 6e-8 = 6e-5 in f32, 1.1e-13 in f64;
# the bounds leave ~3x and ~9x over that.
NI_REL_BOUND = {torch.float32: 2e-4, torch.float64: 1e-12}
# ni evaluator on the thermal 256,000-atom box, f32 kernel path against the
# f64 plain path, relative to the scales of what each measures. Min-max
# normalisation divides each raw sum by its span: the largest |G| * scale
# is ~2.4, so the inputs carry ~2.4x the raw sums' f32 rounding (~1e-7).
# A 4,000-atom box of the same potential through the plain f32 path on a
# CPU read 9e-8, 1.5e-5, 3.3e-5 and 3e-9 of the four scales:
#   dE_per_atom <= 1e-6 * |E/N|: per-atom energies carry ~1e-7 relative;
#   max_dF <= 2e-4 * max|F|, max_dW <= 3e-4 * max_ab sum_pairs |dx_a Fj_b|:
#     as for fe (forces and each pair's virial term inherit the input
#     error, which adds up over the pairs of similar atoms);
#   sum_F <= 1e-6 * N * rms|F|: each Fj is delivered to both ends of its
#     pair, so only rounding remains; one lost pair would fail it.
NI_EVAL_REL = {"dE_per_atom": 1e-6, "max_dF": 2e-4, "max_dW": 3e-4,
               "sum_F": 1e-6}


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of fn() over reps runs, CUDA events, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name}")
    log(card)
    return name, card


def phase_build():
    from meng_zhang_tpu_torch.ops import kernels
    libs, secs, build_log = kernels.build()
    log(f"[build] {', '.join(os.path.relpath(p, REPO) for p in libs.values())}"
        f" in {secs:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)}, one process"
        f" per source)")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line \
                or line.startswith("=="):
            log("[build]   " + line.strip())
    return secs


def scene(dev):
    z = np.load(SCENE_NPZ)
    x = torch.tensor(z["x"], dtype=torch.float32, device=dev)
    box = torch.tensor(BOX, dtype=torch.float32, device=dev)
    return x, box


def _potential():
    from meng_zhang_tpu_torch.testing import synthetic_fe_potential
    return synthetic_fe_potential(0)


def model(dev):
    from meng_zhang_tpu_torch.models.annp import make_annp
    pot = _potential()
    cfg32, p32 = make_annp(pot, torch.float32, dev, pbc=PBC)
    cfg64, p64 = make_annp(pot, torch.float64, dev, pbc=PBC)
    return cfg32, p32, cfg64, p64, float(pot.masses[0])


def md_config(cfg):
    from meng_zhang_tpu_torch.md.simulation import MDConfig
    from meng_zhang_tpu_torch.system.neighbors import cell_grid_dims
    rlist = cfg.cut + SKIN
    # NPT shrinks the box: size the static cell grid for up to 8% shrink
    dims = cell_grid_dims(np.asarray(BOX) * 0.92, rlist)
    return MDConfig(dt=0.001, cutoff=cfg.cut, skin=SKIN, capacity=CAPACITY,
                    nbr_method="cell", cell_dims=dims,
                    cell_capacity=CELL_CAPACITY, ensemble="npt",
                    t_target=300.0, tau_t=0.1, p_target=(0.0,) * 3,
                    p_couple=COUPLE, tau_p=1.0, thermo_every=THERMO_EVERY,
                    pbc=PBC, short_every=SHORT_EVERY,
                    short_skin=SHORT_DELTA)


def rel_err(a, b):
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-300)


def phase_kernels(x, box, cfg32, p32):
    """Kernel vs plain on the scene's [P, 128] planes; returns the JSON
    records (without launch counts) and the planes' short list."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    dev = x.device
    mcfg = md_config(cfg32)
    t0 = time.time()
    nbrs = build_neighbors_cell(x, box, cfg32.cut + SKIN, CAPACITY,
                                mcfg.cell_dims, CELL_CAPACITY, pbc=PBC)
    ev = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT, short_delta=SHORT_DELTA)
    sl = ev.compact_short(x, box, nbrs.idx)
    torch.cuda.synchronize()
    n_real = int((sl.sidx < x.shape[0]).sum(1).max())
    log(f"[kernels] skin list dims {mcfg.cell_dims} overflow "
        f"{bool(nbrs.overflow)} max row {int((nbrs.idx < x.shape[0]).sum(1).max())}"
        f"; short list overflow {bool(sl.overflow)} max row {n_real}/"
        f"{K_SHORT} ({time.time() - t0:.2f} s)")
    check(not bool(nbrs.overflow) and not bool(sl.overflow),
          "neighbor list overflow on the benchmark scene")
    npsf, ntsf, rc = cfg32.npsf, cfg32.ntsf, cfg32.cut
    planes32 = fa.pair_dx_planes(x, box, sl.sidx, PBC)
    p, k = planes32[0].shape
    rng = np.random.default_rng(SEED)
    dedg_np = np.zeros((p, fa.NSF_PAD))
    dedg_np[:, :npsf] = rng.normal(size=(p, npsf))
    b_np = np.zeros((p, fa.AB_PAD))
    b_np[:, :ntsf * ntsf + 1] = rng.normal(size=(p, ntsf * ntsf + 1))
    records = []
    for dtype in (torch.float32, torch.float64):
        planes = [t.to(dtype) for t in planes32]
        dedg = torch.tensor(dedg_np, dtype=dtype, device=dev)
        b = torch.tensor(b_np, dtype=dtype, device=dev)
        bound = REL_BOUND[dtype]
        tag = "f32" if dtype == torch.float32 else "f64"
        cases = [
            ("g_harm", lambda: kernels.g_harm(*planes, npsf, ntsf, rc),
             lambda: fa.g_harm_plain(*planes, npsf, ntsf, rc),
             ("g_raw", "A"), 299),
            ("force_harm",
             lambda: kernels.force_harm(*planes, dedg, b, npsf, ntsf, rc),
             lambda: fa.force_harm_plain(*planes, dedg, b, npsf, ntsf, rc),
             ("fjx", "fjy", "fjz"), 352),
        ]
        for name, kern, plain, outs, line in cases:
            got = kern()
            ref = plain()
            torch.cuda.synchronize()
            worst = 0.0
            for oname, a, r in zip(outs, got, ref):
                check(bool(torch.isfinite(a).all()),
                      f"{name} {tag}: non-finite {oname}")
                err, rel = rel_err(a, r)
                worst = max(worst, err)
                log(f"[kernels] {name} {tag} {oname}: max abs err {err:.3e}"
                    f" max rel err {rel:.3e} (bound {bound:.0e})")
                check(rel <= bound, f"{name} {tag} {oname} disagrees with "
                      f"its plain version: rel {rel:.3e} > {bound:.0e}")
            if dtype != torch.float32:
                continue
            ms = cuda_ms(kern, 10)
            plain_ms = cuda_ms(plain, 3)
            log(f"[kernels] {name} f32 [{p}, {k}]: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms (median, CUDA events)")
            records.append({
                "name": name, "route": "cuda",
                "source": "meng_zhang_tpu_torch/ops/csrc/annp_harm.cu",
                "replaces": f"meng_zhang_tpu/ops/pallas_annp.py:{line}",
                "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms})
    return records, sl


def phase_evaluator(x, box, cfg32, p32, cfg64, p64, sl):
    """Kernel path in f32 against the plain path in f64, same short list;
    then the f64 kernel path against the autograd model on a small box."""
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
    from meng_zhang_tpu_torch.testing import thermal_bcc
    n = x.shape[0]
    dev = x.device
    ev32 = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT, short_delta=SHORT_DELTA)
    ev64 = fa.FusedAnnp(cfg64, p64, k_short=K_SHORT, short_delta=SHORT_DELTA,
                        plain=True)
    x64, box64 = x.double(), box.double()
    e32, f32, w32 = ev32.energy_forces_short(x, box, sl)
    e64, f64, w64 = ev64.energy_forces_short(
        x64, box64, fa.ShortList(sl.sidx, x64, sl.overflow))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(f32).all()) and bool(torch.isfinite(e32)),
          "evaluator: non-finite f32 output")
    check(tuple(f32.shape) == (n, 3) and tuple(w32.shape) == (3, 3),
          "evaluator: wrong output shapes")
    f_rms = float(f64.pow(2).mean().sqrt())
    dd = fa.pair_dx_planes(x64, box64, sl.sidx, PBC)
    fj = ev64._eval_fj(*dd)[1]
    # filler lanes carry Fj = 0 exactly, so they add nothing here
    w_abs = max(float((da * fb).abs().sum()) for da in dd for fb in fj)
    got = {"dE_per_atom": abs(float(e32) - float(e64)) / n,
           "max_dF": float((f32.double() - f64).abs().max()),
           "max_dW": float((w32.double() - w64).abs().max()),
           "sum_F": float(f32.double().sum(0).abs().max())}
    scale = {"dE_per_atom": abs(float(e64)) / n,
             "max_dF": float(f64.abs().max()),
             "max_dW": w_abs, "sum_F": n * f_rms}
    vol = BOX[0] * BOX[1] * BOX[2]
    log(f"[evaluator] N {n}: E/N f64 {float(e64) / n + cfg64.e_shift:.9f} eV"
        f" (shift-free {float(e64) / n:.6e}); RMS F {f_rms:.4e} eV/A; max|F|"
        f" {scale['max_dF']:.4e} eV/A; virial pressure "
        f"{float(torch.trace(w64)) / 3 / vol * 1.6021765e6:.1f} bar")
    for key, val in got.items():
        bound = EVAL_REL[key] * scale[key]
        log(f"[evaluator] {key} {val:.3e} (bound {bound:.3e} = "
            f"{EVAL_REL[key]:.0e} x {scale[key]:.4e})")
        check(val <= bound, f"evaluator {key} {val:.3e} over {bound:.3e}")

    xs, bs = thermal_bcc(5, seed=SEED, disp=0.08)
    xs = torch.tensor(xs, dtype=torch.float64, device=dev)
    bs = torch.tensor(bs, dtype=torch.float64, device=dev)
    cfg_p, p_p = annp.make_annp(_potential(), torch.float64, dev)
    nb = build_neighbors_n2(xs, bs, cfg_p.cut, K_SHORT)
    check(not bool(nb.overflow), "small box: neighbor overflow")
    e_k, f_k, _ = fa.FusedAnnp(cfg_p, p_p, k_short=K_SHORT).energy_forces(
        xs, bs, nb.idx)
    e_a, f_a = annp.energy_forces(cfg_p, p_p, xs, bs, nb.idx)
    e_a = float(e_a) - xs.shape[0] * cfg_p.e_shift       # shift-free
    de = abs(float(e_k) - e_a) / abs(e_a)
    df = float((f_k - f_a).abs().max())
    log(f"[evaluator] 250-atom box, f64 kernels vs autograd model: rel dE "
        f"{de:.3e} (bound {REF_E_RTOL:.0e}), max dF {df:.3e} eV/A (bound "
        f"{REF_F_ATOL:.0e})")
    check(de <= REF_E_RTOL and df <= REF_F_ATOL,
          "kernel path disagrees with the autograd model on the small box")
    return got


def phase_main_path(x, box, cfg32, p32, mass, card):
    """init_state + N_BLOCKS blocks of the NPT main path."""
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    dev = x.device
    n = x.shape[0]
    ev = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT, short_delta=SHORT_DELTA)
    mcfg = md_config(cfg32)
    sim = Simulator(lambda xx, bb, nb, sh: ev.energy_forces_short(xx, bb, sh),
                    torch.full((n,), mass, dtype=torch.float32, device=dev),
                    mcfg,
                    short_build=lambda xx, bb, nb: ev.compact_short(
                        xx, bb, nb.idx))
    pe_off = n * cfg32.e_shift
    kernels.reset_launch_counts()
    t0 = time.time()
    st = sim.init_state(x, box, seed=SEED, t_init=300.0)
    torch.cuda.synchronize()
    log(f"[main] init_state {time.time() - t0:.2f} s")
    rebuilds, rows, block_s = 0, [], []
    for blk in range(N_BLOCKS):
        t0 = time.time()
        st, th = sim.run(st, 1)
        torch.cuda.synchronize()
        block_s.append(time.time() - t0)
        rebuilds += sim.rebuild_count
        if blk == 0:
            st = sim.rebuild(st)       # drive the rebuild path once
            rebuilds += 1
        row = [float(v[-1]) for v in th]
        rows.append(row)
        b = st.box.tolist()
        srow = int((st.short.sidx < n).sum(1).max())
        log(f"[main] step {int(row[0]):4d} T {row[1]:8.3f} K  PE "
            f"{row[2] + pe_off:.6f} eV  P {row[4]:9.2f} bar  box "
            f"{b[0]:.4f} {b[1]:.5f} {b[2]:.4f}  conserved "
            f"{row[6]:.6e}  short row max {srow}/{K_SHORT}  "
            f"{block_s[-1] * 1e3:.1f} ms")
    launches = {"g_harm": kernels.g_harm.launches,
                "force_harm": kernels.force_harm.launches}
    steps = N_BLOCKS * THERMO_EVERY
    check(all(np.isfinite(r).all() for r in rows), "non-finite thermo")
    check(not bool(st.overflow), "neighbor overflow in the main path")
    check(not bool(st.unsafe), "unsafe (dangerous-build) latch set")
    check(rebuilds >= 1, "no skin-list rebuild ran")
    for name, cnt in launches.items():
        check(cnt == steps + 1, f"{name} launched {cnt} times, expected "
              f"{steps + 1} (init + one per step)")
    window = sum(block_s[-RATE_BLOCKS:])
    aps = n * RATE_BLOCKS * THERMO_EVERY / window
    log(f"[main] {steps} NPT steps, {rebuilds} rebuilds, launches "
        f"{launches}, overflow {bool(st.overflow)} unsafe {bool(st.unsafe)}")
    log(f"[main] {aps:.1f} atom-steps/s over the last {RATE_BLOCKS} blocks "
        f"({window:.3f} s) on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


# ------------------------------------------------------------------ ni
def ni_model(dev):
    """(cfg32, p32, cfg64, p64, mass) of the synthetic ni potential."""
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.testing import synthetic_ni_potential
    pot = synthetic_ni_potential(0)
    cfg32, p32 = make_annp(pot, torch.float32, dev)
    cfg64, p64 = make_annp(pot, torch.float64, dev)
    return cfg32, p32, cfg64, p64, float(pot.masses[0])


def ni_md_config(rc, box):
    from meng_zhang_tpu_torch.md.simulation import MDConfig
    from meng_zhang_tpu_torch.system.neighbors import cell_grid_dims
    return MDConfig(dt=0.001, cutoff=rc, skin=NI_SKIN, capacity=NI_CAPACITY,
                    nbr_method="cell",
                    cell_dims=cell_grid_dims(np.asarray(box), rc + NI_SKIN),
                    cell_capacity=NI_CELL_CAPACITY, ensemble="nvt",
                    t_target=NI_T, tau_t=0.1, thermo_every=NI_THERMO_EVERY,
                    stale_factor=0.5, short_every=NI_SHORT_EVERY,
                    short_skin=NI_DELTA)


def ni_thermal_scene(dev, cfg32, p32):
    """The ni scene with Gaussian displacements of NI_DISP A per component,
    its skin list and its short list (f32)."""
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    from meng_zhang_tpu_torch.testing import thermal_fcc
    xn, bn = thermal_fcc(NI_CELLS, seed=SEED, disp=NI_DISP, a=NI_A)
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    ev = fn.FusedNi(cfg32, p32, k_short=NI_KS, short_delta=NI_DELTA)
    mcfg = ni_md_config(ev.rc, bn)
    t0 = time.time()
    nbrs = build_neighbors_cell(x, box, ev.rc + NI_SKIN, NI_CAPACITY,
                                mcfg.cell_dims, NI_CELL_CAPACITY)
    sl = ev.compact_short(x, box, nbrs.idx)
    torch.cuda.synchronize()
    n = x.shape[0]
    log(f"[ni] thermal scene N {n} box {bn[0]:.2f} A: skin list dims "
        f"{mcfg.cell_dims} overflow {bool(nbrs.overflow)} max row "
        f"{int((nbrs.idx < n).sum(1).max())}/{NI_CAPACITY}; short list "
        f"overflow {bool(sl.overflow)} max row "
        f"{int((sl.sidx < n).sum(1).max())}/{NI_KS} ({time.time() - t0:.2f} s)")
    check(not bool(nbrs.overflow) and not bool(sl.overflow),
          "ni: neighbor list overflow on the thermal scene")
    return x, box, sl


def phase_ni_kernels(x, box, cfg32, p32, sl):
    """ni_g / ni_force against their plain versions on the thermal scene's
    [P, 32] planes (filler lanes included), with seeded random dedg."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    dev = x.device
    nsf = cfg32.npsf + cfg32.ntsf
    planes32 = fa.pair_dx_planes(x, box, sl.sidx, cfg32.pbc)
    p, k = planes32[0].shape
    dedg_np = np.zeros((p, fn.NSF_SUB))
    dedg_np[:, :nsf] = np.random.default_rng(SEED).normal(size=(p, nsf))
    filler = sl.sidx >= x.shape[0]
    table = fn.ni_table(p32["coerad"], p32["coeang"])
    records = []
    for dtype in (torch.float32, torch.float64):
        planes = [t.to(dtype) for t in planes32]
        dedg = torch.tensor(dedg_np, dtype=dtype, device=dev)
        bound = NI_REL_BOUND[dtype]
        tag = "f32" if dtype == torch.float32 else "f64"
        cases = [
            ("ni_g", lambda: (kernels.ni_g(*planes, table),),
             lambda: (fn.ni_g_plain(*planes, table),), ("g",), 126),
            ("ni_force", lambda: kernels.ni_force(*planes, dedg, table),
             lambda: fn.ni_force_plain(*planes, dedg, table),
             ("fjx", "fjy", "fjz"), 170),
        ]
        for name, kern, plain, outs, line in cases:
            got = kern()
            ref = plain()
            torch.cuda.synchronize()
            worst = 0.0
            for oname, a, r in zip(outs, got, ref):
                check(bool(torch.isfinite(a).all()),
                      f"{name} {tag}: non-finite {oname}")
                err, rel = rel_err(a, r)
                worst = max(worst, err)
                log(f"[ni-kernels] {name} {tag} {oname}: max abs err "
                    f"{err:.3e} max rel err {rel:.3e} (bound {bound:.0e})")
                check(rel <= bound, f"{name} {tag} {oname} disagrees with "
                      f"its plain version: rel {rel:.3e} > {bound:.0e}")
                if name == "ni_force":
                    check(bool((a[filler] == 0).all()),
                          f"{name} {tag}: filler lanes not exactly 0")
            if dtype != torch.float32:
                continue
            ms = cuda_ms(kern, 10)
            plain_ms = cuda_ms(plain, 3)
            log(f"[ni-kernels] {name} f32 [{p}, {k}]: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms (median, CUDA events)")
            records.append({
                "name": name, "route": "cuda",
                "source": "meng_zhang_tpu_torch/ops/csrc/ni_bp.cu",
                "replaces": f"meng_zhang_tpu/ops/pallas_ni.py:{line}",
                "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms})
    return records


def phase_ni_evaluator(x, box, cfg32, p32, cfg64, p64, sl):
    """FusedNi through the kernels in f32 against the plain path in f64,
    same short list; then the f64 kernel path against the autograd model
    on a 256-atom periodic thermal box."""
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
    from meng_zhang_tpu_torch.testing import thermal_fcc
    n = x.shape[0]
    dev = x.device
    ev32 = fn.FusedNi(cfg32, p32, k_short=NI_KS, short_delta=NI_DELTA)
    ev64 = fn.FusedNi(cfg64, p64, k_short=NI_KS, short_delta=NI_DELTA,
                      plain=True)
    x64, box64 = x.double(), box.double()
    e32, f32, w32 = ev32.energy_forces_short(x, box, sl)
    e64, f64, w64 = ev64.energy_forces_short(
        x64, box64, fa.ShortList(sl.sidx, x64, sl.overflow))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(f32).all()) and bool(torch.isfinite(e32)),
          "ni evaluator: non-finite f32 output")
    check(tuple(f32.shape) == (n, 3) and tuple(w32.shape) == (3, 3),
          "ni evaluator: wrong output shapes")
    f_rms = float(f64.pow(2).mean().sqrt())
    dd = fa.pair_dx_planes(x64, box64, sl.sidx, cfg64.pbc)
    fj = ev64._eval_fj(*dd)[1]
    w_abs = max(float((da * fb).abs().sum()) for da in dd for fb in fj)
    got = {"dE_per_atom": abs(float(e32) - float(e64)) / n,
           "max_dF": float((f32.double() - f64).abs().max()),
           "max_dW": float((w32.double() - w64).abs().max()),
           "sum_F": float(f32.double().sum(0).abs().max())}
    scale = {"dE_per_atom": abs(float(e64)) / n,
             "max_dF": float(f64.abs().max()),
             "max_dW": w_abs, "sum_F": n * f_rms}
    vol = float(box64.prod())
    log(f"[ni-evaluator] N {n}: E/N f64 {float(e64) / n:.9f} eV; RMS F "
        f"{f_rms:.4e} eV/A; max|F| {scale['max_dF']:.4e} eV/A; virial "
        f"pressure {float(torch.trace(w64)) / 3 / vol * 1.6021765e6:.1f} bar")
    for key, val in got.items():
        bound = NI_EVAL_REL[key] * scale[key]
        log(f"[ni-evaluator] {key} {val:.3e} (bound {bound:.3e} = "
            f"{NI_EVAL_REL[key]:.0e} x {scale[key]:.4e})")
        check(val <= bound, f"ni evaluator {key} {val:.3e} over {bound:.3e}")

    xs, bs = thermal_fcc(4, seed=SEED, disp=NI_DISP, a=NI_A)
    xs = torch.tensor(xs, dtype=torch.float64, device=dev)
    bs = torch.tensor(bs, dtype=torch.float64, device=dev)
    ev = fn.FusedNi(cfg64, p64, k_short=NI_KS, short_delta=NI_DELTA)
    nb = build_neighbors_n2(xs, bs, ev.rc + NI_SKIN, NI_CAPACITY)
    check(not bool(nb.overflow), "ni small box: neighbor overflow")
    e_k, f_k, _ = ev.energy_forces(xs, bs, nb.idx)
    e_a, f_a = annp.energy_forces(cfg64, p64, xs, bs, nb.idx)
    de = abs(float(e_k) - float(e_a)) / abs(float(e_a))
    df = float((f_k - f_a).abs().max())
    log(f"[ni-evaluator] 256-atom box, f64 kernels vs autograd model: rel dE"
        f" {de:.3e} (bound {REF_E_RTOL:.0e}), max dF {df:.3e} eV/A (bound "
        f"{REF_F_ATOL:.0e}; max|F| {float(f_a.abs().max()):.3e})")
    check(de <= REF_E_RTOL and df <= REF_F_ATOL,
          "ni kernel path disagrees with the autograd model on the small box")
    return got


def phase_ni_main_path(dev, cfg32, p32, mass, card):
    """init_state + NI_BLOCKS blocks of the NVT main path of
    scripts/model_bench.py --model ni, the light force variant wired as
    there."""
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.testing import thermal_fcc
    xn, bn = thermal_fcc(NI_CELLS, disp=0.0, a=NI_A)     # the perfect lattice
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    n = x.shape[0]
    ev = fn.FusedNi(cfg32, p32, k_short=NI_KS, short_delta=NI_DELTA)
    w0 = torch.zeros((3, 3), dtype=torch.float32, device=dev)

    def force_fn(xx, bb, nb, sh):
        return ev.energy_forces_short(xx, bb, sh)

    def force_fn_light(xx, bb, nb, sh):
        return ev.energy_forces_short(xx, bb, sh, want_virial=False) + (w0,)

    sim = Simulator(force_fn,
                    torch.full((n,), mass, dtype=torch.float32, device=dev),
                    ni_md_config(ev.rc, bn),
                    short_build=lambda xx, bb, nb: ev.compact_short(
                        xx, bb, nb.idx),
                    force_fn_light=force_fn_light)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    st = sim.init_state(x, box, seed=SEED, t_init=NI_T_INIT)
    torch.cuda.synchronize()
    log(f"[ni-main] N {n}, rc {ev.rc:.4f} A, init_state "
        f"{time.time() - t0:.2f} s")
    rebuilds, rows, block_s, srow_max = 0, [], [], 0
    for blk in range(NI_BLOCKS):
        t0 = time.time()
        st, th = sim.run(st, 1)
        torch.cuda.synchronize()
        block_s.append(time.time() - t0)
        rebuilds += sim.rebuild_count
        if blk == 0:
            st = sim.rebuild(st)       # drive the rebuild path once
            rebuilds += 1
        row = [float(v[-1]) for v in th]
        rows.append(row)
        srow = int((st.short.sidx < n).sum(1).max())
        srow_max = max(srow_max, srow)
        log(f"[ni-main] step {int(row[0]):4d} T {row[1]:8.3f} K  PE "
            f"{row[2]:.6f} eV  P {row[4]:10.2f} bar  conserved "
            f"{row[6]:.6e}  short row max {srow}/{NI_KS}  "
            f"{block_s[-1] * 1e3:.1f} ms")
    launches = {"ni_g": kernels.ni_g.launches,
                "ni_force": kernels.ni_force.launches}
    steps = NI_BLOCKS * NI_THERMO_EVERY
    check(all(np.isfinite(r).all() for r in rows), "ni: non-finite thermo")
    check(not bool(st.overflow), "ni: neighbor overflow in the main path")
    check(not bool(st.unsafe), "ni: unsafe (dangerous-build) latch set")
    check(rebuilds >= 1, "ni: no skin-list rebuild ran")
    for name, cnt in launches.items():
        check(cnt == steps + 1, f"{name} launched {cnt} times, expected "
              f"{steps + 1} (init + one per step, light steps included)")
    window = sum(block_s[-RATE_BLOCKS:])
    aps = n * RATE_BLOCKS * NI_THERMO_EVERY / window
    log(f"[ni-main] {steps} NVT steps, {rebuilds} rebuilds, widest short row "
        f"{srow_max}/{NI_KS}, launches {launches}, overflow "
        f"{bool(st.overflow)} unsafe {bool(st.unsafe)}")
    log(f"[ni-main] {aps:.1f} atom-steps/s over the last {RATE_BLOCKS} "
        f"blocks ({window:.3f} s) on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main():
    try:
        name, card = phase_device()
        phase_build()
        dev = torch.device("cuda", 0)
        x, box = scene(dev)
        cfg32, p32, cfg64, p64, mass = model(dev)
        records, sl = phase_kernels(x, box, cfg32, p32)
        phase_evaluator(x, box, cfg32, p32, cfg64, p64, sl)
        launches = phase_main_path(x, box, cfg32, p32, mass, card)
        del x, box, sl
        cfg32, p32, cfg64, p64, mass = ni_model(dev)
        x, box, sl = ni_thermal_scene(dev, cfg32, p32)
        records += phase_ni_kernels(x, box, cfg32, p32, sl)
        phase_ni_evaluator(x, box, cfg32, p32, cfg64, p64, sl)
        del x, box, sl
        launches.update(phase_ni_main_path(dev, cfg32, p32, mass, card))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    except ImportError as e:
        print(f"FAIL: run chip_smoke.py from the repository root ({e})",
              file=sys.stderr, flush=True)
        return 1
    for r in records:
        r["launches"] = launches[r["name"]]
    log(f"[smoke] wall {time.time() - T_START:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
