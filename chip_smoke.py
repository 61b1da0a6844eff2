#!/usr/bin/env python3
"""Bring-up smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives `meng_zhang_tpu_torch` -- never JAX -- through its three main paths:

  * fe Chebyshev ANNP on the reference benchmark scene: the 152,880-atom
    bcc-Fe slab (box 184 x 85.659 x 112.5 A, `boundary m p m`, positions
    from artifacts/bench_minimized.npz), NPT at 300 K with a y-coupled
    barostat, on a synthetic potential of the shipped fe width (npsf 9,
    ntsf 19, nnod 10, rc 6.5 A; meng_zhang_tpu_torch/testing.py), once
    through the harmonic kernels and once through the cos-matrix kernels
    (`FusedAnnp(angular="matrix")`);
  * fcc-Ni Behler-Parrinello ANNP on the scene of
    `scripts/model_bench.py --model ni`: 256,000 atoms (fcc 40^3 cells,
    a = 3.52 A, fully periodic), NVT at 1200 K from 600 K velocities, on a
    synthetic potential of the shipped ni width (npsf 3 + ntsf 24, nnod 24,
    Rc 7.3699319 Bohr = 3.90 A).

Phases, each fatal on failure:

  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every ops/csrc/*.cu with nvcc for sm_90a, in parallel;
  3. fe kernels vs their plain PyTorch versions, in f32 and f64, plus
     times: the harmonic and cos-matrix kernels on [P, 128] short planes
     gathered from the scene (filler lanes included), g_harm, force_harm
     and g_cos also on the [P, 192] skin planes, and the harmonic pair
     also at ntsf 5;
  4. harmonic fe evaluator: energy_forces_short through the kernels in f32
     against the plain path in f64 on the full scene, and the f64 kernel
     path against the autograd model (models/annp.py) on a 250-atom box;
  5. harmonic fe main path: init_state + 20 blocks of 10 NPT steps through
     Simulator, one forced skin-list rebuild after the first block; checks
     finite thermo, no overflow / unsafe, and the kernels' launch counts;
  6. cos-matrix evaluator in f32 through the kernels against its plain
     path in f64 on the full scene (the gates of phase 4);
  7. matrix vs harmonic: both paths through the kernels in f64 on the full
     scene, and energy_dedg's eat against the autograd model's per-atom
     energies on a 432-atom box at the skin-list width;
  8. cos-matrix fe main path: as phase 5, 10 blocks, and no launch of the
     harmonic kernels;
  9. ni kernels vs plain on [P, 32] planes of a thermal 256,000-atom box;
  10. ni evaluator: FusedNi in f32 through the kernels against the f64
      plain path on that box, and the f64 kernel path against the autograd
      model on a 256-atom box;
  11. ni main path: init_state + 20 blocks of 5 NVT steps with the light
      (no-virial) force variant on all but each block's last step;
  12. profile: a fresh harmonic main-path run (init_state and 5 blocks),
      then one block without a skin-list rebuild under torch.profiler:
      device time by kernel (top ten, ms per step) and the device's idle
      share. It runs last, so that the profiler's tracing cannot touch any
      other phase's timing.

Each kernel's record carries its least time on the card (`bound_ms`, the
larger of the FLOPs its function needs over the f32 peak and its bytes
over the memory rate, counted from this run's inputs) and `library_ms` null: no single PyTorch
call computes any of these functions. Prints the kernels' JSON record on
the line before the last, and as the last line
{"ok": true, "device": {...}}. Run from the repository root:
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
COS_BLOCKS, COS_RATE_BLOCKS = 10, 7
SEED = 4928459
# ni scene (scripts/model_bench.py --model ni)
NI_CELLS, NI_A = 40, 3.52
NI_SKIN, NI_CAPACITY, NI_CELL_CAPACITY = 0.5, 64, 24
NI_KS, NI_DELTA, NI_SHORT_EVERY, NI_THERMO_EVERY = 32, 0.2, 5, 5
NI_T, NI_T_INIT, NI_BLOCKS = 1200.0, 600.0, 20
NI_DISP = 0.08      # A per component, the thermal box of phases 9 and 10

# Kernel vs plain, per output, as a fraction of the output's max |value|.
# f32: the longest per-lane sums run over ~400 terms, whose worst-case
# linear rounding growth is 400 * 6e-8 = 2.4e-5; 1e-4 leaves 4x over that.
# f64: the same count at 1.1e-16 gives 4.4e-14; 1e-12 leaves 20x.
REL_BOUND = {torch.float32: 1e-4, torch.float64: 1e-12}
# The cos-matrix kernels, from their own chains (u = 6e-8 in f32):
#   g_cos: an angular column sums w T_n(x) over the row's unordered pairs
#     inside the cutoff (~6,200 of at most 127 * 128 / 2 at Ks 128), and
#     |T_n| <= 1, so every column is bounded by column G_0 = sum w, the
#     row's largest value. Each thread sums <= n/2 <= 64 pair terms, then
#     5 shuffle levels and <= 8 warp partials: <= 77 roundings, 4.6e-6 of
#     G_0; the T_n recurrence adds <= ntsf^2 / 2 = 180 roundings per term
#     (a rounding at step m grows by |U_(n-m)| <= n - m + 1), 1.1e-5. The
#     plain version carries as much: <= 3.1e-5 apart, and 1e-4 leaves 3x.
#     A single serial chain over the ~12,400 ordered terms would reach 7e-4.
#   force_cos: thread j sums its <= 127 partners in one chain, and P, P'
#     carry the recurrences' <= 180 roundings: <= 310, 1.9e-5 of the
#     largest column sum, 3.7e-5 between the two versions; the radial, A
#     and B parts of Fj cancel, so allow the largest Fj to sit 8x under
#     that sum: 3e-4.
#   f64: the same counts at 1.1e-16 give <= 7e-14; 1e-12 leaves 14x.
COS_REL_BOUND = {torch.float32: {"g_cos": 1e-4, "force_cos": 3e-4},
                 torch.float64: {"g_cos": 1e-12, "force_cos": 1e-12}}
# The two angular formulations in f64 on the full scene: the harmonic path
# forms G_n = 1/2 (sum_l c_nl S_l - F2) from power sums S_l ~ (sum fc)^2
# and subtracts, so it loses ~1e-13 of |G| that the matrix path does not.
MATRIX_E_RTOL = 1e-11      # total energy, shift-free
MATRIX_F_ATOL = 1e-9       # eV/A
MATRIX_W_RTOL = 1e-9       # of max |W|
# Least-time model: NVIDIA H100 SXM peak rates at 700 W
PEAK_F32_FLOPS = 67e12     # f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # HBM3
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


def bound(flops, nbytes):
    """(least ms, what bounds it): FLOPs over the f32 peak or bytes (each
    input read once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fe_counts(planes, rc):
    """(lanes, unordered pairs) inside the cutoff on [P, K] planes: the
    fe kernels' work on this run's data."""
    dxx, dxy, dxz = planes
    rsq = dxx * dxx + dxy * dxy + dxz * dxz
    n = ((rsq < rc * rc) & (rsq > 1.0e-12)).sum(1).double()
    return float(n.sum()), float((n * (n - 1) / 2).sum())


# FLOPs per lane / per unordered pair inside the cutoff that each function
# needs, counted from the kernels' sources (a fused multiply-add is 2, a
# sqrt, cos or sin 1): the pair geometry costs GEO a lane; a radial
# Chebyshev term 4 (g) or 8 (force, T and T'); a harmonic (l, m) step 9
# (g_harm: H, w, the two A sums) or 22 (force_harm: H, dH, the B
# contractions); a cos-matrix pair 7 + 4 ntsf (g_cos: cos, x, w, then T_n
# and its sum) or 7 + 10 ntsf (force_cos: T_n, T'_n, P, P'), as x_kj =
# x_jk, plus its five column sums on each side, 12 a side. force_cos runs
# the recurrences once per ordered pair: twice what it needs.
GEO = 20


def fe_flops(name, lanes, pairs, npsf, ntsf):
    n_lm = ntsf * (ntsf + 1) // 2
    per_lane = {"g_harm": GEO + 4 * npsf + 9 * n_lm,
                "force_harm": GEO + 8 * npsf + 22 * n_lm + 30,
                "g_cos": GEO + 4 * npsf,
                "force_cos": GEO + 8 * npsf + 20}[name]
    per_pair = {"g_harm": 0, "force_harm": 0, "g_cos": 7 + 4 * ntsf,
                "force_cos": 7 + 10 * ntsf + 2 * 12}[name]
    return lanes * per_lane + pairs * per_pair


def fe_bytes(name, p, k, itemsize):
    """Planes in, then per kernel its other inputs and its outputs."""
    rows = {"g_harm": 128 + 384, "force_harm": 128 + 384 + 3 * k,
            "g_cos": 128, "force_cos": 128 + 3 * k}[name]
    return p * (3 * k + rows) * itemsize


def record(name, source, line, worst, ms, plain_ms, flops, nbytes):
    b_ms, b_by = bound(flops, nbytes)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": line, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def compare(tag, name, outs, got, ref, bound_rel, filler=None):
    """Kernel outputs against the plain version's, each within bound_rel
    of its max |value|; filler lanes of per-pair outputs exactly 0.
    Returns the worst max abs error."""
    worst = 0.0
    for oname, a, r in zip(outs, got, ref):
        check(bool(torch.isfinite(a).all()), f"{name} {tag}: non-finite "
              f"{oname}")
        err, rel = rel_err(a, r)
        worst = max(worst, err)
        log(f"[{tag}] {name} {oname}: max abs err {err:.3e} max rel err "
            f"{rel:.3e} (bound {bound_rel:.0e})")
        check(rel <= bound_rel, f"{name} {tag} {oname} disagrees with its "
              f"plain version: rel {rel:.3e} > {bound_rel:.0e}")
        if filler is not None and oname.startswith("fj"):
            check(bool((a[filler] == 0).all()),
                  f"{name} {tag}: filler lanes not exactly 0")
    return worst


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


# fe kernels: source in meng_zhang_tpu_torch/ops/csrc/, line of the TPU
# kernel it replaces in meng_zhang_tpu/ops/pallas_annp.py
FE_KERNELS = {"g_harm": ("annp_harm.cu", 299),
              "force_harm": ("annp_harm.cu", 352),
              "g_cos": ("annp_cos.cu", 116), "force_cos": ("annp_cos.cu", 193)}


def phase_kernels(x, box, cfg32, p32):
    """The four fe kernels against their plain versions in f32 and f64 on
    the scene's [P, 128] short planes (filler lanes included), and g_cos
    also on its [P, 192] skin planes, the shape energy_dedg gives it.
    Returns the JSON records (without launch counts), timed at the main
    path's [P, 128], and the short list. g_harm and force_harm are also
    held and timed on the skin planes and, on the short planes, at the
    tests' reduced ntsf 5 (another compile-time instance of force_harm's
    ladder), outside the records."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    dev = x.device
    n = x.shape[0]
    mcfg = md_config(cfg32)
    t0 = time.time()
    nbrs = build_neighbors_cell(x, box, cfg32.cut + SKIN, CAPACITY,
                                mcfg.cell_dims, CELL_CAPACITY, pbc=PBC)
    ev = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT, short_delta=SHORT_DELTA)
    sl = ev.compact_short(x, box, nbrs.idx)
    torch.cuda.synchronize()
    n_real = int((sl.sidx < n).sum(1).max())
    log(f"[kernels] skin list dims {mcfg.cell_dims} overflow "
        f"{bool(nbrs.overflow)} max row {int((nbrs.idx < n).sum(1).max())}"
        f"; short list overflow {bool(sl.overflow)} max row {n_real}/"
        f"{K_SHORT} ({time.time() - t0:.2f} s)")
    check(not bool(nbrs.overflow) and not bool(sl.overflow),
          "neighbor list overflow on the benchmark scene")
    npsf, ntsf, rc = cfg32.npsf, cfg32.ntsf, cfg32.cut
    short32 = fa.pair_dx_planes(x, box, sl.sidx, PBC)
    skin32 = fa.pair_dx_planes(x, box, nbrs.idx, PBC)
    fill_short, fill_skin = sl.sidx >= n, nbrs.idx >= n
    del nbrs
    p, k = short32[0].shape
    lanes, pairs = fe_counts(short32, rc)
    log(f"[kernels] {lanes:.0f} lanes and {pairs:.0f} unordered pairs "
        f"inside {rc} A ({lanes / p:.2f} lanes a row)")
    rng = np.random.default_rng(SEED)
    dedg_np = np.zeros((p, fa.NSF_PAD))
    dedg_np[:, :npsf + ntsf] = rng.normal(size=(p, npsf + ntsf))
    b_np = np.zeros((p, fa.AB_PAD))
    b_np[:, :ntsf * ntsf + 1] = rng.normal(size=(p, ntsf * ntsf + 1))
    records = {}
    for dtype in (torch.float32, torch.float64):
        short = [t.to(dtype) for t in short32]
        skin = [t.to(dtype) for t in skin32]
        dedg = torch.tensor(dedg_np, dtype=dtype, device=dev)
        b = torch.tensor(b_np, dtype=dtype, device=dev)
        bounds = {"g_harm": REL_BOUND[dtype], "force_harm": REL_BOUND[dtype],
                  **COS_REL_BOUND[dtype]}
        tag = "kernels " + ("f32" if dtype == torch.float32 else "f64")
        def g_harm(nt):
            return (lambda pl: kernels.g_harm(*pl, npsf, nt, rc),
                    lambda pl: fa.g_harm_plain(*pl, npsf, nt, rc),
                    ("g_raw", "A"))

        def force_harm(nt):
            return (lambda pl: kernels.force_harm(*pl, dedg, b, npsf, nt, rc),
                    lambda pl: fa.force_harm_plain(*pl, dedg, b, npsf, nt,
                                                   rc),
                    ("fjx", "fjy", "fjz"))

        # (name, what else sets the case apart, planes, filler lanes,
        #  kernel, plain version, outputs, repetitions to time the plain
        #  version; None: kernel time only, outside the record)
        skin_w, reduced = "skin-list width", "ntsf 5"
        cases = [
            ("g_harm", "", short, fill_short, *g_harm(ntsf), 3),
            ("force_harm", "", short, fill_short, *force_harm(ntsf), 3),
            ("g_harm", skin_w, skin, fill_skin, *g_harm(ntsf), None),
            ("force_harm", skin_w, skin, fill_skin, *force_harm(ntsf), None),
            ("g_harm", reduced, short, fill_short, *g_harm(5), None),
            ("force_harm", reduced, short, fill_short, *force_harm(5), None),
            ("g_cos", "", short, fill_short,
             lambda pl: (kernels.g_cos(*pl, npsf, ntsf, rc),),
             lambda pl: (fa.g_cos_plain(*pl, npsf, ntsf, rc),), ("g",), 1),
            ("g_cos", skin_w, skin, fill_skin,
             lambda pl: (kernels.g_cos(*pl, npsf, ntsf, rc),),
             lambda pl: (fa.g_cos_plain(*pl, npsf, ntsf, rc),), ("g",),
             None),
            ("force_cos", "", short, fill_short,
             lambda pl: kernels.force_cos(*pl, dedg, npsf, ntsf, rc),
             lambda pl: fa.force_cos_plain(*pl, dedg, npsf, ntsf, rc),
             ("fjx", "fjy", "fjz"), 1),
        ]
        for name, note, pl, filler, kern, plain, outs, reps in cases:
            shape = f"[{p}, {pl[0].shape[1]}]" + (f" {note}" if note else "")
            got = kern(pl)
            ref = plain(pl)
            torch.cuda.synchronize()
            worst = compare(tag, f"{name} {shape}", outs, got, ref,
                            bounds[name], filler)
            del got, ref
            if dtype != torch.float32:
                continue
            ms = cuda_ms(lambda: kern(pl), 10)
            if reps is None:
                log(f"[kernels] {name} f32 {shape}: kernel {ms:.3f} ms "
                    f"(median, CUDA events; not in the record)")
                continue
            plain_ms = cuda_ms(lambda: plain(pl), reps)
            src, line = FE_KERNELS[name]
            rec = records[name] = record(
                name, f"meng_zhang_tpu_torch/ops/csrc/{src}",
                f"meng_zhang_tpu/ops/pallas_annp.py:{line}", worst, ms,
                plain_ms, fe_flops(name, lanes, pairs, npsf, ntsf),
                fe_bytes(name, p, k, 4))
            log(f"[kernels] {name} f32 {shape}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms (median, CUDA events), bound "
                f"{rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    return list(records.values()), sl


def phase_evaluator(x, box, cfg32, p32, cfg64, p64, sl, angular="harmonic"):
    """Kernel path in f32 against the plain path in f64, same short list;
    on the harmonic path then the f64 kernel path against the autograd
    model on a small box."""
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
    from meng_zhang_tpu_torch.testing import thermal_bcc
    tag = "evaluator" if angular == "harmonic" else "cos-evaluator"
    n = x.shape[0]
    dev = x.device
    ev32 = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT, short_delta=SHORT_DELTA,
                        angular=angular)
    ev64 = fa.FusedAnnp(cfg64, p64, k_short=K_SHORT, short_delta=SHORT_DELTA,
                        plain=True, angular=angular)
    x64, box64 = x.double(), box.double()
    e32, f32, w32 = ev32.energy_forces_short(x, box, sl)
    e64, f64, w64 = ev64.energy_forces_short(
        x64, box64, fa.ShortList(sl.sidx, x64, sl.overflow))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(f32).all()) and bool(torch.isfinite(e32)),
          f"{tag}: non-finite f32 output")
    check(tuple(f32.shape) == (n, 3) and tuple(w32.shape) == (3, 3),
          f"{tag}: wrong output shapes")
    f_rms = float(f64.pow(2).mean().sqrt())
    # the virial's scale from the f32 kernel path's Fj (a scale only);
    # filler lanes carry Fj = 0 exactly, so they add nothing here
    dd = fa.pair_dx_planes(x, box, sl.sidx, PBC)
    fj = ev32._eval_fj(*dd)[1]
    w_abs = max(float((da.double() * fb.double()).abs().sum())
                for da in dd for fb in fj)
    del dd, fj
    got = {"dE_per_atom": abs(float(e32) - float(e64)) / n,
           "max_dF": float((f32.double() - f64).abs().max()),
           "max_dW": float((w32.double() - w64).abs().max()),
           "sum_F": float(f32.double().sum(0).abs().max())}
    scale = {"dE_per_atom": abs(float(e64)) / n,
             "max_dF": float(f64.abs().max()),
             "max_dW": w_abs, "sum_F": n * f_rms}
    vol = BOX[0] * BOX[1] * BOX[2]
    log(f"[{tag}] N {n}: E/N f64 {float(e64) / n + cfg64.e_shift:.9f} eV"
        f" (shift-free {float(e64) / n:.6e}); RMS F {f_rms:.4e} eV/A; max|F|"
        f" {scale['max_dF']:.4e} eV/A; virial pressure "
        f"{float(torch.trace(w64)) / 3 / vol * 1.6021765e6:.1f} bar")
    for key, val in got.items():
        bound_abs = EVAL_REL[key] * scale[key]
        log(f"[{tag}] {key} {val:.3e} (bound {bound_abs:.3e} = "
            f"{EVAL_REL[key]:.0e} x {scale[key]:.4e})")
        check(val <= bound_abs, f"{tag} {key} {val:.3e} over "
              f"{bound_abs:.3e}")
    if angular != "harmonic":
        return got

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


def phase_matrix_vs_harmonic(x, box, cfg64, p64, sl):
    """The two angular paths through their kernels in f64 on the full
    scene; then energy_dedg (g_cos at the skin-list width) against the
    autograd model's per-atom energies on a 432-atom periodic box (6^3
    bcc cells: the smallest cube that holds rc + skin twice)."""
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
    from meng_zhang_tpu_torch.testing import thermal_bcc
    dev = x.device
    x64, box64 = x.double(), box.double()
    sl64 = fa.ShortList(sl.sidx, x64, sl.overflow)
    out = {}
    for angular in ("matrix", "harmonic"):
        ev = fa.FusedAnnp(cfg64, p64, k_short=K_SHORT,
                          short_delta=SHORT_DELTA, angular=angular)
        out[angular] = ev.energy_forces_short(x64, box64, sl64)
    (e_m, f_m, w_m), (e_h, f_h, w_h) = out["matrix"], out["harmonic"]
    de = abs(float(e_m) - float(e_h)) / abs(float(e_h))
    df = float((f_m - f_h).abs().max())
    dw = float((w_m - w_h).abs().max())
    w_max = float(w_h.abs().max())
    log(f"[matrix-vs-harmonic] N {x.shape[0]}, f64 kernels: rel dE {de:.3e}"
        f" (bound {MATRIX_E_RTOL:.0e}), max dF {df:.3e} eV/A (bound "
        f"{MATRIX_F_ATOL:.0e}), max dW {dw:.3e} eV (bound {MATRIX_W_RTOL:.0e}"
        f" x max|W| {w_max:.4e})")
    check(de <= MATRIX_E_RTOL and df <= MATRIX_F_ATOL
          and dw <= MATRIX_W_RTOL * w_max,
          "the matrix and harmonic paths disagree on the full scene")
    del out, e_m, f_m, w_m, e_h, f_h, w_h

    xs, bs = thermal_bcc(6, seed=SEED, disp=0.08)
    xs = torch.tensor(xs, dtype=torch.float64, device=dev)
    bs = torch.tensor(bs, dtype=torch.float64, device=dev)
    cfg_p, p_p = annp.make_annp(_potential(), torch.float64, dev)
    nb = build_neighbors_n2(xs, bs, cfg_p.cut + SKIN, CAPACITY)
    check(not bool(nb.overflow), "energy_dedg box: neighbor overflow")
    eat, dedg = fa.FusedAnnp(cfg_p, p_p).energy_dedg(xs, bs, nb.idx)
    want = annp.atom_energies(cfg_p, p_p, xs, bs, nb.idx) - cfg_p.e_shift
    err = float((eat - want).abs().max())
    scale = float(want.abs().max())
    log(f"[matrix-vs-harmonic] energy_dedg on {xs.shape[0]} atoms at K "
        f"{nb.idx.shape[1]}, f64 g_cos vs autograd atom_energies: max "
        f"|d eat| {err:.3e} eV (bound {REF_E_RTOL:.0e} x {scale:.4e})")
    check(err <= REF_E_RTOL * scale,
          "energy_dedg disagrees with the autograd per-atom energies")
    check(tuple(dedg.shape) == (xs.shape[0], 128)
          and bool(torch.isfinite(dedg).all())
          and bool((dedg[:, cfg_p.nsf:] == 0).all()),
          "energy_dedg: dedg of the wrong shape, non-finite or not padded")
    return de, df


def fe_simulator(x, cfg32, p32, mass, angular):
    """The fe NPT main path's Simulator through one angular path."""
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    ev = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT, short_delta=SHORT_DELTA,
                      angular=angular)
    return Simulator(
        lambda xx, bb, nb, sh: ev.energy_forces_short(xx, bb, sh),
        torch.full((x.shape[0],), mass, dtype=torch.float32, device=x.device),
        md_config(cfg32),
        short_build=lambda xx, bb, nb: ev.compact_short(xx, bb, nb.idx))


def phase_main_path(x, box, cfg32, p32, mass, card, angular="harmonic"):
    """init_state + blocks of the NPT main path through one angular path's
    kernels; the other path's kernels must not launch."""
    from meng_zhang_tpu_torch.ops import kernels
    if angular == "harmonic":
        tag, n_blocks, rate_blocks = "main", N_BLOCKS, RATE_BLOCKS
        names, others = ("g_harm", "force_harm"), ("g_cos", "force_cos")
    else:
        tag, n_blocks, rate_blocks = "cos-main", COS_BLOCKS, COS_RATE_BLOCKS
        names, others = ("g_cos", "force_cos"), ("g_harm", "force_harm")
    n = x.shape[0]
    sim = fe_simulator(x, cfg32, p32, mass, angular)
    pe_off = n * cfg32.e_shift
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    st = sim.init_state(x, box, seed=SEED, t_init=300.0)
    torch.cuda.synchronize()
    log(f"[{tag}] init_state {time.time() - t0:.2f} s")
    rebuilds, rows, block_s = 0, [], []
    for blk in range(n_blocks):
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
        log(f"[{tag}] step {int(row[0]):4d} T {row[1]:8.3f} K  PE "
            f"{row[2] + pe_off:.6f} eV  P {row[4]:9.2f} bar  box "
            f"{b[0]:.4f} {b[1]:.5f} {b[2]:.4f}  conserved "
            f"{row[6]:.6e}  short row max {srow}/{K_SHORT}  "
            f"{block_s[-1] * 1e3:.1f} ms")
    launches = {name: getattr(kernels, name).launches
                for name in names + others}
    steps = n_blocks * THERMO_EVERY
    check(all(np.isfinite(r).all() for r in rows), f"{tag}: non-finite thermo")
    check(not bool(st.overflow), f"{tag}: neighbor overflow")
    check(not bool(st.unsafe), f"{tag}: unsafe (dangerous-build) latch set")
    check(rebuilds >= 1, f"{tag}: no skin-list rebuild ran")
    for name in names:
        check(launches[name] == steps + 1, f"{name} launched "
              f"{launches[name]} times, expected {steps + 1} (init + one "
              "per step)")
    for name in others:
        check(launches[name] == 0, f"{name} launched {launches[name]} times "
              f"on the {angular} path")
    window = sum(block_s[-rate_blocks:])
    aps = n * rate_blocks * THERMO_EVERY / window
    log(f"[{tag}] {steps} NPT steps, {rebuilds} rebuilds, launches "
        f"{launches}, overflow {bool(st.overflow)} unsafe {bool(st.unsafe)}")
    log(f"[{tag}] {aps:.1f} atom-steps/s over the last {rate_blocks} blocks "
        f"({window:.3f} s) on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {name: launches[name] for name in names}


def phase_profile(x, box, cfg32, p32, mass, card):
    """A fresh harmonic main-path run: init_state and the blocks before
    phase 5's rate window, then one block under torch.profiler that ends
    without a skin-list rebuild (the rate window's usual block; up to
    three tries): the ten kernels with the most device time, in ms per
    step, and the device's idle share of the block's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_ms(e):
        return getattr(e, "self_device_time_total", 0.0) / 1e3

    sim = fe_simulator(x, cfg32, p32, mass, "harmonic")
    st = sim.init_state(x, box, seed=SEED, t_init=300.0)
    for _ in range(N_BLOCKS - RATE_BLOCKS):
        st, _ = sim.run(st, 1)
    check(not bool(st.overflow) and not bool(st.unsafe),
          "profile: overflow or unsafe before the profiled block")
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            st, _ = sim.run(st, 1)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
        if sim.rebuild_count == 0:
            break
        log(f"[profile] block rebuilt its skin list ({wall:.3f} ms); again")
    check(sim.rebuild_count == 0, "profile: every profiled block rebuilt")
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in ops)
    check(busy > 0, "profile: torch.profiler recorded no device time")
    log(f"[profile] one {THERMO_EVERY}-step block of the harmonic main path "
        f"on {card}: "
        f"{busy:.3f} ms of device time in {wall:.3f} ms (device idle "
        f"{100 * (1 - busy / wall):.1f} %, {busy / THERMO_EVERY:.3f} ms of "
        f"device time a step)")
    for e in sorted(ops, key=dev_ms, reverse=True)[:10]:
        log(f"[profile]   {dev_ms(e) / THERMO_EVERY:8.3f} ms/step "
            f"{100 * dev_ms(e) / busy:5.1f} %  x{e.count:<5d} {e.key[:100]}")


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


def ni_counts(planes, rc_a):
    """(lanes inside the angular cutoff rc_a (Bohr), ordered legs (p, q),
    p != q, whose three legs lie inside it) on [P, K] planes: the ni
    kernels' work on this run's data."""
    from meng_zhang_tpu_torch.units import CFLENGTH
    lanes = legs = 0
    eye = torch.eye(planes[0].shape[1], dtype=torch.bool,
                    device=planes[0].device)
    for i0 in range(0, planes[0].shape[0], 16384):
        d = torch.stack([t[i0:i0 + 16384] for t in planes], -1).double()
        r2 = (d * d).sum(-1)
        ina = (r2 > 1.0e-12) & (r2 * CFLENGTH ** 2 < rc_a * rc_a)
        djk = d[:, :, None, :] - d[:, None, :, :]
        ok = (ina[:, :, None] & ina[:, None, :] & ~eye
              & ((djk * djk).sum(-1) * CFLENGTH ** 2 < rc_a * rc_a))
        lanes += int(ina.sum())
        legs += int(ok.sum())
    return float(lanes), float(legs)


def ni_flops(name, lanes, legs, table):
    """FLOPs that each function needs, counted from ni_bp.cu as fe_flops
    does: per lane the geometry (15) and each radial function (cos, exp
    and 8: 10 in ni_g; with sin and dfc 15 in ni_force). A G4 term is
    symmetric in its legs (p, q), so per unordered leg pair: its geometry
    (cs, rjk, sqrt, cos, fc3, r2sum: 20; with sin 24), an exp per eta group
    (2) and per function 1 + lambda cos, the zeta squarings (2 log2 zeta)
    and the sum (5 in ni_g; with the derivative and two sums 8 in
    ni_force); ni_force then forms the shared partials in c and rjk (8)
    and, on each side, the partial in its own leg and its four sums (22).
    The kernels visit each ordered leg."""
    zl = sum(int(zeta).bit_length() - 1 for _, group in table.ang
             for _, zeta, _ in group)
    n_f = sum(len(group) for _, group in table.ang)
    n_r = len(table.rad)
    if name == "ni_g":
        per_lane, per_pair = 15 + 10 * n_r, 20 + 2 * len(table.ang) \
            + 5 * n_f + 2 * zl
    else:
        per_lane, per_pair = 15 + 15 * n_r, 24 + 2 * len(table.ang) \
            + 8 * n_f + 2 * zl + 8 + 2 * 22
    return lanes * per_lane + legs / 2 * per_pair


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
    counts = ni_counts(planes32, table.rc_a)
    log(f"[ni-kernels] {counts[0]:.0f} lanes and {counts[1]:.0f} ordered "
        f"legs inside {table.rc_a} Bohr")
    records = []
    for dtype in (torch.float32, torch.float64):
        planes = [t.to(dtype) for t in planes32]
        dedg = torch.tensor(dedg_np, dtype=dtype, device=dev)
        tag = "ni-kernels " + ("f32" if dtype == torch.float32 else "f64")
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
            worst = compare(tag, name, outs, got, ref, NI_REL_BOUND[dtype],
                            filler)
            if dtype != torch.float32:
                continue
            ms = cuda_ms(kern, 10)
            plain_ms = cuda_ms(plain, 3)
            records.append(record(
                name, "meng_zhang_tpu_torch/ops/csrc/ni_bp.cu",
                f"meng_zhang_tpu/ops/pallas_ni.py:{line}", worst, ms,
                plain_ms, ni_flops(name, *counts, table),
                p * (3 * k + fn.NSF_SUB + (3 * k if name == "ni_force"
                                           else 0)) * 4))
            log(f"[ni-kernels] {name} f32 [{p}, {k}]: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms (median, CUDA events), bound "
                f"{records[-1]['bound_ms']:.3f} ms "
                f"({records[-1]['bound_by']})")
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
        phase_evaluator(x, box, cfg32, p32, cfg64, p64, sl, angular="matrix")
        phase_matrix_vs_harmonic(x, box, cfg64, p64, sl)
        launches.update(phase_main_path(x, box, cfg32, p32, mass, card,
                                        angular="matrix"))
        fe = (x, box, cfg32, p32, mass)
        del x, box, sl, cfg64, p64
        cfg32, p32, cfg64, p64, mass = ni_model(dev)
        x, box, sl = ni_thermal_scene(dev, cfg32, p32)
        records += phase_ni_kernels(x, box, cfg32, p32, sl)
        phase_ni_evaluator(x, box, cfg32, p32, cfg64, p64, sl)
        del x, box, sl
        launches.update(phase_ni_main_path(dev, cfg32, p32, mass, card))
        phase_profile(*fe, card)
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
