#!/usr/bin/env python3
"""Bring-up smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives `meng_zhang_tpu_torch` -- never JAX -- through its three main paths,
then through its user-facing run path (`python -m meng_zhang_tpu_torch`,
called in-process as `run.main(argv)`):

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
     gathered from the scene (filler lanes included), all four also on
     the [P, 192] skin planes (the cos pair's f64 comparison there on
     every fourth row) and, on the short planes, at ntsf 5;
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
  9. ni kernels vs plain on [P, 32] planes of a thermal 256,000-atom box,
     and on its first rows with a table whose zetas are not all powers of
     two and whose eta groups differ in size (ni_force's pow route);
  10. ni evaluator: FusedNi in f32 through the kernels against the f64
      plain path on that box, and the f64 kernel path against the autograd
      model on a 256-atom box;
  11. ni main path: init_state + 20 blocks of 5 NVT steps with the light
      (no-virial) force variant on all but each block's last step;
  12. cli-fe: the benchmark scene as a LAMMPS data file and the synthetic
      fe potential as a .ann file, both written with the port's writers,
      through run.main: `--ensemble npt --temp 300 --couple y --boundary
      "m p m" --skin 1.2 --capacity 192 --steps 40 --thermo 10 --dump ...
      --dump-peratom --checkpoint ... --profile`, then `--restart` for 20
      more steps. Checks finite thermo, no warning, g_harm / force_harm
      launched once per evaluation and no plain version run, the last
      dump's c_pe and c_stress finite with c_pe summing to the thermo row's
      PotEng, and the restart's first row equal to the checkpoint's last;
      prints the CLI's atom-steps/s and the cost of a per-atom dump;
  13. cli-ni: `--lattice fcc --cells 40 40 40 --lattice-a 3.52 --ensemble
      nvt --temp 1200 --steps 20 --thermo 5` with the synthetic ni .ann:
      ni_g / ni_force through compact_neighbor_rows and the chunked
      functions, once per evaluation, no plain version;
  14. minimize: cg_relax on the benchmark scene with e_offset = n e_shift
      (n_iter, n_evals, stopping reason, wall time), then a `--minimize`
      (FIRE) CLI run on the screw-dislocation scene of `tools screw
      --dislocation`, replicated to 10 Burgers vectors in z;
  15. profile: a fresh harmonic main-path run (init_state and 5 blocks),
      then one block without a skin-list rebuild under torch.profiler:
      device time by kernel (top ten, ms per step) and the device's idle
      share; then the same for the cos-matrix main path (3 blocks, then
      one) and the ni main path (4 blocks, then one). It runs last, so that the profiler's tracing cannot touch any other
      phase's timing.

Each kernel's record carries its least time on the card (`bound_ms`, the
larger of the FLOPs its function needs over the f32 peak and its bytes
over the memory rate, counted from this run's inputs) and `library_ms` null: no single PyTorch
call computes any of these functions. Prints the kernels' JSON record on
the line before the last, and as the last line
{"ok": true, "device": {...}}. Run from the repository root:
`python3 chip_smoke.py`.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
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
NI_POW_ROWS = 8192  # rows of that box held on the pow-route table
# run path (`python -m meng_zhang_tpu_torch`, run.main in this process)
CLI_FE_STEPS, CLI_FE_RESTART_STEPS, CLI_THERMO = 40, 20, 10
CLI_NI_STEPS, CLI_NI_THERMO = 20, 5
SCREW_REPLICATE = 10       # the screw scene's z (one Burgers vector, 2.47 A):
                           # 24.7 A, 3 cells of rc + skin for the cell list
FIRE_FTOL = 0.1            # eV/A, the --min-ftol of the [minimize] CLI run

# Kernel vs plain, per output, as a fraction of the output's max |value|.
# f32: the longest per-lane sums run over ~400 terms, whose worst-case
# linear rounding growth is 400 * 6e-8 = 2.4e-5; 1e-4 leaves 4x over that.
# f64: the same count at 1.1e-16 gives 4.4e-14; 1e-12 leaves 20x.
REL_BOUND = {torch.float32: 1e-4, torch.float64: 1e-12}
# The cos-matrix kernels, from their own chains (u = 6e-8 in f32):
#   g_cos: an angular column sums w T_n(x) over the row's unordered pairs
#     inside the cutoff (~6,200 of at most 127 * 128 / 2 at Ks 128), and
#     |T_n| <= 1, so every column is bounded by column G_0 = sum w, the
#     row's largest value. Each thread sums <= n/2 <= 64 pair terms of its
#     own lane and, where a part-full last warp's lanes are dealt to the
#     others, <= 21 more (a chunk is shorter than n/2 over the full warps,
#     three at 97-127 lanes), then 5 shuffle levels and <= 8 warp partials:
#     <= 98 roundings, 5.9e-6 of G_0; the T_n recurrence adds <= ntsf^2 / 2
#     = 180 roundings per term (a rounding at step m grows by |U_(n-m)| <=
#     n - m + 1), 1.1e-5. The plain version carries its own sum and the same
#     recurrence: <= 3.3e-5 apart, and 1e-4 leaves 3x.
#     A single serial chain over the ~12,400 ordered terms would reach 7e-4.
#   force_cos: a slot's sum has two chains, its <= 64 partners at k = j + d
#     in thread j's registers and its <= 64 at k = j - d in shared memory,
#     then one add: <= 65 roundings on the sum's path, and P, P' carry the
#     recurrences' <= 180 (P' = sum n w_n U_(n-1): U's recurrence is T's,
#     and n |U_(n-1)| <= n^2 as |T'_n|): <= 245, 1.5e-5 of that sum. The
#     plain version sums the <= 127 partners as one reduction: <= 310,
#     1.9e-5. So <= 3.4e-5 between the two versions (3.7e-5 when the kernel
#     summed one chain of 127); the radial, A and B parts of Fj cancel, so
#     allow the largest Fj to sit 8x under that sum: 3e-4, as before.
#   f64: the same counts at 1.1e-16 give <= 7e-14; 1e-12 leaves 14x.
COS_REL_BOUND = {torch.float32: {"g_cos": 1e-4, "force_cos": 3e-4},
                 torch.float64: {"g_cos": 1e-12, "force_cos": 1e-12}}
COS_SKIN_F64_STRIDE = 4
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
# ni kernel vs plain, per output, as a fraction of the output's max |value|
# (u = 6e-8 in f32).
#   ni_g: a G4 column sums one term per listed leg pair of the row (60 a
#     row on the scene, at most 496). A lane adds <= 16 of them in its
#     register, then 5 shuffle levels: <= 21 roundings on the sum's path,
#     and a term carries ~10 of its own (cospif, expf, the squaring chain,
#     four products): 1.9e-6 of the column's largest value, all terms being
#     positive. The plain version adds every term twice along a 32-step q
#     loop and then sums 32 lanes: <= 74, 4.4e-6. So <= 6.3e-6 apart.
#   ni_force: a lane's four sums take <= 31 pair contributions (its
#     partners) in any order, each a dot product over the table's (eta
#     group, shape) weights (24 terms) times ~20 roundings of factors: <= 75,
#     4.5e-6 of the largest sum; the plain version's q loop as much. The
#     radial, u_p and u_q parts of Fj cancel: allow the largest Fj to sit 8x
#     under the largest part: 7.2e-5.
# 2e-4 leaves ~3x over ni_force's figure (30x over ni_g's); in f64 the same
# counts at 1.1e-16 give <= 1.3e-13, and 1e-12 leaves 7x.
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
# The [cli-fe] dump's c_pe summed over its 152,880 atoms against the thermo
# row's PotEng at the same step, both shift-free: each c_pe is the f32 sum
# eat + e_shift, in which e_shift itself is rounded to f32 (the same
# rounding for every atom, so the sum less n * e_shift carries a bias of n
# times it, up to 37 eV: it is taken out by subtracting n * f32(e_shift));
# what is left per atom is the sum's rounding (half an ULP at
# |e_i| ~ 4.5e3 eV, 2.4e-4 eV) and the dump's 8 significant digits
# (5e-5 eV), which at random signs add up to ~0.1 eV over the atoms; the
# row's own f32 shift-free sum adds < 0.01 eV, and 1 eV leaves 10x.
PE_SUM_ATOL = 1.0
# the kernels' plain versions, none of which may run on the card
PLAIN_VERSIONS = (("fused_annp", "g_harm_plain"),
                  ("fused_annp", "force_harm_plain"),
                  ("fused_annp", "g_cos_plain"),
                  ("fused_annp", "force_cos_plain"),
                  ("fused_ni", "ni_g_plain"), ("fused_ni", "ni_force_plain"))


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


def timed(fn):
    """(fn(), its milliseconds by CUDA events): one run, no warm-up, for
    the plain versions, whose comparison run is also their timing."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


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
# x_jk, plus its five column sums on each side, 12 a side. Both cos
# kernels visit each unordered pair once.
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
              "g_cos": ("annp_gcos.cu", 116),
              "force_cos": ("annp_cos.cu", 193)}


def phase_kernels(x, box, cfg32, p32):
    """The four fe kernels against their plain versions in f32 and f64 on
    the scene's [P, 128] short planes (filler lanes included). Returns the
    JSON records (without launch counts), timed at the main path's
    [P, 128], and the short list. All four are also held and timed on the
    scene's [P, 192] skin planes (the shape energy_dedg gives g_cos; the
    cos pair in f64 on every fourth row of them) and, on the short planes,
    at the tests' reduced ntsf 5 (another compile-time
    instance of force_harm's ladder and of force_cos's recurrence), outside
    the records."""
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
        # each: (kernel, plain version, outputs); both take the planes and
        # the rows of dedg and b that go with them
        def g_harm(nt):
            return (lambda pl, r: kernels.g_harm(*pl, npsf, nt, rc),
                    lambda pl, r: fa.g_harm_plain(*pl, npsf, nt, rc),
                    ("g_raw", "A"))

        def force_harm(nt):
            return (lambda pl, r: kernels.force_harm(*pl, dedg[r], b[r], npsf,
                                                     nt, rc),
                    lambda pl, r: fa.force_harm_plain(*pl, dedg[r], b[r],
                                                      npsf, nt, rc),
                    ("fjx", "fjy", "fjz"))

        def g_cos(nt):
            return (lambda pl, r: (kernels.g_cos(*pl, npsf, nt, rc),),
                    lambda pl, r: (fa.g_cos_plain(*pl, npsf, nt, rc),),
                    ("g",))

        def force_cos(nt):
            return (lambda pl, r: kernels.force_cos(
                        *pl, dedg[r].contiguous(), npsf, nt, rc),
                    lambda pl, r: fa.force_cos_plain(*pl, dedg[r], npsf, nt,
                                                     rc),
                    ("fjx", "fjy", "fjz"))

        # (name, what else sets the case apart, planes, filler lanes,
        #  kernel, plain version, outputs, whether the case is the kernel's
        #  record; the others give a kernel time only)
        skin_w, reduced = "skin-list width", "ntsf 5"
        cases = [
            ("g_harm", "", short, fill_short, *g_harm(ntsf), True),
            ("force_harm", "", short, fill_short, *force_harm(ntsf), True),
            ("g_harm", skin_w, skin, fill_skin, *g_harm(ntsf), False),
            ("force_harm", skin_w, skin, fill_skin, *force_harm(ntsf), False),
            ("g_harm", reduced, short, fill_short, *g_harm(5), False),
            ("force_harm", reduced, short, fill_short, *force_harm(5), False),
            ("g_cos", "", short, fill_short, *g_cos(ntsf), True),
            ("force_cos", "", short, fill_short, *force_cos(ntsf), True),
            ("g_cos", skin_w, skin, fill_skin, *g_cos(ntsf), False),
            ("force_cos", skin_w, skin, fill_skin, *force_cos(ntsf), False),
            ("g_cos", reduced, short, fill_short, *g_cos(5), False),
            ("force_cos", reduced, short, fill_short, *force_cos(5), False),
        ]
        if dtype == torch.float32:
            # the process's first large allocations would otherwise count
            # against the first plain version's one timed run
            cases[0][5](short, slice(None))
        for name, note, pl, filler, kern, plain, outs, in_record in cases:
            # the cos plain versions build a [K, K] matrix a row: in f64 at
            # the skin-list width they are held on every fourth row
            rows = slice(None, None, COS_SKIN_F64_STRIDE) \
                if (dtype == torch.float64 and note == skin_w
                    and name in COS_REL_BOUND[dtype]) else slice(None)
            cpl = [t[rows].contiguous() for t in pl]
            shape = f"[{cpl[0].shape[0]}, {pl[0].shape[1]}]" \
                + (f" {note}" if note else "")
            got = kern(cpl, rows)
            ref, plain_ms = timed(lambda: plain(cpl, rows))
            worst = compare(tag, f"{name} {shape}", outs, got, ref,
                            bounds[name], filler[rows])
            del got, ref, cpl
            if dtype != torch.float32:
                continue
            ms = cuda_ms(lambda: kern(pl, rows), 10)
            if not in_record:
                log(f"[kernels] {name} f32 {shape}: kernel {ms:.3f} ms "
                    f"(median, CUDA events; not in the record)")
                continue
            src, line = FE_KERNELS[name]
            rec = records[name] = record(
                name, f"meng_zhang_tpu_torch/ops/csrc/{src}",
                f"meng_zhang_tpu/ops/pallas_annp.py:{line}", worst, ms,
                plain_ms, fe_flops(name, lanes, pairs, npsf, ntsf),
                fe_bytes(name, p, k, 4))
            log(f"[kernels] {name} f32 {shape}: kernel {ms:.3f} ms (median "
                f"of 10, CUDA events), plain {plain_ms:.3f} ms (one run), "
                f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
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


def profile_block(tag, what, sim, st, steps, card, tries=3):
    """One block of `steps` steps under torch.profiler that ends without a
    skin-list rebuild (the rate window's usual block; up to `tries` tries):
    the ten kernels with the most device time, in ms per step, and the
    device's idle share of the block's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_ms(e):
        return getattr(e, "self_device_time_total", 0.0) / 1e3

    check(not bool(st.overflow) and not bool(st.unsafe),
          f"{tag}: overflow or unsafe before the profiled block")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            st, _ = sim.run(st, 1)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
        if sim.rebuild_count == 0:
            break
        log(f"[{tag}] block rebuilt its skin list ({wall:.3f} ms); again")
    check(sim.rebuild_count == 0, f"{tag}: every profiled block rebuilt")
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in ops)
    check(busy > 0, f"{tag}: torch.profiler recorded no device time")
    log(f"[{tag}] one {steps}-step block of the {what} main path on {card}: "
        f"{busy:.3f} ms of device time in {wall:.3f} ms (device idle "
        f"{100 * (1 - busy / wall):.1f} %, {busy / steps:.3f} ms of "
        f"device time a step)")
    for e in sorted(ops, key=dev_ms, reverse=True)[:10]:
        log(f"[{tag}]   {dev_ms(e) / steps:8.3f} ms/step "
            f"{100 * dev_ms(e) / busy:5.1f} %  x{e.count:<5d} {e.key[:100]}")


def phase_profile(x, box, cfg32, p32, mass, card, angular="harmonic"):
    """A fresh fe main-path run through one angular path: init_state and the
    blocks before its rate window, then one block under torch.profiler."""
    if angular == "harmonic":
        tag, warm = "profile", N_BLOCKS - RATE_BLOCKS
    else:
        tag, warm = "cos-profile", COS_BLOCKS - COS_RATE_BLOCKS
    sim = fe_simulator(x, cfg32, p32, mass, angular)
    st = sim.init_state(x, box, seed=SEED, t_init=300.0)
    for _ in range(warm):
        st, _ = sim.run(st, 1)
    profile_block(tag, angular, sim, st, THERMO_EVERY, card)


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
    Both kernels visit each unordered leg pair once, from the row's pair
    list."""
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
            ref, plain_ms = timed(plain)
            worst = compare(tag, name, outs, got, ref, NI_REL_BOUND[dtype],
                            filler)
            if name == "ni_g":
                # register sums in list order, then shuffles: no atomics
                check(torch.equal(kern()[0], got[0]),
                      f"ni_g {tag}: two runs differ in their bits")
            if dtype != torch.float32:
                continue
            ms = cuda_ms(kern, 10)
            records.append(record(
                name, "meng_zhang_tpu_torch/ops/csrc/ni_bp.cu",
                f"meng_zhang_tpu/ops/pallas_ni.py:{line}", worst, ms,
                plain_ms, ni_flops(name, *counts, table),
                p * (3 * k + fn.NSF_SUB + (3 * k if name == "ni_force"
                                           else 0)) * 4))
            log(f"[ni-kernels] {name} f32 [{p}, {k}]: kernel {ms:.3f} ms "
                f"(median of 10, CUDA events), plain {plain_ms:.3f} ms (one "
                f"run), bound "
                f"{records[-1]['bound_ms']:.3f} ms "
                f"({records[-1]['bound_by']})")

    # ni_force's pow route and a table that is no grid: zeta 3 and 6 (not
    # powers of two) and one function moved into the first eta group, which
    # then holds 9 functions, two of them alike, and the last group 7
    coeang = p32["coeang"].clone()
    coeang[1, 2], coeang[13, 2], coeang[16, 0] = 3.0, 6.0, coeang[0, 0]
    odd = fn.ni_table(p32["coerad"], coeang)
    rows = slice(0, NI_POW_ROWS)
    for dtype in (torch.float32, torch.float64):
        planes = [t[rows].to(dtype).contiguous() for t in planes32]
        dedg = torch.tensor(dedg_np[rows], dtype=dtype, device=dev)
        tag = "ni-kernels pow route " + ("f32" if dtype == torch.float32
                                         else "f64")
        compare(tag, f"ni_g [{NI_POW_ROWS}, {k}]", ("g",),
                (kernels.ni_g(*planes, odd),),
                (fn.ni_g_plain(*planes, odd),), NI_REL_BOUND[dtype])
        compare(tag, f"ni_force [{NI_POW_ROWS}, {k}]", ("fjx", "fjy", "fjz"),
                kernels.ni_force(*planes, dedg, odd),
                fn.ni_force_plain(*planes, dedg, odd), NI_REL_BOUND[dtype],
                filler[rows])
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


def ni_simulator(dev, cfg32, p32, mass):
    """(Simulator, x, box, evaluator) of the NVT main path of
    scripts/model_bench.py --model ni on the perfect lattice, the light
    force variant wired as there."""
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.ops import fused_ni as fn
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
    return sim, x, box, ev


def phase_ni_main_path(dev, cfg32, p32, mass, card):
    """init_state + NI_BLOCKS blocks of the ni NVT main path."""
    from meng_zhang_tpu_torch.ops import kernels
    sim, x, box, ev = ni_simulator(dev, cfg32, p32, mass)
    n = x.shape[0]
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


def phase_ni_profile(dev, cfg32, p32, mass, card):
    """A fresh ni main-path run: init_state and 4 blocks, then one block
    under torch.profiler."""
    sim, x, box, _ = ni_simulator(dev, cfg32, p32, mass)
    st = sim.init_state(x, box, seed=SEED, t_init=NI_T_INIT)
    for _ in range(4):
        st, _ = sim.run(st, 1)
    # the hot ni run rebuilds its skin list about every third block
    profile_block("ni-profile", "ni", sim, st, NI_THERMO_EVERY, card, tries=5)


# ------------------------------------------------------------ run path
@contextlib.contextmanager
def plain_calls():
    """Count the calls of the kernels' plain versions made inside the
    block: {name: calls}."""
    from meng_zhang_tpu_torch.ops import fused_annp, fused_ni
    mods = {"fused_annp": fused_annp, "fused_ni": fused_ni}
    counts, saved = {}, []
    for mod, name in PLAIN_VERSIONS:
        fn = getattr(mods[mod], name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)
        saved.append((mods[mod], name, fn))
        setattr(mods[mod], name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def cli(tag, argv):
    """meng_zhang_tpu_torch.run.main(argv) on the card in this process, its
    output echoed: (thermo rows as printed, stderr lines, wall seconds);
    the kernels' launches are counted from 0 and no plain version may
    run."""
    from meng_zhang_tpu_torch import profiling, run
    from meng_zhang_tpu_torch.ops import kernels
    out, err = io.StringIO(), io.StringIO()
    kernels.reset_launch_counts()
    profiling.reset()
    t0 = time.time()
    try:
        with plain_calls() as plain, contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            run.main(argv)
    except SystemExit as e:
        raise SmokeFailure(f"{tag}: run.main exited ({e}): "
                           f"{err.getvalue()[-2000:]}")
    finally:
        profiling.enable(False)
    wall = time.time() - t0
    lines = out.getvalue().splitlines()
    for line in lines + err.getvalue().splitlines():
        log(f"[{tag}] {line}")
    check(not plain, f"{tag}: plain versions ran on the card: {plain}")
    warn = [ln for ln in err.getvalue().splitlines() if "WARNING" in ln]
    check(not warn, f"{tag}: {warn}")
    rows = lines[1:]
    check(len(rows) >= 2 and all(
        math.isfinite(float(v)) for ln in rows for v in ln.split()),
        f"{tag}: missing or non-finite thermo rows")
    launches = {k: getattr(kernels, k).launches
                for k in ("g_harm", "force_harm", "g_cos", "force_cos",
                          "ni_g", "ni_force")}
    log(f"[{tag}] {wall:.2f} s in run.main; launches {launches}")
    return rows, err.getvalue().splitlines(), wall, launches


def _loop_rate(err):
    line = next(ln for ln in err if ln.startswith("Loop time"))
    return float(line.split("(")[1].split()[0].replace(",", ""))


def _phase_avg_ms(err, name):
    """Average ms of a phase in the CLI's --profile report."""
    line = next(ln for ln in err if ln.split()[:1] == [name])
    return float(line.split()[3])


def _last_snapshot(path):
    """(column names, [N, C] array) of a .lammpstrj's last snapshot."""
    with open(path) as f:
        lines = f.read().splitlines()
    i, last = 0, None
    while i < len(lines):
        n = int(lines[i + 3])
        last = (i, n)
        i += 9 + n
    i, n = last
    cols = lines[i + 8].split()[2:]
    rows = np.array([ln.split() for ln in lines[i + 9:i + 9 + n]],
                    dtype=np.float64)
    return int(lines[i + 1]), cols, rows


def write_inputs(tmp):
    """The benchmark scene as a LAMMPS data file and the synthetic fe and
    ni potentials as .ann files, written with the port's own writers."""
    from meng_zhang_tpu_torch.io.lammps_data import LammpsData, write_data
    from meng_zhang_tpu_torch.io.potential import write_ann
    from meng_zhang_tpu_torch.testing import synthetic_ni_potential
    x = np.load(SCENE_NPZ)["x"].astype(np.float64)
    paths = {k: os.path.join(tmp, name) for k, name in (
        ("data", "fe_st.dat"), ("fe", "fe.ann"), ("ni", "ni.ann"))}
    write_data(paths["data"], LammpsData(
        x=x, types=np.ones(len(x), np.int32), box_lo=np.zeros(3),
        box_hi=np.asarray(BOX), n_types=1), comment="benchmark scene")
    write_ann(paths["fe"], _potential())
    write_ann(paths["ni"], synthetic_ni_potential(0))
    return paths


def phase_cli_fe(card, tmp, paths, dev):
    """The benchmark workflow through the CLI: NPT with a per-atom dump and
    a checkpoint, then --restart."""
    from meng_zhang_tpu_torch.models.annp import make_annp
    n = len(np.load(SCENE_NPZ)["x"])
    dump, ck = os.path.join(tmp, "fe.lammpstrj"), os.path.join(tmp, "fe.npz")
    argv = ["--data", paths["data"], "--potential", paths["fe"],
            "--ensemble", "npt", "--temp", "300", "--couple", "y",
            "--boundary", "m p m", "--skin", str(SKIN), "--capacity",
            str(CAPACITY), "--thermo", str(CLI_THERMO)]
    rows, err, _, launches = cli("cli-fe", argv + [
        "--steps", str(CLI_FE_STEPS), "--dump", dump, "--dump-peratom",
        "--checkpoint", ck, "--profile"])
    n_dumps = CLI_FE_STEPS // CLI_THERMO
    want = CLI_FE_STEPS + 1 + n_dumps       # init, steps, per-atom dumps
    for name in ("g_harm", "force_harm"):
        check(launches[name] == want, f"cli-fe: {name} launched "
              f"{launches[name]} times, expected {want} (init + one per "
              f"step + one per per-atom dump)")
    check(launches["g_cos"] == launches["force_cos"] == 0,
          "cli-fe: cos kernels launched on the harmonic path")
    step, cols, snap = _last_snapshot(dump)
    check(step == CLI_FE_STEPS and snap.shape == (n, 12) and cols[5:] == [
        "c_pe"] + [f"c_stress[{k}]" for k in range(1, 7)],
        f"cli-fe: dump columns {cols}, shape {snap.shape}, step {step}")
    check(bool(np.isfinite(snap[:, 5:]).all()),
          "cli-fe: non-finite c_pe / c_stress")
    e_shift = make_annp(_potential(), torch.float32, "cpu")[0].e_shift
    pe_row = float(rows[-1].split()[2]) - n * e_shift
    pe_sum = math.fsum(snap[:, 5]) - n * float(np.float32(e_shift))
    log(f"[cli-fe] step {step}: shift-free sum of c_pe {pe_sum:.4f} eV "
        f"(less n f32(e_shift)), thermo PotEng {pe_row:.4f} eV (less "
        f"n e_shift), |diff| {abs(pe_sum - pe_row):.4f} eV (bound "
        f"{PE_SUM_ATOL}); max|c_stress| {np.abs(snap[:, 6:]).max():.4e} eV")
    check(abs(pe_sum - pe_row) <= PE_SUM_ATOL,
          "cli-fe: the dump's c_pe does not sum to the thermo PotEng")
    rate = _loop_rate(err)
    block_ms = _phase_avg_ms(err, "md_block")
    dump_ms = _phase_avg_ms(err, "dump")
    log(f"[cli-fe] Loop time rate {rate:.1f} atom-steps/s (per-atom dumps "
        f"included); md_block {block_ms:.3f} ms a {CLI_THERMO}-step block = "
        f"{n * CLI_THERMO / block_ms * 1e3:.1f} atom-steps/s; a per-atom "
        f"dump {dump_ms:.3f} ms on {card}")

    fe_step_costs(card, dev)

    rows2, err2, _, launches2 = cli("cli-fe-restart", argv + [
        "--steps", str(CLI_FE_RESTART_STEPS), "--restart", ck])
    check(rows2[0] == rows[-1], "cli-fe: the restart's first row differs "
          f"from the checkpoint's last: {rows2[0]!r} vs {rows[-1]!r}")
    check(int(rows2[-1].split()[0]) == CLI_FE_STEPS + CLI_FE_RESTART_STEPS,
          "cli-fe: the restart did not continue the step count")
    for name in ("g_harm", "force_harm"):
        check(launches2[name] == CLI_FE_RESTART_STEPS + 1,
              f"cli-fe restart: {name} launched {launches2[name]} times")
    return {k: launches[k] + launches2[k] for k in ("g_harm", "force_harm")}


def step_costs(tag, card, fns):
    """Median ms (CUDA events, 5 runs after a warm-up) of each named
    evaluation, so that the run path's step can be set beside the
    Simulator's."""
    for name, fn in fns.items():
        log(f"[{tag}] {name}: {cuda_ms(fn, 5):.3f} ms on {card}")


def fe_step_costs(card, dev):
    """The fe scene's evaluations: run.py's step (compaction of the skin
    list at rc, then the kernels) against the Simulator's (the kernels on
    a refresh-static short list), the compaction alone, and the per-atom
    evaluation of a dump."""
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    x, box = scene(dev)
    cfg32, p32 = make_annp(_potential(), torch.float32, dev, pbc=PBC)
    ev = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT)
    nb = Simulator(None, torch.ones(x.shape[0], device=dev),
                   md_config(cfg32)).build_nbrs(x, box)
    sl = ev.compact_short(x, box, nb.idx)
    step_costs("cli-fe", card, {
        "run.py step, energy_forces (skin list [N, 192])":
            lambda: ev.energy_forces(x, box, nb.idx),
        "Simulator step, energy_forces_short (short list [N, 128])":
            lambda: ev.energy_forces_short(x, box, sl),
        "compact_short alone (at rc)":
            lambda: fa.compact_short(x, box, nb.idx, cfg32.cut, K_SHORT,
                                     PBC),
        "a dump's per-atom evaluation (compact_short + per_atom=True)":
            lambda: ev.energy_forces_short(
                x, box, ev.compact_short(x, box, nb.idx),
                want_virial=False, per_atom=True)})


def phase_cli_ni(card, paths, dev):
    """The fcc-Ni NVT workflow through the CLI: compact_neighbor_rows and
    the chunked functions, hence FusedNi's kernels."""
    argv = ["--lattice", "fcc", "--cells", str(NI_CELLS), str(NI_CELLS),
            str(NI_CELLS), "--lattice-a", str(NI_A), "--potential",
            paths["ni"], "--ensemble", "nvt", "--temp", str(NI_T),
            "--steps", str(CLI_NI_STEPS), "--thermo", str(CLI_NI_THERMO)]
    rows, err, _, launches = cli("cli-ni", argv)
    for name in ("ni_g", "ni_force"):
        check(launches[name] == CLI_NI_STEPS + 1, f"cli-ni: {name} "
              f"launched {launches[name]} times, expected "
              f"{CLI_NI_STEPS + 1} (init + one per step)")
    log(f"[cli-ni] Loop time rate {_loop_rate(err):.1f} atom-steps/s on "
        f"{card}")
    ni_step_costs(card, dev)
    return {k: launches[k] for k in ("ni_g", "ni_force")}


def ni_step_costs(card, dev):
    """The ni scene's evaluations at the CLI's defaults (skin 2.0,
    capacity 256): run.py's step (compact_neighbor_rows to 32, then the
    chunked function) against the Simulator's (FusedNi on a refresh-static
    short list), and the repack alone."""
    from meng_zhang_tpu_torch.md.simulation import MDConfig, Simulator
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.system.neighbors import cell_grid_dims
    from meng_zhang_tpu_torch.testing import synthetic_ni_potential
    from meng_zhang_tpu_torch.testing import thermal_fcc
    xn, bn = thermal_fcc(NI_CELLS, seed=SEED, disp=NI_DISP, a=NI_A)
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    cfg, params = annp.make_annp(synthetic_ni_potential(0), torch.float32,
                                 dev)
    rc = annp.descriptor_cutoff(cfg, params)
    nb = Simulator(None, torch.ones(x.shape[0], device=dev), MDConfig(
        dt=0.001, cutoff=rc, skin=2.0, capacity=256, nbr_method="cell",
        cell_dims=cell_grid_dims(bn, rc + 2.0))).build_nbrs(x, box)
    ev = fn.FusedNi(cfg, params, k_short=NI_KS, short_delta=NI_DELTA)
    sl = ev.compact_short(x, box, nb.idx)

    def cli_step():
        idx_s, _ = annp.compact_neighbor_rows(x, box, nb.idx, rc, NI_KS)
        return annp.energy_forces_virial_chunked(cfg, params, x, box, idx_s,
                                                 shift=False)

    step_costs("cli-ni", card, {
        "run.py step, compact_neighbor_rows ([N, 256] -> 32) + "
        "energy_forces_virial_chunked": cli_step,
        "Simulator step, FusedNi.energy_forces_short (short list [N, 32])":
            lambda: ev.energy_forces_short(x, box, sl),
        "compact_neighbor_rows alone":
            lambda: annp.compact_neighbor_rows(x, box, nb.idx, rc, NI_KS)})


def phase_minimize(card, tmp, paths, dev):
    """cg_relax on the benchmark scene (the reference's `minimize 1e-6 1e-6
    1000 10000`, shift-free energies with e_offset = n e_shift), then a
    --minimize (FIRE) CLI run on the screw-dislocation scene of
    `python -m meng_zhang_tpu_torch.tools screw --dislocation`."""
    from meng_zhang_tpu_torch import tools
    from meng_zhang_tpu_torch.md.minimize import cg_relax
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    x, box = scene(dev)
    n = x.shape[0]
    cfg32, p32 = make_annp(_potential(), torch.float32, dev, pbc=PBC)
    ev = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT)
    sim = Simulator(None, torch.ones(n, device=dev), md_config(cfg32))

    def ef(xx, bb, idx):
        return ev.energy_forces(xx, bb, idx, want_virial=False, shift=False)

    kernels.reset_launch_counts()
    with plain_calls() as plain:
        torch.cuda.synchronize()
        t0 = time.time()
        _, st = cg_relax(ef, sim.build_nbrs, x, box, etol=1e-6, ftol=1e-6,
                         max_iter=1000, dmax=0.1,
                         e_offset=n * cfg32.e_shift)
        torch.cuda.synchronize()
        wall = time.time() - t0
    check(not plain, f"minimize: plain versions ran on the card: {plain}")
    check(st.converged in ("etol", "ftol"), f"cg stopped: {st.converged}")
    check(kernels.g_harm.launches >= st.n_evals > 0,
          "cg: fewer kernel launches than force evaluations")
    log(f"[minimize] cg_relax on the {n}-atom scene: n_iter {st.n_iter}, "
        f"n_evals {st.n_evals}, converged {st.converged!r}, pe "
        f"{float(st.pe) + n * cfg32.e_shift:.4f} eV, fnorm {st.fnorm:.4e}, "
        f"{wall:.3f} s on {card} (launches g_harm "
        f"{kernels.g_harm.launches})")
    del x, box, ev, sim

    screw = os.path.join(tmp, "screw.dat")
    tools.main(["screw", "--dislocation", "--out", screw])
    rows, err, wall, launches = cli("minimize", [
        "--data", screw, "--replicate", "1", "1", str(SCREW_REPLICATE),
        "--potential", paths["fe"], "--skin", str(SKIN), "--capacity",
        str(CAPACITY), "--minimize", "--min-ftol", str(FIRE_FTOL),
        "--steps", str(CLI_THERMO), "--thermo", str(CLI_THERMO)])
    fline = next(ln for ln in err if "fmax=" in ln)
    fmax = float(fline.split("fmax=")[1].split()[0])
    evals = launches["g_harm"] - CLI_THERMO - 1
    check(fmax <= FIRE_FTOL, f"minimize: FIRE stopped at fmax {fmax}")
    check(launches["force_harm"] == launches["g_harm"] and evals > 0,
          "minimize: FIRE ran no kernel evaluation")
    log(f"[minimize] FIRE (--minimize --min-ftol {FIRE_FTOL}) on the "
        f"screw-dislocation scene: fmax {fmax:.4e} eV/A after {evals} force "
        f"evaluations (kernel launches less the run's {CLI_THERMO + 1}); "
        f"run.main {wall:.2f} s on {card}")
    return {k: launches[k] for k in ("g_harm", "force_harm")}


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
        with tempfile.TemporaryDirectory() as tmp:
            paths = write_inputs(tmp)
            cli_launches = {"cli-fe": phase_cli_fe(card, tmp, paths, dev),
                            "cli-ni": phase_cli_ni(card, paths, dev),
                            "minimize": phase_minimize(card, tmp, paths,
                                                       dev)}
        log(f"[smoke] run-path launches {cli_launches}")
        phase_profile(*fe, card)
        phase_profile(*fe, card, angular="matrix")
        del fe
        phase_ni_profile(dev, cfg32, p32, mass, card)
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
