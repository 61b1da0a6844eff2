#!/usr/bin/env python3
"""Bring-up smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives `meng_zhang_tpu_torch` -- never JAX -- through its four main paths
and the sharded drivers (slabs, columns, bricks) on each model family, then
through its user-facing run path (`python -m meng_zhang_tpu_torch`, called
in-process as `run.main(argv)`):

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
    Rc 7.3699319 Bohr = 3.90 A);
  * bcc-Fe ANNA-ADP on the scene of `scripts/model_bench.py --model anna`:
    128,000 atoms (bcc 40^3 cells, a = 2.8553 A, fully periodic), NVE from
    300 K velocities, through `make_anna_fast_fns` (phase 1 on g_harm), on
    a synthetic potential of the shipped width (npsf 9 + ntsf 19, nnod 6,
    two outputs, rc 5.055 A).

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
  11a. [ni-wide-kernels]: the same scene on a synthetic BP potential of the
      shipped table shape at Rc NI_WIDE_RC = 6.0 A (fcc: 86 partners within
      6.2 A): ni_g / ni_force against their plain versions on the
      [256000, 128] short planes in f32 and f64 (f64 held on every
      NI_WIDE_F64_STRIDE-th row), ni_g bitwise repeatable, their times and
      bounds; then the 10 + 22 table of testing.NI_WIDE_ANGULAR (nsf 32, 20
      eta groups, 22 (lambda, zeta) shapes, 12 through pow) and the
      potential's table at K 48 and K 256 (2 and 8 slots a lane) on
      NI_POW_ROWS of those rows; [ni-wide-main]: phase 11's NVT run on that
      potential at Ks 128 (skin capacity 128), NI_WIDE_BLOCKS blocks, its
      gates and launch counts, the widest short row and the rate;
  12. anna-kernel: g_harm against its plain version in f32 and f64 on the
      [128000, 72] short planes of a thermal box of the ANNA scene at rc
      5.055 A (its 3-slots-a-lane instance), and its time and bound;
  13. anna-eval: the fast path's force_fn in f32 through g_harm against
      the same path in f64 on g_harm's plain version on that box, and the
      f64 fast path against the reference-shaped energy_forces_virial on a
      432-atom box;
  14. anna-md: init_state + 20 blocks of 5 NVE steps with the light force
      variant; finite thermo, no overflow / unsafe, g_harm once a step and
      no other kernel or plain version; prints the rate and the NVE drift
      (not gated: the forces freeze (d2, q2), so NVE drifts by design);
  15. cli-fe: the benchmark scene as a LAMMPS data file and the synthetic
      fe potential as a .ann file, both written with the port's writers,
      through run.main: `--ensemble npt --temp 300 --couple y --boundary
      "m p m" --skin 1.2 --capacity 192 --steps 40 --thermo 10 --dump ...
      --dump-peratom --checkpoint ... --profile`, then `--restart` for 20
      more steps. Checks finite thermo, no warning, g_harm / force_harm
      launched once per evaluation and no plain version run, the last
      dump's c_pe and c_stress finite with c_pe summing to the thermo row's
      PotEng, and the restart's first row equal to the checkpoint's last;
      prints the CLI's atom-steps/s and the cost of a per-atom dump;
  16. cli-ni: `--lattice fcc --cells 40 40 40 --lattice-a 3.52 --ensemble
      nvt --temp 1200 --steps 20 --thermo 5` with the synthetic ni .ann:
      ni_g / ni_force through compact_neighbor_rows and the chunked
      functions, once per evaluation, no plain version;
  17. minimize: cg_relax on the benchmark scene with e_offset = n e_shift
      (n_iter, n_evals, stopping reason, wall time), then a `--minimize`
      (FIRE) CLI run on the screw-dislocation scene of `tools screw
      --dislocation`, replicated to 10 Burgers vectors in z;
  18. cli-anna: `--lattice bcc --cells 40 40 40 --ensemble nve --temp 300
      --steps 20 --thermo 5` with the synthetic .anna (run.py's defaults,
      the reference-shaped functions on the skin list), g_harm once per
      evaluation; then `--minimize` with a per-atom dump on a 432-atom
      thermal box, whose c_pe sums to the thermo row's PotEng;
  19. profile: a fresh harmonic main-path run (init_state and 5 blocks),
      then one block without a skin-list rebuild under torch.profiler:
      device time by kernel (top ten, ms per step) and the device's idle
      share; then the same for the cos-matrix main path (3 blocks, then
      one), the ni main path (4 blocks, then one) and the ANNA main path
      (4 blocks, then one, and its light step's phases timed apart). It
      runs last, so that the profiler's tracing cannot touch any other
      phase's timing.

The multi-element and thin-box paths, each fatal on failure, by tag:

  * [multi-fe] (after phase 8): the benchmark scene with types 1/2 drawn
    50/50 (numpy.random.default_rng(0)) and the two-element synthetic fe
    potential (testing.synthetic_fe_potential_multi): phase 4's gates with
    elems on both angular paths, the f64 kernel path against the autograd
    model with elems on a 250-atom box, the elems-blind control
    (BLIND_OVER_*), then 10 NPT blocks through Simulator with the
    atoms' masses (101 launches of each harmonic kernel, no plain
    version), its rate beside phase 5's;
  * [rowsweep]: build_neighbors_cell_rowsweep against build_neighbors_cell
    on the benchmark scene, and Simulator(nbr_method="rowsweep") through a
    forced rebuild;
  * [multi-ni] (after phase 11): the thermal ni box typed 50/50 with the
    two-element ni potential: phase 10's gates with elems, the
    elems-blind control, 2 NVT blocks of make_short_chunked_fns(elems)
    from the perfect lattice;
  * [thin-box] (after phase 17): `tools screw --dislocation` as it is
    (5,016 atoms, z one Burgers vector, pbc (F, F, T)) through 9 explicit
    z-images: image mode in f64 against the z-replicated scene (E/9, F of
    the first copy, W/9, THIN_REL), the f32 kernels against the f64 plain
    path (THIN_W_OVER_PLAIN for W) and g_harm / force_harm against their
    plain versions on the image planes, 10 NVE blocks through
    Simulator(image_shifts=...), and FIRE on the image route;
  * [cli-multi]: run.main on the benchmark scene written with its
    [multi-fe] types and the two-element .ann: 20 NPT steps with per-atom
    dumps, c_pe summing to PotEng.

The sharded slab driver (parallel/domain.py: ShardedMD over SHARD_D = 4
shards in this process, every per-shard tensor [4, ...], so each kernel
launches once a step for all shards), each fatal on failure, by tag:

  * [shard-fe] (after [rowsweep]): ShardedMD(FrameShortModel(FusedAnnp))
    on the fe scene: distribute in f32 against phase 4's f64 plain path
    (EVAL_REL); the four fe kernels against their plain versions on the
    frame planes [4 cc, 128] (the cos pair on every fourth row); on the
    slab x < SHARD_SLAB_X in f64 the sharded kernel path against one
    device, and AnnpFrameModel (both angular paths, the skin rows at full
    width) against FrameShortModel (SHARD_REL64); halo_b 16 trips
    OVF_COVERAGE; SHARD_BLOCKS NPT blocks (migrate_b SHARD_MIGRATE_B; a
    migrate and rebuild forced after the first block if none ran) from
    phase 5's start: T against a single-device run over the first
    SHARD_T_STEPS steps within `shard_t_bound`, one launch a step of each
    harmonic kernel, gid a permutation; its rate beside phase 5's;
  * [shard-ni] (after phase 11): FrameShortModel(FusedNi) on the thermal ni
    box (periodic x: the ring's seam halos are unwrapped) against phase
    10's f64 plain path, in f64 against one device, ni_g / ni_force on the
    frame planes, the coverage trip, then SHARD_BLOCKS NVT blocks from the
    perfect lattice as phase 11;
  * [shard-anna] (after phase 14): AnnaFrameModel(fast=True) on the thermal
    ANNA box against phase 13's f64 fast path (ANNA_EVAL_REL), g_harm on
    the frame planes [4 cc, 96], SHARD_ANNA_BLOCKS NVE blocks from the
    perfect lattice with halo_b SHARD_ANNA_HALO_B (drift printed).

The drivers across processes (parallel/launch.py: `spawn` starts the
ranks, each holding D / W shards of `ShardMesh(group=...)`; every rank
builds the same driver from the same host data through
`launch.run_sharded`, and each run is held against the same run in this
process), each fatal on failure, by tag, added after [shard3d-fe]:

  * [dist] / [dist-fe] / [dist3d-ni]: one launch of DIST_WORLD gloo ranks
    on the one card (the P2P blocks and the collectives through host
    memory): [shard-fe]'s 4-slab NPT run from phase 5's start, one slab
    a rank, DIST_BLOCKS blocks, then a migrate and a rebuild; one f64
    evaluation of [shard-fe]'s slab x < SHARD_SLAB_X (forces within
    DIST_REL64 of max|F| of the in-process one); [shard3d-ni]'s (2, 2, 2)
    NVT run from the perfect lattice, two bricks a rank, DIST_NI_BLOCKS
    blocks, then a three-round migrate and a rebuild. T and PE at every
    block and the final positions against the in-process run within
    bounds derived from the evaluator gates (dist_compare: the f32 runs
    differ by index_add_'s atomics and the ranks' order of the virial
    sum), each rank's launches once a step of the path's kernels, the
    replicated state (box, chains, virial, flags) bitwise equal on every
    rank (checked in the ranks); prints each rank's start and run seconds and
    peak device memory, and the rates against the in-process runs;
  * [dist-nccl]: an NCCL group of one rank holding [dist-fe]'s 4 slabs
    (the collectives through NCCL), one block against the same block in
    this process; with two or more visible cards, [dist-fe]'s run on
    NCCL with one rank a card on 4 (or 2) cards; with one card it prints
    that the check across cards did not run.

Rows of 257-512 partners (the kernels' MAX_K = NI_MAX_K = 512), each
fatal on failure, by tag:

  * [fe-wide-kernels] (after [dist-nccl]): the benchmark scene on the fe
    potential of the shipped widths at rc FE_WIDE_RC (a skin list at rc +
    FE_WIDE_SKIN of capacity FE_WIDE_CAPACITY, short rows at Ks
    FE_WIDE_KS, ~330-360 partners a row): the four fe kernels against
    their plain versions in f32 and f64 (the cos pair on the first
    WIDE_ROWS rows, f64 on every WIDE_F64_STRIDE-th row), and the first
    WIDE_PAD_ROWS rows widened to K 512 by filler lanes; each kernel's time
    on every row and its bound;
  * [fe-wide-main]: phase 5's NPT path through FusedAnnp(k_short=
    FE_WIDE_KS) on that potential, FE_WIDE_BLOCKS blocks: phase 5's gates,
    the widest short and skin rows and the rate;
  * [ni-wider] (after [ni-wide-main]): the ni potential of the shipped
    table at Rc NI_WIDER_RC on a thermal box of NI_WIDER_CELLS^3 fcc cells
    at Ks NI_WIDER_KS (~320 partners a row): ni_g / ni_force against their
    plain versions on the first WIDE_ROWS rows (f64 on every
    WIDE_F64_STRIDE-th; NI_WIDER_REL_BOUND) and on WIDE_PAD_ROWS rows at K
    512, their times on every row and bounds; the cross-tile instances
    ni_g_tiles / ni_force_tiles on the same [16384, 352] planes, against
    the one-warp kernels (twice NI_WIDER_REL_BOUND) and timed beside them
    (the crossover); one evaluation of the
    chunked BP functions in f32 against the f64 plain path (NI_EVAL_REL);
    then [ni-wider-main], NI_WIDER_BLOCKS blocks of phase 11's NVT path at
    those sizes, its gates.

Rows of more than 512 partners (the harmonic pair in virtual rows of
kernels.HARM_TILE slots, the ni pair's cross-tile instances in tiles of
kernels.NI_TILE), each fatal on failure, by tag, after [disloc-core]:

  * [fe-widest]: the benchmark slab on the fe potential of the shipped
    widths at rc FE_WIDEST_RC (~610 partners a row): g_harm / force_harm on
    the rows compacted at rc against their plain versions on WIDEST_ROWS
    rows (f64 on every WIDE_F64_STRIDE-th), their times on every row and
    bounds; one energy_forces_virial_chunked in f32
    against the f64 plain path (WIDEST_OVER_PLAIN times the f32 plain
    path's difference); FE_WIDEST_CLI_STEPS NPT steps of the CLI's
    `--engine xla` route at --capacity FE_WIDEST_CAPACITY;
  * [ni-widest]: the ni potential of the shipped table at Rc NI_WIDEST_RC
    on thermal fcc NI_WIDEST_CELLS^3 cells (~600 partners a row):
    ni_g_tiles / ni_force_tiles against the plain versions on the whole row
    and their tiled plain twins on WIDEST_ROWS rows (NI_WIDEST_REL_BOUND;
    ni_force's twin on the f64 rows), ni_force_tiles' sum kernel on its
    unit kernel's partials against its plain twin on the same ones, two
    runs bit for bit equal, the times and bounds; one chunked evaluation
    in f32 against f64 (WIDEST_OVER_PLAIN);
    NI_WIDEST_CLI_STEPS NVT steps of the CLI's BP route at --capacity
    NI_WIDEST_CAPACITY;
  * [anna-widest]: the synthetic .anna of the shipped widths at cut
    ANNA_WIDEST_CUT on thermal bcc ANNA_WIDEST_CELLS^3 cells (rows of
    513-640 partners, counted): local_params, the reference-shaped
    energy_forces_virial and make_anna_fast_fns(k_short=ANNA_WIDEST_KS) in
    f32 against f64 (WIDEST_OVER_PLAIN).

The 2-D and 3-D grid drivers (parallel/domain2d.py, domain3d.py:
ShardedMD2D on a (2, 2) grid of columns, ShardedMD3D on a (2, 2, 2) grid
of bricks, on the same in-process mesh; every frame row is a centre), each
fatal on failure, by tag:

  * [shard2d-fe] (after [shard-fe]): [shard-fe]'s checks through
    ShardedMD2D(FrameShortModel(FusedAnnp)), `boundary m p m`; its
    coverage trip moves a row of shard 0 from outside its y-high send set
    into that face band, which must latch OVF_COVERAGE at the rebuild;
  * [shard3d-fe] (after [shard2d-fe]): one evaluation, no MD:
    ShardedMD3D(FrameShortModel(FusedAnnp)) on the fe scene, x and z not
    periodic, distribute in f32 against phase 4's f64 plain path, and
    g_harm / force_harm on the bricks' frame planes;
  * [shard3d-ni] (after [shard-ni]): [shard-ni]'s checks through
    ShardedMD3D(FrameShortModel(FusedNi)), without the slab halo's
    coverage trip;
  * [shard2d-anna] (after [shard-anna]): [shard-anna]'s checks through
    ShardedMD2D(AnnaFrameModel(fast=True)), the NVE run from the perfect
    lattice on the derived send-table capacities.

The scale configurations (meng_zhang_tpu_torch/scripts/: BASELINE.json
configs 3-5 at their full atom counts, the timed steps cut), each fatal on
failure, by tag, after the run path and before the profiles:

  * [disloc-core]: `scripts/disloc_core.py` in full (config 4: the
    30,096-atom screw-dislocation scene, FIRE with the boundary shell
    frozen in passes on fresh skin lists, then one evaluation on a fresh
    list at the relaxed positions for the per-atom tallies and their
    dump): that evaluation's fmax within f_tol, the per-atom virials
    summing to the virial, the frozen shell unmoved, g_harm / force_harm
    once an evaluation;
  * [scale-500k]: `scripts/scale_demo.py --config 500k` (config 3:
    500,094 atoms, three-axis NPT) with SCALE_500K_STEPS timed steps after
    the 10 warm-up blocks: no overflow, no `unsafe` latch in the timed
    window, finite thermo, the box moved on all three axes, one launch an
    evaluation; g_harm / force_harm against their plain versions on
    SCALE_SLICE short rows, and their times on the full [500094, 128];
  * [scale-2m]: `--config 2m` (config 5's scene: the 1,964,085-atom STGB
    bicrystal, its overlap prune timed; FIRE <= 100 iterations,
    SCALE_2M_WARMUP warm-up blocks, SCALE_2M_STEPS timed NVE steps): the
    same gates, the kernels
    against their plain versions on two slices (one through the grain
    boundary at x = STGB_PLANE_X) and timed on [1964085, 128], the peak
    memory of a skin-list build, a compaction and an evaluation, and one
    f32 evaluation of the relaxed scene against one f64 evaluation under
    EVAL_REL. Each prints its atoms, peak memory, wall and rate with the
    card's name and power limit.

The other run scripts (meng_zhang_tpu_torch/scripts/, each main(argv)
through `scale_script`: launches counted from 0, no plain version on the
card), each fatal on failure, by tag, after [scale-2m]:

  * [script-profile-2m]: `profile_2m.py` on [scale-2m]'s FIRE-relaxed
    positions (passed through main's `scene`, no second FIRE): each
    phase's time and peak memory;
  * [script-model-ni] / [script-model-anna]: `model_bench.py --model ni |
    anna` at the full scenes, `--backend kernels` for
    SCRIPT_MODEL_STEPS["kernels"] timed steps and `chunked` for
    SCRIPT_MODEL_STEPS["chunked"]: no overflow, no `unsafe` latch, finite
    thermo, the path's kernels once an evaluation and no other, and their
    rate ratio;
  * [script-profile-fe] / [script-profile-ni]: `profile_bench.py` and
    `profile_ni.py` in full. Each profile's kernels launch as often as it
    counts their calls, and its chained phases give energy_forces_short's
    E (and W) exactly and its forces within the f32 rounding of the
    delivery's atomic adds (chained_gate);
  * [script-sharded-small]: `sharded_demo.py --scene small` for
    SCRIPT_SHARDED_SMALL_STEPS NPT steps on 4 slabs and its single-device
    reference: T and PE over the first SCRIPT_PARITY_STEPS steps within
    shard_t_bound and sharded_pe_bound, the run-long statistics printed;
    [script-sharded-100k]: `--scene 100k` (8 slabs, 30 steps);
    [script-sharded2d]: `sharded2d_demo.py` (12,672 atoms on a (2, 4)
    grid, its own t = 0 parity limits, 20 NVE steps): no overflow, no
    `unsafe` latch (slabs), finite thermo, g_harm / force_harm once an
    evaluation of each run;
  * [script-halo]: `halo_fraction.py --cells SCRIPT_HALO_CELLS` (524,288
    atoms; planning only, no launch): every row planned or refused with a
    reason, the 8-shard
    layouts planned, and the rows at --cells SCRIPT_HALO_CPU_CELLS equal
    to the same planning on the CPU;
  * [script-bench]: `bench.py --steps SCRIPT_BENCH_STEPS`, the port's
    headline run, on the 152,880-atom benchmark scene: exactly one stdout
    line, bench.py's JSON object (metric, value, unit atom-steps/s,
    vs_baseline = value / (0.559 x 152,880)), no overflow or `unsafe`,
    g_harm / force_harm once an evaluation; its rate beside phase 5's.

Every phase of a script also holds its path's kernels against their
plain versions (f32 and f64, the bounds above) on SCALE_SLICE rows of its
own planes (the final state's short rows, or the frames' compacted rows).

Each kernel's record carries its least time on the card (`bound_ms`, the
larger of the FLOPs its function needs over the f32 peak and its bytes
over the memory rate, counted from this run's inputs) and `library_ms` null: no single PyTorch
call computes any of these functions. g_harm's record also carries its
ANNA-shape figures (`anna_shape`, `anna_ms`, `anna_plain_ms`,
`anna_bound_ms`, `anna_bound_by`, `anna_max_abs_err`, and `anna_launches`
from phase 14); ni_g's and ni_force's carry their [ni-wide-kernels] figures
(`wide_shape`, `wide_ms`, `wide_plain_ms`, `wide_bound_ms`,
`wide_bound_by`, `wide_max_abs_err`, and `wide_launches` from
[ni-wide-main]) and their [ni-wider] figures (the same keys as `wider_*`,
`wider_plain_rows` the rows of the plain versions' timed run, and
`wider_launches` from [ni-wider-main]); the four fe kernels' carry their
[fe-wide-kernels] figures as `wide_*` (`wide_plain_rows` likewise, and
`wide_launches` from [fe-wide-main]); g_harm's and force_harm's carry
their [fe-widest] figures as `widest_*` (`widest_tile`
kernels.HARM_TILE). The records `ni_g_tiles`, `ni_force_tiles` and
`ni_force_tiles_sum` are the ni pair's cross-tile instances at
[ni-widest]'s shape (`tile` kernels.NI_TILE), their launches [ni-widest]'s
CLI run's (ni_force_tiles' unit kernel and its sum kernel once a chunk of
kernels.ni_scratch_rows rows; ni_force_tiles' `ms` the whole function,
both kernels, ni_force_tiles_sum's the sum kernel's share); the first two
also carry [ni-wider]'s crossover (`crossover_shape`, `crossover_ms`
their time on the one-warp kernels' planes, `crossover_one_warp_ms` the
one-warp kernels', `crossover_err_vs_one_warp` their max abs difference
from the one-warp kernels' outputs). Its
`launches` add the new paths'
runs ([multi-fe]'s and [rowsweep]'s Simulators, [multi-ni]'s,
[thin-box]'s Simulator and FIRE, [cli-multi], the seven sharded runs, the
ranks' and the in-process references' runs of the across-process tags,
[disloc-core], [scale-500k], [scale-2m], [ni-wide-main], [fe-wide-main],
[ni-wider-main], the [*-widest] CLI runs and [anna-widest]'s f32
evaluations, and the [script-*] runs) to the main paths';
g_harm's and force_harm's also carry
their times and bounds on the scale scenes (`scale_500k_ms`,
`scale_500k_bound_ms`, `scale_500k_bound_by`, and the same for `2m`). Prints
the kernels' JSON record on the line before the last, and as the last line
{"ok": true, "device": {...}}. Run from the repository root:
`python3 chip_smoke.py`.
"""
import concurrent.futures
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
# the wide ni path ([ni-wide-*]): the ni scene on a synthetic BP potential
# of the shipped table shape at Rc 6.0 A, whose rows hold ~86-100 partners
# within Rc + NI_DELTA (fcc: 86 within 6.2 A)
NI_WIDE_RC = 6.0    # A
NI_WIDE_KS, NI_WIDE_CAPACITY, NI_WIDE_CELL_CAPACITY = 128, 128, 64
NI_WIDE_BLOCKS, NI_WIDE_RATE_BLOCKS = 10, 7
# [ni-wide-kernels]: the f64 kernels run on every row and are held against
# the plain versions on every 4th (the plain f64 pair loop over all
# 256,000 rows costs ~20 s of the smoke)
NI_WIDE_F64_STRIDE = 4
NI_WIDE_PLAIN_ROWS = 65536   # rows of its plain versions (of 256,000)
# rows of 257-512 partners (kernels.MAX_K = NI_MAX_K = 512): bcc Fe holds
# 330 lattice partners within 9.7 A (338 within rc + SHORT_DELTA, 410
# within rc + FE_WIDE_SKIN), fcc Ni 320 within 9.2 A (368 within 9.9 A)
FE_WIDE_RC = 9.7    # A
FE_WIDE_KS, FE_WIDE_SKIN = 384, 0.8
FE_WIDE_CAPACITY, FE_WIDE_CELL_CAPACITY = 512, 256
FE_WIDE_BLOCKS, FE_WIDE_RATE_BLOCKS = 5, 3
WIDE_F64_STRIDE = 4    # rows of the wide tags' f64 plain versions
WIDE_ROWS = 8192    # rows of the wide cos and ni plain versions
WIDE_PAD_ROWS = 2048   # rows of the K 512 checks (filler lanes)
NI_WIDER_RC, NI_WIDER_CELLS = 9.2, 16     # A; 16,384 atoms
NI_WIDER_KS, NI_WIDER_CAPACITY, NI_WIDER_CELL_CAPACITY = 352, 448, 192
NI_WIDER_BLOCKS = 2                       # 10 NVT steps
# rows of more than 512 partners (the harmonic pair as virtual rows of
# kernels.HARM_TILE slots, the ni pair through its cross-tile instances in
# kernels.NI_TILE-slot tiles): bcc Fe holds 608 lattice partners within
# 12.0 A (700 within 12.4), fcc Ni 602 within 11.5 A
FE_WIDEST_RC, FE_WIDEST_SKIN = 12.0, 0.4
FE_WIDEST_CAPACITY, FE_WIDEST_CELL_CAPACITY = 896, 320
FE_WIDEST_CLI_STEPS = 10
NI_WIDEST_RC, NI_WIDEST_CELLS, NI_WIDEST_SKIN = 11.5, 16, 0.5
NI_WIDEST_CAPACITY, NI_WIDEST_CELL_CAPACITY = 896, 320
NI_WIDEST_CLI_STEPS = 5
# [anna-widest]: the synthetic .anna of the shipped widths at cut 11.5 A on
# thermal bcc 16^3 cells (8,192 atoms, box 45.7 A): 536 lattice partners
# within cut, 608 within cut + 0.3
ANNA_WIDEST_CUT, ANNA_WIDEST_CELLS = 11.5, 16
ANNA_WIDEST_CAPACITY, ANNA_WIDEST_CELL_CAPACITY, ANNA_WIDEST_KS = \
    768, 448, 640
WIDEST_ROWS = 2048     # rows of the widest tags' plain comparisons
# run path (`python -m meng_zhang_tpu_torch`, run.main in this process)
CLI_FE_STEPS, CLI_FE_RESTART_STEPS, CLI_THERMO = 40, 20, 10
CLI_NI_STEPS, CLI_NI_THERMO = 20, 5
SCREW_REPLICATE = 10       # the screw scene's z (one Burgers vector, 2.47 A):
                           # 24.7 A, 3 cells of rc + skin for the cell list
FIRE_FTOL = 0.1            # eV/A, the --min-ftol of the [minimize] CLI run
# ANNA-ADP scene (scripts/model_bench.py --model anna): perfect bcc 40^3
# cells, 128,000 atoms, NVE from 300 K velocities
ANNA_CELLS, ANNA_T = 40, 300.0
ANNA_SKIN, ANNA_CAPACITY, ANNA_CELL_CAPACITY = 0.5, 96, 48
ANNA_KS, ANNA_DELTA, ANNA_EVERY, ANNA_BLOCKS = 72, 0.2, 5, 20
ANNA_DISP = 0.08    # A per component, the thermal box of [anna-kernel/eval]
CLI_ANNA_STEPS, CLI_ANNA_THERMO = 20, 5
ANNA_MIN_CELLS, ANNA_MIN_FTOL = 6, 0.05     # the small box of the FIRE run
# multi-element and thin-box paths
MULTI_BLOCKS, MULTI_RATE_BLOCKS = 10, 7     # [multi-fe] NPT blocks
MULTI_NI_BLOCKS = 2                         # [multi-ni] NVT blocks
CLI_MULTI_STEPS = 20
THIN_PBC = (False, False, True)    # the screw scene: periodic along the line
THIN_IMAGES = 9                    # 2 ceil((rc + skin) / b) + 1 z-images
THIN_BLOCKS, THIN_RATE_BLOCKS = 10, 7
# image mode against the z-replicated scene, both f64 through the kernels:
# one evaluation of the same pairs in another order, so rounding alone
# (~1e-14 relative on the full scene, see MATRIX_*) separates them
THIN_REL = 1e-9
# The f32 kernel path against the f64 plain path in image mode: EVAL_REL,
# but for W. The screw cell's per-atom virial carries the same f32 bias as
# the slab's (~1e-4 eV an atom from the normalisation, see EVAL_REL), over
# a smaller sum |dx Fj| (0.32 against 0.78 eV an atom): f32 arithmetic
# alone reads 3.6e-4 of that scale, through the plain path on a CPU. The
# kernels' own rounding (~4e-6 relative, REL_BOUND's measurements) is far
# below that bias, so the kernel path's W error is held to 2x the plain
# f32 path's on the same inputs, measured in the same run.
THIN_W_OVER_PLAIN = 2.0
# The elems-blind evaluation (every atom through element 1's network) must
# differ from the selected one by far more than the f32 path's error: by
# more than 100 times the difference the f32 kernels read against the f64
# plain path, and by more than 10 times that difference's bound. (Element
# 2's weights are element 1's times 1 + 0.02 N(0, 1): on a 768-atom slab
# of the fe potential through the plain path on a CPU, the blind forces
# differ by 6.8 % of max|F|, 68x the max_dF bound, and f32 by 1.8e-5.)
BLIND_OVER_ERR, BLIND_OVER_BOUND = 100.0, 10.0

# the sharded drivers (parallel/domain.py, domain2d.py, domain3d.py), one
# card
SHARD_D = 4                    # slabs on the one card
SHARD_BLOCKS = 10              # [shard-fe], [shard-ni] and their grids' blocks
SHARD_ANNA_BLOCKS = 5          # [shard-anna], [shard2d-anna] NVE blocks
SHARD_T_STEPS = 20             # steps held against the single-device run
SHARD_MIGRATE_B = 512          # rows merged at each slab boundary at a
                               # rebuild of [shard-fe]'s run
SHARD_SLAB_X = 92.0            # [shard(2d)-fe]'s f64 slab: the atoms below
                               # it (A)
# [shard-anna]'s NVE run from the perfect lattice: bc 8,192 rows, 5.12 of
# its (100) planes (1,600 atoms, 1.428 A apart). The derived 6,808 rows
# (4.26 planes) leave the plane that ends the frame 5.71 A from the plane
# that ends the centre rows, 0.16 A beyond rlist 5.555 A, and thermal
# motion trips the coverage proof at the first rebuild (on an H100 at
# 700 W, 25 steps from 300 K velocities); one plane more leaves 1.59 A.
SHARD_ANNA_HALO_B = 16384
# f64 sharded kernel path against the f64 single-device kernel path on the
# same atoms: the same pair terms summed in another order (lanes sorted by
# frame row instead of atom id, the D frames' virials added), so only
# rounding separates them: ~1e-14 of each output's scale (the matrix-vs-
# harmonic comparison above reads 3e-14 on the full scene); 1e-9 leaves
# 1e5x, and a lost or doubled pair moves F by ~1e-2 of max|F|.
SHARD_REL64 = 1e-9
# the sharded drivers across processes (parallel/launch.py): gloo ranks on
# the one card, the NCCL backend at one rank (and across cards when the
# machine has several)
DIST_WORLD = 4                 # [dist-fe], [dist3d-ni]: ranks on the card
DIST_BLOCKS = 2                # [dist-fe] NPT blocks
DIST_NI_BLOCKS = 2             # [dist3d-ni] NVT blocks
DIST_TIMEOUT = 600.0           # s, a launch's limit
# f64 forces of the ranks against the in-process evaluation of the same
# frames: the same kernel launches on the same local frames; only the
# order of index_add_'s atomic Fj adds differs, ~1e-16 of max|F| a row's
# few hundred terms; 1e-12 leaves 1e3x over that, and a lost or doubled
# halo row moves F by ~1e-2 of max|F|.
DIST_REL64 = 1e-12
# the scale configurations (meng_zhang_tpu_torch/scripts/): full atom
# counts, the timed steps cut
SCALE_500K_STEPS = 60      # NPT steps after the warm-up (the script's 200)
SCALE_2M_STEPS = 30        # NVE steps after the warm-up (the script's 100)
SCALE_2M_WARMUP = 5        # [scale-2m]'s warm-up blocks (the script's 10)
SCALE_SLICE = 20000        # short rows of each kernel-vs-plain check
STGB_PLANE_X = 230.0       # A, the 2m scene's middle grain boundary
# the run scripts (meng_zhang_tpu_torch/scripts/): full scenes, steps cut
SCRIPT_MODEL_STEPS = {"kernels": 20, "chunked": 10}   # the script's 100
SCRIPT_SHARDED_SMALL_STEPS = 200                      # the script's 1000
SCRIPT_PARITY_STEPS = 100      # [script-sharded-small]'s gated window
SCRIPT_HALO_CPU_CELLS = 40     # [script-halo]'s card-vs-CPU planning
SCRIPT_HALO_CELLS = 64         # [script-halo]'s planning run (the script's 100)
SCRIPT_BENCH_STEPS = 100       # [script-bench]'s timed steps (the script's 500)
U32 = 2.0 ** -24               # f32 unit roundoff


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
# The cos pair at [fe-wide-kernels]'s rows of up to 383 partners (K 384,
# and K 512 with filler lanes), by the counts above: g_cos's thread sums
# <= n/2 = 192 terms of its own lane and <= 21 dealt ones, then 5 shuffle
# levels and <= 16 warp partials, with the recurrence's 180: <= 414
# roundings, 2.5e-5 of G_0, and the plain version as many: 1e-4 leaves
# 2x. force_cos's slot sums run <= 192 partners a chain plus the
# recurrences' 180: 373 roundings, 2.2e-5 of the sum; the plain version's
# one reduction over <= 383 partners plus 180: 3.4e-5; 5.6e-5 apart, and
# the same 8x for Fj's cancellation: 4.5e-4, so 5e-4. f64: <= 1.1e-13;
# 1e-12 leaves 9x. The harmonic pair keeps REL_BOUND: its longest sums
# (the plain versions' over <= 512 lanes, the kernels' <= 16 slots a lane,
# 5 shuffles and the second tile's add) stay within ~500 terms, 3e-5.
COS_WIDE_REL_BOUND = {torch.float32: {"g_cos": 1e-4, "force_cos": 5e-4},
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
#     At K 128 (the wide path, ~86 partners and ~2,000 listed pairs a row,
#     at most 8,128): a lane's sum takes <= 64 of them across the tiles,
#     <= 79 roundings; the plain version's 128-step loop and 128-lane sum
#     <= 266: <= 2.1e-5 apart.
#   ni_force: a lane's four sums take <= 31 pair contributions (its
#     partners) in any order, each a dot product over the table's (eta
#     group, shape) weights (24 terms) times ~20 roundings of factors: <= 75,
#     4.5e-6 of the largest sum; the plain version's q loop as much. The
#     radial, u_p and u_q parts of Fj cancel: allow the largest Fj to sit 8x
#     under the largest part: 7.2e-5. At K 128 a slot's sums take <= 127
#     contributions: <= 171 roundings a side, 2.1e-5 apart, 1.6e-4 with the
#     same 8x (a worst case; rounding errors add at random, so the run reads
#     far less).
# 2e-4 leaves ~3x over ni_force's figure at K 32 (30x over ni_g's), 1.25x at
# K 128; in f64 the same counts at 1.1e-16 give <= 3e-13, and 1e-12 leaves
# 3x.
NI_REL_BOUND = {torch.float32: 2e-4, torch.float64: 1e-12}
# [ni-wider]'s rows of up to 351 partners (Ks 352, and 512 with filler
# lanes), by the same counts: ni_force's slot sums take <= 351
# contributions, <= 395 roundings a side, 4.7e-5 apart, 3.8e-4 with the 8x;
# ni_g's lane sums take <= ~850 listed pairs (~24,000 a row over 32 lanes)
# and the plain version's loop and sum <= 704, 9.3e-5 apart. So 4e-4; in
# f64 the same counts give <= 7e-13, under 1e-12.
NI_WIDER_REL_BOUND = {torch.float32: 4e-4, torch.float64: 1e-12}
# The ni pair's cross-tile instances at [ni-widest]'s rows of up to ~660
# partners inside Rc (K 768, T 6 tiles of 128 slots, U 21 units), by the
# same counts. ni_force: within a unit a slot's sums take its partners in
# the unit's other tile (<= 128) one a round, or as a key slot a 5-level
# shuffle tree a round and <= 4 rounds in order; within its own tile's
# unit (a, a) both roles add to one sum (<= 127 partners); the sum kernel
# then adds the T partials in tile order: <= ~140 roundings, ~184 with the
# factors' 44. The plain version's q loop adds <= 660 contributions, 704
# roundings: 4.2e-5 of the largest sum, so <= 5.3e-5 apart, 4.3e-4 with
# the 8x for Fj's cancellation. ni_g: a unit lists each unordered pair of
# its two tiles once, <= ~7,700 at ~120 partners a tile, ~30 pair tiles of
# <= 256; a lane adds its <= 64 pairs of 8 pair tiles as <= 32 sums of
# two, the transposed tree 5 levels, lane e the <= 4 batch sums in list
# order, and the wrapper the U unit partials in unit order: <= ~73
# roundings with the term's ~10, 4.4e-6 of the column (G4's terms are all
# positive; the 2^(1 - zeta) factor after the sum is exact); the plain
# version's 660-step loop and sums over the lanes <= 1,000, 6e-5. So 7e-4
# keeps ~1.6x over ni_force's
# figure (1e-3 for the card tests' rows of up to ~880 partners,
# tests/test_torch_cuda.py NI_TILES_RTOL); in f64 the same counts give
# <= 1.4e-12: 2e-12.
NI_WIDEST_REL_BOUND = {torch.float32: 7e-4, torch.float64: 2e-12}
# The widest tags' f32 paths (the chunked functions, ANNA-ADP's
# functions) against f64 on the same rows: beside their kernels' rounding
# (~4e-6 of the kernels' outputs in f32, the checks above) both the
# kernel path and the plain path carry the same dominant f32 error, the
# network inputs' (EVAL_REL: normalisation subtracts a mean up to ~30 from
# sums with a spread of ~0.1), which grows with the rows' partners (~610
# here, 5x phase 4's). So E, F and W of the f32 kernel path are held to
# WIDEST_OVER_PLAIN times the f32 plain path's own difference from the f64
# reference, measured in the same run on the same rows (as
# THIN_W_OVER_PLAIN): the two differ by the order of their sums alone, so
# their differences are draws of one size, and 3x leaves room for the
# larger draw; sum F keeps its rounding bound (EVAL_REL["sum_F"]). The ni
# pair has no such shared error (min-max normalisation adds ~2.4x the raw
# sums' rounding, NI_EVAL_REL): each path's own rounding of the G4 sums
# leads, reaching every pair term of a row alike through dE/dG, and W,
# the sum over ~10^7 pairs, takes it coherently. So its ratio follows the
# G4 sums' chains: ni_g_tiles' (<= ~73 roundings, NI_WIDEST_REL_BOUND)
# are shorter than the plain version's (~600-step q loops), and 3x holds
# for it too. With one running sum a lane across the row (~1,350 terms)
# the kernel's max dW read 3.9x the plain path's; see PERF.md.
WIDEST_OVER_PLAIN = 3.0
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
# ANNA fast path (make_anna_fast_fns) on the thermal 128,000-atom box, f32
# through g_harm against f64 on its plain version, each bound relative to
# the scale of what it measures (u = 6e-8 in f32). Phase 1 forms the
# angular G from power sums S_l ~ (sum fc)^2 and subtracts (g_harm's f32
# outputs agree with the plain version's to ~4e-6 of their largest value),
# and the first layer divides G by its spread over thermal boxes, so
# (d2, q2) carry ~3e-6 relative (1.2e-6 of 0.39 /A with plain f32 on a
# 3,456-atom box on a CPU), 10x more with the kernel's rounding.
#   dE_per_atom <= 1e-5 * |E/N|: an atom's energy sums ~58 pair terms of
#     ~20 roundings each over terms whose sizes reach a few |E/N|: ~4e-6
#     of |E/N| in the worst case, plus the (d2, q2) error through the
#     angular terms; the CPU read 7e-8 (it averages over the atoms);
#   max_dF <= 3e-4 * max|F|: a force sums ~58 pair terms, each a difference
#     of two centred terms of up to ~|F|: ~90 roundings on ~10 |F| of terms,
#     5e-5, plus (d2, q2)'s ~3e-5; the CPU read 2.8e-6;
#   max_dW <= 3e-4 * max|W|: W inherits the pair terms' relative error,
#     which (d2, q2)'s shared bias adds up over the pairs; the CPU read
#     4.5e-6 (W ~ +20 kbar, no cancellation to speak of);
#   sum_F <= 1e-6 * N * rms|F|: every pair's term enters its two atoms'
#     forces with opposite signs (newton-off: the same two centred terms
#     at both ends), so only rounding remains; one lost pair would leave
#     ~rms|F| and fail it.
ANNA_EVAL_REL = {"dE_per_atom": 1e-5, "max_dF": 3e-4, "max_dW": 3e-4,
                 "sum_F": 1e-6}
# the fast path against the reference-shaped energy_forces_virial in f64
# on a 432-atom box: the CPU tests' bars (tests/test_torch_anna.py)
ANNA_REF = {"E_rtol": 1e-10, "F_rtol": 1e-8, "F_atol": 1e-10,
            "W_rtol": 1e-8, "W_atol": 1e-9}
# The [cli-anna] dump's c_pe summed over its 432 atoms against the thermo
# PotEng: both come from the same f32 atom energies, e_base included,
# and the thermo row's shift-free sum takes f32(e_base) out exactly
# (Sterbenz); so the sum of c_pe less n f32(e_base) differs from the row
# less n e_base by the dump's 8 significant digits (5e-5 eV at
# |e_i| ~ 4.5e3 eV, 0.022 eV over 432 atoms at worst), the row's printed
# 4 decimals and the f32 sum's rounding (~1e-4): 0.05 eV.
ANNA_PE_SUM_ATOL = 0.05
# the kernels' plain versions, none of which may run on the card
PLAIN_VERSIONS = (("fused_annp", "g_harm_plain"),
                  ("fused_annp", "force_harm_plain"),
                  ("fused_annp", "g_cos_plain"),
                  ("fused_annp", "force_cos_plain"),
                  ("fused_ni", "ni_g_plain"), ("fused_ni", "ni_force_plain"),
                  ("fused_ni", "ni_g_tiles_plain"),
                  ("fused_ni", "ni_force_tiles_plain"),
                  ("fused_ni", "ni_force_tiles_part_plain"),
                  ("fused_ni", "ni_force_tiles_sum_plain"))


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


def md_config(cfg, skin=SKIN, capacity=CAPACITY,
              cell_capacity=CELL_CAPACITY):
    """The fe NPT main path's MDConfig; [fe-wide-main] passes its own skin
    and capacities."""
    from meng_zhang_tpu_torch.md.simulation import MDConfig
    from meng_zhang_tpu_torch.system.neighbors import cell_grid_dims
    rlist = cfg.cut + skin
    # NPT shrinks the box: size the static cell grid for up to 8% shrink
    dims = cell_grid_dims(np.asarray(BOX) * 0.92, rlist)
    return MDConfig(dt=0.001, cutoff=cfg.cut, skin=skin, capacity=capacity,
                    nbr_method="cell", cell_dims=dims,
                    cell_capacity=cell_capacity, ensemble="npt",
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
            # the cos plain versions build a [K, K] matrix a row: they are
            # held on every fourth row, but for the f32 short planes (the
            # records' shape)
            rows = slice(None, None, COS_SKIN_F64_STRIDE) \
                if (name in COS_REL_BOUND[dtype]
                    and (dtype == torch.float64 or note)) else slice(None)
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
            ms = cuda_ms(lambda: kern(pl, slice(None)), 10)
            if not in_record:
                log(f"[kernels] {name} f32 [{pl[0].shape[0]}, "
                    f"{pl[0].shape[1]}] {note}: kernel {ms:.3f} ms (median, "
                    "CUDA events; not in the record)")
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


def phase_evaluator(x, box, cfg32, p32, cfg64, p64, sl, angular="harmonic",
                    elems=None, pot=None, tag=None, ref_out=None):
    """Kernel path in f32 against the plain path in f64, same short list;
    on the harmonic path then the f64 kernel path against the autograd
    model on a small box. elems: the atoms' elements (a multi-element
    potential `pot`; the small box then takes types 50/50 from SEED).
    ref_out: a list that receives the f64 plain path's (E, F, W) and the
    virial's scale, for [shard-fe]'s gates."""
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
    from meng_zhang_tpu_torch.testing import thermal_bcc
    if tag is None:
        tag = "evaluator" if angular == "harmonic" else "cos-evaluator"
    n = x.shape[0]
    dev = x.device
    ev32 = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT, short_delta=SHORT_DELTA,
                        angular=angular, elems=elems)
    ev64 = fa.FusedAnnp(cfg64, p64, k_short=K_SHORT, short_delta=SHORT_DELTA,
                        plain=True, angular=angular, elems=elems)
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
    fj = ev32._eval_fj(*dd, elems)[1]
    w_abs = max(float((da.double() * fb.double()).abs().sum())
                for da in dd for fb in fj)
    del dd, fj
    vol = BOX[0] * BOX[1] * BOX[2]
    log(f"[{tag}] N {n}: E/N f64 {float(e64) / n + cfg64.e_shift:.9f} eV"
        f" (shift-free {float(e64) / n:.6e}); RMS F {f_rms:.4e} eV/A; max|F|"
        f" {float(f64.abs().max()):.4e} eV/A; virial pressure "
        f"{float(torch.trace(w64)) / 3 / vol * 1.6021765e6:.1f} bar")
    got = eval_gates(tag, EVAL_REL, (e32, f32, w32), (e64, f64, w64), w_abs)
    if ref_out is not None:
        ref_out.extend((e64, f64, w64, w_abs))
    if angular != "harmonic":
        return got

    xs, bs = thermal_bcc(5, seed=SEED, disp=0.08)
    xs = torch.tensor(xs, dtype=torch.float64, device=dev)
    bs = torch.tensor(bs, dtype=torch.float64, device=dev)
    cfg_p, p_p = annp.make_annp(pot or _potential(), torch.float64, dev)
    el = None if elems is None else torch.as_tensor(
        np.random.default_rng(SEED).integers(0, 2, xs.shape[0]), device=dev)
    nb = build_neighbors_n2(xs, bs, cfg_p.cut, K_SHORT)
    check(not bool(nb.overflow), "small box: neighbor overflow")
    e_k, f_k, _ = fa.FusedAnnp(cfg_p, p_p, k_short=K_SHORT,
                               elems=el).energy_forces(xs, bs, nb.idx)
    e_a, f_a = annp.energy_forces(cfg_p, p_p, xs, bs, nb.idx, el)
    e_a = float(e_a) - xs.shape[0] * cfg_p.e_shift       # shift-free
    de = abs(float(e_k) - e_a) / abs(e_a)
    df = float((f_k - f_a).abs().max())
    log(f"[{tag}] 250-atom box, f64 kernels vs autograd model: rel dE "
        f"{de:.3e} (bound {REF_E_RTOL:.0e}), max dF {df:.3e} eV/A (bound "
        f"{REF_F_ATOL:.0e})")
    check(de <= REF_E_RTOL and df <= REF_F_ATOL,
          f"{tag}: kernel path disagrees with the autograd model on the "
          "small box")
    return got


def eval_gates(tag, rel, out32, out64, w_abs):
    """The evaluator gates: (E, F, W) of the f32 kernel path against the
    f64 plain path, each difference within rel[key] of its scale (W's:
    w_abs = max_ab sum_pairs |dx_a Fj_b|). Returns the differences."""
    (e32, f32, w32), (e64, f64, w64) = out32, out64
    n = f64.shape[0]
    got = {"dE_per_atom": abs(float(e32) - float(e64)) / n,
           "max_dF": float((f32.double() - f64).abs().max()),
           "max_dW": float((w32.double() - w64).abs().max()),
           "sum_F": float(f32.double().sum(0).abs().max())}
    scale = {"dE_per_atom": abs(float(e64)) / n,
             "max_dF": float(f64.abs().max()), "max_dW": w_abs,
             "sum_F": n * float(f64.pow(2).mean().sqrt())}
    for key, r in rel.items():
        bound_abs = r * scale[key]
        log(f"[{tag}] {key} {got[key]:.3e} (bound {bound_abs:.3e} = "
            f"{r:.0e} x {scale[key]:.4e})")
        check(got[key] <= bound_abs, f"{tag} {key} {got[key]:.3e} over "
              f"{bound_abs:.3e}")
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


def fe_simulator(x, cfg32, p32, mass, angular, elems=None, mcfg=None,
                 k_short=K_SHORT):
    """The fe NPT main path's Simulator through one angular path; mass a
    number or the atoms' masses, elems the atoms' elements, mcfg the
    MDConfig (default md_config), k_short the short rows' width."""
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    ev = fa.FusedAnnp(cfg32, p32, k_short=k_short, short_delta=SHORT_DELTA,
                      angular=angular, elems=elems)
    masses = torch.as_tensor(mass, dtype=torch.float32, device=x.device)
    return Simulator(
        lambda xx, bb, nb, sh: ev.energy_forces_short(xx, bb, sh),
        masses.expand(x.shape[0]).contiguous(), mcfg or md_config(cfg32),
        short_build=lambda xx, bb, nb: ev.compact_short(xx, bb, nb.idx))


def phase_main_path(x, box, cfg32, p32, mass, card, angular="harmonic",
                    elems=None, tag=None, n_blocks=None, rate_blocks=None,
                    wide=False):
    """init_state + blocks of the NPT main path through one angular path's
    kernels (elems: the atoms' elements, with `mass` their masses); the
    other path's kernels and the plain versions must not run. Returns the
    path's launches, its atom-steps/s over the rate window and its median
    block's ms (a block without a skin rebuild). wide: [fe-wide-main], the
    harmonic path at the sizes of the rc FE_WIDE_RC potential."""
    from meng_zhang_tpu_torch.ops import kernels
    if angular == "harmonic":
        tag0, nb0, rb0 = "main", N_BLOCKS, RATE_BLOCKS
        names, others = ("g_harm", "force_harm"), ("g_cos", "force_cos")
    else:
        tag0, nb0, rb0 = "cos-main", COS_BLOCKS, COS_RATE_BLOCKS
        names, others = ("g_cos", "force_cos"), ("g_harm", "force_harm")
    ks, mcfg = K_SHORT, None
    if wide:
        tag0, nb0, rb0 = "fe-wide-main", FE_WIDE_BLOCKS, FE_WIDE_RATE_BLOCKS
        ks, mcfg = FE_WIDE_KS, fe_wide_md_config(cfg32)
    tag, n_blocks = tag or tag0, n_blocks or nb0
    rate_blocks = rate_blocks or rb0
    n = x.shape[0]
    sim = fe_simulator(x, cfg32, p32, mass, angular, elems, mcfg, ks)
    pe_off = n * cfg32.e_shift
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    with plain_calls() as plain:
        st = sim.init_state(x, box, seed=SEED, t_init=300.0)
        torch.cuda.synchronize()
        log(f"[{tag}] init_state {time.time() - t0:.2f} s")
        rebuilds, rows, block_s, srow_max, krow_max = 0, [], [], 0, 0
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
            srow_max = max(srow_max, srow)
            krow_max = max(krow_max, int((st.nbrs.idx < n).sum(1).max()))
            log(f"[{tag}] step {int(row[0]):4d} T {row[1]:8.3f} K  PE "
                f"{row[2] + pe_off:.6f} eV  P {row[4]:9.2f} bar  box "
                f"{b[0]:.4f} {b[1]:.5f} {b[2]:.4f}  conserved "
                f"{row[6]:.6e}  short row max {srow}/{ks}  "
                f"{block_s[-1] * 1e3:.1f} ms")
    launches = {name: getattr(kernels, name).launches
                for name in names + others}
    steps = n_blocks * THERMO_EVERY
    check(not plain, f"{tag}: plain versions ran on the card: {plain}")
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
        f"{launches}, overflow {bool(st.overflow)} unsafe {bool(st.unsafe)}"
        f"; widest short row {srow_max}/{ks}, widest skin row {krow_max}/"
        f"{sim.cfg.capacity}")
    log(f"[{tag}] {aps:.1f} atom-steps/s over the last {rate_blocks} blocks "
        f"({window:.3f} s) on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return ({name: launches[name] for name in names}, aps,
            float(np.median(block_s)) * 1e3)


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


# --------------------------------------------------- fe, wide rows
def fe_wide_model(dev):
    """(cfg32, p32, mass) of the synthetic fe potential of the shipped
    widths at rc FE_WIDE_RC."""
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.testing import synthetic_fe_potential
    pot = synthetic_fe_potential(0, cut=FE_WIDE_RC)
    cfg32, p32 = make_annp(pot, torch.float32, dev, pbc=PBC)
    return cfg32, p32, float(pot.masses[0])


def fe_wide_md_config(cfg):
    return md_config(cfg, FE_WIDE_SKIN, FE_WIDE_CAPACITY,
                     FE_WIDE_CELL_CAPACITY)


def pad_lanes(planes, filler, box, k):
    """[P, K] planes and filler mask widened to k lanes with filler lanes
    (dx = 2 box + 10 on each axis)."""
    p, k0 = planes[0].shape
    out = [torch.cat([t, torch.full((p, k - k0), 2.0 * float(b) + 10.0,
                                    dtype=t.dtype, device=t.device)], 1)
           for t, b in zip(planes, box)]
    return out, torch.cat([filler, torch.ones((p, k - k0), dtype=torch.bool,
                                              device=filler.device)], 1)


def phase_fe_wide_kernels(x, box, cfg32, p32):
    """[fe-wide-kernels]: the four fe kernels on the benchmark scene's
    short planes at Ks FE_WIDE_KS on the rc FE_WIDE_RC potential (~330-360
    partners a row: g_harm's two-tile instances, force_harm's rows over
    two blocks, the cos pair's 16-warp blocks), against their plain
    versions in f32 and f64 (f64 on every WIDE_F64_STRIDE-th row): the
    harmonic pair on every row, the cos pair (whose plain versions build a
    [K, K] matrix a row) on the first WIDE_ROWS rows; then the first
    WIDE_PAD_ROWS rows widened to kernels.MAX_K = 512 by filler lanes (the
    widest instances). Each kernel's f32 time on every
    row (median of 10, CUDA events) and its bound. Returns the wide
    figures of each kernel's record."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    tag = "fe-wide-kernels"
    n = x.shape[0]
    mcfg = fe_wide_md_config(cfg32)
    t0 = time.time()
    nbrs = build_neighbors_cell(x, box, cfg32.cut + FE_WIDE_SKIN,
                                FE_WIDE_CAPACITY, mcfg.cell_dims,
                                FE_WIDE_CELL_CAPACITY, pbc=PBC)
    ev = fa.FusedAnnp(cfg32, p32, k_short=FE_WIDE_KS,
                      short_delta=SHORT_DELTA)
    sl = ev.compact_short(x, box, nbrs.idx)
    torch.cuda.synchronize()
    skin_max = int((nbrs.idx < n).sum(1).max())
    short_max = int((sl.sidx < n).sum(1).max())
    log(f"[{tag}] rc {cfg32.cut} A: skin list dims {mcfg.cell_dims} "
        f"overflow {bool(nbrs.overflow)} max row {skin_max}/"
        f"{FE_WIDE_CAPACITY}; short list overflow {bool(sl.overflow)} max "
        f"row {short_max}/{FE_WIDE_KS} ({time.time() - t0:.2f} s)")
    check(not bool(nbrs.overflow) and not bool(sl.overflow),
          f"{tag}: neighbor list overflow")
    check(short_max > 256, f"{tag}: no short row wider than 256 lanes")
    del nbrs
    npsf, ntsf, rc = cfg32.npsf, cfg32.ntsf, cfg32.cut
    planes32 = fa.pair_dx_planes(x, box, sl.sidx, PBC)
    filler = sl.sidx >= n
    p, k = planes32[0].shape
    lanes, pairs = fe_counts(planes32, rc)
    log(f"[{tag}] {lanes:.0f} lanes and {pairs:.0f} unordered pairs inside "
        f"{rc} A ({lanes / p:.2f} lanes a row)")
    rows, pad_rows = slice(0, WIDE_ROWS), slice(0, WIDE_PAD_ROWS)
    wide32, fill_wide = pad_lanes([t[pad_rows] for t in planes32],
                                  filler[pad_rows], box.tolist(),
                                  kernels.MAX_K)
    rng = np.random.default_rng(SEED)
    dedg_np = np.zeros((p, fa.NSF_PAD))
    dedg_np[:, :npsf + ntsf] = rng.normal(size=(p, npsf + ntsf))
    b_np = np.zeros((p, fa.AB_PAD))
    b_np[:, :ntsf * ntsf + 1] = rng.normal(size=(p, ntsf * ntsf + 1))
    figs = {}
    for dtype in (torch.float32, torch.float64):
        planes = [t.to(dtype) for t in planes32]
        wide = [t.to(dtype) for t in wide32]
        dedg = torch.tensor(dedg_np, dtype=dtype, device=x.device)
        b = torch.tensor(b_np, dtype=dtype, device=x.device)
        bounds = {"g_harm": REL_BOUND[dtype], "force_harm": REL_BOUND[dtype],
                  **COS_WIDE_REL_BOUND[dtype]}
        sub = f"{tag} " + ("f32" if dtype == torch.float32 else "f64")
        # each: (kernel, plain version, outputs), on planes and the rows
        # of dedg and b that go with them
        fns = {
            "g_harm": (lambda pl, r: kernels.g_harm(*pl, npsf, ntsf, rc),
                       lambda pl, r: fa.g_harm_plain(*pl, npsf, ntsf, rc),
                       ("g_raw", "A")),
            "force_harm": (
                lambda pl, r: kernels.force_harm(
                    *pl, dedg[r].contiguous(), b[r].contiguous(), npsf, ntsf,
                    rc),
                lambda pl, r: fa.force_harm_plain(*pl, dedg[r], b[r], npsf,
                                                  ntsf, rc),
                ("fjx", "fjy", "fjz")),
            "g_cos": (lambda pl, r: (kernels.g_cos(*pl, npsf, ntsf, rc),),
                      lambda pl, r: (fa.g_cos_plain(*pl, npsf, ntsf, rc),),
                      ("g",)),
            "force_cos": (
                lambda pl, r: kernels.force_cos(
                    *pl, dedg[r].contiguous(), npsf, ntsf, rc),
                lambda pl, r: fa.force_cos_plain(*pl, dedg[r], npsf, ntsf,
                                                 rc),
                ("fjx", "fjy", "fjz"))}
        for name, (kern, plain, outs) in fns.items():
            step = 1 if dtype == torch.float32 else WIDE_F64_STRIDE
            cmp_rows = (slice(0, WIDE_ROWS, step)
                        if name in COS_REL_BOUND[dtype]
                        else slice(None, None, step))
            cpl = [t[cmp_rows].contiguous() for t in planes]
            got = kern(cpl, cmp_rows)
            ref, plain_ms = timed(lambda: plain(cpl, cmp_rows))
            worst = compare(sub, f"{name} [{cpl[0].shape[0]}, {k}]", outs,
                            got, ref, bounds[name], filler[cmp_rows])
            del got, ref, cpl
            compare(sub, f"{name} [{WIDE_PAD_ROWS}, {kernels.MAX_K}]",
                    outs, kern(wide, pad_rows), plain(wide, pad_rows),
                    bounds[name], fill_wide)
            if dtype != torch.float32:
                continue
            ms = cuda_ms(lambda: kern(planes, slice(None)), 10)
            b_ms, b_by = bound(fe_flops(name, lanes, pairs, npsf, ntsf),
                               fe_bytes(name, p, k, 4))
            plain_rows = p if name not in COS_REL_BOUND[dtype] else WIDE_ROWS
            figs[name] = {"wide_shape": [p, k], "wide_ms": ms,
                          "wide_plain_ms": plain_ms,
                          "wide_plain_rows": plain_rows,
                          "wide_bound_ms": b_ms, "wide_bound_by": b_by,
                          "wide_max_abs_err": worst}
            log(f"[{tag}] {name} f32 [{p}, {k}]: kernel {ms:.3f} ms (median "
                f"of 10, CUDA events), plain {plain_ms:.3f} ms on "
                f"{plain_rows} rows (one run), bound {b_ms:.3f} ms ({b_by})")
        del planes, wide, dedg, b
    return figs


# ------------------------------------------------------------------ ni
def ni_model(dev):
    """(cfg32, p32, cfg64, p64, mass) of the synthetic ni potential."""
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.testing import synthetic_ni_potential
    pot = synthetic_ni_potential(0)
    cfg32, p32 = make_annp(pot, torch.float32, dev)
    cfg64, p64 = make_annp(pot, torch.float64, dev)
    return cfg32, p32, cfg64, p64, float(pot.masses[0])


def ni_sizes(wide):
    """(Ks, skin-list capacity, cell capacity, fcc cells a side) of the ni
    path, of the wide ni path (wide=True) or of the wider one
    (wide="wider")."""
    if wide == "wider":
        return (NI_WIDER_KS, NI_WIDER_CAPACITY, NI_WIDER_CELL_CAPACITY,
                NI_WIDER_CELLS)
    return ((NI_WIDE_KS, NI_WIDE_CAPACITY, NI_WIDE_CELL_CAPACITY, NI_CELLS)
            if wide else (NI_KS, NI_CAPACITY, NI_CELL_CAPACITY, NI_CELLS))


def ni_wide_model(dev, rc=NI_WIDE_RC):
    """(cfg32, p32, mass) of the synthetic ni potential at Rc rc (A)."""
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.testing import synthetic_ni_potential
    from meng_zhang_tpu_torch.units import CFLENGTH
    pot = synthetic_ni_potential(0, rc_bohr=rc * CFLENGTH)
    cfg32, p32 = make_annp(pot, torch.float32, dev)
    return cfg32, p32, float(pot.masses[0])


def ni_md_config(rc, box, wide=False):
    from meng_zhang_tpu_torch.md.simulation import MDConfig
    from meng_zhang_tpu_torch.system.neighbors import cell_grid_dims
    _, capacity, cell_capacity, _ = ni_sizes(wide)
    return MDConfig(dt=0.001, cutoff=rc, skin=NI_SKIN, capacity=capacity,
                    nbr_method="cell",
                    cell_dims=cell_grid_dims(np.asarray(box), rc + NI_SKIN),
                    cell_capacity=cell_capacity, ensemble="nvt",
                    t_target=NI_T, tau_t=0.1, thermo_every=NI_THERMO_EVERY,
                    stale_factor=0.5, short_every=NI_SHORT_EVERY,
                    short_skin=NI_DELTA)


def ni_thermal_scene(dev, cfg32, p32, wide=False):
    """The ni scene with Gaussian displacements of NI_DISP A per component,
    its skin list and its short list (f32), at the ni path's sizes or the
    wide (or wider) path's."""
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    from meng_zhang_tpu_torch.testing import thermal_fcc
    ks, capacity, cell_capacity, cells = ni_sizes(wide)
    tag = {False: "ni", True: "ni-wide", "wider": "ni-wider"}[wide]
    xn, bn = thermal_fcc(cells, seed=SEED, disp=NI_DISP, a=NI_A)
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    ev = fn.FusedNi(cfg32, p32, k_short=ks, short_delta=NI_DELTA)
    mcfg = ni_md_config(ev.rc, bn, wide)
    t0 = time.time()
    nbrs = build_neighbors_cell(x, box, ev.rc + NI_SKIN, capacity,
                                mcfg.cell_dims, cell_capacity)
    sl = ev.compact_short(x, box, nbrs.idx)
    torch.cuda.synchronize()
    n = x.shape[0]
    log(f"[{tag}] thermal scene N {n} box {bn[0]:.2f} A: skin list dims "
        f"{mcfg.cell_dims} overflow {bool(nbrs.overflow)} max row "
        f"{int((nbrs.idx < n).sum(1).max())}/{capacity}; short list "
        f"overflow {bool(sl.overflow)} max row "
        f"{int((sl.sidx < n).sum(1).max())}/{ks} ({time.time() - t0:.2f} s)")
    check(not bool(nbrs.overflow) and not bool(sl.overflow),
          f"{tag}: neighbor list overflow on the thermal scene")
    return x, box, sl


def ni_counts(planes, rc_a):
    """(lanes inside the angular cutoff rc_a (Bohr), ordered legs (p, q),
    p != q, whose three legs lie inside it) on [P, K] planes: the ni
    kernels' work on this run's data."""
    from meng_zhang_tpu_torch.units import CFLENGTH
    lanes = legs = 0
    k = planes[0].shape[1]
    eye = torch.eye(k, dtype=torch.bool, device=planes[0].device)
    rows = max(1, 16384 * 32 * 32 // (k * k))     # ~1.2 GiB of djk a chunk
    for i0 in range(0, planes[0].shape[0], rows):
        d = torch.stack([t[i0:i0 + rows] for t in planes], -1).double()
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


def ni_plane_checks(tag, planes32, table, nsf, filler, f64_stride=1,
                    plain_rows=None, rel_bound=NI_REL_BOUND):
    """ni_g / ni_force against their plain versions on [P, K] planes
    (filler lanes included), with seeded random dedg, in f32 and f64 (the
    f64 kernels on every row, held against the plain versions on every
    f64_stride-th; with plain_rows, both dtypes on the first plain_rows
    rows alone); ni_g run twice for equal bits; then each kernel's f32
    time (median of 10, CUDA events), its plain version's (the comparison
    run) and its bound from this run's lanes and legs. Returns the two
    records."""
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    dev = planes32[0].device
    p, k = planes32[0].shape
    dedg_np = np.zeros((p, fn.NSF_SUB))
    dedg_np[:, :nsf] = np.random.default_rng(SEED).normal(size=(p, nsf))
    counts = ni_counts(planes32, table.rc_a)
    log(f"[{tag}] {counts[0]:.0f} lanes and {counts[1]:.0f} ordered "
        f"legs inside {table.rc_a} Bohr")
    records = []
    for dtype in (torch.float32, torch.float64):
        step = 1 if dtype == torch.float32 else f64_stride
        planes = [t.to(dtype) for t in planes32]
        dedg = torch.tensor(dedg_np, dtype=dtype, device=dev)
        # the plain versions on every step-th row of the first plain_rows
        # (rows are independent)
        sel = slice(0, plain_rows, step)
        sub_planes = [t[sel].contiguous() for t in planes]
        sub_dedg = dedg[sel].contiguous()
        shown = ((f" (every {step}th row)" if step > 1 else "")
                 + (f" (of the first {plain_rows})" if plain_rows else ""))
        sub = f"{tag} " + ("f32" if dtype == torch.float32 else "f64")
        cases = [
            ("ni_g", lambda: (kernels.ni_g(*planes, table),),
             lambda: (fn.ni_g_plain(*sub_planes, table),), ("g",), 126),
            ("ni_force", lambda: kernels.ni_force(*planes, dedg, table),
             lambda: fn.ni_force_plain(*sub_planes, sub_dedg, table),
             ("fjx", "fjy", "fjz"), 170),
        ]
        for name, kern, plain, outs, line in cases:
            got = kern()
            ref, plain_ms = timed(plain)
            worst = compare(sub, name + shown, outs, [a[sel] for a in got],
                            ref, rel_bound[dtype], filler[sel])
            if name == "ni_g":
                # register sums in list order, then shuffles: no atomics
                check(torch.equal(kern()[0], got[0]),
                      f"ni_g {sub}: two runs differ in their bits")
            del got, ref
            if dtype != torch.float32:
                continue
            ms = cuda_ms(kern, 10)
            records.append(record(
                name, "meng_zhang_tpu_torch/ops/csrc/ni_bp.cu",
                f"meng_zhang_tpu/ops/pallas_ni.py:{line}", worst, ms,
                plain_ms, ni_flops(name, *counts, table),
                p * (3 * k + fn.NSF_SUB + (3 * k if name == "ni_force"
                                           else 0)) * 4))
            log(f"[{tag}] {name} f32 [{p}, {k}]: kernel {ms:.3f} ms "
                f"(median of 10, CUDA events), plain {plain_ms:.3f} ms (one "
                f"run), bound "
                f"{records[-1]['bound_ms']:.3f} ms "
                f"({records[-1]['bound_by']})")
        del planes, dedg, sub_planes, sub_dedg
    return records


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
    records = ni_plane_checks("ni-kernels", planes32, table, nsf, filler)

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


def phase_ni_evaluator(x, box, cfg32, p32, cfg64, p64, sl, ref_out):
    """FusedNi through the kernels in f32 against the plain path in f64,
    same short list; then the f64 kernel path against the autograd model
    on a 256-atom periodic thermal box. ref_out: a list that receives the
    f64 plain path's (E, F, W) and the virial's scale ([shard-ni])."""
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
    vol = float(box64.prod())
    log(f"[ni-evaluator] N {n}: E/N f64 {float(e64) / n:.9f} eV; RMS F "
        f"{f_rms:.4e} eV/A; max|F| {float(f64.abs().max()):.4e} eV/A; virial"
        f" pressure {float(torch.trace(w64)) / 3 / vol * 1.6021765e6:.1f} bar")
    got = eval_gates("ni-evaluator", NI_EVAL_REL, (e32, f32, w32),
                     (e64, f64, w64), w_abs)
    ref_out.extend((e64, f64, w64, w_abs))
    del dd, fj

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


def ni_simulator(dev, cfg32, p32, mass, wide=False):
    """(Simulator, x, box, evaluator) of the NVT main path of
    scripts/model_bench.py --model ni on the perfect lattice, the light
    force variant wired as there; wide: at the wide (or wider) path's
    sizes."""
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.testing import thermal_fcc
    cells = ni_sizes(wide)[3]
    xn, bn = thermal_fcc(cells, disp=0.0, a=NI_A)       # the perfect lattice
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    n = x.shape[0]
    ev = fn.FusedNi(cfg32, p32, k_short=ni_sizes(wide)[0],
                    short_delta=NI_DELTA)
    w0 = torch.zeros((3, 3), dtype=torch.float32, device=dev)

    def force_fn(xx, bb, nb, sh):
        return ev.energy_forces_short(xx, bb, sh)

    def force_fn_light(xx, bb, nb, sh):
        return ev.energy_forces_short(xx, bb, sh, want_virial=False) + (w0,)

    sim = Simulator(force_fn,
                    torch.full((n,), mass, dtype=torch.float32, device=dev),
                    ni_md_config(ev.rc, bn, wide),
                    short_build=lambda xx, bb, nb: ev.compact_short(
                        xx, bb, nb.idx),
                    force_fn_light=force_fn_light)
    return sim, x, box, ev


def phase_ni_main_path(dev, cfg32, p32, mass, card, wide=False):
    """init_state + NI_BLOCKS blocks of the ni NVT main path ([ni-main]);
    wide: NI_WIDE_BLOCKS blocks of the wide path ([ni-wide-main]), rows of
    up to NI_WIDE_KS partners on the potential at Rc NI_WIDE_RC; "wider":
    NI_WIDER_BLOCKS blocks on NI_WIDER_CELLS^3 cells at Ks NI_WIDER_KS on
    the potential at Rc NI_WIDER_RC ([ni-wider-main]). Returns the
    launches and the rate."""
    from meng_zhang_tpu_torch.ops import kernels
    tag, n_blocks, rate_blocks = {
        False: ("ni-main", NI_BLOCKS, RATE_BLOCKS),
        True: ("ni-wide-main", NI_WIDE_BLOCKS, NI_WIDE_RATE_BLOCKS),
        "wider": ("ni-wider-main", NI_WIDER_BLOCKS, 1)}[wide]
    ks = ni_sizes(wide)[0]
    sim, x, box, ev = ni_simulator(dev, cfg32, p32, mass, wide)
    n = x.shape[0]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    st = sim.init_state(x, box, seed=SEED, t_init=NI_T_INIT)
    torch.cuda.synchronize()
    log(f"[{tag}] N {n}, rc {ev.rc:.4f} A, Ks {ks}, init_state "
        f"{time.time() - t0:.2f} s")
    rebuilds, rows, block_s, srow_max = 0, [], [], 0
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
        srow = int((st.short.sidx < n).sum(1).max())
        srow_max = max(srow_max, srow)
        log(f"[{tag}] step {int(row[0]):4d} T {row[1]:8.3f} K  PE "
            f"{row[2]:.6f} eV  P {row[4]:10.2f} bar  conserved "
            f"{row[6]:.6e}  short row max {srow}/{ks}  "
            f"{block_s[-1] * 1e3:.1f} ms")
    launches = {"ni_g": kernels.ni_g.launches,
                "ni_force": kernels.ni_force.launches}
    steps = n_blocks * NI_THERMO_EVERY
    check(all(np.isfinite(r).all() for r in rows),
          f"{tag}: non-finite thermo")
    check(not bool(st.overflow), f"{tag}: neighbor overflow in the main path")
    check(not bool(st.unsafe), f"{tag}: unsafe (dangerous-build) latch set")
    check(rebuilds >= 1, f"{tag}: no skin-list rebuild ran")
    for name, cnt in launches.items():
        check(cnt == steps + 1, f"{tag}: {name} launched {cnt} times, "
              f"expected {steps + 1} (init + one per step, light steps "
              "included)")
    window = sum(block_s[-rate_blocks:])
    aps = n * rate_blocks * NI_THERMO_EVERY / window
    log(f"[{tag}] {steps} NVT steps, {rebuilds} rebuilds, widest short row "
        f"{srow_max}/{ks}, launches {launches}, overflow "
        f"{bool(st.overflow)} unsafe {bool(st.unsafe)}")
    log(f"[{tag}] {aps:.1f} atom-steps/s over the last {rate_blocks} "
        f"blocks ({window:.3f} s) on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, aps


def phase_ni_wide_kernels(dev, cfg32, p32):
    """[ni-wide-kernels]: ni_g / ni_force against their plain versions on
    the [P, NI_WIDE_KS] short planes of the thermal ni scene on the
    potential at Rc NI_WIDE_RC (filler lanes included) in f32 and f64 (the
    f64 plain versions on every NI_WIDE_F64_STRIDE-th row, both on the
    first NI_WIDE_PLAIN_ROWS rows), their times and bounds; then, on its
    first NI_POW_ROWS rows, the 10 + 22 table of
    testing.NI_WIDE_ANGULAR (nsf 32, 20 eta groups, 22 shapes, 12 of them
    through pow), and the potential's table at K 48 and K 256 (the kernels'
    instances of 2 and 8 slots a lane). Returns the wide figures of each
    kernel's record."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.testing import (NI_WIDE_ANGULAR,
                                              NI_WIDE_RAD_ETAS,
                                              synthetic_ni_potential)
    from meng_zhang_tpu_torch.units import CFLENGTH
    x, box, sl = ni_thermal_scene(dev, cfg32, p32, wide=True)
    planes32 = fa.pair_dx_planes(x, box, sl.sidx, cfg32.pbc)
    p, k = planes32[0].shape
    filler = sl.sidx >= x.shape[0]
    table = fn.ni_table(p32["coerad"], p32["coeang"])
    records = ni_plane_checks("ni-wide-kernels", planes32, table,
                              cfg32.npsf + cfg32.ntsf, filler,
                              NI_WIDE_F64_STRIDE, NI_WIDE_PLAIN_ROWS)

    pot = synthetic_ni_potential(0, npsf=10, rc_bohr=NI_WIDE_RC * CFLENGTH,
                                 ang=NI_WIDE_ANGULAR,
                                 rad_etas=NI_WIDE_RAD_ETAS)
    wide = fn.ni_table(pot.sym_coerad, pot.sym_coeang)
    rows = slice(0, NI_POW_ROWS)
    dedg_np = np.random.default_rng(SEED).normal(size=(NI_POW_ROWS,
                                                       fn.NSF_SUB))
    # the other instances of the kernels: K 48 (lanes 40-87 of the rows, 2
    # slots a lane) and K 256 (the rows and 128 filler lanes, 8 slots)
    pad = 2.0 * box + 10.0
    planes256 = [torch.cat([t[rows], torch.full_like(t[rows], float(b))], 1)
                 for t, b in zip(planes32, pad)]
    cases = [("10+22 table", wide, [t[rows] for t in planes32],
              filler[rows]),
             ("K 48", table, [t[rows, 40:88] for t in planes32],
              filler[rows, 40:88]),
             ("K 256", table, planes256, torch.cat(
                 [filler[rows], torch.ones_like(filler[rows])], 1))]
    for case, tab, case_planes, case_filler in cases:
        kc = case_planes[0].shape[1]
        for dtype in (torch.float32, torch.float64):
            planes = [t.to(dtype).contiguous() for t in case_planes]
            dedg = torch.tensor(dedg_np, dtype=dtype, device=dev)
            tag = f"ni-wide-kernels {case} " + (
                "f32" if dtype == torch.float32 else "f64")
            compare(tag, f"ni_g [{NI_POW_ROWS}, {kc}]", ("g",),
                    (kernels.ni_g(*planes, tab),),
                    (fn.ni_g_plain(*planes, tab),), NI_REL_BOUND[dtype])
            compare(tag, f"ni_force [{NI_POW_ROWS}, {kc}]",
                    ("fjx", "fjy", "fjz"),
                    kernels.ni_force(*planes, dedg, tab),
                    fn.ni_force_plain(*planes, dedg, tab),
                    NI_REL_BOUND[dtype], case_filler)
    return {r["name"]: {"wide_shape": [p, k], "wide_ms": r["ms"],
                        "wide_plain_ms": r["plain_ms"],
                        "wide_bound_ms": r["bound_ms"],
                        "wide_bound_by": r["bound_by"],
                        "wide_max_abs_err": r["max_abs_err"]}
            for r in records}


def phase_ni_wider(dev, card):
    """[ni-wider]: the synthetic ni potential of the shipped table shape at
    Rc NI_WIDER_RC on the thermal fcc box of NI_WIDER_CELLS^3 cells, short
    planes at Ks NI_WIDER_KS (~320 partners a row: the kernels' 16-slot
    instances): ni_g / ni_force against their plain versions in f32 and
    f64 on the first WIDE_ROWS rows (f64 on every WIDE_F64_STRIDE-th),
    their times on every row and bounds; the cross-tile instances on the
    same planes beside them (ni_tiles_crossover);
    the first WIDE_PAD_ROWS rows widened to NI_MAX_K = 512 by filler lanes;
    one evaluation
    of the chunked BP functions (run.py's route: rows no wider than the
    kernels go as they are) in f32 against the f64 plain path (the gates
    of [ni-evaluator]); then [ni-wider-main], NI_WIDER_BLOCKS blocks of the
    ni NVT main path at those sizes. Returns the wider figures of each
    kernel's record (and the cross-tile instances' crossover times as
    a dict of their own, by name: `crossover_*`), the main path's launches
    and its rate."""
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.testing import synthetic_ni_potential
    from meng_zhang_tpu_torch.units import CFLENGTH
    tag = "ni-wider"
    pot = synthetic_ni_potential(0, rc_bohr=NI_WIDER_RC * CFLENGTH)
    cfg32, p32 = make_annp(pot, torch.float32, dev)
    cfg64, p64 = make_annp(pot, torch.float64, dev)
    x, box, sl = ni_thermal_scene(dev, cfg32, p32, wide="wider")
    n = x.shape[0]
    short_max = int((sl.sidx < n).sum(1).max())
    check(short_max > 256, f"{tag}: no short row wider than 256 lanes")
    planes32 = fa.pair_dx_planes(x, box, sl.sidx, cfg32.pbc)
    filler = sl.sidx >= n
    table = fn.ni_table(p32["coerad"], p32["coeang"])
    records = ni_plane_checks(tag, planes32, table, pot.nsf, filler,
                              WIDE_F64_STRIDE, WIDE_ROWS,
                              NI_WIDER_REL_BOUND)
    tiles = ni_tiles_crossover(tag, planes32, table, pot.nsf, filler,
                               records, card)
    rows = slice(0, WIDE_PAD_ROWS)
    wide32, fill_wide = pad_lanes([t[rows] for t in planes32], filler[rows],
                                  box.tolist(), kernels.NI_MAX_K)
    dedg_np = np.random.default_rng(SEED).normal(size=(WIDE_PAD_ROWS,
                                                       fn.NSF_SUB))
    for dtype in (torch.float32, torch.float64):
        planes = [t.to(dtype) for t in wide32]
        dedg = torch.tensor(dedg_np, dtype=dtype, device=dev)
        sub = f"{tag} " + ("f32" if dtype == torch.float32 else "f64")
        shape = f"[{WIDE_PAD_ROWS}, {kernels.NI_MAX_K}]"
        compare(sub, f"ni_g {shape}", ("g",), (kernels.ni_g(*planes, table),),
                (fn.ni_g_plain(*planes, table),), NI_WIDER_REL_BOUND[dtype])
        compare(sub, f"ni_force {shape}", ("fjx", "fjy", "fjz"),
                kernels.ni_force(*planes, dedg, table),
                fn.ni_force_plain(*planes, dedg, table),
                NI_WIDER_REL_BOUND[dtype], fill_wide)
    del wide32, planes, dedg

    # the chunked functions through the kernels in f32, the plain path in
    # f64, on the same rows
    t0 = time.time()
    e32, f32, w32 = annp.energy_forces_virial_chunked(cfg32, p32, x, box,
                                                      sl.sidx, shift=False)
    torch.cuda.synchronize()
    chunked_s = time.time() - t0
    x64, box64 = x.double(), box.double()
    ev64 = fn.FusedNi(cfg64, p64, k_short=NI_WIDER_KS, short_delta=NI_DELTA,
                      plain=True)
    e64, f64, w64 = ev64.energy_forces_short(
        x64, box64, fa.ShortList(sl.sidx, x64, sl.overflow))
    check(bool(torch.isfinite(f32).all()) and bool(torch.isfinite(e32)),
          f"{tag}: non-finite chunked output")
    # the virial's scale from the f32 kernel path's Fj (a scale only)
    ev32 = annp.fused_evaluator(cfg32, p32)
    dd = fa.pair_dx_planes(x, box, sl.sidx, cfg32.pbc)
    fj = ev32._eval_fj(*dd)[1]
    w_abs = max(float((da.double() * fb.double()).abs().sum())
                for da in dd for fb in fj)
    del dd, fj
    log(f"[{tag}] chunked functions on {n} atoms at K {sl.sidx.shape[1]}: "
        f"{chunked_s:.3f} s (one call, the first); E/N f64 "
        f"{float(e64) / n:.9f} eV; max|F| {float(f64.abs().max()):.4e} eV/A")
    eval_gates(tag, NI_EVAL_REL, (e32, f32, w32), (e64, f64, w64), w_abs)
    del x, box, sl, planes32, filler, x64, box64, e64, f64, w64
    launches, rate = phase_ni_main_path(dev, cfg32, p32,
                                        float(pot.masses[0]), card,
                                        wide="wider")
    figs = {r["name"]: {"wider_shape": [n, NI_WIDER_KS], "wider_ms": r["ms"],
                        "wider_plain_ms": r["plain_ms"],
                        "wider_plain_rows": WIDE_ROWS,
                        "wider_bound_ms": r["bound_ms"],
                        "wider_bound_by": r["bound_by"],
                        "wider_max_abs_err": r["max_abs_err"]}
            for r in records}
    crossover = {name: {"crossover_shape": [n, NI_WIDER_KS],
                        "crossover_ms": tiles[name][0],
                        "crossover_one_warp_ms": figs[short]["wider_ms"],
                        "crossover_err_vs_one_warp": tiles[name][1]}
                 for name, short in (("ni_g_tiles", "ni_g"),
                                     ("ni_force_tiles", "ni_force"))}
    return figs, crossover, launches, rate


def ni_tiles_crossover(tag, planes32, table, nsf, filler, records, card):
    """The cross-tile instances on the one-warp kernels' [P, K <= 512]
    planes (f32, the dedg of ni_plane_checks): held to the one-warp
    kernels (each within its rel bound of the plain versions, so twice
    it apart) and timed beside them (the records' ms, median of 10).
    Returns {name: (ms, max abs err)}."""
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    p, k = planes32[0].shape
    dedg_np = np.zeros((p, fn.NSF_SUB))
    dedg_np[:, :nsf] = np.random.default_rng(SEED).normal(size=(p, nsf))
    dedg = torch.tensor(dedg_np, dtype=torch.float32,
                        device=planes32[0].device)
    bound_rel = 2 * NI_WIDER_REL_BOUND[torch.float32]
    sub = f"{tag} f32"
    err_g = compare(sub, f"ni_g_tiles [{p}, {k}] vs ni_g", ("g",),
                    (kernels.ni_g_tiles(*planes32, table),),
                    (kernels.ni_g(*planes32, table),), bound_rel)
    err_f = compare(sub, f"ni_force_tiles [{p}, {k}] vs ni_force",
                    ("fjx", "fjy", "fjz"),
                    kernels.ni_force_tiles(*planes32, dedg, table),
                    kernels.ni_force(*planes32, dedg, table), bound_rel,
                    filler)
    out = {"ni_g_tiles": (cuda_ms(lambda: kernels.ni_g_tiles(
               *planes32, table), 10), err_g),
           "ni_force_tiles": (cuda_ms(lambda: kernels.ni_force_tiles(
               *planes32, dedg, table), 10), err_f)}
    one = {r["name"]: r["ms"] for r in records}
    for name, short in (("ni_g_tiles", "ni_g"),
                        ("ni_force_tiles", "ni_force")):
        log(f"[{tag}] crossover at [{p}, {k}]: {name} {out[name][0]:.3f} ms "
            f"(tiles of {kernels.NI_TILE}, median of 10, CUDA events), the "
            f"one-warp {short} {one[short]:.3f} ms "
            f"({one[short] / out[name][0]:.2f}x) on {card}")
    return out


def phase_ni_profile(dev, cfg32, p32, mass, card):
    """A fresh ni main-path run: init_state and 4 blocks, then one block
    under torch.profiler."""
    sim, x, box, _ = ni_simulator(dev, cfg32, p32, mass)
    st = sim.init_state(x, box, seed=SEED, t_init=NI_T_INIT)
    for _ in range(4):
        st, _ = sim.run(st, 1)
    # the hot ni run rebuilds its skin list about every third block
    profile_block("ni-profile", "ni", sim, st, NI_THERMO_EVERY, card, tries=5)


# --------------------------------------------------------------- ANNA
def anna_model(dev):
    """(cfg32, p32, cfg64, p64, mass) of the synthetic ANNA-ADP potential."""
    from meng_zhang_tpu_torch.models.anna_adp import make_anna
    from meng_zhang_tpu_torch.testing import synthetic_anna_potential
    pot = synthetic_anna_potential(0)
    cfg32, p32 = make_anna(pot, torch.float32, dev)
    cfg64, p64 = make_anna(pot, torch.float64, dev)
    return cfg32, p32, cfg64, p64, float(pot.masses[0])


def anna_md_config(rc, box):
    from meng_zhang_tpu_torch.md.simulation import MDConfig
    from meng_zhang_tpu_torch.system.neighbors import cell_grid_dims
    return MDConfig(dt=0.001, cutoff=rc, skin=ANNA_SKIN,
                    capacity=ANNA_CAPACITY, nbr_method="cell",
                    cell_dims=cell_grid_dims(np.asarray(box),
                                             rc + ANNA_SKIN),
                    cell_capacity=ANNA_CELL_CAPACITY, ensemble="nve",
                    t_target=ANNA_T, tau_t=0.1, thermo_every=ANNA_EVERY,
                    stale_factor=0.5, short_every=ANNA_EVERY,
                    short_skin=ANNA_DELTA)


def phase_anna_kernel(dev, cfg32, p32):
    """g_harm against its plain version on the short planes [128000, 72]
    of a thermal box of the ANNA scene, at rc 5.055 A, in f32 and f64,
    and its f32 time. Returns the ANNA fields of g_harm's record and the
    box with its skin and short lists."""
    from meng_zhang_tpu_torch.models.anna_adp import make_anna_fast_fns
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    from meng_zhang_tpu_torch.testing import thermal_bcc
    xn, bn = thermal_bcc(ANNA_CELLS, seed=SEED, disp=ANNA_DISP)
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    n, rc, npsf, ntsf = x.shape[0], cfg32.cut, cfg32.npsf, cfg32.ntsf
    mcfg = anna_md_config(rc, bn)
    nbrs = build_neighbors_cell(x, box, rc + ANNA_SKIN, ANNA_CAPACITY,
                                mcfg.cell_dims, ANNA_CELL_CAPACITY)
    short = make_anna_fast_fns(cfg32, p32, k_short=ANNA_KS,
                               delta=ANNA_DELTA)[2](x, box, nbrs)
    log(f"[anna-kernel] thermal box N {n}: skin list dims {mcfg.cell_dims} "
        f"overflow {bool(nbrs.overflow)} max row "
        f"{int((nbrs.idx < n).sum(1).max())}/{ANNA_CAPACITY}; short list "
        f"overflow {bool(short.overflow)} max row "
        f"{int((short.idx < n).sum(1).max())}/{ANNA_KS}")
    check(not bool(nbrs.overflow) and not bool(short.overflow),
          "anna: neighbor list overflow on the thermal box")
    planes32 = fa.pair_dx_planes(x, box, short.idx, (True,) * 3)
    p, k = planes32[0].shape
    lanes, pairs = fe_counts(planes32, rc)
    log(f"[anna-kernel] {lanes:.0f} lanes inside {rc} A ({lanes / p:.2f} a "
        f"row)")
    out = {}
    for dtype in (torch.float32, torch.float64):
        planes = [t.to(dtype) for t in planes32]
        tag = "anna-kernel " + ("f32" if dtype == torch.float32 else "f64")
        got = kernels.g_harm(*planes, npsf, ntsf, rc)
        ref, plain_ms = timed(lambda: fa.g_harm_plain(*planes, npsf, ntsf,
                                                      rc))
        worst = compare(tag, f"g_harm [{p}, {k}]", ("g_raw", "A"), got, ref,
                        REL_BOUND[dtype])
        del got, ref
        if dtype == torch.float32:
            ms = cuda_ms(lambda: kernels.g_harm(*planes, npsf, ntsf, rc), 10)
            b_ms, b_by = bound(fe_flops("g_harm", lanes, pairs, npsf, ntsf),
                               fe_bytes("g_harm", p, k, 4))
            out = {"anna_shape": [p, k], "anna_ms": ms,
                   "anna_plain_ms": plain_ms, "anna_bound_ms": b_ms,
                   "anna_bound_by": b_by, "anna_max_abs_err": worst}
            log(f"[anna-kernel] g_harm f32 [{p}, {k}] rc {rc}: kernel "
                f"{ms:.3f} ms (median of 10, CUDA events), plain "
                f"{plain_ms:.3f} ms (one run), bound {b_ms:.3f} ms ({b_by})")
    return out, (x, box, nbrs, short)


def phase_anna_eval(box_lists, cfg32, p32, cfg64, p64):
    """make_anna_fast_fns' force_fn through g_harm in f32 against the same
    path in f64 on g_harm's plain version on the thermal box; then the f64
    fast path through the kernel against the reference-shaped
    energy_forces_virial on a 432-atom box. Returns the f64 plain path's
    (E, F, W) on the thermal box ([shard-anna])."""
    from meng_zhang_tpu_torch.models import anna_adp as A
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_n2
    from meng_zhang_tpu_torch.testing import thermal_bcc
    x, box, nbrs, short = box_lists
    n, dev = x.shape[0], x.device
    f32_fn = A.make_anna_fast_fns(cfg32, p32, k_short=ANNA_KS,
                                  delta=ANNA_DELTA)[0]
    f64_fn = A.make_anna_fast_fns(cfg64, p64, k_short=ANNA_KS,
                                  delta=ANNA_DELTA, plain=True)[0]
    x64, box64 = x.double(), box.double()
    e32, f32, w32 = f32_fn(x, box, nbrs, short)
    e64, f64, w64 = f64_fn(x64, box64, nbrs, short._replace(ref_x=x64))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(f32).all()) and bool(torch.isfinite(e32))
          and bool(torch.isfinite(w32).all()), "anna-eval: non-finite f32")
    f_rms = float(f64.pow(2).mean().sqrt())
    got = {"dE_per_atom": abs(float(e32) - float(e64)) / n,
           "max_dF": float((f32.double() - f64).abs().max()),
           "max_dW": float((w32.double() - w64).abs().max()),
           "sum_F": float(f32.double().sum(0).abs().max())}
    scale = {"dE_per_atom": abs(float(e64)) / n,
             "max_dF": float(f64.abs().max()),
             "max_dW": float(w64.abs().max()), "sum_F": n * f_rms}
    vol = float(box64.prod())
    log(f"[anna-eval] N {n}: E/N f64 {float(e64) / n + cfg64.e_base:.9f} eV"
        f" (shift-free {float(e64) / n:.6e}); RMS F {f_rms:.4e} eV/A; "
        f"max|F| {scale['max_dF']:.4e} eV/A; virial pressure "
        f"{float(torch.trace(w64)) / 3 / vol * 1.6021765e6:.1f} bar")
    for key, val in got.items():
        bound_abs = ANNA_EVAL_REL[key] * scale[key]
        log(f"[anna-eval] {key} {val:.3e} (bound {bound_abs:.3e} = "
            f"{ANNA_EVAL_REL[key]:.0e} x {scale[key]:.4e})")
        check(val <= bound_abs, f"anna-eval {key} {val:.3e} over "
              f"{bound_abs:.3e}")
    ref = (e64, f64, w64)
    del f32_fn, f64_fn, e32, f32, w32, x64, box64

    xs, bs = thermal_bcc(6, seed=SEED, disp=ANNA_DISP)
    xs = torch.tensor(xs, dtype=torch.float64, device=dev)
    bs = torch.tensor(bs, dtype=torch.float64, device=dev)
    nb = build_neighbors_n2(xs, bs, cfg64.cut + 0.3, ANNA_CAPACITY)
    fns = A.make_anna_fast_fns(cfg64, p64, k_short=ANNA_KS, delta=ANNA_DELTA)
    e_f, f_f, w_f = fns[0](xs, bs, nb, fns[2](xs, bs, nb))
    e_r, f_r, w_r = A.energy_forces_virial(cfg64, p64, xs, bs, nb.idx,
                                           shift=False)
    de = abs(float(e_f) - float(e_r)) / abs(float(e_r))
    df = float(((f_f - f_r).abs() - ANNA_REF["F_rtol"] * f_r.abs()).max())
    dw = float(((w_f - w_r).abs() - ANNA_REF["W_rtol"] * w_r.abs()).max())
    log(f"[anna-eval] {xs.shape[0]}-atom box, f64 fast path (kernel) vs "
        f"reference-shaped energy_forces_virial: rel dE {de:.3e} (bound "
        f"{ANNA_REF['E_rtol']:.0e}), max(|dF| - {ANNA_REF['F_rtol']:.0e} "
        f"|F|) {df:.3e} eV/A (bound {ANNA_REF['F_atol']:.0e}), max(|dW| - "
        f"{ANNA_REF['W_rtol']:.0e} |W|) {dw:.3e} eV (bound "
        f"{ANNA_REF['W_atol']:.0e})")
    check(de <= ANNA_REF["E_rtol"] and df <= ANNA_REF["F_atol"]
          and dw <= ANNA_REF["W_atol"],
          "anna: the fast path disagrees with the reference-shaped path")
    return ref


def anna_simulator(dev, cfg32, p32, mass):
    """(Simulator, x, box) of the ANNA NVE main path on the perfect
    lattice, the light force variant wired as scripts/model_bench.py
    wires it."""
    from meng_zhang_tpu_torch.geometry.lattice import bcc
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.models.anna_adp import make_anna_fast_fns
    xn, bn = bcc(ANNA_CELLS)
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    force_fn, force_fn_light, short_build = make_anna_fast_fns(
        cfg32, p32, k_short=ANNA_KS, delta=ANNA_DELTA)
    sim = Simulator(force_fn, torch.full((x.shape[0],), mass,
                                         dtype=torch.float32, device=dev),
                    anna_md_config(cfg32.cut, bn), short_build=short_build,
                    force_fn_light=force_fn_light)
    return sim, x, box


def phase_anna_md(dev, cfg32, p32, mass, card):
    """init_state + ANNA_BLOCKS blocks of the ANNA NVE main path."""
    from meng_zhang_tpu_torch.ops import kernels
    sim, x, box = anna_simulator(dev, cfg32, p32, mass)
    n = x.shape[0]
    pe_off = n * cfg32.e_base
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with plain_calls() as plain:
        t0 = time.time()
        st = sim.init_state(x, box, seed=SEED, t_init=ANNA_T)
        torch.cuda.synchronize()
        log(f"[anna-md] N {n}, rc {cfg32.cut} A, init_state "
            f"{time.time() - t0:.2f} s")
        rebuilds, rows, block_s, srow_max = 0, [], [], 0
        for _ in range(ANNA_BLOCKS):
            t0 = time.time()
            st, th = sim.run(st, 1)
            torch.cuda.synchronize()
            block_s.append(time.time() - t0)
            rebuilds += sim.rebuild_count
            row = [float(v[-1]) for v in th]
            rows.append(row)
            srow = int((st.short.idx < n).sum(1).max())
            srow_max = max(srow_max, srow)
            log(f"[anna-md] step {int(row[0]):4d} T {row[1]:8.3f} K  PE "
                f"{row[2] + pe_off:.4f} eV  P {row[4]:9.2f} bar  conserved "
                f"{row[6] + pe_off:.4f} eV  short row max {srow}/{ANNA_KS}  "
                f"{block_s[-1] * 1e3:.1f} ms")
    launches = {k: getattr(kernels, k).launches for k in kernels.WRAPPERS}
    steps = ANNA_BLOCKS * ANNA_EVERY
    check(not plain, f"anna-md: plain versions ran on the card: {plain}")
    check(all(np.isfinite(r).all() for r in rows), "anna: non-finite thermo")
    check(not bool(st.overflow), "anna: neighbor overflow in the main path")
    check(not bool(st.unsafe), "anna: unsafe (dangerous-build) latch set")
    check(srow_max <= ANNA_KS, f"anna: short row of {srow_max} partners")
    check(launches["g_harm"] == steps + 1, f"anna: g_harm launched "
          f"{launches['g_harm']} times, expected {steps + 1} (init + one per "
          "step, light steps included)")
    check(sum(launches.values()) == launches["g_harm"],
          f"anna: other kernels launched: {launches}")
    window = sum(block_s[-RATE_BLOCKS:])
    aps = n * RATE_BLOCKS * ANNA_EVERY / window
    drift = rows[-1][6] - rows[0][6]
    log(f"[anna-md] {steps} NVE steps, {rebuilds} rebuilds, widest short "
        f"row {srow_max}/{ANNA_KS}, launches {launches}, overflow "
        f"{bool(st.overflow)} unsafe {bool(st.unsafe)}; conserved energy "
        f"drift {drift:.4f} eV over steps {int(rows[0][0])}-"
        f"{int(rows[-1][0])} ({drift / n:.3e} eV/atom; not gated: the "
        f"forces freeze (d2, q2))")
    log(f"[anna-md] {aps:.1f} atom-steps/s over the last {RATE_BLOCKS} "
        f"blocks ({window:.3f} s) on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches["g_harm"], aps


def phase_anna_profile(dev, cfg32, p32, mass, card):
    """A fresh ANNA main-path run: init_state and 4 blocks, then one block
    under torch.profiler; then the light step's three phases timed apart
    on the run's last state (make_anna_fast_fns' own functions)."""
    from meng_zhang_tpu_torch.models import anna_adp as A
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    sim, x, box = anna_simulator(dev, cfg32, p32, mass)
    st = sim.init_state(x, box, seed=SEED, t_init=ANNA_T)
    for _ in range(4):
        st, _ = sim.run(st, 1)
    profile_block("anna-profile", "ANNA", sim, st, ANNA_EVERY, card, tries=5)
    gp = A._gp(p32)
    idx = st.short.idx
    pl = fa.pair_dx_planes(st.x, st.box, idx, cfg32.pbc)
    lp = A._phase1(cfg32, p32, pl)
    e_at, fcols = A._fields_from_planes(cfg32, gp, *pl, lp)
    ftab = torch.nn.functional.pad(fcols, (0, 1, 0, 16 - fcols.shape[0]))
    step_costs("anna-profile", card, {
        "dx planes [N, 72] x3": lambda: fa.pair_dx_planes(
            st.x, st.box, idx, cfg32.pbc),
        "phase 1 (g_harm, S_l -> G, network)":
            lambda: A._phase1(cfg32, p32, pl),
        "phase 2 (fields and atom energies)":
            lambda: A._fields_from_planes(cfg32, gp, *pl, lp),
        "phase 3 (newton-off pair forces, light)":
            lambda: A._force_from_planes(cfg32, gp, *pl, idx, ftab, fcols,
                                         False),
        "phase 3 with the virial":
            lambda: A._force_from_planes(cfg32, gp, *pl, idx, ftab, fcols,
                                         True),
        "force_fn_light (the whole light step's evaluation)":
            lambda: sim.force_fn_light(st.x, st.box, st.nbrs, st.short)})


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
    launches = {k: getattr(kernels, k).launches for k in kernels.WRAPPERS}
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
    """The benchmark scene as a LAMMPS data file, the synthetic fe and ni
    potentials as .ann files (the port's own writers) and the synthetic
    ANNA-ADP potential as a .anna file (testing.anna_text)."""
    from meng_zhang_tpu_torch.io.lammps_data import LammpsData, write_data
    from meng_zhang_tpu_torch.io.potential import write_ann
    from meng_zhang_tpu_torch.testing import (anna_text,
                                              synthetic_anna_potential,
                                              synthetic_ni_potential)
    x = np.load(SCENE_NPZ)["x"].astype(np.float64)
    paths = {k: os.path.join(tmp, name) for k, name in (
        ("data", "fe_st.dat"), ("fe", "fe.ann"), ("ni", "ni.ann"),
        ("anna", "fe.anna"))}
    write_data(paths["data"], LammpsData(
        x=x, types=np.ones(len(x), np.int32), box_lo=np.zeros(3),
        box_hi=np.asarray(BOX), n_types=1), comment="benchmark scene")
    write_ann(paths["fe"], _potential())
    write_ann(paths["ni"], synthetic_ni_potential(0))
    with open(paths["anna"], "w") as f:
        f.write(anna_text(synthetic_anna_potential(0)))
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


def phase_cli_anna(card, tmp, paths):
    """The ANNA NVE workflow through the CLI on the 128,000-atom scene
    (run.py's defaults: --skin 2.0 --capacity 256, reference-shaped
    energy_forces_virial every step), then --minimize (FIRE) with a
    per-atom dump on a small thermal box."""
    from meng_zhang_tpu_torch.io.lammps_data import LammpsData, write_data
    from meng_zhang_tpu_torch.testing import E_BASE_ANNA, thermal_bcc
    cells = [str(ANNA_CELLS)] * 3
    rows, err, _, launches = cli("cli-anna", [
        "--lattice", "bcc", "--cells", *cells, "--potential",
        paths["anna"], "--ensemble", "nve", "--temp", str(ANNA_T),
        "--steps", str(CLI_ANNA_STEPS), "--thermo", str(CLI_ANNA_THERMO)])
    check(launches["g_harm"] == CLI_ANNA_STEPS + 1, f"cli-anna: g_harm "
          f"launched {launches['g_harm']} times, expected "
          f"{CLI_ANNA_STEPS + 1} (init + one per step)")
    check(sum(launches.values()) == launches["g_harm"],
          f"cli-anna: other kernels launched: {launches}")
    log(f"[cli-anna] Loop time rate {_loop_rate(err):.1f} atom-steps/s on "
        f"{card}")
    total = launches["g_harm"]

    xs, bs = thermal_bcc(ANNA_MIN_CELLS, seed=SEED, disp=0.1)
    data = os.path.join(tmp, "anna_small.dat")
    write_data(data, LammpsData(x=xs, types=np.ones(len(xs), np.int32),
                                box_lo=np.zeros(3), box_hi=bs, n_types=1))
    dump = os.path.join(tmp, "anna.lammpstrj")
    rows, err, wall, launches = cli("cli-anna-min", [
        "--data", data, "--potential", paths["anna"], "--skin",
        str(ANNA_SKIN), "--capacity", str(ANNA_CAPACITY), "--minimize",
        "--min-ftol", str(ANNA_MIN_FTOL), "--steps", str(CLI_THERMO),
        "--thermo", str(CLI_THERMO), "--dump", dump, "--dump-peratom"])
    fline = next(ln for ln in err if "fmax=" in ln)
    fmax = float(fline.split("fmax=")[1].split()[0])
    evals = launches["g_harm"] - CLI_THERMO - 2      # run and one dump
    check(fmax <= ANNA_MIN_FTOL and evals > 0,
          f"cli-anna: FIRE stopped at fmax {fmax} after {evals} evaluations")
    n = len(xs)
    step, cols, snap = _last_snapshot(dump)
    check(step == CLI_THERMO and snap.shape == (n, 6) and cols[5:] == [
        "c_pe"] and bool(np.isfinite(snap[:, 5]).all()),
        f"cli-anna: dump columns {cols}, shape {snap.shape}, step {step}")
    e_base = E_BASE_ANNA
    pe_row = float(rows[-1].split()[2]) - n * e_base
    pe_sum = math.fsum(snap[:, 5]) - n * float(np.float32(e_base))
    log(f"[cli-anna] FIRE (--minimize --min-ftol {ANNA_MIN_FTOL}) on a "
        f"{n}-atom thermal box: fmax {fmax:.4e} eV/A after {evals} "
        f"evaluations, run.main {wall:.2f} s; step {step}: sum of c_pe less "
        f"n f32(e_base) {pe_sum:.4f} eV, thermo PotEng less n e_base "
        f"{pe_row:.4f} eV, |diff| {abs(pe_sum - pe_row):.4f} eV (bound "
        f"{ANNA_PE_SUM_ATOL})")
    check(abs(pe_sum - pe_row) <= ANNA_PE_SUM_ATOL,
          "cli-anna: the dump's c_pe does not sum to the thermo PotEng")
    return total + launches["g_harm"]


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


# ------------------------------------------ multi-element and thin box
def blind_gate(tag, f_blind, f_sel, measured, bound):
    """The elems-blind forces must differ from the selected ones by more
    than BLIND_OVER_ERR x the measured f32 error and BLIND_OVER_BOUND x its
    bound: the select is live."""
    diff = float((f_blind.double() - f_sel.double()).abs().max())
    log(f"[{tag}] elems-blind: max |F_blind - F_elems| {diff:.4e} eV/A = "
        f"{diff / max(measured, 1e-300):.1f}x the f32 error {measured:.3e}, "
        f"{diff / bound:.1f}x its bound {bound:.3e}")
    check(diff > BLIND_OVER_ERR * measured and diff > BLIND_OVER_BOUND * bound,
          f"{tag}: the elems-blind evaluation is too close to the selected "
          "one: the network select is not live")


def phase_multi_fe(x, box, sl, card, single):
    """The benchmark scene with types 1/2 drawn 50/50 and the two-element
    synthetic fe potential: (a) f32 kernels with elems against the f64
    plain path with elems on both angular paths, and (b) the f64 kernel
    path against the autograd model on a 250-atom box (phase_evaluator);
    (c) the elems-blind control; (d) init_state + MULTI_BLOCKS NPT blocks
    through Simulator. Returns (launches, types)."""
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.testing import synthetic_fe_potential_multi
    n, dev = x.shape[0], x.device
    pot = synthetic_fe_potential_multi(2)
    types = np.random.default_rng(0).integers(1, 3, n)
    el = torch.as_tensor(types - 1, device=dev)
    cfg32, p32 = make_annp(pot, torch.float32, dev, pbc=PBC)
    cfg64, p64 = make_annp(pot, torch.float64, dev, pbc=PBC)
    log(f"[multi-fe] {pot.elements} masses {pot.masses}: "
        f"{int((types == 1).sum())} / {int((types == 2).sum())} atoms")
    got = {angular: phase_evaluator(x, box, cfg32, p32, cfg64, p64, sl,
                                    angular, elems=el, pot=pot,
                                    tag=f"multi-fe {angular}")
           for angular in ("harmonic", "matrix")}
    ev = fa.FusedAnnp(cfg32, p32, k_short=K_SHORT, short_delta=SHORT_DELTA)
    f_sel = ev.energy_forces_short(x, box, sl, elems=el)[1]
    f_blind = ev.energy_forces_short(x, box, sl)[1]
    f_max = float(f_sel.abs().max())
    blind_gate("multi-fe", f_blind, f_sel, got["harmonic"]["max_dF"],
               EVAL_REL["max_dF"] * f_max)
    del f_sel, f_blind
    masses = torch.as_tensor(pot.masses, dtype=torch.float32,
                             device=dev)[el]
    launches, rate, block_ms = phase_main_path(
        x, box, cfg32, p32, masses, card, elems=el, tag="multi-fe",
        n_blocks=MULTI_BLOCKS, rate_blocks=MULTI_RATE_BLOCKS)
    log(f"[multi-fe] {rate:.1f} atom-steps/s against {single[0]:.1f} of "
        f"the single-element main path ({100 * (rate / single[0] - 1):+.1f}"
        f" %; their windows hold different shares of skin rebuilds); median "
        f"block {block_ms:.3f} ms against {single[1]:.3f} "
        f"({100 * (block_ms / single[1] - 1):+.1f} %) on {card}")
    return launches, types


def phase_rowsweep(x, box, cfg32, p32, mass, card):
    """build_neighbors_cell_rowsweep against build_neighbors_cell on the
    benchmark scene, then Simulator(nbr_method="rowsweep"): a block, a
    forced rebuild (its list equal to a fresh build), a block."""
    import dataclasses
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.neighbors import (
        build_neighbors_cell, build_neighbors_cell_rowsweep)
    mcfg = dataclasses.replace(md_config(cfg32), nbr_method="rowsweep")
    args = (x, box, cfg32.cut + SKIN, CAPACITY, mcfg.cell_dims,
            CELL_CAPACITY)
    a = build_neighbors_cell_rowsweep(*args, pbc=PBC)
    b = build_neighbors_cell(*args, pbc=PBC)
    check(torch.equal(a.idx, b.idx) and bool(a.overflow) == bool(b.overflow)
          and not bool(a.overflow), "rowsweep: rows or flags differ from "
          "build_neighbors_cell")
    sim = fe_simulator(x, cfg32, p32, mass, "harmonic", mcfg=mcfg)
    kernels.reset_launch_counts()
    with plain_calls() as plain:
        st = sim.init_state(x, box, seed=SEED, t_init=300.0)
        st, th0 = sim.run(st, 1)
        st = sim.rebuild(st)
        fresh = build_neighbors_cell(st.x, st.box, *args[2:], pbc=PBC)
        check(torch.equal(st.nbrs.idx, fresh.idx),
              "rowsweep: the Simulator's rebuilt list differs from a fresh "
              "build")
        st, th1 = sim.run(st, 1)
    launches = {k: getattr(kernels, k).launches
                for k in ("g_harm", "force_harm")}
    rows = [[float(v[-1]) for v in th] for th in (th0, th1)]
    check(not plain and all(np.isfinite(r).all() for r in rows)
          and not bool(st.overflow) and not bool(st.unsafe),
          f"rowsweep: plain {plain}, rows {rows}, overflow "
          f"{bool(st.overflow)}, unsafe {bool(st.unsafe)}")
    want = 2 * THERMO_EVERY + 1
    check(all(v == want for v in launches.values()),
          f"rowsweep: launches {launches}, expected {want} each")
    log(f"[rowsweep] {x.shape[0]} atoms: rows and flags equal to "
        f"build_neighbors_cell; Simulator(nbr_method='rowsweep') 2 blocks "
        f"around a forced rebuild, T {rows[-1][1]:.3f} K, launches "
        f"{launches} on {card}")
    return launches


def phase_multi_ni(dev, card):
    """The thermal ni box with types 1/2 drawn 50/50 and the two-element
    synthetic ni potential: (a) FusedNi(elems) in f32 through the kernels
    against the f64 plain path; (b) the elems-blind control; (c) init_state
    + MULTI_NI_BLOCKS NVT blocks of the chunked functions with elems
    (make_short_chunked_fns), whose evaluator is FusedNi, from the perfect
    lattice."""
    from meng_zhang_tpu_torch.md.simulation import Simulator
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.testing import (synthetic_ni_potential_multi,
                                              thermal_fcc)
    pot = synthetic_ni_potential_multi(2)
    cfg32, p32 = annp.make_annp(pot, torch.float32, dev)
    cfg64, p64 = annp.make_annp(pot, torch.float64, dev)
    x, box, sl = ni_thermal_scene(dev, cfg32, p32)
    n = x.shape[0]
    el = torch.as_tensor(np.random.default_rng(0).integers(0, 2, n),
                         device=dev)
    ev32 = fn.FusedNi(cfg32, p32, k_short=NI_KS, short_delta=NI_DELTA,
                      elems=el)
    ev64 = fn.FusedNi(cfg64, p64, k_short=NI_KS, short_delta=NI_DELTA,
                      plain=True, elems=el)
    x64, box64 = x.double(), box.double()
    out32 = ev32.energy_forces_short(x, box, sl)
    out64 = ev64.energy_forces_short(x64, box64,
                                     fa.ShortList(sl.sidx, x64, sl.overflow))
    dd = fa.pair_dx_planes(x64, box64, sl.sidx, cfg64.pbc)
    fj = ev64._eval_fj(*dd, el)[1]
    w_abs = max(float((da * fb).abs().sum()) for da in dd for fb in fj)
    del dd, fj
    got = eval_gates("multi-ni", NI_EVAL_REL, out32, out64, w_abs)
    f_blind = fn.FusedNi(cfg32, p32, k_short=NI_KS).energy_forces_short(
        x, box, sl)[1]
    blind_gate("multi-ni", f_blind, out32[1], got["max_dF"],
               NI_EVAL_REL["max_dF"] * float(out64[1].abs().max()))
    del out32, out64, f_blind, x64, box64

    force_fn, light, short_build = annp.make_short_chunked_fns(
        cfg32, p32, k_short=NI_KS, delta=NI_DELTA, elems=el)
    rc = annp.descriptor_cutoff(cfg32, p32)
    masses = torch.as_tensor(pot.masses, dtype=torch.float32,
                             device=dev)[el]
    sim = Simulator(force_fn, masses, ni_md_config(rc, box.cpu().numpy()),
                    short_build=short_build, force_fn_light=light)
    # from the perfect lattice, as the ni main path: on the thermal box the
    # stiff potential's forces move atoms past short_delta/2 in an epoch
    x0 = torch.tensor(thermal_fcc(NI_CELLS, disp=0.0, a=NI_A)[0],
                      dtype=torch.float32, device=dev)
    kernels.reset_launch_counts()
    t0 = time.time()
    with plain_calls() as plain:
        st = sim.init_state(x0, box, seed=SEED, t_init=NI_T_INIT)
        st, th = sim.run(st, MULTI_NI_BLOCKS)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: getattr(kernels, k).launches for k in ("ni_g", "ni_force")}
    want = MULTI_NI_BLOCKS * NI_THERMO_EVERY + 1
    check(not plain and bool(torch.isfinite(th.temp).all())
          and bool(torch.isfinite(th.pe).all()) and not bool(st.overflow)
          and not bool(st.unsafe), f"multi-ni: plain {plain}, T "
          f"{th.temp.tolist()}, overflow {bool(st.overflow)}, unsafe "
          f"{bool(st.unsafe)}")
    check(all(v == want for v in launches.values()),
          f"multi-ni: launches {launches}, expected {want} each")
    log(f"[multi-ni] {MULTI_NI_BLOCKS} NVT blocks of the chunked functions "
        f"with elems: T {[round(t, 3) for t in th.temp.tolist()]} K, "
        f"launches {launches}, {wall:.2f} s with init_state on {card}")
    return launches


def phase_thin_box(card, tmp, dev):
    """The screw-dislocation scene of `tools screw --dislocation`, one
    Burgers vector thick along z, run as it is through explicit images:
    (a) image mode in f64 against the z-replicated scene through the
    ordinary path, (b) the f32 kernels against the f64 plain path in image
    mode, and g_harm / force_harm against their plain versions on the
    image planes, (c) init_state + THIN_BLOCKS NVE blocks through
    Simulator(image_shifts=...), (d) FIRE (--min-ftol FIRE_FTOL) on the
    image route. Returns (c)'s and (d)'s launches."""
    import dataclasses
    from meng_zhang_tpu_torch import tools
    from meng_zhang_tpu_torch.io.lammps_data import read_data
    from meng_zhang_tpu_torch.md.minimize import fire_relax
    from meng_zhang_tpu_torch.md.simulation import MDConfig, Simulator
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.cell import image_table
    from meng_zhang_tpu_torch.system.neighbors import (
        build_neighbors_cell, build_neighbors_images, cell_grid_dims)
    path = os.path.join(tmp, "screw_thin.dat")
    tools.main(["screw", "--dislocation", "--out", path])
    data = read_data(path)
    xn, bn = data.x.copy(), data.box
    xn[:, 2] %= bn[2]           # the dislocation's u_z leaves [0, b): wrap
    n = len(xn)
    pot = _potential()
    rlist = pot.cut + SKIN
    shifts, pbc_eff = annp.image_shift_table(bn, rlist, THIN_PBC)
    check(shifts is not None and len(shifts) == THIN_IMAGES
          and pbc_eff == (False,) * 3, f"thin-box: image shifts {shifts}, "
          f"pbc_eff {pbc_eff}")
    log(f"[thin-box] {n} atoms, box {np.round(bn, 4).tolist()} A, pbc "
        f"{THIN_PBC}: {len(shifts)} z-images, x_ext {len(shifts) * n} rows")
    sh = torch.as_tensor(shifts, device=dev)
    cfg64, p64 = annp.make_annp(pot, torch.float64, dev, pbc=pbc_eff)
    cfg32, p32 = annp.make_annp(pot, torch.float32, dev, pbc=pbc_eff)
    x64 = torch.tensor(xn, dtype=torch.float64, device=dev)
    box64 = torch.tensor(bn, dtype=torch.float64, device=dev)
    t0 = time.time()
    nb = build_neighbors_images(x64, box64, sh, rlist, CAPACITY, pbc_eff)
    torch.cuda.synchronize()
    n_ext = len(shifts) * n
    log(f"[thin-box] image n2 build {time.time() - t0:.3f} s, overflow "
        f"{bool(nb.overflow)}, widest row {int((nb.idx < n_ext).sum(1).max())}"
        f"/{CAPACITY}")
    check(not bool(nb.overflow), "thin-box: image neighbor overflow")

    # (a) image mode against the z-replicated scene, both f64 kernels
    img = annp.energy_forces_virial_images(cfg64, p64, x64, box64, nb.idx,
                                           sh, shift=False)
    reps = len(shifts)
    dz = torch.tensor([0.0, 0.0, bn[2]], dtype=torch.float64, device=dev)
    x_rep = torch.cat([x64 + k * dz for k in range(reps)])
    box_rep = box64 * torch.tensor([1.0, 1.0, reps], dtype=torch.float64,
                                   device=dev)
    cfgr, pr = annp.make_annp(pot, torch.float64, dev, pbc=THIN_PBC)
    rr = pot.cut + 0.3
    nbr = build_neighbors_cell(x_rep, box_rep, rr, CAPACITY,
                               cell_grid_dims(box_rep.cpu().numpy(), rr),
                               CELL_CAPACITY, pbc=THIN_PBC)
    check(not bool(nbr.overflow), "thin-box: replicated scene overflow")
    rep = annp.energy_forces_virial_chunked(cfgr, pr, x_rep, box_rep,
                                            nbr.idx, shift=False)
    del nbr, x_rep
    de = abs(float(img[0]) - float(rep[0]) / reps) / abs(float(rep[0]) / reps)
    df = float((img[1] - rep[1][:n]).abs().max()) / float(rep[1].abs().max())
    dw = float((img[2] - rep[2] / reps).abs().max()) \
        / float((rep[2] / reps).abs().max())
    log(f"[thin-box] f64 image mode vs the z-replicated scene ({reps * n} "
        f"atoms): rel dE {de:.3e}, max dF {df:.3e} of max|F|, max dW "
        f"{dw:.3e} of max|W| (bound {THIN_REL:.0e} each); E/N "
        f"{float(img[0]) / n + cfg64.e_shift:.9f} eV")
    check(max(de, df, dw) <= THIN_REL,
          "thin-box: image mode disagrees with the replicated scene")
    del rep

    # (b) f32 kernels against the f64 plain path, image mode
    x32, box32 = x64.float(), box64.float()
    out32 = annp.energy_forces_virial_images(cfg32, p32, x32, box32, nb.idx,
                                             sh, shift=False)
    x_ext64 = image_table(x64, box64, sh)
    ev64 = fa.FusedAnnp(cfg64, p64, k_short=kernels.MAX_K, plain=True)
    zero = torch.zeros((), dtype=torch.bool, device=dev)
    out64 = ev64.energy_forces_short(x64, box64,
                                     fa.ShortList(nb.idx, x64, zero),
                                     x_ext=x_ext64)
    dd = fa.pair_dx_planes(x64, box64, nb.idx, pbc_eff, x_ext=x_ext64)
    fj = ev64._eval_fj(*dd)[1]
    w_abs = max(float((da * fb).abs().sum()) for da in dd for fb in fj)
    # W: on this scene f32 arithmetic itself misses max_dW's bound (the
    # plain path in f32 reads 3.6e-4 of the scale on a CPU): the kernel
    # path is held to the plain path's own f32 error instead
    got = eval_gates("thin-box", {k: v for k, v in EVAL_REL.items()
                                  if k != "max_dW"}, out32, out64, w_abs)
    x_ext32 = image_table(x32, box32, sh)
    w32p = fa.FusedAnnp(cfg32, p32, k_short=kernels.MAX_K,
                        plain=True).energy_forces_short(
        x32, box32, fa.ShortList(nb.idx, x32, zero), x_ext=x_ext32)[2]
    dw_plain = float((w32p.double() - out64[2]).abs().max())
    log(f"[thin-box] max_dW {got['max_dW']:.3e} ({got['max_dW'] / w_abs:.2e}"
        f" of {w_abs:.4e}), the f32 plain path's {dw_plain:.3e} (bound "
        f"{THIN_W_OVER_PLAIN} x that)")
    check(got["max_dW"] <= THIN_W_OVER_PLAIN * dw_plain,
          "thin-box: the kernels' f32 virial error exceeds the plain f32 "
          "path's")
    del x_ext32, w32p
    # the kernels' inputs in image mode: self-image lanes (dx = (0, 0, k b),
    # longer than the box) are ordinary lanes to them
    self_img = (nb.idx < n_ext) & (nb.idx % n == torch.arange(
        n, device=dev)[:, None])
    p, k = dd[0].shape
    rng = np.random.default_rng(SEED)
    dedg_np = np.zeros((p, fa.NSF_PAD))
    dedg_np[:, :cfg64.nsf] = rng.normal(size=(p, cfg64.nsf))
    b_np = np.zeros((p, fa.AB_PAD))
    b_np[:, :cfg64.ntsf ** 2 + 1] = rng.normal(size=(p, cfg64.ntsf ** 2 + 1))
    filler = nb.idx >= n_ext
    for dtype in (torch.float32, torch.float64):
        pl = [t.to(dtype) for t in dd]
        dedg = torch.tensor(dedg_np, dtype=dtype, device=dev)
        b = torch.tensor(b_np, dtype=dtype, device=dev)
        tag = "thin-box kernels " + ("f32" if dtype == torch.float32
                                     else "f64")
        args = (cfg64.npsf, cfg64.ntsf, cfg64.cut)
        compare(tag, f"g_harm [{p}, {k}]", ("g_raw", "A"),
                kernels.g_harm(*pl, *args), fa.g_harm_plain(*pl, *args),
                REL_BOUND[dtype])
        compare(tag, f"force_harm [{p}, {k}]", ("fjx", "fjy", "fjz"),
                kernels.force_harm(*pl, dedg, b, *args),
                fa.force_harm_plain(*pl, dedg, b, *args), REL_BOUND[dtype],
                filler)
    log(f"[thin-box] {int(self_img.sum())} self-image lanes (an atom and its "
        f"own z-image) among {int((~filler).sum())} lanes")
    del dd, fj, out32, out64, x_ext64

    # (c) NVE through Simulator(image_shifts=...)
    def force_fn(xx, bb, nbrs):
        return annp.energy_forces_virial_images(cfg32, p32, xx, bb, nbrs.idx,
                                                sh, shift=False)

    mcfg = MDConfig(dt=0.001, cutoff=pot.cut, skin=SKIN, capacity=CAPACITY,
                    nbr_method="n2", ensemble="nve", t_target=300.0,
                    thermo_every=THERMO_EVERY, pbc=pbc_eff)
    masses = torch.full((n,), float(pot.masses[0]), dtype=torch.float32,
                        device=dev)
    sim = Simulator(force_fn, masses, mcfg, image_shifts=sh)
    kernels.reset_launch_counts()
    block_s, rows = [], []
    with plain_calls() as plain:
        t0 = time.time()
        st = sim.init_state(x32, box32, seed=SEED, t_init=300.0)
        torch.cuda.synchronize()
        log(f"[thin-box] init_state {time.time() - t0:.3f} s")
        for _ in range(THIN_BLOCKS):
            t0 = time.time()
            st, th = sim.run(st, 1)
            torch.cuda.synchronize()
            block_s.append(time.time() - t0)
            rows.append([float(v[-1]) for v in th])
            log(f"[thin-box] step {int(rows[-1][0]):4d} T {rows[-1][1]:8.3f} "
                f"K  PE {rows[-1][2] + n * cfg32.e_shift:.6f} eV  conserved "
                f"{rows[-1][6]:.6e}  rebuilds {sim.rebuild_count}  "
                f"{block_s[-1] * 1e3:.1f} ms")
    launches = {k: getattr(kernels, k).launches
                for k in ("g_harm", "force_harm")}
    want = THIN_BLOCKS * THERMO_EVERY + 1
    check(not plain and all(np.isfinite(r).all() for r in rows)
          and not bool(st.overflow), f"thin-box: plain {plain}, finite "
          f"{all(np.isfinite(r).all() for r in rows)}, overflow "
          f"{bool(st.overflow)}")
    check(all(v == want for v in launches.values()),
          f"thin-box: launches {launches}, expected {want} each")
    window = sum(block_s[-THIN_RATE_BLOCKS:])
    log(f"[thin-box] {THIN_BLOCKS * THERMO_EVERY} NVE steps: "
        f"{n * THIN_RATE_BLOCKS * THERMO_EVERY / window:.1f} atom-steps/s "
        f"over the last {THIN_RATE_BLOCKS} blocks ({window:.3f} s), "
        f"conserved-energy drift {rows[-1][6] - rows[0][6]:+.6e} eV over "
        f"{(THIN_BLOCKS - 1) * THERMO_EVERY} steps, unsafe "
        f"{bool(st.unsafe)}, launches {launches} on {card}")

    # (d) FIRE on the image route
    kernels.reset_launch_counts()
    with plain_calls() as plain:
        t0 = time.time()
        _, fst = fire_relax(
            lambda xx, bb, idx: annp.energy_forces_virial_images(
                cfg32, p32, xx, bb, idx, sh, shift=False)[:2],
            sim.build_nbrs, x32, box32, f_tol=FIRE_FTOL)
        torch.cuda.synchronize()
        wall = time.time() - t0
    evals = kernels.g_harm.launches
    check(not plain and float(fst.fmax) <= FIRE_FTOL and evals > 0,
          f"thin-box FIRE: fmax {float(fst.fmax)} after {evals} evaluations")
    log(f"[thin-box] FIRE (f_tol {FIRE_FTOL}) on the {n}-atom image route: "
        f"fmax {float(fst.fmax):.4e} eV/A after {evals} evaluations, "
        f"{wall:.3f} s on {card}")
    return {k: launches[k] + getattr(kernels, k).launches for k in launches}


def phase_cli_multi(card, tmp, types):
    """run.main on the benchmark scene written with its [multi-fe] types
    and the two-element .ann: NPT with per-atom dumps."""
    from meng_zhang_tpu_torch.io.lammps_data import LammpsData, write_data
    from meng_zhang_tpu_torch.io.potential import write_ann
    from meng_zhang_tpu_torch.testing import synthetic_fe_potential_multi
    x = np.load(SCENE_NPZ)["x"].astype(np.float64)
    n = len(x)
    data, ann = (os.path.join(tmp, f) for f in ("fe_st2.dat", "fe2.ann"))
    dump = os.path.join(tmp, "fe2.lammpstrj")
    write_data(data, LammpsData(x=x, types=types.astype(np.int32),
                                box_lo=np.zeros(3), box_hi=np.asarray(BOX),
                                n_types=2), comment="benchmark scene, typed")
    pot = synthetic_fe_potential_multi(2)
    write_ann(ann, pot)
    rows, err, wall, launches = cli("cli-multi", [
        "--data", data, "--potential", ann, "--ensemble", "npt", "--temp",
        "300", "--couple", "y", "--boundary", "m p m", "--skin", str(SKIN),
        "--capacity", str(CAPACITY), "--steps", str(CLI_MULTI_STEPS),
        "--thermo", str(CLI_THERMO), "--dump", dump, "--dump-peratom",
        "--profile"])
    check(any(f"elements={pot.elements}" in ln for ln in err),
          "cli-multi: the run did not read two elements")
    want = CLI_MULTI_STEPS + 1 + CLI_MULTI_STEPS // CLI_THERMO
    check(launches["g_harm"] == launches["force_harm"] == want,
          f"cli-multi: launches {launches}, expected {want} of g_harm and "
          "force_harm (init + one per step + one per per-atom dump)")
    check(sum(launches.values()) == 2 * want,
          f"cli-multi: other kernels launched: {launches}")
    step, cols, snap = _last_snapshot(dump)
    check(step == CLI_MULTI_STEPS and snap.shape == (n, 12)
          and bool(np.isfinite(snap[:, 5:]).all()),
          f"cli-multi: dump step {step}, shape {snap.shape}")
    e_shift = pot.e_shift + pot.e_atom
    pe_row = float(rows[-1].split()[2]) - n * e_shift
    pe_sum = math.fsum(snap[:, 5]) - n * float(np.float32(e_shift))
    block_ms = _phase_avg_ms(err, "md_block")
    log(f"[cli-multi] step {step}: shift-free sum of c_pe {pe_sum:.4f} eV, "
        f"thermo PotEng {pe_row:.4f} eV, |diff| {abs(pe_sum - pe_row):.4f} "
        f"eV (bound {PE_SUM_ATOL}); Loop time rate {_loop_rate(err):.1f} "
        f"atom-steps/s (per-atom dumps included); md_block {block_ms:.3f} ms"
        f" a {CLI_THERMO}-step block = {n * CLI_THERMO / block_ms * 1e3:.1f}"
        f" atom-steps/s; run.main {wall:.2f} s on {card}")
    check(abs(pe_sum - pe_row) <= PE_SUM_ATOL,
          "cli-multi: the dump's c_pe does not sum to the thermo PotEng")
    return {k: launches[k] for k in ("g_harm", "force_harm")}


def shard_config(n, cut, skin, capacity, cell_capacity, mesh=None, **kw):
    """The driver's config: ShardConfig of SHARD_D slabs, or with `mesh`
    Shard2DConfig / Shard3DConfig of that grid."""
    from meng_zhang_tpu_torch.parallel.domain import ShardConfig
    from meng_zhang_tpu_torch.parallel.domain2d import Shard2DConfig
    from meng_zhang_tpu_torch.parallel.domain3d import Shard3DConfig
    make, d = ShardConfig, SHARD_D
    if mesh is not None:
        make = Shard2DConfig if len(mesh) == 2 else Shard3DConfig
        d, kw = int(np.prod(mesh)), dict(kw, mesh_shape=mesh)
    return make(n_devices=d, c_loc=n // d, cutoff=cut, skin=skin, dt=0.001,
                capacity=capacity, cell_capacity=cell_capacity, **kw)


def shard_driver(model, mass, box, cfg, dev):
    """ShardedMD, ShardedMD2D or ShardedMD3D, by the config's mesh."""
    from meng_zhang_tpu_torch.parallel import domain, domain2d, domain3d
    mesh = getattr(cfg, "mesh_shape", ())
    make = {0: domain.ShardedMD, 2: domain2d.ShardedMD2D,
            3: domain3d.ShardedMD3D}[len(mesh)]
    return make(model, mass, box, cfg, device=dev)


def shard_geometry(md):
    """One line of the layout's rows: the rows a shard evaluates against
    its own C, and D times them against N."""
    c = md.cfg
    if hasattr(md, "n_frame"):
        rows = md.n_frame
        frame = (md.wx_frame, md.wy_frame) + (
            (md.wz_frame,) if md.k == 3 else ())
        head = (f"mesh {md.shape}, send tables {'/'.join(map(str, md.caps))}"
                f" rows, frame rows {rows}, frame "
                f"{'x'.join(f'{w:.3f}' for w in frame)} A")
    else:
        rows = c.cc
        head = (f"halo_b {c.halo_b}, bc {c.bc}, cc {rows}, frame "
                f"{md.frame_wx:.3f} A")
    ratio = c.n_devices * rows / md.n
    return (f"{head} ({rows / c.c_loc:.3f} x C, {ratio:.3f} x N rows), K "
            f"{c.capacity}, cells {md.frame_dims}")


def shard_outputs(st, order):
    """(PE shift-free, F [N, 3] in the original atom order, W)."""
    return (st.pe.sum(), st.f_loc.reshape(-1, 3)[torch.argsort(order)],
            st.virial)


def shard_rel64(tag, what, got, want):
    """(E, F, W) of the f64 sharded path against the f64 single-device
    path, each difference within SHARD_REL64 of the output's scale."""
    (e, f, w), (e0, f0, w0) = got, want
    errs = {"E": abs(float(e) - float(e0)) / abs(float(e0)),
            "F": rel_err(f, f0)[1], "W": rel_err(w, w0)[1]}
    log(f"[{tag}] {what}: rel dE {errs['E']:.3e}, max dF / max|F| "
        f"{errs['F']:.3e}, max dW / max|W| {errs['W']:.3e} (bound "
        f"{SHARD_REL64:.0e})")
    check(max(errs.values()) <= SHARD_REL64, f"{tag}: {what} disagree")


def shard_planes(md, st, idx, pbc):
    """The dx planes [D*cc, K] of every shard's centre rows over the rows
    idx [D, cc, K], as the driver's evaluation gathers them."""
    from meng_zhang_tpu_torch.ops import frames
    x_ext = md._frame(st.x_loc, st.halo_l, st.halo_r)
    off, cc = md._short_geom()
    sidx, _ = frames.frame_tables(idx, x_ext.shape[1], off, cc)
    return frames.frame_planes(x_ext[:, off:off + cc], x_ext, st.box, sidx,
                               pbc)


def shard_kernel_checks(tag, planes32, cases, stride=1):
    """Each case (name, kernel, plain version, outputs, bounds by dtype)
    on every stride-th row of the frame planes in f32 and f64, the kernel
    against its plain version; then the kernel's f32 time on all of
    them. kernel/plain take (planes, dtype)."""
    p, k = planes32[0].shape
    for dtype in (torch.float32, torch.float64):
        pl = [t[::stride].to(dtype).contiguous() for t in planes32]
        for name, kern, plain, outs, bounds in cases:
            compare(f"{tag} {'f32' if dtype == torch.float32 else 'f64'}",
                    f"{name} frame planes [{pl[0].shape[0]}, {k}]", outs,
                    kern(pl, dtype), plain(pl, dtype), bounds[dtype])
        del pl
    for name, kern, _, _, _ in cases:
        ms = cuda_ms(lambda: kern(planes32, torch.float32), 5)
        log(f"[{tag}] {name} f32 on the [{p}, {k}] frame planes: {ms:.3f} "
            "ms (median of 5, CUDA events)")


def fe_kernel_cases(npsf, ntsf, rc, p, dev):
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    rng = np.random.default_rng(SEED)
    dedg_np = np.zeros((p, fa.NSF_PAD))
    dedg_np[:, :npsf + ntsf] = rng.normal(size=(p, npsf + ntsf))
    b_np = np.zeros((p, fa.AB_PAD))
    b_np[:, :ntsf * ntsf + 1] = rng.normal(size=(p, ntsf * ntsf + 1))

    made = {}

    def co(a, pl, dtype):
        """The first rows of a coefficient table, one for each plane row,
        on the card (copied once, outside the timed launches)."""
        key = (id(a), pl[0].shape[0], dtype)
        if key not in made:
            made[key] = torch.tensor(a[:pl[0].shape[0]], dtype=dtype,
                                     device=dev)
        return made[key]

    harm = [("g_harm", lambda pl, dt: kernels.g_harm(*pl, npsf, ntsf, rc),
             lambda pl, dt: fa.g_harm_plain(*pl, npsf, ntsf, rc),
             ("g_raw", "A"), REL_BOUND),
            ("force_harm",
             lambda pl, dt: kernels.force_harm(*pl, co(dedg_np, pl, dt),
                                               co(b_np, pl, dt), npsf, ntsf, rc),
             lambda pl, dt: fa.force_harm_plain(*pl, co(dedg_np, pl, dt),
                                                co(b_np, pl, dt), npsf, ntsf, rc),
             ("fjx", "fjy", "fjz"), REL_BOUND)]
    cos = [("g_cos",
            lambda pl, dt: (kernels.g_cos(*pl, npsf, ntsf, rc),),
            lambda pl, dt: (fa.g_cos_plain(*pl, npsf, ntsf, rc),),
            ("g",), {d: b["g_cos"] for d, b in COS_REL_BOUND.items()}),
           ("force_cos",
            lambda pl, dt: kernels.force_cos(*pl, co(dedg_np, pl, dt), npsf,
                                             ntsf, rc),
            lambda pl, dt: fa.force_cos_plain(*pl, co(dedg_np, pl, dt), npsf,
                                              ntsf, rc),
            ("fjx", "fjy", "fjz"),
            {d: b["force_cos"] for d, b in COS_REL_BOUND.items()})]
    return harm, cos


def ni_kernel_cases(cfg, table, p, dev):
    """ni_g and ni_force against their plain versions (the cases of
    shard_kernel_checks) on [p, K] planes of the ni table `table`,
    ni_force's dE/dG drawn from SEED."""
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    nsf = cfg.npsf + cfg.ntsf
    dedg_np = np.zeros((p, fn.NSF_SUB))
    dedg_np[:, :nsf] = np.random.default_rng(SEED).normal(size=(p, nsf))
    dedgs = {dt: torch.tensor(dedg_np, dtype=dt, device=dev)
             for dt in (torch.float32, torch.float64)}
    return [("ni_g", lambda pl, dt: (kernels.ni_g(*pl, table),),
             lambda pl, dt: (fn.ni_g_plain(*pl, table),), ("g",),
             NI_REL_BOUND),
            ("ni_force",
             lambda pl, dt: kernels.ni_force(*pl, dedgs[dt], table),
             lambda pl, dt: fn.ni_force_plain(*pl, dedgs[dt], table),
             ("fjx", "fjy", "fjz"), NI_REL_BOUND)]


def shard_t_bound(t_ref, rel_f, f_max, mass, steps, v_rms):
    """|dT| bound after `steps` steps between two f32 runs from one start
    whose evaluations are each within rel_f * f_max of the f64 forces (the
    evaluator gates): the velocities differ by at most dv = 2 rel_f f_max
    steps dt / (m MVV2E) an atom, and T = m v^2 / (3 kB) per atom moves by
    at most 2 dv / v_rms of itself (to first order)."""
    from meng_zhang_tpu_torch.units import MVV2E
    dv = 2.0 * rel_f * f_max * steps * 0.001 / (mass * MVV2E)
    return 2.0 * t_ref * dv / v_rms


def shard_md(tag, md, x, v, n_blocks, names, card, sim_run, rel_f,
             rate_ref, mass, migrate=False, thermo_every=THERMO_EVERY):
    """distribute + n_blocks of the sharded run from (x, v); sim_run():
    the single-device Simulator's Thermo over the first SHARD_T_STEPS
    steps from the same start. Gates: finite thermo, no overflow or
    unsafe, >= 1 rebuild (one is forced after the first block when the
    run flags none, after a migrate with `migrate`), each kernel in
    `names` launched once a step (and once by distribute), no other
    kernel and no plain version, T against the single-device run within
    shard_t_bound. Returns the launches."""
    from meng_zhang_tpu_torch.ops import kernels
    all_names = kernels.WRAPPERS
    n = x.shape[0]
    th_ref = sim_run()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with plain_calls() as plain:
        t0 = time.time()
        st, _ = md.distribute(x, v)
        torch.cuda.synchronize()
        log(f"[{tag}] distribute {time.time() - t0:.2f} s: "
            f"{shard_geometry(md)}")
        rows, block_s, rebuilds, migrated = [], [], 0, 0
        for blk in range(n_blocks):
            t0 = time.time()
            st, th = md.run(st, 1)
            torch.cuda.synchronize()
            block_s.append(time.time() - t0)
            rebuilds += md.rebuild_count
            migrated += md.migrated
            if blk == 0 and rebuilds == 0:
                if migrate:
                    st = md.migrate(st)
                    migrated += md.migrated
                st = md.rebuild(st)       # drive the rebuild path once
                rebuilds += 1
            row = [float(c[-1]) for c in th]
            rows.append(row)
            log(f"[{tag}] step {int(row[0]):4d} T {row[1]:8.3f} K  PE "
                f"{row[2]:.6f} eV  P {row[4]:9.2f} bar  conserved "
                f"{row[6]:.6e}  {block_s[-1] * 1e3:.1f} ms")
    launches = {k: getattr(kernels, k).launches for k in all_names}
    steps = n_blocks * thermo_every
    check(not plain, f"{tag}: plain versions ran on the card: {plain}")
    check(all(np.isfinite(r).all() for r in rows), f"{tag}: non-finite "
          "thermo")
    check(not bool(st.overflow.any()), f"{tag}: overflow flags "
          f"{st.overflow.tolist()}")
    check(not bool(st.unsafe.any()), f"{tag}: unsafe latch set")
    check(rebuilds >= 1, f"{tag}: no rebuild ran")
    for k in all_names:
        want = steps + 1 if k in names else 0
        check(launches[k] == want, f"{tag}: {k} launched {launches[k]} "
              f"times, expected {want} (one a step for all "
              f"{md.cfg.n_devices} shards, and one at distribute)")
    gid = np.sort(st.gid.reshape(-1).cpu().numpy())
    check(np.array_equal(gid, np.arange(n)), f"{tag}: gid not a "
          "permutation")
    # T against the single-device run over the first SHARD_T_STEPS steps
    n_cmp = SHARD_T_STEPS // thermo_every
    f_max = float(st.f_loc.abs().max())
    v_rms = float(st.v_loc.double().pow(2).mean().sqrt()) * math.sqrt(3.0)
    for i in range(n_cmp):
        t_ref = float(th_ref.temp[i])
        bnd = shard_t_bound(t_ref, rel_f, f_max, mass, (i + 1) * thermo_every,
                            v_rms)
        dt_ = abs(rows[i][1] - t_ref)
        log(f"[{tag}] step {(i + 1) * thermo_every}: T {rows[i][1]:.6f} K "
            f"against the single-device {t_ref:.6f} K: |dT| {dt_:.3e} K "
            f"(bound {bnd:.3e} K)")
        check(dt_ <= bnd, f"{tag}: T off the single-device run")
    drift = rows[-1][6] - rows[0][6]
    log(f"[{tag}] conserved-quantity drift {drift:+.6e} eV over steps "
        f"{int(rows[0][0])}-{int(rows[-1][0])} (printed, not gated)")
    rate_blocks = min(RATE_BLOCKS, n_blocks - 2)
    window = sum(block_s[-rate_blocks:])
    aps = n * rate_blocks * thermo_every / window
    log(f"[{tag}] {steps} steps, {rebuilds} rebuilds, {migrated} atoms "
        f"migrated between shards, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"[{tag}] {aps:.1f} atom-steps/s over the last {rate_blocks} blocks "
        f"({window:.3f} s), the single-device Simulator's {rate_ref:.1f} in "
        f"this run, on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {k: v for k, v in launches.items() if v}


def shard_coverage(tag, md, x):
    """An undersized slab halo (bc of 8 rows) must trip OVF_COVERAGE."""
    import dataclasses
    from meng_zhang_tpu_torch.parallel import domain as D
    md.cfg = dataclasses.replace(md.cfg, halo_b=16)
    st, _ = md.distribute(x)
    ovf = st.overflow.tolist()
    log(f"[{tag}] halo_b 16: overflow flags {ovf} (OVF_COVERAGE "
        f"{D.OVF_COVERAGE})")
    check(all(o & D.OVF_COVERAGE for o in ovf), f"{tag}: an undersized halo "
          "passed the coverage proof")


def grid_coverage(tag, md, x):
    """A grid driver's coverage trip (tests/test_multichip2d.py:149-177):
    an own row of shard 0 outside its y-high send set, moved 0.1 A inside
    that face, must latch OVF_COVERAGE on shard 0 at the next rebuild."""
    from meng_zhang_tpu_torch.parallel import domain as D
    st, _ = md.distribute(x)
    check(not bool(st.overflow.any()), f"{tag}: overflow before the trip")
    yhi = float(md.yb_frac[0, 1]) * float(st.box[1])
    outside = torch.nonzero(st.x_loc[0, :, 1] < yhi - md.w_send - 0.5)
    check(outside.numel() > 0, f"{tag}: shard 0 has no row outside its "
          "y-high send set")
    x_loc = st.x_loc.clone()
    x_loc[0, int(outside[0, 0]), 1] = yhi - 0.1
    ovf = md.rebuild(st._replace(x_loc=x_loc)).overflow.tolist()
    log(f"[{tag}] a row of shard 0 moved into its y-high face band: overflow"
        f" flags {ovf} (OVF_COVERAGE {D.OVF_COVERAGE}; "
        f"{outside.shape[0]} of its {md.cfg.c_loc} rows outside the send "
        "set)")
    check(ovf[0] & D.OVF_COVERAGE, f"{tag}: the teleported row passed the "
          "coverage proof")


# the layouts of the sharded tags: [shard-*] SHARD_D slabs, [shard2d-*] a
# (2, 2) grid of columns, [shard3d-*] a (2, 2, 2) grid of bricks
SHARD_MESH = {"1d": None, "2d": (2, 2), "3d": (2, 2, 2)}
# rows of the harmonic kernels' plain comparisons on the fe frame planes:
# every row of the slabs' 213,360, every 4th of the grids' 401,200 and
# 636,336 (their times stay on every row)
SHARD_HARM_STRIDE = {"1d": 1, "2d": 4, "3d": 4}
SHARD_TAG = {"1d": "shard", "2d": "shard2d", "3d": "shard3d"}


def phase_shard_fe(x, box, cfg32, p32, cfg64, p64, mass, card, ref,
                   main_rate, layout="1d"):
    """A sharded driver on the fe main path's scene at the shipped width:
    FrameShortModel(FusedAnnp) over SHARD_D slabs (layout "1d",
    [shard-fe]) or a (2, 2) grid of columns ("2d", [shard2d-fe]) on the
    card. (a) distribute in f32 against the f64 plain single-device path
    at the same x (phase 4's EVAL_REL); (b) on the slab x < SHARD_SLAB_X
    in f64, the sharded kernel path against the single-device kernel path
    (SHARD_REL64), and AnnpFrameModel on both angular paths (the skin
    rows at full width) against FrameShortModel; (c) the four fe kernels
    against their plain versions on the frame planes; (d) the coverage
    trip (an undersized slab halo; on the grid a row teleported into a
    face band); (e) SHARD_BLOCKS NPT blocks (migrate_b SHARD_MIGRATE_B)
    from the main path's start."""
    from meng_zhang_tpu_torch.md.simulation import create_velocities
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.parallel import domain as D
    tag = f"{SHARD_TAG[layout]}-fe"
    t_phase = time.time()
    dev = x.device
    n = x.shape[0]

    def md_of(model, bx, n_at, **kw):
        return shard_driver(model, mass, bx, shard_config(
            n_at, cfg32.cut, SKIN, CAPACITY, CELL_CAPACITY,
            mesh=SHARD_MESH[layout], pbc=PBC, **kw), dev)

    def short_model(cfg, p, **kw):
        return D.FrameShortModel(fa.FusedAnnp(cfg, p, k_short=K_SHORT,
                                              short_delta=SHORT_DELTA, **kw))

    # (a) f32 sharded against the f64 plain single-device evaluation
    md = md_of(short_model(cfg32, p32), box, n)
    t0 = time.time()
    st, order = md.distribute(x)
    torch.cuda.synchronize()
    log(f"[{tag}] distribute {time.time() - t0:.2f} s: {shard_geometry(md)}")
    check(not bool(st.overflow.any()), f"{tag}: overflow at distribute "
          f"{st.overflow.tolist()}")
    e64, f64, w64, w_abs = ref
    eval_gates(tag, EVAL_REL, shard_outputs(st, order), (e64, f64, w64),
               w_abs)
    planes = shard_planes(md, st, st.short.sidx, PBC)
    del st, md, e64, f64, w64

    # (c) the kernels on the frame planes
    harm, cos = fe_kernel_cases(cfg32.npsf, cfg32.ntsf, cfg32.cut,
                                planes[0].shape[0], dev)
    shard_kernel_checks(tag, planes, harm, SHARD_HARM_STRIDE[layout])
    shard_kernel_checks(tag, [t[::4].contiguous() for t in planes], cos)
    del planes

    # (b) f64 on a slab cut from the scene
    keep = torch.nonzero(x[:, 0] < SHARD_SLAB_X).reshape(-1)
    d = SHARD_D if layout == "1d" else int(np.prod(SHARD_MESH[layout]))
    keep = keep[:keep.shape[0] // d * d]
    xs = x[keep].double()
    box64 = box.double()
    ns = xs.shape[0]
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    mcfg = md_config(cfg64)
    nb = build_neighbors_cell(xs, box64, cfg64.cut + SKIN, CAPACITY,
                              mcfg.cell_dims, CELL_CAPACITY, pbc=PBC)
    want = fa.FusedAnnp(cfg64, p64, k_short=K_SHORT).energy_forces(
        xs, box64, nb.idx)
    del nb
    md = md_of(short_model(cfg64, p64), box64, ns)
    st, order = md.distribute(xs)
    check(not bool(st.overflow.any()), f"{tag}: slab overflow")
    shard_rel64(tag, f"{ns}-atom slab, f64 FrameShortModel vs one device",
                shard_outputs(st, order), want)
    short_out = shard_outputs(st, order)
    del st
    for angular in ("harmonic", "matrix"):
        mda = md_of(D.AnnpFrameModel(fa.FusedAnnp(cfg64, p64,
                                                  angular=angular)),
                    box64, ns)
        st, order = mda.distribute(xs)
        check(not bool(st.overflow.any()), f"{tag}: AnnpFrameModel overflow")
        shard_rel64(tag, f"f64 AnnpFrameModel ({angular}, K {CAPACITY}) vs "
                    "FrameShortModel", shard_outputs(st, order), short_out)
        del st, mda
    # (d) the coverage proof
    (shard_coverage if layout == "1d" else grid_coverage)(tag, md, xs)
    del md, xs, want, short_out

    # (e) NPT from the main path's start
    masses = torch.full((n,), mass, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    v0 = create_velocities(gen, masses, 300.0, torch.float32)
    mcfg = md_config(cfg32)

    def sim_run():
        sim = fe_simulator(x, cfg32, p32, mass, "harmonic")
        s = sim.init_state(x, box, v=v0)
        return sim.run(s, SHARD_T_STEPS // THERMO_EVERY)[1]

    md = md_of(short_model(cfg32, p32), box, n, ensemble="npt",
               t_target=300.0, tau_t=mcfg.tau_t, p_target=mcfg.p_target,
               p_couple=COUPLE, tau_p=mcfg.tau_p, thermo_every=THERMO_EVERY,
               migrate_b=SHARD_MIGRATE_B)
    launches = shard_md(tag, md, x, v0, SHARD_BLOCKS,
                        ("g_harm", "force_harm"), card, sim_run,
                        EVAL_REL["max_dF"], main_rate, mass, migrate=True)
    log(f"[{tag}] phase {time.time() - t_phase:.1f} s")
    return launches


def phase_shard3d_fe(x, box, cfg32, p32, mass, ref):
    """The 3-D driver on the fe scene, one evaluation ([shard3d-fe]):
    ShardedMD3D(FrameShortModel(FusedAnnp)) on a (2, 2, 2) grid of bricks,
    x and z not periodic. distribute in f32 against the f64 plain
    single-device path (EVAL_REL); g_harm and force_harm against their
    plain versions on the bricks' frame planes; the time of one
    evaluation of all eight frames. Returns distribute's launches."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.parallel import domain as D
    tag = "shard3d-fe"
    t_phase = time.time()
    dev = x.device
    md = shard_driver(
        D.FrameShortModel(fa.FusedAnnp(cfg32, p32, k_short=K_SHORT,
                                       short_delta=SHORT_DELTA)),
        mass, box, shard_config(x.shape[0], cfg32.cut, SKIN, CAPACITY,
                                CELL_CAPACITY, mesh=SHARD_MESH["3d"],
                                pbc=PBC), dev)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with plain_calls() as plain:
        t0 = time.time()
        st, order = md.distribute(x)
        torch.cuda.synchronize()
    launches = {k: getattr(kernels, k).launches for k in ("g_harm",
                                                          "force_harm")}
    log(f"[{tag}] distribute {time.time() - t0:.2f} s: {shard_geometry(md)};"
        f" skin rows {tuple(st.idx.shape)} "
        f"({st.idx.numel() * st.idx.element_size() / 2**30:.2f} GiB), peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(not plain, f"{tag}: plain versions ran on the card: {plain}")
    check(launches == {"g_harm": 1, "force_harm": 1}, f"{tag}: launches "
          f"{launches}, expected one of each harmonic kernel")
    check(not bool(st.overflow.any()), f"{tag}: overflow at distribute "
          f"{st.overflow.tolist()}")
    e64, f64, w64, w_abs = ref
    eval_gates(tag, EVAL_REL, shard_outputs(st, order), (e64, f64, w64),
               w_abs)
    ms = cuda_ms(lambda: md.refill_forces(st), 3)
    log(f"[{tag}] one evaluation of the {md.cfg.n_devices} frames: {ms:.2f} "
        "ms (median of 3, CUDA events)")
    planes = shard_planes(md, st, st.short.sidx, PBC)
    del st, md, e64, f64, w64
    harm, _ = fe_kernel_cases(cfg32.npsf, cfg32.ntsf, cfg32.cut,
                              planes[0].shape[0], dev)
    shard_kernel_checks(tag, planes, harm, SHARD_HARM_STRIDE["3d"])
    log(f"[{tag}] phase {time.time() - t_phase:.1f} s")
    return launches


def phase_shard_ni(dev, x, box, cfg32, p32, cfg64, p64, mass, card, ref,
                   ni_rate, layout="1d"):
    """A sharded driver on the ni scene (periodic: the seam's halos take
    their +-L shift): FrameShortModel(FusedNi) over SHARD_D slabs ("1d",
    [shard-ni]) or a (2, 2, 2) grid of bricks ("3d", [shard3d-ni]). (a)
    distribute on the thermal box in f32 against the f64 plain
    single-device path (NI_EVAL_REL), and in f64 against the f64
    single-device kernel path (SHARD_REL64); (b) ni_g and ni_force against
    their plain versions on the frame planes; (c) on slabs, an undersized
    halo trips the coverage proof; (d) SHARD_BLOCKS NVT blocks from the
    perfect lattice, as the ni main path."""
    from meng_zhang_tpu_torch.md.simulation import create_velocities
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.parallel import domain as D
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    from meng_zhang_tpu_torch.testing import thermal_fcc
    tag = f"{SHARD_TAG[layout]}-ni"
    t_phase = time.time()
    n = x.shape[0]
    pbc = (True,) * 3
    rc = fn.FusedNi(cfg32, p32).rc

    def model(cfg, p):
        return D.FrameShortModel(fn.FusedNi(cfg, p, k_short=NI_KS,
                                            short_delta=NI_DELTA))

    def md_of(mdl, bx, **kw):
        return shard_driver(mdl, mass, bx, shard_config(
            n, rc, NI_SKIN, NI_CAPACITY, NI_CELL_CAPACITY,
            mesh=SHARD_MESH[layout], stale_factor=0.5, **kw), dev)

    md = md_of(model(cfg32, p32), box)
    t0 = time.time()
    st, order = md.distribute(x)
    torch.cuda.synchronize()
    log(f"[{tag}] distribute {time.time() - t0:.2f} s: {shard_geometry(md)}")
    check(not bool(st.overflow.any()), f"{tag}: overflow at distribute")
    e64, f64, w64, w_abs = ref
    eval_gates(tag, NI_EVAL_REL, shard_outputs(st, order), (e64, f64, w64),
               w_abs)
    planes = shard_planes(md, st, st.short.sidx, pbc)
    del st, md, e64, f64, w64
    shard_kernel_checks(tag, planes, ni_kernel_cases(
        cfg32, fn.ni_table(p32["coerad"], p32["coeang"]),
        planes[0].shape[0], dev))
    del planes

    x64, box64 = x.double(), box.double()
    ev64 = fn.FusedNi(cfg64, p64, k_short=NI_KS, short_delta=NI_DELTA)
    nb = build_neighbors_cell(x64, box64, rc + NI_SKIN, NI_CAPACITY,
                              ni_md_config(rc, box.cpu().numpy()).cell_dims,
                              NI_CELL_CAPACITY)
    want = ev64.energy_forces(x64, box64, nb.idx)
    del nb
    md = md_of(model(cfg64, p64), box64)
    st, order = md.distribute(x64)
    shard_rel64(tag, "f64 FrameShortModel vs one device",
                shard_outputs(st, order), want)
    del st, want
    if layout == "1d":
        shard_coverage(tag, md, x64)
    del md, x64

    x0 = torch.tensor(thermal_fcc(NI_CELLS, disp=0.0, a=NI_A)[0],
                      dtype=torch.float32, device=dev)
    masses = torch.full((n,), mass, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    v0 = create_velocities(gen, masses, NI_T_INIT, torch.float32)

    def sim_run():
        sim, xx, bb, _ = ni_simulator(dev, cfg32, p32, mass)
        s = sim.init_state(xx, bb, v=v0)
        return sim.run(s, SHARD_T_STEPS // NI_THERMO_EVERY)[1]

    md = md_of(model(cfg32, p32), box, ensemble="nvt", t_target=NI_T,
               tau_t=0.1, thermo_every=NI_THERMO_EVERY)
    launches = shard_md(tag, md, x0, v0, SHARD_BLOCKS, ("ni_g", "ni_force"),
                        card, sim_run, NI_EVAL_REL["max_dF"], ni_rate, mass,
                        thermo_every=NI_THERMO_EVERY)
    log(f"[{tag}] phase {time.time() - t_phase:.1f} s")
    return launches


def phase_shard_anna(dev, box_lists, cfg32, p32, mass, card, ref,
                     anna_rate, layout="1d"):
    """A sharded driver on the ANNA scene, AnnaFrameModel(fast=True) on
    the skin rows at full width: SHARD_D slabs ("1d", [shard-anna]) or a
    (2, 2) grid of columns ("2d", [shard2d-anna]). (a) distribute on the
    thermal box in f32 against make_anna_fast_fns in f64 (g_harm's plain
    version) on one device (ANNA_EVAL_REL); (b) g_harm against its plain
    version on the frame planes; (c) SHARD_ANNA_BLOCKS NVE blocks from the
    ANNA main path's start (the perfect lattice, its velocities), drift
    printed, not gated: the slabs with halo_b SHARD_ANNA_HALO_B, the grid
    with its derived send-table capacities. (The thermal box's 0.08 A
    displacements heat the NVE run past 1,200 K.)"""
    from meng_zhang_tpu_torch.md.simulation import create_velocities
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.parallel import domain as D
    tag = f"{SHARD_TAG[layout]}-anna"
    t_phase = time.time()
    x, box, _, _ = box_lists
    n = x.shape[0]
    pbc = (True,) * 3

    def md_of(**kw):
        return shard_driver(model, mass, box, shard_config(
            n, cfg32.cut, ANNA_SKIN, ANNA_CAPACITY, ANNA_CELL_CAPACITY,
            mesh=SHARD_MESH[layout], stale_factor=0.5, **kw), dev)

    model = D.AnnaFrameModel(cfg32, p32, fast=True)
    md = md_of()
    t0 = time.time()
    st, order = md.distribute(x)
    torch.cuda.synchronize()
    log(f"[{tag}] distribute {time.time() - t0:.2f} s: {shard_geometry(md)}")
    check(not bool(st.overflow.any()), f"{tag}: overflow at distribute")
    e64, f64, w64 = ref
    e32, f32, w32 = shard_outputs(st, order)
    got = {"dE_per_atom": abs(float(e32) - float(e64)) / n,
           "max_dF": float((f32.double() - f64).abs().max()),
           "max_dW": float((w32.double() - w64).abs().max()),
           "sum_F": float(f32.double().sum(0).abs().max())}
    scale = {"dE_per_atom": abs(float(e64)) / n,
             "max_dF": float(f64.abs().max()),
             "max_dW": float(w64.abs().max()),
             "sum_F": n * float(f64.pow(2).mean().sqrt())}
    for key, val in got.items():
        bound_abs = ANNA_EVAL_REL[key] * scale[key]
        log(f"[{tag}] {key} {val:.3e} (bound {bound_abs:.3e} = "
            f"{ANNA_EVAL_REL[key]:.0e} x {scale[key]:.4e})")
        check(val <= bound_abs, f"{tag} {key} {val:.3e} over "
              f"{bound_abs:.3e}")
    planes = shard_planes(md, st, st.idx, pbc)
    del st, md, e32, f32, w32
    npsf, ntsf, rc = cfg32.npsf, cfg32.ntsf, cfg32.cut
    shard_kernel_checks(tag, planes, [
        ("g_harm", lambda pl, dt: kernels.g_harm(*pl, npsf, ntsf, rc),
         lambda pl, dt: fa.g_harm_plain(*pl, npsf, ntsf, rc),
         ("g_raw", "A"), REL_BOUND)])
    del planes

    masses = torch.full((n,), mass, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    v0 = create_velocities(gen, masses, ANNA_T, torch.float32)

    def sim_run():
        sim, xx, bb = anna_simulator(dev, cfg32, p32, mass)
        s = sim.init_state(xx, bb, v=v0)
        return sim.run(s, SHARD_T_STEPS // ANNA_EVERY)[1]

    x0 = anna_simulator(dev, cfg32, p32, mass)[1]
    halo = {"halo_b": SHARD_ANNA_HALO_B} if layout == "1d" else {}
    md = md_of(thermo_every=ANNA_EVERY, **halo)
    launches = shard_md(tag, md, x0, v0, SHARD_ANNA_BLOCKS, ("g_harm",),
                        card, sim_run, ANNA_EVAL_REL["max_dF"], anna_rate,
                        mass, thermo_every=ANNA_EVERY)
    log(f"[{tag}] phase {time.time() - t_phase:.1f} s")
    return launches


# ------------------------------------------------- across processes
def shard_x_bound(rel_f, f_max, mass, steps, extent):
    """max |dx| bound after `steps` steps between two f32 runs from one
    start whose evaluations are each within rel_f * f_max of the f64 forces
    (the evaluator gates): the accelerations differ by at most da = 2 rel_f
    f_max / (m MVV2E), so the positions by da (steps dt)^2 / 2 (to first
    order); and each step rounds a position in f32 at most twice (the drift
    and the wrap or the barostat's scaling), which may leave the two runs
    up to one ulp of the box's largest edge apart each time."""
    from meng_zhang_tpu_torch.units import MVV2E
    t = steps * 0.001
    da = 2.0 * rel_f * f_max / (mass * MVV2E)
    return 0.5 * da * t * t + 2 * steps * float(np.spacing(np.float32(extent)))


def dist_compare(tag, got, want, spec, rel):
    """A run over the process group against the same run in this process
    (launch.run_sharded's results for spec): finite thermo, no overflow or
    unsafe, and at every block T within shard_t_bound and PE within 2
    rel["dE_per_atom"] |PE| + N max|F| shard_x_bound (each run's f32 PE
    within the evaluator gate of the f64 energy at its own positions, and
    those positions apart by at most the x bound), and the final positions
    (nearest image on the periodic axes) within shard_x_bound: the two f32
    runs differ by rounding alone (index_add_'s atomics deliver the Fj in
    another order on every run, and the virial adds the ranks' partial sums
    in rank order), each within the evaluator gates' rel["max_dF"] of the
    f64 forces, so they differ by at most the bounds that hold two such
    runs apart. Rebuilds and migrated atoms are printed."""
    for out, who in ((got, "ranks"), (want, "in process")):
        check(all(np.isfinite(c).all() for c in out["thermo"].values()),
              f"{tag}: non-finite thermo ({who})")
        check(not out["overflow"].any() and not out["unsafe"].any(),
              f"{tag}: overflow {out['overflow'].tolist()} unsafe "
              f"{out['unsafe'].tolist()} ({who})")
    rel_f, mass, every = rel["max_dF"], spec.mass, spec.cfg.thermo_every
    n = want["x"].shape[0]
    extent = float(want["box"].max())
    f_max = float(np.abs(want["f"]).max())
    v_rms = float(np.sqrt((want["v"] ** 2).mean() * 3.0))
    for i, (t_got, t_ref) in enumerate(zip(got["thermo"]["temp"],
                                           want["thermo"]["temp"])):
        steps = (i + 1) * every
        bnd = shard_t_bound(t_ref, rel_f, f_max, mass, steps, v_rms)
        pe_ref = want["thermo"]["pe"][i]
        d_pe = got["thermo"]["pe"][i] - pe_ref
        pe_bnd = (2.0 * rel["dE_per_atom"] * abs(pe_ref) + n * f_max
                  * shard_x_bound(rel_f, f_max, mass, steps, extent))
        log(f"[{tag}] block {i + 1}: T {t_got:.6f} K against {t_ref:.6f} K "
            f"in process: |dT| {abs(t_got - t_ref):.3e} K (bound {bnd:.3e} "
            f"K); dPE {d_pe:+.3e} eV (bound {pe_bnd:.3e} eV)")
        check(abs(t_got - t_ref) <= bnd, f"{tag}: T off the in-process run")
        check(abs(d_pe) <= pe_bnd, f"{tag}: PE off the in-process run")
    d = got["x"] - want["x"]
    per = np.asarray(spec.pbc)
    d[:, per] -= want["box"][per] * np.rint(d[:, per] / want["box"][per])
    dx = float(np.abs(d).max())
    x_bnd = shard_x_bound(rel_f, f_max, mass, len(want["block_s"]) * every,
                          extent)
    log(f"[{tag}] max |dx| {dx:.3e} A (bound {x_bnd:.3e} A); rebuilds "
        f"{got['rebuild_count']} / {want['rebuild_count']}, migrated "
        f"{got['migrated']} / {want['migrated']} (ranks / in process)")
    check(dx <= x_bnd, f"{tag}: positions off the in-process run")


def dist_launches(tag, out, want):
    """Each rank's launches against `want` {kernel: count} (every other
    kernel 0): every rank launches each kernel once a step for its own
    shards."""
    from meng_zhang_tpu_torch.ops import kernels
    for r, got in enumerate(out.launches):
        exp = {k: want.get(k, 0) for k in kernels.WRAPPERS}
        check(got == exp, f"{tag}: rank {r} launches {got}, expected {exp}")


def dist_rate(tag, got, want, n, thermo_every, card):
    """Rank 0's blocks after the first (the first warms the caches)
    against the in-process run's."""
    blocks = got["block_s"]
    steps = thermo_every * max(len(blocks) - 1, 1)
    rates = [n * steps / (sum(out["block_s"][1:]) or out["block_s"][0])
             for out in (got, want)]
    log(f"[{tag}] {rates[0]:.1f} atom-steps/s over {steps} steps (rank 0's "
        f"clock), in process {rates[1]:.1f}, on {card}; distribute "
        f"{got['distribute_s']:.2f} s (in process "
        f"{want['distribute_s']:.2f}), blocks "
        f"{', '.join(f'{b:.3f}' for b in got['block_s'])} s (in process "
        f"{', '.join(f'{b:.3f}' for b in want['block_s'])})")


def dist_launch_line(tag, out, wall, card):
    """The launch's wall, each rank's start and run seconds and peak
    device memory."""
    log(f"[{tag}] {len(out.launches)} ranks on {card}: launch wall {wall:.1f}"
        f" s; a rank's start (spawn to the group's first barrier) "
        f"{', '.join(f'{s[0]:.1f}' for s in out.seconds)} s, run "
        f"{', '.join(f'{s[1]:.1f}' for s in out.seconds)} s; peak device "
        f"memory {', '.join(f'{b / 2**30:.2f}' for b in out.peak_bytes)} "
        "GiB")


def dist_fe_specs(x, box, cfg32, mass):
    """[shard-fe]'s run from the main path's start (4 slabs, y-coupled
    NPT, f32, FrameShortModel(FusedAnnp), migrate_b SHARD_MIGRATE_B) for
    DIST_BLOCKS blocks, then a migrate and a rebuild; and one f64
    evaluation of the slab x < SHARD_SLAB_X."""
    import dataclasses
    from meng_zhang_tpu_torch.md.simulation import create_velocities
    from meng_zhang_tpu_torch.parallel import launch
    dev = x.device
    n = x.shape[0]
    masses = torch.full((n,), mass, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    v0 = create_velocities(gen, masses, 300.0, torch.float32)
    mcfg = md_config(cfg32)
    cfg = shard_config(n, cfg32.cut, SKIN, CAPACITY, CELL_CAPACITY, pbc=PBC,
                       ensemble="npt", t_target=300.0, tau_t=mcfg.tau_t,
                       p_target=mcfg.p_target, p_couple=COUPLE,
                       tau_p=mcfg.tau_p, thermo_every=THERMO_EVERY,
                       migrate_b=SHARD_MIGRATE_B)
    spec = launch.ShardRun(
        cfg=cfg, pot=_potential(), x=x.cpu().numpy(), box=box.cpu().numpy(),
        mass=mass, v=v0.cpu().numpy(), dtype="float32", pbc=PBC,
        k_short=K_SHORT, short_delta=SHORT_DELTA, n_blocks=DIST_BLOCKS,
        migrate_rebuild=True, device=dev.type)
    keep = torch.nonzero(x[:, 0] < SHARD_SLAB_X).reshape(-1)
    keep = keep[:keep.shape[0] // SHARD_D * SHARD_D]
    spec64 = dataclasses.replace(
        spec, cfg=shard_config(keep.shape[0], cfg32.cut, SKIN, CAPACITY,
                               CELL_CAPACITY, pbc=PBC),
        x=x[keep].double().cpu().numpy(), box=box.double().cpu().numpy(),
        v=None, dtype="float64", n_blocks=0, migrate_rebuild=False)
    return spec, spec64


def dist_ni_spec(dev):
    """[shard3d-ni]'s run: the (2, 2, 2) grid of bricks on the 256,000-atom
    ni scene, NVT from the perfect lattice, DIST_NI_BLOCKS blocks, then a
    migrate (three rounds) and a rebuild."""
    from meng_zhang_tpu_torch.md.simulation import create_velocities
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.parallel import launch
    from meng_zhang_tpu_torch.testing import (synthetic_ni_potential,
                                              thermal_fcc)
    cfg32, p32, _, _, mass = ni_model(dev)
    x0, box = thermal_fcc(NI_CELLS, disp=0.0, a=NI_A)
    n = x0.shape[0]
    masses = torch.full((n,), mass, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    v0 = create_velocities(gen, masses, NI_T_INIT, torch.float32)
    cfg = shard_config(n, fn.FusedNi(cfg32, p32).rc, NI_SKIN, NI_CAPACITY,
                       NI_CELL_CAPACITY, mesh=SHARD_MESH["3d"],
                       stale_factor=0.5, ensemble="nvt", t_target=NI_T,
                       tau_t=0.1, thermo_every=NI_THERMO_EVERY)
    return launch.ShardRun(
        cfg=cfg, pot=synthetic_ni_potential(0), x=x0.astype(np.float32),
        box=np.asarray(box, np.float32), mass=mass, v=v0.cpu().numpy(),
        dtype="float32", k_short=NI_KS, short_delta=NI_DELTA,
        n_blocks=DIST_NI_BLOCKS, migrate_rebuild=True,
        device=dev.type)


def phase_dist(x, box, cfg32, mass, card):
    """The drivers across processes on DIST_WORLD gloo ranks on the one
    card, in one launch ([dist-fe] and [dist3d-ni]; the ranks' P2P blocks
    through host memory): [shard-fe]'s run and f64 slab (dist_fe_specs),
    one slab a rank, and [shard3d-ni]'s run (dist_ni_spec), two bricks a
    rank, each held against the same run in this process (dist_compare;
    the slab's f64 forces within DIST_REL64 of max|F|), each rank's
    launches once a step of each of the path's kernels. Returns ({tag:
    launches of the ranks and of the in-process runs}, the fe spec)."""
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.parallel import launch
    t_phase = time.time()
    spec, spec64 = dist_fe_specs(x, box, cfg32, mass)
    spec_ni = dist_ni_spec(x.device)
    kernels.reset_launch_counts()
    t0 = time.time()
    want, want64, want_ni = (launch.run_sharded(s, distributed=False)
                             for s in (spec, spec64, spec_ni))
    ref = {k: getattr(kernels, k).launches for k in ("g_harm", "force_harm",
                                                     "ni_g", "ni_force")}
    log(f"[dist] in process: the three runs {time.time() - t0:.1f} s")
    t0 = time.time()
    out = launch.spawn(launch.run_each, DIST_WORLD, "gloo", x.device.type,
                       ([spec, spec64, spec_ni],), DIST_TIMEOUT)
    dist_launch_line("dist", out, time.time() - t0, card)
    got, got64, got_ni = out.result
    steps = DIST_BLOCKS * THERMO_EVERY
    ni_steps = DIST_NI_BLOCKS * NI_THERMO_EVERY
    dist_launches("dist", out, {"g_harm": steps + 2, "force_harm": steps + 2,
                                "ni_g": ni_steps + 1,
                                "ni_force": ni_steps + 1})
    ranks = {k: sum(r[k] for r in out.launches) for k in ref}

    tag = "dist-fe"
    log(f"[{tag}] {got['n_local']} slab a rank")
    dist_compare(tag, got, want, spec, EVAL_REL)
    f_scale = float(np.abs(want64["f"]).max())
    errs = {"F": float(np.abs(got64["f"] - want64["f"]).max()) / f_scale,
            "E": abs(got64["pe"] - want64["pe"]) / abs(want64["pe"]),
            "W": float(np.abs(got64["virial"] - want64["virial"]).max())
            / float(np.abs(want64["virial"]).max())}
    log(f"[{tag}] {spec64.x.shape[0]}-atom slab in f64 across the ranks "
        f"against in process: max dF / max|F| {errs['F']:.3e} (bound "
        f"{DIST_REL64:.0e}), rel dE {errs['E']:.3e}, max dW / max|W| "
        f"{errs['W']:.3e}")
    check(errs["F"] <= DIST_REL64, f"{tag}: f64 forces across the ranks "
          "differ from the in-process evaluation")
    dist_rate(tag, got, want, spec.x.shape[0], THERMO_EVERY, card)
    fe = {k: ranks[k] + ref[k] for k in ("g_harm", "force_harm")}
    log(f"[{tag}] launches (ranks and in process) {fe}")

    tag = "dist3d-ni"
    log(f"[{tag}] {got_ni['n_local']} bricks a rank")
    dist_compare(tag, got_ni, want_ni, spec_ni, NI_EVAL_REL)
    dist_rate(tag, got_ni, want_ni, spec_ni.x.shape[0], NI_THERMO_EVERY,
              card)
    ni = {k: ranks[k] + ref[k] for k in ("ni_g", "ni_force")}
    log(f"[{tag}] launches (ranks and in process) {ni}; [dist] phase "
        f"{time.time() - t_phase:.1f} s")
    return {"dist-fe": fe, "dist3d-ni": ni}, spec


def phase_dist_nccl(spec, card):
    """The NCCL backend ([dist-nccl]): a group of one rank holding all 4
    slabs (the collectives through NCCL, every pair local), one block of
    [dist-fe]'s run against the same block in this process; with two or
    more visible cards, [dist-fe]'s run with one rank a card on 4 (or 2)
    cards against the in-process run. NCCL refuses two ranks of one
    communicator on one card."""
    import dataclasses
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.parallel import launch
    tag = "dist-nccl"
    t_phase = time.time()
    spec1 = dataclasses.replace(spec, n_blocks=1, migrate_rebuild=False)
    kernels.reset_launch_counts()
    want = launch.run_sharded(spec1, distributed=False)
    ref = {k: getattr(kernels, k).launches for k in ("g_harm",
                                                     "force_harm")}
    t0 = time.time()
    out = launch.spawn(launch.run_sharded, 1, "nccl", spec.device, (spec1,),
                       DIST_TIMEOUT)
    dist_launch_line(tag, out, time.time() - t0, card)
    log(f"[{tag}] one NCCL rank, {out.result['n_local']} slabs")
    dist_compare(tag, out.result, want, spec1, EVAL_REL)
    dist_launches(tag, out, {"g_harm": THERMO_EVERY + 1,
                             "force_harm": THERMO_EVERY + 1})
    dist_rate(tag, out.result, want, spec.x.shape[0], THERMO_EVERY, card)
    launches = {k: ref[k] + out.launches[0][k] for k in ref}
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[{tag}] across cards: not run, {count} visible card")
    else:
        world = 4 if count >= 4 else 2
        kernels.reset_launch_counts()
        want = launch.run_sharded(spec, distributed=False)
        for k in launches:
            launches[k] += getattr(kernels, k).launches
        t0 = time.time()
        out = launch.spawn(launch.run_sharded, world, "nccl", spec.device,
                           (spec,), DIST_TIMEOUT)
        sub = f"{tag} {world} cards"
        dist_launch_line(sub, out, time.time() - t0, card)
        dist_compare(sub, out.result, want, spec, EVAL_REL)
        steps = DIST_BLOCKS * THERMO_EVERY
        dist_launches(sub, out, {"g_harm": steps + 1,
                                 "force_harm": steps + 1})
        dist_rate(sub, out.result, want, spec.x.shape[0], THERMO_EVERY,
                  card)
        for k in launches:
            launches[k] += sum(r[k] for r in out.launches)
    log(f"[{tag}] launches (ranks and in process) {launches}; phase "
        f"{time.time() - t_phase:.1f} s")
    return launches


# ------------------------------------------------- scale configurations
def scale_script(tag, module, argv, stdout=None, **kw):
    """module.main(argv, **kw) (meng_zhang_tpu_torch/scripts/) on the card
    in this process, its JSON line echoed (and kept in `stdout`, a
    StringIO, when given): (the run it returns, the kernels' launches
    counted from 0, wall seconds). No plain version may run."""
    from meng_zhang_tpu_torch.ops import kernels
    out = io.StringIO() if stdout is None else stdout
    kernels.reset_launch_counts()
    t0 = time.time()
    try:
        with plain_calls() as plain, contextlib.redirect_stdout(out):
            run = module.main(argv, **kw)
    except (SystemExit, RuntimeError) as e:
        raise SmokeFailure(f"{tag}: {module.__name__}.main failed: {e}")
    wall = time.time() - t0
    for line in out.getvalue().splitlines():
        log(f"[{tag}] {line}")
    check(not plain, f"{tag}: plain versions ran on the card: {plain}")
    launches = {k: getattr(kernels, k).launches for k in kernels.WRAPPERS}
    log(f"[{tag}] {wall:.2f} s in {module.__name__}.main; launches "
        f"{launches}")
    return run, launches, wall


def scale_gates(tag, rec, launches, evaluations, wall, card):
    """A scale run's gates: no overflow, no `unsafe` latch in the timed
    window, finite thermo, and g_harm / force_harm once an evaluation and
    no other kernel; prints the phase's atoms, peak memory, wall and
    rate."""
    check(not rec["overflow"], f"{tag}: neighbor overflow")
    check(not rec["unsafe"], f"{tag}: unsafe (dangerous-build) latch set in "
          "the timed window")
    check(all(math.isfinite(rec[k]) for k in (
        "temp_K", "press_bar", "pe_eV", "vol_A3", "drift_eV")),
        f"{tag}: non-finite thermo")
    for name, count in launches.items():
        want = evaluations if name in ("g_harm", "force_harm") else 0
        check(count == want, f"{tag}: {name} launched {count} times, "
              f"expected {want}")
    log(f"[{tag}] {rec['atoms']} atoms: {rec['steps']} timed steps "
        f"{rec['atom_steps_per_s']:.1f} atom-steps/s ({rec['wall_s']:.3f} s"
        f" timed), T {rec['temp_K']:.2f} K, P {rec['press_bar']:.1f} bar, "
        f"NVE/NPT drift {rec['drift_eV']:.4f} eV (printed, not gated), "
        f"{rec['rebuilds']} rebuilds; peak device memory "
        f"{rec['peak_mem_gib']:.3f} GiB (by stage: "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    rec["peak_mem_gib_by_stage"].items())
        + f"); phase wall {wall:.1f} s on {card}")


def rows_planes(x, box, sidx, rows, pbc):
    """dx planes [len(rows), K] of the short rows of atoms `rows`."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    return fa.pair_dx_planes(x[rows], box, sidx[rows], pbc, x_ext=x)


def scale_kernel_times(tag, planes, cfg):
    """g_harm and force_harm on the full scene's [N, 128] short planes:
    median ms of 5 (CUDA events; force_harm's coefficient tables drawn on
    the card) and the bound from this run's pairs. Outside the launch
    counts."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    npsf, ntsf, rc = cfg.npsf, cfg.ntsf, cfg.cut
    p, k = planes[0].shape
    gen = torch.Generator(device=planes[0].device).manual_seed(SEED)
    dedg = torch.zeros((p, fa.NSF_PAD), device=planes[0].device)
    dedg[:, :npsf + ntsf] = torch.randn((p, npsf + ntsf), generator=gen,
                                        device=planes[0].device)
    b = torch.zeros((p, fa.AB_PAD), device=planes[0].device)
    b[:, :ntsf * ntsf + 1] = torch.randn((p, ntsf * ntsf + 1),
                                         generator=gen,
                                         device=planes[0].device)
    lanes, pairs = fe_counts(planes, rc)
    out = {}
    for name, fn in (("g_harm", lambda: kernels.g_harm(*planes, npsf, ntsf,
                                                       rc)),
                     ("force_harm", lambda: kernels.force_harm(
                         *planes, dedg, b, npsf, ntsf, rc))):
        ms = cuda_ms(fn, 5)
        b_ms, b_by = bound(fe_flops(name, lanes, pairs, npsf, ntsf),
                           fe_bytes(name, p, k, 4))
        out[name] = (ms, b_ms, b_by)
        log(f"[{tag}] {name} f32 on the scene's [{p}, {k}] short planes: "
            f"{ms:.3f} ms (median of 5, CUDA events; bound {b_ms:.3f} ms, "
            f"{b_by}; {lanes:.4e} lanes in the cutoff)")
    return out


def phase_scale_500k(card):
    """Config 3 through `scripts/scale_demo.py --config 500k` at its full
    500,094 atoms, SCALE_500K_STEPS timed NPT steps after the warm-up: the
    scale gates, the box moved on all three axes, g_harm / force_harm
    against their plain versions on the first SCALE_SLICE short rows, and
    their times on the full scene."""
    from meng_zhang_tpu_torch.scripts import scale_demo
    tag = "scale-500k"
    run, launches, wall = scale_script(
        tag, scale_demo, ["--config", "500k", "--steps",
                          str(SCALE_500K_STEPS)])
    rec, st = run.record, run.state
    c = scale_demo.CONFIGS["500k"]
    steps = run.sim.cfg.thermo_every * scale_demo.WARMUP_BLOCKS + rec["steps"]
    scale_gates(tag, rec, launches, 1 + steps, wall, card)
    b0, b1 = run.box.tolist(), st.box.tolist()
    log(f"[{tag}] box {b0} -> {b1} (p_couple {c['couple']})")
    check(all(u != v for u, v in zip(b0, b1)),
          f"{tag}: the barostat left an axis of the box unmoved")
    pbc = tuple(run.evaluator.pbc)
    cfg = run.evaluator.cfg
    rows = torch.arange(SCALE_SLICE, device=st.x.device)
    shard_kernel_checks(tag, rows_planes(st.x, st.box, st.short.sidx, rows,
                                         pbc),
                        fe_kernel_cases(cfg.npsf, cfg.ntsf, cfg.cut,
                                        SCALE_SLICE, st.x.device)[0])
    planes = rows_planes(st.x, st.box, st.short.sidx,
                         torch.arange(rec["atoms"], device=st.x.device), pbc)
    times = scale_kernel_times(tag, planes, cfg)
    return {k: launches[k] for k in ("g_harm", "force_harm")}, times


class _Timed:
    """Wraps module.name to add each call's seconds to .seconds."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn, self.seconds = getattr(module, name), 0.0

    def __enter__(self):
        def timed_call(*a, **kw):
            t0 = time.time()
            try:
                return self.fn(*a, **kw)
            finally:
                self.seconds += time.time() - t0
        setattr(self.module, self.name, timed_call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_scale_2m(card):
    """Config 5's scene through `scripts/scale_demo.py --config 2m` at its
    full 1,964,085 atoms: the STGB build (its overlap prune timed), FIRE
    (<= 100 iterations), the warm-up, SCALE_2M_STEPS timed NVE steps; the
    scale gates, g_harm / force_harm against their plain versions on two
    slices of SCALE_SLICE short rows (the first atoms, and the atoms
    nearest the grain boundary at x = STGB_PLANE_X), their times on the
    full scene, the peak memory of one skin-list build, one compaction and
    one evaluation, and one f32 evaluation of the relaxed scene against
    one f64 evaluation (the evaluator gates, EVAL_REL)."""
    from meng_zhang_tpu_torch.geometry import stgb
    from meng_zhang_tpu_torch.models.annp import make_annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.scripts import scale_demo
    tag = "scale-2m"
    with _Timed(stgb, "_prune_overlaps") as prune:
        run, launches, wall = scale_script(
            tag, scale_demo, ["--config", "2m", "--steps",
                              str(SCALE_2M_STEPS)], warmup=SCALE_2M_WARMUP)
    rec, st, sim, ev = run.record, run.state, run.sim, run.evaluator
    n = rec["atoms"]
    log(f"[{tag}] scene built in {rec['scene_s']:.3f} s, its overlap prune "
        f"{prune.seconds:.3f} s (host); FIRE {rec['fire_iters']} iterations"
        f" in {rec['fire_s']:.2f} s, fmax {rec['fire_fmax']:.4e} eV/A; init"
        f" {rec['init_s']:.2f} s; warm-up {rec['warmup_s']:.2f} s")
    evaluations = rec["fire_iters"] + 1 + 1 + \
        sim.cfg.thermo_every * SCALE_2M_WARMUP + rec["steps"]
    scale_gates(tag, rec, launches, evaluations, wall, card)
    pbc, cfg, dev = tuple(ev.pbc), ev.cfg, st.x.device
    cases = fe_kernel_cases(cfg.npsf, cfg.ntsf, cfg.cut, SCALE_SLICE, dev)[0]
    near = torch.argsort((st.x[:, 0] - STGB_PLANE_X).abs())[:SCALE_SLICE]
    log(f"[{tag}] boundary slice: x in [{float(st.x[near, 0].min()):.3f}, "
        f"{float(st.x[near, 0].max()):.3f}] A")
    for what, rows in (("first rows", torch.arange(SCALE_SLICE, device=dev)),
                       ("boundary rows", near)):
        log(f"[{tag}] kernels vs plain on the {what}")
        shard_kernel_checks(tag, rows_planes(st.x, st.box, st.short.sidx,
                                             rows, pbc), cases)
    planes = rows_planes(st.x, st.box, st.short.sidx,
                         torch.arange(n, device=dev), pbc)
    times = scale_kernel_times(tag, planes, cfg)
    del planes, cases, near
    x, box = run.x_start, run.box
    del run, st

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks = {}
    for what, fn in (("skin-list build", lambda: sim.build_nbrs(x, box)),
                     ("compaction", lambda: ev.compact_short(x, box,
                                                             nb.idx)),
                     ("evaluation", lambda: ev.energy_forces_short(
                         x, box, sl, want_virial=False))):
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peaks[what] = (torch.cuda.max_memory_allocated() - base) / 2**30
        base = torch.cuda.memory_allocated()
        if what == "skin-list build":
            nb = out
        elif what == "compaction":
            sl = out
        del out
    log(f"[{tag}] peak memory above what was held before, GiB: "
        + ", ".join(f"{k} {v:.3f}" for k, v in peaks.items())
        + f" (skin list and short list held: {base / 2**30:.3f} GiB)")
    del nb

    cfg64, p64 = make_annp(_potential(), torch.float64, dev)
    ev64 = fa.FusedAnnp(cfg64, p64, k_short=ev.k_short,
                        short_delta=ev.short_delta)
    dd = fa.pair_dx_planes(x, box, sl.sidx, pbc)
    fj = ev._eval_fj(*dd)[1]
    w_abs = max(float((da.double() * fb.double()).abs().sum())
                for da in dd for fb in fj)
    del dd, fj
    out32 = ev.energy_forces_short(x, box, sl)
    x64 = x.double()
    out64 = ev64.energy_forces_short(x64, box.double(),
                                     fa.ShortList(sl.sidx, x64, sl.overflow))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out32[1]).all()), f"{tag}: non-finite f32 "
          "forces on the relaxed scene")
    log(f"[{tag}] relaxed scene, f32 kernels vs f64 kernels: E/N f64 "
        f"{float(out64[0]) / n + cfg64.e_shift:.9f} eV, max|F| "
        f"{float(out64[1].abs().max()):.4e} eV/A")
    eval_gates(tag, EVAL_REL, out32, out64, w_abs)
    return {k: launches[k] for k in ("g_harm", "force_harm")}, times, \
        (x, box)


def phase_disloc_core(card, tmp):
    """Config 4 through `scripts/disloc_core.py` in full (30,096 atoms,
    FIRE with the shell frozen in passes of <= 400 iterations on a fresh
    skin list each, then one evaluation on a fresh list at the relaxed
    positions for the fmax and the per-atom tallies and their dump): that
    fmax within f_tol, the per-atom virials summing to the virial, the
    frozen shell exactly where it started, g_harm / force_harm once an
    evaluation."""
    from meng_zhang_tpu_torch.scripts import disloc_core
    tag = "disloc-core"
    run, launches, wall = scale_script(
        tag, disloc_core, ["--dump", os.path.join(tmp, "core.lammpstrj"),
                           "--out", os.path.join(tmp, "core.json")])
    rec = run.record
    f_tol = disloc_core.FIRE["f_tol"]
    evals = rec["fire_iters"] + rec["fire_passes"]
    log(f"[{tag}] {rec['atoms']} atoms ({rec['frozen_atoms']} frozen): FIRE"
        f" {rec['fire_iters']} iterations in {rec['fire_passes']} passes, "
        f"{rec['fire_s']:.3f} s ({rec['atoms'] * evals / rec['fire_s']:.1f} "
        f"atom-evaluations/s), largest move in a pass "
        f"{rec['fire_max_disp_A']:.3f} A ({rec['fire_last_pass_disp_A']:.3f}"
        f" in the last; half-skin {disloc_core.SKIN / 2} A), fmax on a fresh"
        f" list {rec['fmax_eV_A']:.4e} eV/A (f_tol {f_tol}), PE "
        f"{rec['pe_eV']:.6f} eV, core excess "
        f"{rec['core_excess_eV']:.4f} eV over {rec['core_atoms_r10']} atoms"
        f" (max {rec['core_max_excess_eV']:.4f}); peak device memory "
        f"{rec['peak_mem_gib']:.3f} GiB; phase wall {wall:.1f} s on {card}")
    check(rec["fmax_eV_A"] <= f_tol, f"{tag}: fmax on a fresh list at the "
          f"relaxed positions {rec['fmax_eV_A']:.4e} over f_tol {f_tol}")
    check(rec["vatom_sum_matches_virial"], f"{tag}: the per-atom virials do "
          "not sum to the virial")
    shell = run.types == 2
    x0 = run.x0.astype(np.float32).astype(np.float64)    # the run's f32 start
    check(bool(np.array_equal(run.x[shell], x0[shell])),
          f"{tag}: frozen shell atoms moved")
    for name, count in launches.items():
        want = rec["fire_iters"] + rec["fire_passes"] + 1 \
            if name in ("g_harm", "force_harm") else 0
        check(count == want, f"{tag}: {name} launched {count} times, "
              f"expected {want}")
    check(bool(np.isfinite(run.eatom).all() and np.isfinite(run.vatom).all()),
          f"{tag}: non-finite per-atom tallies")
    return {k: launches[k] for k in ("g_harm", "force_harm")}


# ----------------------------------------------------- the run scripts
def script_launches(tag, launches, want):
    """Each kernel launched want[name] times and no other kernel; returns
    the launches."""
    from meng_zhang_tpu_torch.ops import kernels
    for name in kernels.WRAPPERS:
        check(launches[name] == want.get(name, 0),
              f"{tag}: {name} launched {launches[name]} times, expected "
              f"{want.get(name, 0)}")
    return {k: v for k, v in launches.items() if v}


def add_launches(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return total


def run_rows(st):
    """The rows a Simulator state's force evaluation reads: its short
    list's (ShortList.sidx; the chunked and ANNA short rows' .idx), else
    the skin list's."""
    if st.short is None:
        return st.nbrs.idx
    return st.short.sidx if hasattr(st.short, "sidx") else st.short.idx


def slice_planes(x, box, rows_idx, pbc):
    """The dx planes of the first SCALE_SLICE rows of rows_idx."""
    rows = torch.arange(min(SCALE_SLICE, rows_idx.shape[0]), device=x.device)
    return rows_planes(x, box, rows_idx, rows, pbc)


def path_cases(kind, cfg, p, dev, table=None):
    """The kernel-vs-plain cases (shard_kernel_checks) of a path's
    kernels on [p, K] planes: "ni" ni_g and ni_force (on the ni table),
    "fe" g_harm and force_harm, "anna" g_harm at ANNA's (npsf, ntsf,
    rc)."""
    if kind == "ni":
        return ni_kernel_cases(cfg, table, p, dev)
    harm = fe_kernel_cases(cfg.npsf, cfg.ntsf, cfg.cut, p, dev)[0]
    return harm[:1] if kind == "anna" else harm


def phase_script_model(card, model):
    """`scripts/model_bench.py --model <model>` at its full scene (ni:
    256,000 atoms NVT; anna: 128,000 atoms NVE) with both backends,
    SCRIPT_MODEL_STEPS timed steps each: no overflow, no `unsafe` latch in
    the timed window, finite T and PE, the path's kernels launched once an
    evaluation and no other kernel; the kernels against their plain
    versions on SCALE_SLICE of the run's own rows at its end."""
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.scripts import model_bench
    tag = f"script-model-{model}"
    names = ("ni_g", "ni_force") if model == "ni" else ("g_harm",)
    total, rates = {}, {}
    for backend, steps in SCRIPT_MODEL_STEPS.items():
        run, launches, wall = scale_script(
            tag, model_bench, ["--model", model, "--backend", backend,
                               "--steps", str(steps)])
        rec, st = run.record, run.state
        check(not rec["overflow"], f"{tag} {backend}: neighbor overflow")
        check(not rec["unsafe"], f"{tag} {backend}: unsafe latch set in the"
              " timed window")
        check(math.isfinite(rec["temp_K"]) and math.isfinite(rec["pe_eV"]),
              f"{tag} {backend}: non-finite thermo")
        add_launches(total, script_launches(
            f"{tag} {backend}", launches,
            {k: run.evaluations for k in names}))
        rates[backend] = rec["atom_steps_per_s"]
        log(f"[{tag}] {backend}: {rec['atoms']} atoms, {rec['steps']} timed "
            f"steps {rec['atom_steps_per_s']:.1f} atom-steps/s "
            f"({rec['wall_s']:.3f} s), T {rec['temp_K']:.2f} K, PE "
            f"{rec['pe_eV']:.6f} eV, {rec['rebuilds']} rebuilds, "
            f"{run.evaluations} evaluations; phase wall {wall:.1f} s on "
            f"{card}")
        planes = slice_planes(st.x, st.box, run_rows(st), (True,) * 3)
        mcfg, params = run.model
        table = fn.ni_table(params["coerad"], params["coeang"]) \
            if model == "ni" else None
        shard_kernel_checks(f"{tag} {backend}", planes, path_cases(
            model, mcfg, planes[0].shape[0], st.x.device, table))
        del run, st, planes
    log(f"[{tag}] chunked / kernels rate: "
        f"{rates['chunked'] / rates['kernels']:.3f}")
    return total


def chained_gate(tag, run):
    """A profile's chained phases against energy_forces_short on the same
    short list: E (and W) equal, F within the f32 rounding of the
    delivery's atomic adds. Both compute an atom's row sum alike and then
    add its <= K partner terms in whatever order index_add_'s atomics
    take; reordering m additions moves a sum by at most (m - 1) u times
    the sum of the magnitudes added, so |dF| <= 2 K u S, S the sum of the
    |Fj| entering the atom (its row's and its partners'), u = 2^-24.
    Returns the largest |dF|."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    ev, x, box = run.evaluator, run.x, run.box
    (e_c, f_c), (e_r, f_r) = run.chained[:2], run.ef[:2]
    check(bool(torch.isfinite(f_c).all()), f"{tag}: non-finite forces")
    check(float(e_c) == float(e_r), f"{tag}: chained E {float(e_c)!r} != "
          f"energy_forces_short's {float(e_r)!r}")
    if len(run.chained) > 2:
        check(bool(torch.equal(run.chained[2], run.ef[2])),
              f"{tag}: chained W differs from energy_forces_short's")
    # the phases' short list, rebuilt as the profile built it
    sidx = ev.compact_short(x, box, run.sim.build_nbrs(x, box).idx).sidx
    fj = ev._eval_fj(*fa.pair_dx_planes(x, box, sidx, ev.pbc))[1]
    mag = torch.stack([t.abs() for t in fj], -1)            # [N, K, 3]
    del fj
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    target = torch.where(sidx < x.shape[0], sidx, rows).reshape(-1)
    s = mag.sum(1).index_add_(0, target, mag.reshape(-1, 3))
    del mag, target
    bnd = 2.0 * sidx.shape[1] * U32 * s
    diff = (f_c - f_r).abs()
    worst = float((diff / bnd.clamp_min(1e-30)).max())
    log(f"[{tag}] chained phases vs energy_forces_short: E equal, max |dF| "
        f"{float(diff.max()):.3e} eV/A, {worst:.3e} of its bound 2 K u S "
        f"at most (K {sidx.shape[1]})")
    check(bool((diff <= bnd).all()), f"{tag}: chained forces off "
          "energy_forces_short's beyond the f32 rounding of the delivery")
    return float(diff.max())


PROFILE_KERNELS = {"fe": ("g_harm", "force_harm"), "2m": ("g_harm",
                   "force_harm"), "ni": ("ni_g", "ni_force")}


def phase_script_profile(card, which, scene=None):
    """`scripts/profile_bench.py` ("fe"), `profile_ni.py` ("ni") or
    `profile_2m.py` ("2m", on `scene`, [scale-2m]'s relaxed positions) in
    full: every phase timed and positive, the chained phases against
    energy_forces_short (chained_gate), the path's two kernels launched
    as the profile counts its calls and no other kernel, the kernels
    against their plain versions on SCALE_SLICE of the final MD state's
    short rows; prints the phase table (times, shares, and for 2m each
    phase's peak memory)."""
    from meng_zhang_tpu_torch.scripts import (profile_2m, profile_bench,
                                              profile_ni)
    tag = f"script-profile-{which}"
    mod = {"fe": profile_bench, "ni": profile_ni, "2m": profile_2m}[which]
    kw = {} if scene is None else {"scene": scene}
    run, launches, wall = scale_script(tag, mod, [], **kw)
    rec = run.record
    got = script_launches(tag, launches, {k: run.kernel_calls
                                          for k in PROFILE_KERNELS[which]})
    check(all(math.isfinite(t) and t > 0.0 for t in rec["times_s"].values()),
          f"{tag}: a phase without a positive time")
    peaks = rec.get("peak_mem_gib_by_phase") or {}
    held = rec.get("held_mem_gib_by_phase") or {}
    for k, t in rec["times_s"].items():
        mem = (f", peak {peaks[k]:.3f} GiB (held at start {held[k]:.3f})"
               if k in peaks else "")
        log(f"[{tag}] {k:14s} {t * 1e3:10.3f} ms  share of a step "
            f"{rec['share_of_step'][k]:.4f}{mem}")
    for k in set(peaks) - set(rec["times_s"]):
        log(f"[{tag}] {k}: peak {peaks[k]:.3f} GiB (held at start "
            f"{held[k]:.3f})")
    log(f"[{tag}] {rec['atoms']} atoms: {rec['atom_steps_per_s_step']:.1f} "
        f"atom-steps/s from the step time; phase wall {wall:.1f} s on "
        f"{card}")
    chained_gate(tag, run)
    st, ev = run.state, run.evaluator
    planes = slice_planes(st.x, st.box, st.short.sidx, ev.pbc)
    shard_kernel_checks(tag, planes, path_cases(
        "ni" if which == "ni" else "fe", ev.cfg, planes[0].shape[0],
        st.x.device, getattr(ev, "table", None)))
    return got

def sharded_checks(tag, md, st, rc):
    """The sharded run's kernels against their plain versions on
    SCALE_SLICE rows of its frame planes, as the model compacts them
    (XlaFrameModel: each centre row's skin row cut to k_short at rc)."""
    from meng_zhang_tpu_torch.ops import frames
    pbc = (True,) * 3
    x_ext = md._frame(st.x_loc, st.halo_l, st.halo_r)
    off, cc = md._short_geom()
    idx, _ = frames.compact_frames(x_ext, st.box, st.idx, off, cc, rc,
                                   md.model.k_short, pbc)
    planes = [t[:SCALE_SLICE] for t in shard_planes(md, st, idx, pbc)]
    shard_kernel_checks(tag, planes, path_cases(
        "fe", md.model.mcfg, planes[0].shape[0], st.x_loc.device))


def sharded_pe_bound(pe_ref, rel, f_max, mass, steps, extent, n):
    """|dPE| bound after `steps` steps between two f32 runs from one start
    whose evaluations are each within the evaluator gates of the f64 path
    (EVAL_REL): at equal positions the two shift-free energies differ by
    at most 2 dE_per_atom |E| (each within dE_per_atom |E| of the f64
    one), and the positions differ by at most shard_x_bound, which moves E
    by at most n f_max |dx| (to first order)."""
    return (2.0 * rel["dE_per_atom"] * abs(pe_ref)
            + n * f_max * shard_x_bound(rel["max_dF"], f_max, mass, steps,
                                        extent))


def phase_script_sharded(card, scene):
    """`scripts/sharded_demo.py --scene <scene>`: small (2,016 atoms on 4
    slabs, SCRIPT_SHARDED_SMALL_STEPS NPT steps, and its single-device
    reference) or 100k (100,000 atoms on 8 slabs, 30 steps). No overflow,
    no `unsafe` latch, finite thermo, g_harm / force_harm once an
    evaluation of each run and no other kernel, the kernels against their
    plain versions on the frame planes; for small, T and PE against the
    single-device run over the first SCRIPT_PARITY_STEPS steps within
    shard_t_bound and sharded_pe_bound (the run-long statistics printed,
    not gated: f32 trajectories diverge)."""
    from meng_zhang_tpu_torch.scripts import sharded_demo
    from meng_zhang_tpu_torch.units import MASS_FE
    tag = f"script-sharded-{scene}"
    argv = ["--scene", scene]
    if scene == "small":
        argv += ["--steps", str(SCRIPT_SHARDED_SMALL_STEPS)]
    run, launches, wall = scale_script(tag, sharded_demo, argv)
    rec, st, md, th = run.record, run.state, run.md, run.thermo
    check(not rec["overflow"], f"{tag}: overflow")
    check(not rec["unsafe"], f"{tag}: unsafe latch set")
    check(all(bool(torch.isfinite(c).all()) for c in th),
          f"{tag}: non-finite thermo")
    evals = run.evaluations * (2 if scene == "small" else 1)
    got = script_launches(tag, launches, {"g_harm": evals,
                                          "force_harm": evals})
    log(f"[{tag}] {rec['atoms']} atoms on {rec['devices']} shards (halo_b "
        f"{rec['halo_b']}, capacity {rec['capacity']}): {rec['steps']} NPT "
        f"steps, {rec['atom_steps_per_s']:.1f} atom-steps/s over the timed "
        f"{rec['wall_s']:.3f} s, {rec['rebuilds']} rebuilds; phase wall "
        f"{wall:.1f} s on {card}")
    if scene == "small":
        ref = run.ref_thermo
        f_max = float(st.f_loc.abs().max())
        v_rms = float(st.v_loc.double().pow(2).mean().sqrt()) * math.sqrt(3)
        extent = float(st.box.max())
        for i in range(SCRIPT_PARITY_STEPS // sharded_demo.THERMO
                       - 1):
            steps = (i + 2) * sharded_demo.THERMO
            t_ref, pe_ref = float(ref.temp[i + 1]), float(ref.pe[i + 1])
            dt_ = abs(float(th.temp[i]) - t_ref)
            dpe = abs(float(th.pe[i]) - pe_ref)
            bt = shard_t_bound(t_ref, EVAL_REL["max_dF"], f_max, MASS_FE,
                               steps, v_rms)
            bp = sharded_pe_bound(pe_ref, EVAL_REL, f_max, MASS_FE, steps,
                                  extent, rec["atoms"])
            log(f"[{tag}] step {steps}: |dT| {dt_:.3e} K (bound {bt:.3e}),"
                f" |dPE| {dpe:.3e} eV (bound {bp:.3e})")
            check(dt_ <= bt and dpe <= bp, f"{tag}: step {steps} off the "
                  "single-device run")
        log(f"[{tag}] parity (the record's): "
            + ", ".join(f"{k} {v:.4g}" for k, v in rec["parity"].items()))
    sharded_checks(tag, md, st, md.model.mcfg.cut)
    return got


def phase_script_sharded2d(card):
    """`scripts/sharded2d_demo.py` at its defaults (12,672 atoms on a
    (2, 4) grid): its own t = 0 parity limits (it raises past them), 20
    NVE steps with no overflow and finite thermo, g_harm / force_harm
    once an evaluation (and once for the single-device reference), the
    kernels against their plain versions on the frame planes."""
    from meng_zhang_tpu_torch.scripts import sharded2d_demo
    tag = "script-sharded2d"
    run, launches, wall = scale_script(tag, sharded2d_demo, [])
    rec, st, md = run.record, run.state, run.md
    check(not rec["overflow"], f"{tag}: overflow")
    check(all(bool(torch.isfinite(c).all()) for c in run.thermo),
          f"{tag}: non-finite thermo")
    got = script_launches(tag, launches, {
        "g_harm": run.evaluations + 1, "force_harm": run.evaluations + 1})
    p = rec["parity_t0"]
    log(f"[{tag}] {rec['atoms']} atoms on {rec['mesh']}: ghost fraction "
        f"{rec['ghost_fraction']:.3f} ({rec['ghost_rows_per_device']} rows "
        f"a shard); t = 0 |dF|max {p['f_max_abs']:.3e} eV/A (limit "
        f"{sharded2d_demo.F_LIMIT}), |dE| {p['e_abs']:.3e} eV (limit "
        f"{sharded2d_demo.E_LIMIT}), |dW|max {p['w_max_abs']:.3e} eV; "
        f"{rec['steps']} NVE steps {rec['atom_steps_per_s']:.1f} "
        f"atom-steps/s, {rec['rebuilds']} rebuilds, unsafe "
        f"{rec['unsafe']}; phase wall {wall:.1f} s on {card}")
    sharded_checks(tag, md, st, md.model.mcfg.cut)
    return got


def phase_script_halo(card):
    """`scripts/halo_fraction.py --cells SCRIPT_HALO_CELLS` (524,288 atoms
    of the script's 2,000,000; planning only: no kernel launch): every row
    planned or refused with a reason, every 8-shard layout planned; and the
    rows of a run at SCRIPT_HALO_CPU_CELLS equal to the same planning on
    the CPU."""
    from meng_zhang_tpu_torch.scripts import halo_fraction
    tag = "script-halo"
    run, launches, wall = scale_script(
        tag, halo_fraction, ["--cells", str(SCRIPT_HALO_CELLS)])
    script_launches(tag, launches, {})
    rows = run.record["rows"]
    for r in rows:
        log(f"[{tag}] {r['decomp']:22s} owned {r['owned']:8d} ghost "
            f"{r['ghost_rows']} fraction {r['ghost_fraction']} {r['note']}")
        check((r["ghost_rows"] is None) == bool(r["note"]),
              f"{tag}: {r['decomp']}: a row neither planned nor refused")
    check(all(r["ghost_rows"] is not None for r in rows[:4]),
          f"{tag}: an 8-shard layout was refused")
    argv = ["--cells", str(SCRIPT_HALO_CPU_CELLS)]
    card_rows = scale_script(tag, halo_fraction, argv)[0].record["rows"]
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_rows = halo_fraction.main(argv, device="cpu").record["rows"]
    check(card_rows == cpu_rows, f"{tag}: rows at --cells "
          f"{SCRIPT_HALO_CPU_CELLS} differ between the card and the CPU")
    log(f"[{tag}] rows at --cells {SCRIPT_HALO_CPU_CELLS} equal to the "
        f"CPU's; phase wall {wall:.1f} s on {card}")
    return {}


def phase_script_bench(card, fe_rate):
    """`scripts/bench.py --steps SCRIPT_BENCH_STEPS` on the benchmark scene
    (the committed minimized npz, no minimize): exactly one stdout line,
    a JSON object with bench.py's four keys, unit atom-steps/s, a positive
    value and vs_baseline = value / (0.559 x 152,880) to its three
    decimals; no overflow and no `unsafe` latch; g_harm / force_harm once
    an evaluation and no other kernel, and against their plain versions on
    SCALE_SLICE of the final state's short rows. Prints its rate beside
    [main]'s."""
    from meng_zhang_tpu_torch.scripts import bench
    tag = "script-bench"
    out = io.StringIO()
    run, launches, wall = scale_script(
        tag, bench, ["--steps", str(SCRIPT_BENCH_STEPS)], stdout=out)
    lines = [line for line in out.getvalue().splitlines() if line.strip()]
    check(len(lines) == 1, f"{tag}: {len(lines)} stdout lines, expected 1")
    try:
        rec = json.loads(lines[0])
    except ValueError as e:
        raise SmokeFailure(f"{tag}: stdout is no JSON line ({e})")
    check(isinstance(rec, dict) and set(rec) == {
        "metric", "value", "unit", "vs_baseline"},
        f"{tag}: keys {sorted(rec) if isinstance(rec, dict) else rec}")
    check(rec["unit"] == "atom-steps/s", f"{tag}: unit {rec['unit']!r}")
    check(math.isfinite(rec["value"]) and rec["value"] > 0,
          f"{tag}: value {rec['value']}")
    check(rec["vs_baseline"] == round(rec["value"] / bench.BASELINE_APS, 3),
          f"{tag}: vs_baseline {rec['vs_baseline']} is not value / "
          f"{bench.BASELINE_APS:.0f}")
    check(rec["metric"].startswith(f"reference {bench.REF_ATOMS}-atom") and
          run.minimized is None, f"{tag}: not the committed scene "
          f"({rec['metric']})")
    st = run.state
    check(not bool(st.overflow), f"{tag}: neighbor overflow")
    check(not bool(st.unsafe), f"{tag}: unsafe (dangerous-build) latch set")
    got = script_launches(tag, launches, {"g_harm": run.evaluations,
                                          "force_harm": run.evaluations})
    ev = run.evaluator
    planes = slice_planes(st.x, st.box, st.short.sidx, ev.pbc)
    shard_kernel_checks(tag, planes, path_cases("fe", ev.cfg,
                                                planes[0].shape[0],
                                                st.x.device))
    log(f"[{tag}] {rec['value']:.1f} atom-steps/s over {SCRIPT_BENCH_STEPS} "
        f"NPT steps ({run.rebuilds} rebuilds), vs_baseline "
        f"{rec['vs_baseline']}, beside [main]'s {fe_rate:.1f} "
        f"({rec['value'] / fe_rate:.3f}x); phase wall {wall:.1f} s on {card}")
    return got


def phase_scripts(card, relaxed_2m, fe_rate):
    """The run scripts' phases; returns their launches by tag."""
    t0 = time.time()
    extra = {"script-profile-2m": phase_script_profile(card, "2m",
                                                       relaxed_2m)}
    for model in ("ni", "anna"):
        extra[f"script-model-{model}"] = phase_script_model(card, model)
    for which in ("fe", "ni"):
        extra[f"script-profile-{which}"] = phase_script_profile(card, which)
    for scene in ("small", "100k"):
        extra[f"script-sharded-{scene}"] = phase_script_sharded(card, scene)
    extra["script-sharded2d"] = phase_script_sharded2d(card)
    phase_script_halo(card)
    extra["script-bench"] = phase_script_bench(card, fe_rate)
    log(f"[scripts] the ten script phases took {time.time() - t0:.1f} s")
    return extra


# ------------------------------------------------- rows over 512 partners
@contextlib.contextmanager
def g_harm_plain_inside():
    """kernels.g_harm replaced by its plain version inside the block: the
    f32 plain path of ANNA-ADP's reference-shaped functions, which take no
    plain switch (their phase 1 reads kernels.g_harm at each call), for
    [anna-widest]'s bounds."""
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    saved = kernels.g_harm
    kernels.g_harm = fa.g_harm_plain
    try:
        yield
    finally:
        kernels.g_harm = saved


def widest_gates(tag, out32, plain32, out64):
    """[*-widest]'s f32 gates: each of E (per atom), F, W of the f32 kernel
    path within WIDEST_OVER_PLAIN times the f32 plain path's difference
    from the f64 reference out64 on the same rows, and sum F within
    EVAL_REL["sum_F"] N rms|F|. out*: (E, F, W)."""
    def diffs(out):
        (e, f, w), (e64, f64, w64) = out, out64
        n = f64.shape[0]
        return {"dE_per_atom": abs(float(e) - float(e64)) / n,
                "max_dF": float((f.double() - f64).abs().max()),
                "max_dW": float((w.double() - w64).abs().max())}
    f32 = out32[1]
    check(bool(torch.isfinite(f32).all()) and math.isfinite(float(out32[0]))
          and bool(torch.isfinite(out32[2]).all()),
          f"{tag}: non-finite f32 output")
    got, own = diffs(out32), diffs(plain32)
    for key in got:
        lim = WIDEST_OVER_PLAIN * own[key]
        log(f"[{tag}] {key} {got[key]:.3e} (bound {lim:.3e} = "
            f"{WIDEST_OVER_PLAIN} x the "
            f"f32 plain path's {own[key]:.3e})")
        check(got[key] <= lim, f"{tag} {key} {got[key]:.3e} over {lim:.3e}")
    f64 = out64[1]
    n = f64.shape[0]
    sum_f = float(f32.double().sum(0).abs().max())
    lim = EVAL_REL["sum_F"] * n * float(f64.pow(2).mean().sqrt())
    log(f"[{tag}] sum_F {sum_f:.3e} (bound {lim:.3e})")
    check(sum_f <= lim, f"{tag} sum_F {sum_f:.3e} over {lim:.3e}")


def widest_rows(tag, x, box, idx, rc, pbc):
    """Each skin row's partners within rc: (widest, mean, narrowest),
    logged; fails unless some row holds more than 512."""
    n = x.shape[0]
    dd = __import__("meng_zhang_tpu_torch.ops.fused_annp",
                    fromlist=["pair_dx_planes"]).pair_dx_planes(
        x, box, idx, pbc)
    cnt = ((sum(d * d for d in dd) < rc * rc) & (idx < n)).sum(1)
    del dd
    w, m, lo = int(cnt.max()), float(cnt.float().mean()), int(cnt.min())
    log(f"[{tag}] partners within {rc} A: widest row {w}, mean {m:.1f}, "
        f"narrowest {lo}")
    check(w > 512, f"{tag}: no row of more than 512 partners")
    return w, m, lo


def widest_potentials(pool):
    """The [*-widest] tags' synthetic potentials, built on `pool` while the
    earlier phases run: their normalisation boxes, twice the cutoff wide,
    take ~10 s each of host work (testing.py), which the card need not
    wait for. {name: future}."""
    from meng_zhang_tpu_torch.testing import (synthetic_fe_potential,
                                              synthetic_ni_potential)
    from meng_zhang_tpu_torch.units import CFLENGTH
    return {"fe": pool.submit(synthetic_fe_potential, 0, cut=FE_WIDEST_RC),
            "ni": pool.submit(synthetic_ni_potential, 0,
                              rc_bohr=NI_WIDEST_RC * CFLENGTH)}


def phase_fe_widest(x, box, card, tmp, paths, pot):
    """[fe-widest]: the benchmark slab on the fe potential of the shipped
    widths at rc FE_WIDEST_RC (~610 partners a row). The tiled g_harm /
    force_harm on the rows compacted at rc (run.py's route, kernels.
    tiled_width wide) against their plain versions on the first
    WIDEST_ROWS rows (f32, the plain versions timed; f64 on every
    WIDE_F64_STRIDE-th), their f32 times on every row and bounds; one
    energy_forces_virial_chunked in f32 against the f64 plain path
    (widest_gates); then
    FE_WIDEST_CLI_STEPS NPT steps of `python -m meng_zhang_tpu_torch
    --engine xla` at capacity FE_WIDEST_CAPACITY. Returns the widest
    figures of g_harm's and force_harm's records and the CLI's
    launches."""
    from meng_zhang_tpu_torch.io.potential import write_ann
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.neighbors import build_neighbors_cell
    tag = "fe-widest"
    t_phase = time.time()
    cfg32, p32 = annp.make_annp(pot, torch.float32, x.device, pbc=PBC)
    cfg64, p64 = annp.make_annp(pot, torch.float64, x.device, pbc=PBC)
    n, rc = x.shape[0], FE_WIDEST_RC
    npsf, ntsf = cfg32.npsf, cfg32.ntsf
    mcfg = md_config(cfg32, FE_WIDEST_SKIN, FE_WIDEST_CAPACITY,
                     FE_WIDEST_CELL_CAPACITY)
    nbrs = build_neighbors_cell(x, box, rc + FE_WIDEST_SKIN,
                                FE_WIDEST_CAPACITY, mcfg.cell_dims,
                                FE_WIDEST_CELL_CAPACITY, pbc=PBC)
    check(not bool(nbrs.overflow), f"{tag}: skin list overflow")
    widest, _, _ = widest_rows(tag, x, box, nbrs.idx, rc, PBC)
    ks = kernels.tiled_width(widest, kernels.HARM_TILE)
    sidx = fa.compact_short(x, box, nbrs.idx, rc, ks, PBC).sidx
    del nbrs
    planes32 = fa.pair_dx_planes(x, box, sidx, PBC)
    filler = sidx >= n
    lanes, pairs = fe_counts(planes32, rc)
    log(f"[{tag}] rows compacted at rc to K {ks} ({ks // kernels.HARM_TILE} "
        f"virtual rows of {kernels.HARM_TILE}); {lanes:.0f} lanes inside "
        f"{rc} A")
    rng = np.random.default_rng(SEED)
    dedg_np = np.zeros((n, fa.NSF_PAD))
    dedg_np[:, :npsf + ntsf] = rng.normal(size=(n, npsf + ntsf))
    b_np = np.zeros((n, fa.AB_PAD))
    b_np[:, :ntsf * ntsf + 1] = rng.normal(size=(n, ntsf * ntsf + 1))
    figs = {}
    for dtype in (torch.float32, torch.float64):
        step = 1 if dtype == torch.float32 else WIDE_F64_STRIDE
        rows = slice(0, WIDEST_ROWS, step)
        pl = [t[rows].to(dtype).contiguous() for t in planes32]
        dedg = torch.tensor(dedg_np[rows], dtype=dtype, device=x.device)
        b = torch.tensor(b_np[rows], dtype=dtype, device=x.device)
        sub = f"{tag} " + ("f32" if dtype == torch.float32 else "f64")
        shown = f"[{pl[0].shape[0]}, {ks}]"
        g_ref, g_ms = timed(lambda: fa.g_harm_plain(*pl, npsf, ntsf, rc))
        g_worst = compare(sub, f"g_harm {shown}", ("g_raw", "A"),
                          kernels.g_harm(*pl, npsf, ntsf, rc), g_ref,
                          REL_BOUND[dtype])
        f_ref, f_ms = timed(lambda: fa.force_harm_plain(*pl, dedg, b, npsf,
                                                        ntsf, rc))
        f_worst = compare(sub, f"force_harm {shown}", ("fjx", "fjy", "fjz"),
                          kernels.force_harm(*pl, dedg, b, npsf, ntsf, rc),
                          f_ref, REL_BOUND[dtype], filler[rows])
        del g_ref, f_ref
        if dtype == torch.float32:
            worst = {"g_harm": g_worst, "force_harm": f_worst}
            plain_ms = {"g_harm": g_ms, "force_harm": f_ms}
            log(f"[{tag}] the plain versions on {shown}: g_harm {g_ms:.3f}, "
                f"force_harm {f_ms:.3f} ms (one run, CUDA events)")
    del pl, dedg, b
    dedg = torch.tensor(dedg_np, dtype=torch.float32, device=x.device)
    b = torch.tensor(b_np, dtype=torch.float32, device=x.device)
    times = {
        "g_harm": cuda_ms(lambda: kernels.g_harm(*planes32, npsf, ntsf, rc),
                          10),
        "force_harm": cuda_ms(lambda: kernels.force_harm(
            *planes32, dedg, b, npsf, ntsf, rc), 10)}
    log(f"[{tag}] tiles of {kernels.HARM_TILE} slots at [{n}, {ks}]: g_harm "
        f"{times['g_harm']:.3f} ms, force_harm {times['force_harm']:.3f} ms "
        f"(median of 10, CUDA events) on {card}")
    del dedg, b
    for name in ("g_harm", "force_harm"):
        b_ms, b_by = bound(fe_flops(name, lanes, 0, npsf, ntsf),
                           fe_bytes(name, n, ks, 4))
        figs[name] = {"widest_shape": [n, ks],
                      "widest_tile": kernels.HARM_TILE,
                      "widest_ms": times[name],
                      "widest_bound_ms": b_ms, "widest_bound_by": b_by,
                      "widest_plain_ms": plain_ms[name],
                      "widest_plain_rows": WIDEST_ROWS,
                      "widest_max_abs_err": worst[name]}
        log(f"[{tag}] {name} bound {b_ms:.3f} ms ({b_by})")

    # the chunked function through the kernels in f32, the plain path in
    # f32 and f64, on the same compacted rows
    x64, box64 = x.double(), box.double()
    t0 = time.time()
    out32 = annp.energy_forces_virial_chunked(cfg32, p32, x, box, sidx,
                                              shift=False)
    torch.cuda.synchronize()
    chunked_s = time.time() - t0
    sl = fa.ShortList(sidx, x, torch.zeros((), dtype=torch.bool,
                                           device=x.device))
    plain32 = fa.FusedAnnp(cfg32, p32, k_short=ks, plain=True) \
        .energy_forces_short(x, box, sl)
    out64 = fa.FusedAnnp(cfg64, p64, k_short=ks, plain=True) \
        .energy_forces_short(x64, box64, sl._replace(ref_x=x64))
    log(f"[{tag}] energy_forces_virial_chunked on {n} atoms at K {ks}: "
        f"{chunked_s:.3f} s (one call, the first); E/N f64 "
        f"{float(out64[0]) / n:.9f} eV; max|F| "
        f"{float(out64[1].abs().max()):.4e} eV/A")
    widest_gates(tag, out32, plain32, out64)
    del planes32, filler, sidx, sl, out32, plain32, out64, x64, box64

    # run.py's --engine xla route at capacity FE_WIDEST_CAPACITY
    ann = os.path.join(tmp, "fe_widest.ann")
    write_ann(ann, pot)
    rows, err, _, launches = cli(f"{tag}-cli", [
        "--data", paths["data"], "--potential", ann, "--engine", "xla",
        "--ensemble", "npt", "--temp", "300", "--couple", "y", "--boundary",
        "m p m", "--skin", str(FE_WIDEST_SKIN), "--capacity",
        str(FE_WIDEST_CAPACITY), "--steps", str(FE_WIDEST_CLI_STEPS),
        "--thermo", "5"])
    for name in ("g_harm", "force_harm"):
        check(launches[name] == FE_WIDEST_CLI_STEPS + 1,
              f"{tag}: {name} launched {launches[name]} times in the CLI "
              f"run, expected {FE_WIDEST_CLI_STEPS + 1} (init + one a step)")
    check(sum(launches.values()) == 2 * launches["g_harm"],
          f"{tag}: other kernels launched in the CLI run: {launches}")
    log(f"[{tag}] CLI Loop time rate {_loop_rate(err):.1f} atom-steps/s on "
        f"{card}; the phase took {time.time() - t_phase:.1f} s")
    return figs, {k: launches[k] for k in ("g_harm", "force_harm")}


def phase_ni_widest(dev, card, tmp, pot):
    """[ni-widest]: the synthetic ni potential of the shipped table at Rc
    NI_WIDEST_RC on the thermal fcc box of NI_WIDEST_CELLS^3 cells (~620
    partners a row). ni_g / ni_force on the rows compacted at Rc
    (kernels.tiled_width wide: the cross-tile instances) against the plain
    versions on the whole row and against their tiled plain twins, on the
    first WIDEST_ROWS rows (f32; f64 on every WIDE_F64_STRIDE-th), and
    ni_force_tiles' sum kernel on its unit kernel's partials of those rows
    against its plain twin on the same partials; two runs bit for bit
    equal; the f32 times on every row (the sum kernel's over the chunks
    that ni_force_tiles gives it) and the bounds; one
    energy_forces_virial_chunked in f32 against the f64 kernel path (held
    to the plain versions just above), the f32 plain path's difference
    setting the bounds (widest_gates); then NI_WIDEST_CLI_STEPS NVT steps
    of the CLI's BP route at capacity NI_WIDEST_CAPACITY. Returns the
    records of ni_g_tiles, ni_force_tiles and ni_force_tiles_sum (without
    launches) and the CLI's launches."""
    from meng_zhang_tpu_torch.io.potential import write_ann
    from meng_zhang_tpu_torch.models import annp
    from meng_zhang_tpu_torch.ops import fused_annp as fa
    from meng_zhang_tpu_torch.ops import fused_ni as fn
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.neighbors import (build_neighbors_cell,
                                                       cell_grid_dims)
    from meng_zhang_tpu_torch.testing import thermal_fcc
    tag = "ni-widest"
    t_phase = time.time()
    cfg32, p32 = annp.make_annp(pot, torch.float32, dev)
    cfg64, p64 = annp.make_annp(pot, torch.float64, dev)
    xn, bn = thermal_fcc(NI_WIDEST_CELLS, seed=SEED, disp=NI_DISP, a=NI_A)
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    n, rc = x.shape[0], annp.descriptor_cutoff(cfg32, p32)
    nbrs = build_neighbors_cell(
        x, box, rc + NI_WIDEST_SKIN, NI_WIDEST_CAPACITY,
        cell_grid_dims(bn, rc + NI_WIDEST_SKIN), NI_WIDEST_CELL_CAPACITY)
    check(not bool(nbrs.overflow), f"{tag}: skin list overflow")
    widest, _, _ = widest_rows(tag, x, box, nbrs.idx, rc, (True,) * 3)
    ks = kernels.tiled_width(widest, kernels.NI_TILE)
    sidx = fa.compact_short(x, box, nbrs.idx, rc, ks, (True,) * 3).sidx
    del nbrs
    planes32 = fa.pair_dx_planes(x, box, sidx, (True,) * 3)
    filler = sidx >= n
    table = fn.ni_table(p32["coerad"], p32["coeang"])
    counts = ni_counts([t[:WIDEST_ROWS] for t in planes32], table.rc_a)
    scale = n / WIDEST_ROWS
    counts = (counts[0] * scale, counts[1] * scale)
    log(f"[{tag}] rows compacted at Rc {rc:.4f} A to K {ks} (tiles of "
        f"{kernels.NI_TILE}); ~{counts[0]:.0f} lanes and ~{counts[1]:.0f} "
        f"ordered legs inside {table.rc_a} Bohr (the first {WIDEST_ROWS} "
        f"rows' counts x {scale:.0f})")
    dedg_np = np.zeros((n, fn.NSF_SUB))
    dedg_np[:, :pot.nsf] = np.random.default_rng(SEED).normal(
        size=(n, pot.nsf))
    worst = {}
    for dtype in (torch.float32, torch.float64):
        step = 1 if dtype == torch.float32 else WIDE_F64_STRIDE
        rows = slice(0, WIDEST_ROWS, step)
        pl = [t[rows].to(dtype).contiguous() for t in planes32]
        dedg = torch.tensor(dedg_np[rows], dtype=dtype, device=dev)
        sub = f"{tag} " + ("f32" if dtype == torch.float32 else "f64")
        shown = f"[{pl[0].shape[0]}, {ks}]"
        g = kernels.ni_g_tiles(*pl, table)
        check(torch.equal(kernels.ni_g_tiles(*pl, table), g),
              f"{sub}: two ni_g_tiles runs differ in their bits")
        fj = kernels.ni_force_tiles(*pl, dedg, table)
        check(all(torch.equal(u, v) for u, v in zip(
            kernels.ni_force_tiles(*pl, dedg, table), fj)),
            f"{sub}: two ni_force_tiles runs differ in their bits")
        g_ref, g_ms = timed(lambda: fn.ni_g_plain(*pl, table))
        w_g = compare(sub, f"ni_g_tiles {shown} vs ni_g_plain", ("g",),
                      (g,), (g_ref,), NI_WIDEST_REL_BOUND[dtype])
        compare(sub, f"ni_g_tiles {shown} vs its plain twin", ("g",), (g,),
                (fa.sum_tiles(fn.ni_g_tiles_plain(*pl, table,
                                                  kernels.NI_TILE)),),
                NI_WIDEST_REL_BOUND[dtype])
        f_ref, f_ms = timed(lambda: fn.ni_force_plain(*pl, dedg, table))
        w_f = compare(sub, f"ni_force_tiles {shown} vs ni_force_plain",
                      ("fjx", "fjy", "fjz"), fj, f_ref,
                      NI_WIDEST_REL_BOUND[dtype], filler[rows])
        del g_ref, f_ref
        part = kernels.ni_force_tiles.units(*pl, dedg, table)
        s_ref, s_ms = timed(lambda: fn.ni_force_tiles_sum_plain(
            *pl, dedg, part, table))
        w_s = compare(sub, f"ni_force_tiles_sum {shown} vs its plain twin",
                      ("fjx", "fjy", "fjz"), kernels.ni_force_tiles_sum(
                          *pl, dedg, part, table), s_ref,
                      NI_WIDEST_REL_BOUND[dtype], filler[rows])
        del part, s_ref
        if dtype == torch.float32:
            worst = {"ni_g_tiles": w_g, "ni_force_tiles": w_f,
                     "ni_force_tiles_sum": w_s}
            plain_ms = {"ni_g_tiles": g_ms, "ni_force_tiles": f_ms,
                        "ni_force_tiles_sum": s_ms}
        else:        # the twin's q loop a second time: on the f64 rows alone
            compare(sub, f"ni_force_tiles {shown} vs its plain twin",
                    ("fjx", "fjy", "fjz"), fj, fn.ni_force_tiles_plain(
                        *pl, dedg, table, kernels.NI_TILE),
                    NI_WIDEST_REL_BOUND[dtype], filler[rows])
        del pl, dedg, g, fj
    dedg = torch.tensor(dedg_np, dtype=torch.float32, device=dev)
    # ni_force_tiles' memory beyond its inputs: the three Fj planes and
    # its scratch of unit partials (kernels.NI_SCRATCH_BYTES at most)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fj = kernels.ni_force_tiles(*planes32, dedg, table)
    torch.cuda.synchronize()
    log(f"[{tag}] ni_force_tiles at [{n}, {ks}] f32: peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB "
        f"above its inputs, of which Fj "
        f"{sum(t.numel() * t.element_size() for t in fj) / 2**20:.1f} MiB "
        f"(scratch cap {kernels.NI_SCRATCH_BYTES / 2**20:.0f} MiB)")
    del fj
    # the sum kernel alone, on the chunks that ni_force_tiles gives it
    chunk = kernels.ni_scratch_rows(ks, 4)
    spans = [slice(r0, min(n, r0 + chunk)) for r0 in range(0, n, chunk)]
    parts = [kernels.ni_force_tiles.units(*(t[s] for t in planes32),
                                          dedg[s], table) for s in spans]

    def sums():
        for s, part in zip(spans, parts):
            kernels.ni_force_tiles_sum(*(t[s] for t in planes32), dedg[s],
                                       part, table)
    times = {"ni_g_tiles": cuda_ms(lambda: kernels.ni_g_tiles(*planes32,
                                                              table), 3),
             "ni_force_tiles": cuda_ms(lambda: kernels.ni_force_tiles(
                 *planes32, dedg, table), 3),
             "ni_force_tiles_sum": cuda_ms(sums, 3)}
    log(f"[{tag}] tiles of {kernels.NI_TILE} slots at [{n}, {ks}]: "
        f"ni_g_tiles {times['ni_g_tiles']:.3f} ms, ni_force_tiles "
        f"{times['ni_force_tiles']:.3f} ms, of which its sum kernel "
        f"{times['ni_force_tiles_sum']:.3f} ms over {len(spans)} chunks of "
        f"<= {chunk} rows (median of 3, CUDA events) on {card}")
    del dedg, parts
    nt = -(-ks // kernels.NI_TILE)
    sum_work = (counts[0] * (15 + 15 * len(table.rad) + 6 + 4 * nt),
                (n * (6 * ks + fn.NSF_SUB) + counts[0] * 4 * nt) * 4)
    records = []
    for name, line, short in (("ni_g_tiles", 126, "ni_g"),
                              ("ni_force_tiles", 170, "ni_force"),
                              ("ni_force_tiles_sum", 170, None)):
        work = sum_work if short is None else (
            ni_flops(short, *counts, table),
            n * (3 * ks + fn.NSF_SUB
                 + (3 * ks if short == "ni_force" else 0)) * 4)
        rec = record(name, "meng_zhang_tpu_torch/ops/csrc/ni_bp.cu",
                     f"meng_zhang_tpu/ops/pallas_ni.py:{line}", worst[name],
                     times[name], plain_ms[name], *work)
        rec.update({"shape": [n, ks], "tile": kernels.NI_TILE,
                    "plain_rows": WIDEST_ROWS})
        records.append(rec)
        log(f"[{tag}] {name} f32 [{n}, {ks}]: kernel {rec['ms']:.3f} ms, "
            f"plain {rec['plain_ms']:.3f} ms on {WIDEST_ROWS} rows (one "
            f"run), bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")

    # the chunked function in f32 and f64 through the kernels, and in f32
    # through the plain versions, on the same compacted rows
    x64, box64 = x.double(), box.double()
    t0 = time.time()
    out32 = annp.energy_forces_virial_chunked(cfg32, p32, x, box, sidx,
                                              shift=False)
    torch.cuda.synchronize()
    chunked_s = time.time() - t0
    out64 = annp.energy_forces_virial_chunked(cfg64, p64, x64, box64, sidx,
                                              shift=False)
    sl = fa.ShortList(sidx, x, torch.zeros((), dtype=torch.bool, device=dev))
    t0 = time.time()
    plain32 = fn.FusedNi(cfg32, p32, k_short=kernels.NI_MAX_K, plain=True) \
        .energy_forces_short(x, box, sl)
    torch.cuda.synchronize()
    log(f"[{tag}] energy_forces_virial_chunked on {n} atoms at K {ks}: "
        f"{chunked_s:.3f} s (one call, the first); the f32 plain path "
        f"{time.time() - t0:.1f} s; E/N f64 {float(out64[0]) / n:.9f} eV; "
        f"max|F| {float(out64[1].abs().max()):.4e} eV/A")
    widest_gates(tag, out32, plain32, out64)
    del planes32, filler, sidx, sl, out32, plain32, out64, x64, box64

    ann = os.path.join(tmp, "ni_widest.ann")
    write_ann(ann, pot)
    _, err, _, launches = cli(f"{tag}-cli", [
        "--lattice", "fcc", "--cells", *[str(NI_WIDEST_CELLS)] * 3,
        "--lattice-a", str(NI_A), "--potential", ann, "--ensemble", "nvt",
        "--temp", str(NI_T), "--skin", str(NI_WIDEST_SKIN), "--capacity",
        str(NI_WIDEST_CAPACITY), "--steps", str(NI_WIDEST_CLI_STEPS),
        "--thermo", str(NI_WIDEST_CLI_STEPS)])
    want = NI_WIDEST_CLI_STEPS + 1
    chunks = len(spans)
    for name, each in (("ni_g_tiles", 1), ("ni_force_tiles", chunks),
                       ("ni_force_tiles_sum", chunks)):
        check(launches[name] == want * each, f"{tag}: {name} launched "
              f"{launches[name]} times in the CLI run, expected "
              f"{want * each} (init + one a step, {each} a call: rows of K "
              f"{ks} in chunks of <= {chunk})")
    check(sum(launches.values()) == want * (1 + 2 * chunks),
          f"{tag}: other kernels launched in the CLI run: {launches}")
    log(f"[{tag}] CLI Loop time rate {_loop_rate(err):.1f} atom-steps/s on "
        f"{card}; the phase took {time.time() - t_phase:.1f} s")
    return records, {k: launches[k] for k in (
        "ni_g_tiles", "ni_force_tiles", "ni_force_tiles_sum")}


def phase_anna_widest(dev, card):
    """[anna-widest]: the synthetic .anna of the shipped widths at cut
    ANNA_WIDEST_CUT on thermal bcc ANNA_WIDEST_CELLS^3 cells (rows of
    513-640 partners within cut, counted and printed): local_params,
    the reference-shaped energy_forces_virial (phase 1 through the tiled
    g_harm) and make_anna_fast_fns(k_short=ANNA_WIDEST_KS) in f32 against
    f64, each f32 difference within WIDEST_OVER_PLAIN times its f32 plain
    path's (g_harm's plain version inside phase 1; the fast path's plain
    switch), measured here on the same rows. Returns the g_harm
    launches of the f32 kernel runs."""
    from meng_zhang_tpu_torch.models import anna_adp as A
    from meng_zhang_tpu_torch.ops import kernels
    from meng_zhang_tpu_torch.system.neighbors import (build_neighbors_cell,
                                                       cell_grid_dims)
    from meng_zhang_tpu_torch.testing import (synthetic_anna_potential,
                                              thermal_bcc)
    tag = "anna-widest"
    t_phase = time.time()
    pot = synthetic_anna_potential(0, cut=ANNA_WIDEST_CUT)
    cfg32, p32 = A.make_anna(pot, torch.float32, dev)
    cfg64, p64 = A.make_anna(pot, torch.float64, dev)
    xn, bn = thermal_bcc(ANNA_WIDEST_CELLS, seed=SEED, disp=ANNA_DISP)
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    box = torch.tensor(bn, dtype=torch.float32, device=dev)
    x64, box64 = x.double(), box.double()
    n, cut = x.shape[0], cfg32.cut
    rl = cut + 0.5
    nbrs = build_neighbors_cell(x, box, rl, ANNA_WIDEST_CAPACITY,
                                cell_grid_dims(bn, rl),
                                ANNA_WIDEST_CELL_CAPACITY)
    check(not bool(nbrs.overflow), f"{tag}: skin list overflow")
    widest, _, lo = widest_rows(tag, x, box, nbrs.idx, cut, (True,) * 3)
    check(widest <= ANNA_WIDEST_KS, f"{tag}: a row of {widest} partners")
    idx = nbrs.idx
    kernels.reset_launch_counts()
    lp32 = A.local_params(cfg32, p32, x, box, idx)
    ref32 = A.energy_forces_virial(cfg32, p32, x, box, idx, shift=False)
    fns32 = A.make_anna_fast_fns(cfg32, p32, k_short=ANNA_WIDEST_KS,
                                 delta=0.3)
    short = fns32[2](x, box, nbrs)
    check(not bool(short.overflow), f"{tag}: short-list overflow")
    s_w = int((short.idx < n).sum(1).max())
    fast32 = fns32[0](x, box, nbrs, short)
    torch.cuda.synchronize()
    launches = kernels.g_harm.launches
    lp64 = A.local_params(cfg64, p64, x64, box64, idx)
    ref64 = A.energy_forces_virial(cfg64, p64, x64, box64, idx, shift=False)
    with g_harm_plain_inside():
        lp32p = A.local_params(cfg32, p32, x, box, idx)
        ref32p = A.energy_forces_virial(cfg32, p32, x, box, idx, shift=False)
    fast64 = A.make_anna_fast_fns(cfg64, p64, k_short=ANNA_WIDEST_KS,
                                  delta=0.3, plain=True)[0](
        x64, box64, nbrs, short._replace(ref_x=x64))
    fast32p = A.make_anna_fast_fns(cfg32, p32, k_short=ANNA_WIDEST_KS,
                                   delta=0.3, plain=True)[0](
        x, box, nbrs, short)
    log(f"[{tag}] N {n}: skin rows {idx.shape[1]} wide, short rows within "
        f"cut + 0.3 up to {s_w} of {ANNA_WIDEST_KS}; local params "
        f"(d2, q2) f64 in [{float(lp64.min()):.4f}, {float(lp64.max()):.4f}]"
        f" /A; E/N f64 {float(ref64[0]) / n + cfg64.e_base:.6f} eV")
    d_lp = float((lp32.double() - lp64).abs().max())
    d_lpp = float((lp32p.double() - lp64).abs().max())
    log(f"[{tag}] local_params max |d(d2, q2)| {d_lp:.3e} (bound "
        f"{WIDEST_OVER_PLAIN * d_lpp:.3e} = {WIDEST_OVER_PLAIN} x the f32 "
        f"plain path's {d_lpp:.3e})")
    check(d_lp <= WIDEST_OVER_PLAIN * d_lpp, f"{tag}: local_params f32")
    log(f"[{tag}] energy_forces_virial (reference-shaped):")
    widest_gates(tag, ref32, ref32p, ref64)
    log(f"[{tag}] make_anna_fast_fns(k_short={ANNA_WIDEST_KS}):")
    widest_gates(tag, fast32, fast32p, fast64)
    check(launches == 3, f"{tag}: g_harm launched {launches} times in the "
          "three f32 kernel runs, expected 3")
    log(f"[{tag}] the phase took {time.time() - t_phase:.1f} s on {card}")
    return launches


def main():
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        return run_phases(pool)


def run_phases(pool):
    try:
        kind, card = phase_device()
        phase_build()
        dev = torch.device("cuda", 0)
        x, box = scene(dev)
        cfg32, p32, cfg64, p64, mass = model(dev)
        records, sl = phase_kernels(x, box, cfg32, p32)
        fe_ref = []
        phase_evaluator(x, box, cfg32, p32, cfg64, p64, sl, ref_out=fe_ref)
        launches, *main_rate = phase_main_path(x, box, cfg32, p32, mass,
                                               card)
        phase_evaluator(x, box, cfg32, p32, cfg64, p64, sl, angular="matrix")
        phase_matrix_vs_harmonic(x, box, cfg64, p64, sl)
        launches.update(phase_main_path(x, box, cfg32, p32, mass, card,
                                        angular="matrix")[0])
        multi_launches, types = phase_multi_fe(x, box, sl, card, main_rate)
        # launches of the new paths' runs, added to the records' counts
        extra = {"multi-fe": multi_launches,
                 "rowsweep": phase_rowsweep(x, box, cfg32, p32, mass, card)}
        extra["shard-fe"] = phase_shard_fe(x, box, cfg32, p32, cfg64, p64,
                                           mass, card, fe_ref, main_rate[0])
        extra["shard2d-fe"] = phase_shard_fe(x, box, cfg32, p32, cfg64, p64,
                                             mass, card, fe_ref,
                                             main_rate[0], layout="2d")
        extra["shard3d-fe"] = phase_shard3d_fe(x, box, cfg32, p32, mass,
                                               fe_ref)
        # the [*-widest] potentials' host work overlaps the ranks' start
        widest_pots = widest_potentials(pool)
        dist_counts, dist_spec = phase_dist(x, box, cfg32, mass, card)
        extra.update(dist_counts)
        extra["dist-nccl"] = phase_dist_nccl(dist_spec, card)
        del dist_spec
        cfg_w, p_w, mass_w = fe_wide_model(dev)
        fe_wide = phase_fe_wide_kernels(x, box, cfg_w, p_w)
        extra["fe-wide-main"], fe_wide_rate, _ = phase_main_path(
            x, box, cfg_w, p_w, mass_w, card, wide=True)
        log(f"[fe-wide-main] rate {fe_wide_rate / main_rate[0]:.3f}x "
            "[main]'s")
        for kname, fig in fe_wide.items():
            fig["wide_launches"] = extra["fe-wide-main"].get(kname, 0)
        del cfg_w, p_w
        del fe_ref
        fe = (x, box, cfg32, p32, mass)
        del x, box, sl, cfg64, p64
        cfg32, p32, cfg64, p64, mass = ni_model(dev)
        x, box, sl = ni_thermal_scene(dev, cfg32, p32)
        records += phase_ni_kernels(x, box, cfg32, p32, sl)
        ni_ref = []
        phase_ni_evaluator(x, box, cfg32, p32, cfg64, p64, sl, ni_ref)
        ni_launches, ni_rate = phase_ni_main_path(dev, cfg32, p32, mass,
                                                  card)
        launches.update(ni_launches)
        extra["shard-ni"] = phase_shard_ni(dev, x, box, cfg32, p32, cfg64,
                                           p64, mass, card, ni_ref, ni_rate)
        extra["shard3d-ni"] = phase_shard_ni(dev, x, box, cfg32, p32, cfg64,
                                             p64, mass, card, ni_ref,
                                             ni_rate, layout="3d")
        del x, box, sl, ni_ref
        ni = (dev, cfg32, p32, mass, card)
        cfg_w, p_w, mass_w = ni_wide_model(dev)
        ni_wide = phase_ni_wide_kernels(dev, cfg_w, p_w)
        extra["ni-wide-main"], wide_rate = phase_ni_main_path(
            dev, cfg_w, p_w, mass_w, card, wide=True)
        log(f"[ni-wide-main] rate {wide_rate / ni_rate:.3f}x [ni-main]'s")
        for kname, fig in ni_wide.items():
            fig["wide_launches"] = extra["ni-wide-main"][kname]
        del cfg_w, p_w
        ni_wider, crossover, extra["ni-wider-main"], wider_rate = \
            phase_ni_wider(dev, card)
        log(f"[ni-wider-main] rate {wider_rate / ni_rate:.3f}x [ni-main]'s")
        for kname, fig in ni_wider.items():
            fig["wider_launches"] = extra["ni-wider-main"][kname]
        extra["multi-ni"] = phase_multi_ni(dev, card)
        t_anna = time.time()
        cfg32, p32, cfg64, p64, mass = anna_model(dev)
        anna, box_lists = phase_anna_kernel(dev, cfg32, p32)
        anna_ref = phase_anna_eval(box_lists, cfg32, p32, cfg64, p64)
        anna["anna_launches"], anna_rate = phase_anna_md(dev, cfg32, p32,
                                                         mass, card)
        extra["shard-anna"] = phase_shard_anna(dev, box_lists, cfg32, p32,
                                               mass, card, anna_ref,
                                               anna_rate)
        extra["shard2d-anna"] = phase_shard_anna(dev, box_lists, cfg32, p32,
                                                 mass, card, anna_ref,
                                                 anna_rate, layout="2d")
        del box_lists, anna_ref
        log(f"[anna-md] phases anna-kernel, anna-eval and anna-md took "
            f"{time.time() - t_anna:.1f} s")
        anna_prof = (dev, cfg32, p32, mass, card)
        with tempfile.TemporaryDirectory() as tmp:
            paths = write_inputs(tmp)
            cli_launches = {"cli-fe": phase_cli_fe(card, tmp, paths, dev),
                            "cli-ni": phase_cli_ni(card, paths, dev),
                            "minimize": phase_minimize(card, tmp, paths,
                                                       dev),
                            "thin-box": phase_thin_box(card, tmp, dev),
                            "cli-multi": phase_cli_multi(card, tmp, types),
                            "cli-anna": {"g_harm": phase_cli_anna(
                                card, tmp, paths)}}
            extra["disloc-core"] = phase_disloc_core(card, tmp)
            fe_widest, extra["fe-widest"] = phase_fe_widest(
                fe[0], fe[1], card, tmp, paths, widest_pots["fe"].result())
            ni_widest, extra["ni-widest"] = phase_ni_widest(
                dev, card, tmp, widest_pots["ni"].result())
        extra["anna-widest"] = {"g_harm": phase_anna_widest(dev, card)}
        records += ni_widest
        log(f"[smoke] run-path launches {cli_launches}")
        for key in ("thin-box", "cli-multi"):
            extra[key] = cli_launches[key]
        scale = {}
        extra["scale-500k"], scale["500k"] = phase_scale_500k(card)
        extra["scale-2m"], scale["2m"], relaxed_2m = phase_scale_2m(card)
        extra.update(phase_scripts(card, relaxed_2m, main_rate[0]))
        del relaxed_2m
        phase_profile(*fe, card)
        phase_profile(*fe, card, angular="matrix")
        del fe
        phase_ni_profile(*ni)
        phase_anna_profile(*anna_prof)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    except ImportError as e:
        print(f"FAIL: run chip_smoke.py from the repository root ({e})",
              file=sys.stderr, flush=True)
        return 1
    log(f"[smoke] main-path launches {launches}; new paths' {extra}")
    for r in records:
        r["launches"] = launches.get(r["name"], 0) + sum(
            d.get(r["name"], 0) for d in extra.values())
        if r["name"] == "g_harm":
            r.update(anna)
        r.update(ni_wide.get(r["name"], {}))
        r.update(fe_wide.get(r["name"], {}))
        r.update(ni_wider.get(r["name"], {}))
        r.update(crossover.get(r["name"], {}))
        r.update(fe_widest.get(r["name"], {}))
        for cfg, times in scale.items():
            if r["name"] in times:
                ms, b_ms, b_by = times[r["name"]]
                r.update({f"scale_{cfg}_ms": ms, f"scale_{cfg}_bound_ms": b_ms,
                          f"scale_{cfg}_bound_by": b_by})
    log(f"[smoke] wall {time.time() - T_START:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
