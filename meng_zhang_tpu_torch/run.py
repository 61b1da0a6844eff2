"""Command-line MD runner -- the user-facing equivalent of the reference's
LAMMPS input scripts (in.st_test: units metal / read_data / pair_style annp /
pair_coeff / velocity create / fix npt / minimize / run N).

Counterpart of meng_zhang_tpu/run.py (:22-357): the same flags, the same
stdout thermo table and stderr log lines, the same species, mass and
pe_offset rules and the same engine routing:

  * `--engine pallas` (the default) on a Chebyshev potential: every step
    compacts the skin list at the cutoff and runs `FusedAnnp.energy_forces`
    (the harmonic kernels g_harm and force_harm), as the JAX CLI runs
    `PallasAnnp.energy_forces`; `--dump-peratom` adds its per-atom energies
    and stress tallies (c_pe, c_stress[1..6]);
  * a BP potential, or `--engine xla`: `compact_neighbor_rows` then
    `energy_forces_virial_chunked` (models/annp.py: FusedNi's kernels ni_g
    and ni_force for BP, FusedAnnp's for Chebyshev); `--dump-peratom` adds
    c_pe from the autograd model (`annp.atom_energies`). A multi-element BP
    (or `--engine xla`) potential runs this route too, where the JAX CLI
    runs the plain `annp.energy_forces_virial`: the same energy, on the
    kernels;
  * an ANNA-ADP potential (`.anna`, or `--model anna`): every step runs
    `anna_adp.energy_forces_virial` on the skin list (its phase 1 through
    the kernel g_harm), `--minimize` `anna_adp.energy_forces`, and
    `--dump-peratom` adds c_pe from `anna_adp.atom_energies`.

A multi-element potential (`.ann` or `.anna`) selects each atom's network
by its data-file type (type t is element t - 1), as the JAX CLI does.

Runs on the card; `main(argv, device="cpu")` is the only way to the CPU,
where the kernels' plain versions run. Two differences from the JAX CLI:
the cell list's per-cell capacity is sized from the scene's densest cell
(at least MDConfig's 64), where the JAX CLI keeps 64 and overflows on the
152,880-atom benchmark scene (83 atoms in its densest cell at --skin 1.2);
and `--minimize` on a multi-element potential selects the networks by
type, where the JAX CLI's minimizer evaluates every atom with the first
element's network (meng_zhang_tpu/run.py:257-263 pass no elems).

Example (the benchmark scene's workflow):
    python -m meng_zhang_tpu_torch \\
        --data fe_st.dat --potential fe_annp_potential_2.ann \\
        --ensemble npt --temp 300 --pdamp 1.0 --couple y \\
        --steps 1000 --dt 0.001 --thermo 10 --dump traj.lammpstrj
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def resolve_device(device="cuda"):
    """The run's torch.device: the card unless `device` names another (None
    is the card); exits when the card is asked for and there is none."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device; main(argv, device='cpu') runs on "
                 "the CPU")
    return dev


def build_parser():
    ap = argparse.ArgumentParser(
        prog="meng_zhang_tpu_torch",
        description="MD on an NVIDIA GPU with ANNP/ANNA-ADP neural-network "
                    "potentials")
    src = ap.add_argument_group("scene")
    src.add_argument("--data", help="LAMMPS data file (atomic style)")
    src.add_argument("--lattice", choices=("bcc", "fcc"),
                     help="generate a perfect lattice instead of --data")
    src.add_argument("--cells", type=int, nargs=3, default=(10, 10, 10))
    src.add_argument("--lattice-a", type=float, default=2.8553)
    src.add_argument("--replicate", type=int, nargs=3,
                     help="replicate the scene (nx ny nz)")

    pot = ap.add_argument_group("potential")
    pot.add_argument("--potential", required=True, help=".ann or .anna file")
    pot.add_argument("--model", choices=("annp", "anna"), default=None,
                     help="default: by file extension")
    pot.add_argument("--engine", choices=("pallas", "xla"), default="pallas",
                     help="pallas: the fused per-step evaluator (Chebyshev "
                          "annp); xla: the chunked function path")

    md = ap.add_argument_group("dynamics")
    md.add_argument("--ensemble", choices=("nve", "nvt", "npt", "langevin"),
                    default="nve")
    md.add_argument("--steps", type=int, default=100)
    md.add_argument("--dt", type=float, default=0.001, help="ps")
    md.add_argument("--temp", type=float, default=300.0)
    md.add_argument("--tdamp", type=float, default=0.1, help="ps")
    md.add_argument("--press", type=float, default=0.0, help="bar")
    md.add_argument("--pdamp", type=float, default=1.0, help="ps")
    md.add_argument("--couple", default="xyz",
                    help="NPT coupled axes, e.g. 'y' (in.st_test couples y)")
    md.add_argument("--seed", type=int, default=4928459)
    md.add_argument("--minimize", action="store_true",
                    help="FIRE relaxation before dynamics")
    md.add_argument("--min-ftol", type=float, default=1e-4)

    nb = ap.add_argument_group("neighbors")
    nb.add_argument("--skin", type=float, default=2.0, help="A (in.st_test:9)")
    nb.add_argument("--capacity", type=int, default=256)
    nb.add_argument("--boundary", default="p p p",
                    help="per-axis boundary like LAMMPS, e.g. 'm p m' "
                         "(the benchmark scene, in.st_test:7); "
                         "m/f/s = non-periodic, p = periodic")

    out = ap.add_argument_group("output")
    out.add_argument("--thermo", type=int, default=10, help="steps per row")
    out.add_argument("--dump", help="write .lammpstrj every thermo interval")
    out.add_argument("--dump-peratom", action="store_true",
                     help="add per-atom energy (c_pe) -- and per-atom "
                          "stress columns (c_stress[1..6], eV, LAMMPS "
                          "vatom order) on the pallas engine -- to --dump "
                          "(compute pe/atom + stress/atom)")
    out.add_argument("--checkpoint", help="write final state to .npz")
    out.add_argument("--restart", help="resume from a checkpoint .npz")
    out.add_argument("--profile", nargs="?", const="", metavar="TRACE",
                     help="print the program's spans and counters at the "
                          "end; with a path, also write a Chrome trace of "
                          "the MD loop there (torch.profiler: the spans "
                          "over the kernels they launched)")
    return ap


def _cell_capacity(x_np, box_np, dims, pbc, headroom=1.25, minimum=64):
    """Per-cell capacity of the cell list: the scene's densest cell (binned
    as system/neighbors.py bins) with headroom, rounded up to 8, and at
    least MDConfig's default."""
    import numpy as np
    s = x_np / box_np
    frac = np.where(pbc, s - np.floor(s), np.clip(s, 0.0, 1.0))
    c3 = np.minimum((frac * dims).astype(np.int64), np.asarray(dims) - 1)
    cid = (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]
    k = int(np.bincount(cid).max() * headroom) + 1
    return max(minimum, -(-k // 8) * 8)


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from . import profiling
    from .geometry import lattice as L
    from .io.lammps_data import read_data
    from .io.potential import read_ann, read_anna
    from .md.simulation import MDConfig, Simulator
    from .models import anna_adp, annp
    from .system.neighbors import cell_grid_dims

    dev = resolve_device(device)
    if args.profile is not None:
        profiling.enable()

    # ---- scene ----
    types = None
    if args.data:
        data = read_data(args.data)
        if args.replicate:
            data = L.replicate_data(data, args.replicate)
        x_np, box_np, types = data.x, data.box, data.types
        masses_in = data.masses
    elif args.lattice:
        basis = L.BCC_BASIS if args.lattice == "bcc" else L.FCC_BASIS
        x_np, box_np = L.simple_lattice(args.cells, args.lattice_a, basis)
        masses_in = None
    else:
        sys.exit("error: provide --data or --lattice")

    # ---- potential/model ----
    btoks = args.boundary.split() if " " in args.boundary else list(args.boundary)
    pbc = tuple(t.lower().startswith("p") for t in btoks)
    if len(pbc) != 3:
        sys.exit("error: --boundary needs three axis letters, e.g. 'm p m'")
    is_anna = (args.model == "anna") if args.model else \
        args.potential.endswith(".anna")
    if is_anna:
        pot = read_anna(args.potential)
        mcfg, params = anna_adp.make_anna(pot, torch.float32, dev, pbc=pbc)
        model_name = "anna_adp"
    else:
        pot = read_ann(args.potential)
        mcfg, params = annp.make_annp(pot, torch.float32, dev, pbc=pbc)
        model_name = "annp-" + ("behler" if pot.sym_coerad is not None
                                else "chebyshev")
    # ---- species mapping: data-file atom types -> potential elements ----
    # type t maps to element t-1; generator scenes use extra types for the
    # same element (the boundary shell), which clamp to the last element
    ne = len(pot.elements)
    if types is not None and int(np.max(types)) > ne:
        if ne == 1:
            log(f"note: {int(np.max(types))} atom types mapped to the single "
                f"element {pot.elements[0]} (generator boundary-shell types)")
        else:
            sys.exit(f"error: data file has {int(np.max(types))} atom types "
                     f"but the potential defines only {ne} elements; "
                     "provide a type->element mapping scene")
    elems = None
    if ne > 1:
        if types is None:
            log(f"note: no atom types in scene; all atoms set to element 0 "
                f"({pot.elements[0]})")
        else:
            elems = torch.as_tensor(np.minimum(types, ne) - 1, device=dev)
    # per-atom masses: Masses section if present, else the potential's mass
    if masses_in is not None and types is not None:
        masses_np = np.asarray(masses_in)[
            np.minimum(types, len(masses_in)) - 1]
    else:
        pmass = np.asarray(pot.masses)
        if types is not None and ne > 1:
            masses_np = pmass[np.minimum(types, ne) - 1]
        else:
            masses_np = np.full(len(x_np), float(pmass[0]))
    log(f"model: {model_name}  elements={pot.elements}  cut={mcfg.cut} A  "
        f"atoms={len(x_np)}  box={np.round(box_np, 3)}")

    use_pallas = args.engine == "pallas" and model_name == "annp-chebyshev"
    if args.engine == "pallas" and not use_pallas:
        log("note: pallas engine serves Chebyshev annp (any element "
            "count); falling back to xla for this model")

    x = torch.as_tensor(np.asarray(x_np), dtype=torch.float32, device=dev)
    box = torch.as_tensor(np.asarray(box_np), dtype=torch.float32,
                          device=dev)

    # ---- neighbor cutoff (ni descriptors vanish at 3.9 A) ----
    cut = mcfg.cut
    if model_name == "annp-behler":
        cut = annp.effective_cutoff(pot)
        log(f"neighbor cutoff {cut:.3f} A (descriptor range; header lists "
            f"{mcfg.cut})")

    # All paths return SHIFT-FREE per-run PE (sum of e_at - e_shift): the
    # per-atom shift is O(-4.5e3 eV), so the shifted total of a 152k-atom
    # scene sits where f32 ULP is ~64 eV and the thermo PE column would
    # quantize. The constant n*e_shift is added back in f64 at print time.
    n_atoms = len(x_np)
    pe_offset = n_atoms * (mcfg.e_base if is_anna else mcfg.e_shift)
    if use_pallas:
        from .ops.fused_annp import FusedAnnp
        ev = FusedAnnp(mcfg, params, elems=elems)

        def force_fn(xx, bb, nbrs):
            return ev.energy_forces(xx, bb, nbrs.idx, want_virial=True,
                                    shift=False)
    elif is_anna:
        def force_fn(xx, bb, nbrs):
            return anna_adp.energy_forces_virial(mcfg, params, xx, bb,
                                                 nbrs.idx, elems, shift=False)
    else:
        # per-eval short-neighbor repack (K drops from the skin-list
        # capacity to the in-cutoff count -- k_annp_short_nbor's job), then
        # the chunked path with the pairwise virial
        from .system.neighbors import estimate_capacity
        k_short = min(args.capacity,
                      estimate_capacity(box_np, cut, len(x_np),
                                        headroom=1.4))
        log(f"short-neighbor repack width {k_short} (list capacity "
            f"{args.capacity})")

        def force_fn(xx, bb, nbrs):
            idx_s, ovf = annp.compact_neighbor_rows(xx, bb, nbrs.idx, cut,
                                                    k_short, pbc)
            e, f, w = annp.energy_forces_virial_chunked(
                mcfg, params, xx, bb, idx_s, elems, chunk=512, shift=False)
            # poison on short-list overflow: silently dropped pairs must
            # never pass (the fused path does the same)
            nan = torch.full((), float("nan"), dtype=e.dtype, device=dev)
            return torch.where(ovf, nan, e), torch.where(ovf, nan, f), w

    # ---- simulator ----
    rlist = cut + args.skin
    # NPT can shrink the box; size the static cell grid with ~8% margin
    dims_box = np.asarray(box_np) * (0.92 if args.ensemble == "npt" else 1.0)
    dims = cell_grid_dims(dims_box, rlist)
    nbr_method = "cell" if min(dims) >= 3 and len(x_np) > 4096 else "n2"
    couple = tuple(ax in args.couple.lower() for ax in "xyz")
    cell_kw = {}
    if nbr_method == "cell":
        cell_kw = dict(cell_dims=dims, cell_capacity=_cell_capacity(
            np.asarray(x_np), np.asarray(box_np), dims, np.asarray(pbc)))
    cfg = MDConfig(
        dt=args.dt, cutoff=cut, skin=args.skin, capacity=args.capacity,
        nbr_method=nbr_method, ensemble=args.ensemble, t_target=args.temp,
        tau_t=args.tdamp, damp=args.tdamp, p_target=(args.press,) * 3,
        p_couple=couple, tau_p=args.pdamp, thermo_every=args.thermo,
        pbc=pbc, **cell_kw)
    masses = torch.as_tensor(masses_np, dtype=torch.float32, device=dev)
    sim = Simulator(force_fn, masses, cfg)

    # ---- minimize ----
    if args.minimize:
        from .md.minimize import fire_relax
        log("FIRE minimization...")

        if is_anna:
            def ef(xx, bb, idx):
                return anna_adp.energy_forces(mcfg, params, xx, bb, idx,
                                              elems)
        else:
            def ef(xx, bb, idx):
                return annp.energy_forces_chunked(mcfg, params, xx, bb, idx,
                                                  elems, chunk=256)

        x, fst = fire_relax(ef, lambda xx, bb: sim.build_nbrs(xx, bb),
                            x, box, f_tol=args.min_ftol)
        log(f"  fmax={float(fst.fmax):.3e}  pe={float(fst.pe):.6f}")

    # ---- run ----
    if args.restart:
        from .md.checkpoint import load_checkpoint
        st = load_checkpoint(args.restart, sim)
        log(f"restarted from {args.restart} at step {int(st.step)}")
    else:
        st = sim.init_state(x, box, seed=args.seed, t_init=args.temp)

    dump = None
    if args.dump:
        from .io.dump import DumpWriter
        dump = DumpWriter(args.dump, types=types)

    peratom_fn = None
    if args.dump_peratom:
        if not args.dump:
            sys.exit("error: --dump-peratom needs --dump")
        if use_pallas:
            def peratom_fn(ss):
                sl = ev.compact_short(ss.x, ss.box, ss.nbrs.idx)
                _, _, eat, vat = ev.energy_forces_short(
                    ss.x, ss.box, sl, want_virial=False, per_atom=True)
                return {"c_pe": eat, "c_stress": vat}
        else:
            model = anna_adp if is_anna else annp

            def peratom_fn(ss):
                return {"c_pe": model.atom_energies(
                    mcfg, params, ss.x, ss.box, ss.nbrs.idx, elems)}

    n_blocks = max(1, args.steps // args.thermo)
    print(f"{'Step':>8} {'Temp':>10} {'PotEng':>16} {'KinEng':>12} "
          f"{'Press':>12} {'Volume':>14}")
    th0 = sim.thermo(st)
    _print_thermo(int(st.step), th0, pe_offset)
    trace = profiling.torch_trace(args.profile) if args.profile \
        else contextlib.nullcontext()
    rebuilds = 0
    t0 = time.time()
    with trace:
        for b in range(n_blocks):
            # each span ends in a host read (the block's stale flag, the
            # dump's copies), so its host time covers its device work
            with profiling.span("md_block"):
                st, th = sim.run(st, 1)
            rebuilds += sim.rebuild_count
            _print_thermo(int(st.step), _last(th), pe_offset)
            if dump:
                with profiling.span("dump"):
                    extra = None
                    if peratom_fn is not None:
                        extra = {k: v.cpu().numpy()
                                 for k, v in peratom_fn(st).items()}
                    dump.write(int(st.step), st.x.cpu().numpy(),
                               st.box.cpu().numpy(), v=None, extra=extra)
    wall = time.time() - t0
    steps = n_blocks * args.thermo
    log(f"Loop time {wall:.2f} s for {steps} steps with {len(x_np)} atoms "
        f"({len(x_np) * steps / wall:,.0f} atom-steps/s, "
        f"{rebuilds} neighbor rebuilds)")
    if bool(st.overflow):
        log("WARNING: neighbor capacity overflow occurred (results unsafe); "
            "raise --capacity")
    if bool(st.unsafe):
        log("WARNING: dangerous neighbor builds -- an atom moved > skin/2 "
            "before a rebuild landed (pairs may have been missed); raise "
            "--skin or lower --thermo")

    if dump:
        dump.close()
    if args.checkpoint:
        from .md.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, st)
        log(f"checkpoint written to {args.checkpoint}")
    if args.profile is not None:
        log(profiling.report())
        if args.profile:
            log(f"Chrome trace of the MD loop written to {args.profile}")


def _last(th):
    return type(th)(*(col[-1] for col in th))


def _print_thermo(step, th, pe_offset=0.0):
    # pe arrives shift-free (f32, ~0.01 eV resolution); the constant
    # n*e_shift offset is re-applied here in python f64
    print(f"{step:>8d} {float(th.temp):>10.3f} "
          f"{float(th.pe) + pe_offset:>16.4f} "
          f"{float(th.ke):>12.4f} {float(th.press):>12.2f} "
          f"{float(th.vol):>14.3f}", flush=True)


if __name__ == "__main__":
    main()
