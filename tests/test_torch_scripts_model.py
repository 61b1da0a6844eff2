"""The port's model_bench (meng_zhang_tpu_torch/scripts/model_bench.py)
against the JAX package's scripts/model_bench.py, which reads the shipped
potentials and writes into artifacts/: here the JAX side is rebuilt from
the JAX package's functions with the script's values (PallasNi and
make_anna_fast_fns in Pallas interpret mode, the chunked functions), on
reduced synthetic potentials written as files that both packages read.

Each backend of each model runs main(argv, device="cpu") in f64 (two
warm-up blocks, the latch reset, one timed block) against the JAX
Simulator from the port's velocity draw: positions, velocities and forces
to atol 1e-9, the record's T and PE to rtol 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meng_zhang_tpu.geometry import lattice as j_lattice
from meng_zhang_tpu.io.potential import read_ann as j_read_ann
from meng_zhang_tpu.io.potential import read_anna as j_read_anna
from meng_zhang_tpu.md import simulation as JS
from meng_zhang_tpu.models import anna_adp as JA
from meng_zhang_tpu.models import annp as JM
from meng_zhang_tpu.ops.pallas_ni import PallasNi
from meng_zhang_tpu.system.neighbors import cell_grid_dims
from meng_zhang_tpu_torch.io.potential import write_ann
from meng_zhang_tpu_torch.md import simulation as S
from meng_zhang_tpu_torch.scripts import model_bench
from meng_zhang_tpu_torch.testing import anna_text, synthetic_anna_potential
from torch_port_util import reduced_ni_potential

ATOL, RTOL = 1e-9, 1e-9
CELLS = {"ni": 4, "anna": 6}     # 256 fcc atoms, 432 bcc atoms


@pytest.fixture(scope="module")
def pot_files(tmp_path_factory):
    """The reduced ni potential (.ann, Rc 2.91 A) and the reduced ANNA-ADP
    potential (.anna, npsf 4, ntsf 5, nnod 6)."""
    d = tmp_path_factory.mktemp("pots")
    ni, anna = str(d / "ni.ann"), str(d / "fe.anna")
    write_ann(ni, reduced_ni_potential())
    with open(anna, "w") as fh:
        fh.write(anna_text(synthetic_anna_potential(0, npsf=4, ntsf=5,
                                                    nnod=6)))
    return {"ni": ni, "anna": anna}


def _jax_run(model, backend, path, v):
    """scripts/model_bench.py's Simulator (:73-178) in f64: init_state from
    the velocities v, two warm-up blocks, the latch reset, one block.
    Returns (state, Thermo of the block, energy offset, n)."""
    if model == "ni":
        pot = j_read_ann(path)
        jc, jp = JM.make_annp(pot, dtype=jnp.float64)
        rc = JM.effective_cutoff(pot)
        x, box = j_lattice.fcc(CELLS["ni"], a=3.52)
        mass, capacity, cell_cap = 58.6934, 64, 24
        ensemble, t_target, delta, e_shift = "nvt", 1200.0, 0.2, jc.e_shift
        if backend == "kernels":
            pk = PallasNi(jc, jp, k_short=32, short_delta=delta)

            def force_fn(xx, bb, nbrs, short):
                return pk.energy_forces_short(xx, bb, short,
                                              want_virial=True, shift=False)

            def light(xx, bb, nbrs, short):
                e, f = pk.energy_forces_short(xx, bb, short, shift=False)
                return e, f, jnp.zeros((3, 3), xx.dtype)

            def short_build(xx, bb, nbrs):
                return pk.compact_short(xx, bb, nbrs.idx, nbrs.rev)
        else:
            force_fn, light, short_build = JM.make_short_chunked_fns(
                jc, jp, k_short=32, delta=delta, chunk=1024)
    else:
        pot = j_read_anna(path)
        jc, jp = JA.make_anna(pot, dtype=jnp.float64)
        rc = jc.cut
        x, box = j_lattice.bcc([CELLS["anna"]] * 3)
        mass, capacity, cell_cap = 55.847, 96, 48
        ensemble, t_target, e_shift = "nve", 300.0, jc.e_base
        if backend == "kernels":
            delta = 0.2
            force_fn, light, short_build = JA.make_anna_fast_fns(
                jc, jp, k_short=72, delta=delta, chunk=2048)
        else:
            delta, e_shift, light, short_build = 0.0, 0.0, None, None

            def force_fn(xx, bb, nbrs):
                e, f = JA.energy_forces(jc, jp, xx, bb, nbrs.idx)
                return e, f, jnp.zeros((3, 3), xx.dtype)
    n = len(x)
    cfg = JS.MDConfig(
        dt=0.001, cutoff=rc, skin=0.5, capacity=capacity, nbr_method="cell",
        cell_dims=cell_grid_dims(np.asarray(box), rc + 0.5),
        cell_capacity=cell_cap, ensemble=ensemble, t_target=t_target,
        tau_t=0.1, thermo_every=5, stale_factor=0.5,
        short_every=5 if short_build else 0, short_skin=delta,
        with_rev=model == "ni" and backend == "kernels")
    sim = JS.Simulator(force_fn, jnp.full(n, mass, jnp.float64), cfg,
                       short_build=short_build, force_fn_light=light)
    st = sim.init_state(jnp.asarray(x), jnp.asarray(box), v=jnp.asarray(v))
    st, _ = sim.run(st, 2)
    st = st._replace(unsafe=jnp.zeros_like(st.unsafe))
    st, th = sim.run(st, 1)
    return st, th, e_shift, n


@pytest.mark.parametrize("model,backend", [
    ("ni", "kernels"), ("ni", "chunked"), ("anna", "kernels"),
    ("anna", "chunked")])
def test_model_bench_matches_jax(pot_files, model, backend):
    run = model_bench.main(
        ["--model", model, "--cells", str(CELLS[model]), "--steps", "5",
         "--backend", backend, "--potential", pot_files[model]],
        device="cpu", dtype=torch.float64)
    rec, st = run.record, run.state
    n = rec["atoms"]
    t_init = min(model_bench.MODELS[model]["t_target"], 600.0)
    v = S.create_velocities(
        torch.Generator().manual_seed(model_bench.SEED),
        run.sim.masses, t_init, torch.float64)
    jst, jth, e_shift, jn = _jax_run(model, backend, pot_files[model],
                                     v.numpy())
    assert n == jn and rec["steps"] == 5
    for name in ("x", "v", "f"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), rtol=0,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(rec["temp_K"], float(jth.temp[-1]), rtol=RTOL)
    np.testing.assert_allclose(rec["pe_eV"], float(jth.pe[-1]) + n * e_shift,
                               rtol=RTOL)
    assert rec["unsafe"] is bool(jst.unsafe) is False
    assert rec["overflow"] is bool(jst.overflow) is False
    assert run.evaluations == 1 + 3 * 5
    assert rec["backend"] == backend and rec["device"] == "cpu"
