"""The port's headline benchmark (meng_zhang_tpu_torch/scripts/bench.py) on
the CPU at small sizes: its one JSON line, its scenes' settings against
what the root bench.py passes to the JAX MDConfig and PallasAnnp (built
here with the same arguments; the root bench.py itself is not imported),
and the minimize branch that a missing or mis-shaped npz sends it to.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from meng_zhang_tpu.md.simulation import MDConfig as JaxMDConfig
from meng_zhang_tpu.models.annp import make_annp as jax_make_annp
from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
from meng_zhang_tpu.system.neighbors import cell_grid_dims as jax_dims
from meng_zhang_tpu_torch.scripts import bench
from meng_zhang_tpu_torch.testing import synthetic_fe_potential, thermal_bcc

FIELDS = ("dt", "cutoff", "skin", "capacity", "nbr_method", "cell_dims",
          "cell_capacity", "ensemble", "t_target", "tau_t", "p_target",
          "p_couple", "tau_p", "thermo_every", "pbc", "short_every",
          "short_skin")


def _line(capsys):
    """The run's stdout: exactly one line, a JSON object with bench.py's
    four keys."""
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["unit"] == "atom-steps/s"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / (0.559 * 152880), 3)
    return rec


def test_synthetic_prints_one_bench_line(capsys):
    """6 cells a side (432 atoms, 17.13 A): the smallest bcc box above
    2 (rc + skin) = 17.0 A, below which both packages' Simulators refuse a
    periodic box (the single-image convention would miss images)."""
    run = bench.main(["--synthetic", "--n-cells", "6", "--steps", "20"],
                     device="cpu")
    rec = _line(capsys)
    assert rec == run.record
    assert rec["metric"].startswith("bcc-Fe annp NVE throughput")
    assert "synthetic fe potential" in rec["metric"]
    st = run.state
    assert st.x.shape == (2 * 6 ** 3, 3)
    assert not bool(st.overflow) and not bool(st.unsafe)
    # init, the 10-step warm-up block and 20 timed steps
    assert run.evaluations == 1 + 10 + 20 and run.minimized is None


@pytest.mark.parametrize("scene", ["reference", "synthetic"])
def test_scene_settings_are_bench_py_s(scene):
    """bench.py passes capacity 192 and skin 1.2 with NPT (`m p m`,
    y-coupled) for the reference scene, capacity 256 and skin 2.0 with NVE
    for the synthetic one (:284-286, :306-308), into MDConfig at :130-137
    with the cell grid at 0.92 of the box under NPT (:128), and
    PallasAnnp(short_delta=0.4) at its default Ks (:103-115)."""
    pot = synthetic_fe_potential(0)
    if scene == "reference":
        box = np.asarray(bench.BOX)
        capacity, skin, ens = 192, 1.2, "npt"
        pbc, couple = (False, True, False), (False, True, False)
    else:
        box = np.full(3, 24 * 2.8553)
        capacity, skin, ens = 256, 2.0, "nve"
        pbc, couple = (True,) * 3, (False,) * 3
    jcfg, jparams = jax_make_annp(pot, dtype=jnp.float32, pbc=pbc)
    pk = PallasAnnp(jcfg, jparams, short_delta=0.4)
    dims = jax_dims(box * (0.92 if ens == "npt" else 1.0), jcfg.cut + skin)
    want = JaxMDConfig(dt=0.001, cutoff=jcfg.cut, skin=skin,
                       capacity=capacity, nbr_method="cell", cell_dims=dims,
                       cell_capacity=96, ensemble=ens, t_target=300.0,
                       tau_t=0.1, p_target=(0.0,) * 3, p_couple=couple,
                       tau_p=1.0, thermo_every=10, with_rev=True, pbc=pbc,
                       short_every=10, short_skin=pk.short_delta,
                       short_host_refresh=False)
    got = bench.md_config(jcfg.cut, box, scene)
    for f in FIELDS:
        assert tuple(np.atleast_1d(getattr(got, f))) == \
            tuple(np.atleast_1d(getattr(want, f))), f
    assert (bench.K_SHORT, bench.SHORT_DELTA) == (pk.k_short, pk.short_delta)
    assert bench.SCENES[scene]["pbc"] == pbc


def _small_scene():
    """A 192-atom bcc slab (4 x 6 x 4 cells, 0.02 A noise): the periodic y
    (17.13 A) above 2 (rc + skin) = 15.4 A, the whole small enough for the
    all-pairs list."""
    x, box = thermal_bcc((4, 6, 4), seed=2, disp=0.02)
    return x, np.asarray(box)


def test_missing_or_misshaped_npz_minimizes(tmp_path, capsys):
    """No npz at --min-npz: cg_minimize runs and writes it; an npz of
    another shape (the committed 152,880-atom one, or a written one): it
    runs again; an npz of the scene's shape: it is used, no minimize."""
    scene = _small_scene()
    n = len(scene[0])
    npz = tmp_path / "min.npz"
    argv = ["--steps", "10", "--min-npz", str(npz)]
    run = bench.main(argv, device="cpu", scene=scene)
    _line(capsys)
    assert run.minimized is not None and run.minimized.n_evals > 1
    assert run.minimized.converged in ("etol", "ftol")
    with np.load(npz) as z:
        x_min = z["x"]
    assert x_min.shape == (n, 3)
    np.testing.assert_allclose(x_min, run.minimized.x.numpy(), rtol=0,
                               atol=0)
    # the written npz is used as it is
    run = bench.main(argv, device="cpu", scene=scene)
    _line(capsys)
    assert run.minimized is None
    # mis-shaped: the committed artifact, and a written one
    run = bench.main(["--steps", "10"], device="cpu", scene=scene)
    _line(capsys)
    assert run.minimized is not None
    np.savez(npz, x=np.zeros((n - 1, 3), np.float32))
    run = bench.main(argv, device="cpu", scene=scene)
    assert run.minimized is not None
    assert "NPT" in _line(capsys)["metric"]
    with np.load(npz) as z:
        assert z["x"].shape == (n, 3)


def test_no_npz_and_nothing_to_minimize_falls_back(tmp_path, capsys):
    run = bench.main(["--min-npz", str(tmp_path / "none.npz"), "--n-cells",
                      "6", "--steps", "10"], device="cpu")
    assert _line(capsys)["metric"].startswith("bcc-Fe annp NVE")
    assert run.minimized is None and not (tmp_path / "none.npz").exists()
