"""The sharded drivers across processes (meng_zhang_tpu_torch/parallel/
launch.py, mesh.py's process-group backend): W ranks spawned on the CPU
over gloo, each holding D / W shards, against the in-process mesh (D
shards in this process), all in f64 on the synthetic potentials at reduced
width:

  * every collective of the distributed mesh (ppermute with a shard that no
    pair names, in f64, bool and int64; ring_shift; all_gather; psum, also
    of one partial sum a rank; any) exactly equal to the in-process mesh's
    on the same [D, ...] tensors, on W = 2 (L = 2) and W = 4 (L = 1);
  * ShardedMD (4 slabs, `m p m`, y-coupled NPT, migrate_b, in-run
    rebuilds) on W = 2 and 4, ShardedMD2D (2, 2) on W = 2 and 4 and
    ShardedMD3D (2, 2, 2) on W = 4 (two shards a rank, so the rounds cross
    local and remote pairs), each against the same run in process: thermo
    rtol 1e-10, gathered positions atol 1e-10 A, equal rebuild counts and
    migrated atoms; the replicated state (box, thermostat and barostat
    chains, virial, global flags) bitwise equal on every rank (checked in
    the ranks by `run_sharded`);
  * an undersized halo_b on W = 4 latches OVF_COVERAGE on the same shards
    as in process;
  * W = 2 ranks against the JAX ShardedMD on the 8-device CPU mesh
    (tests/conftest.py) in this process: thermo rtol 1e-9, positions atol
    1e-9 A (test_torch_domain.py's bars);
  * a rank that raises makes `spawn` raise within its timeout, with that
    rank's traceback;
  * the launcher's CLI (`python -m meng_zhang_tpu_torch.parallel.launch`)
    on 2 gloo ranks over 4 shards.

Only the JAX comparison imports JAX; the ranks import the port alone. The
driver runs of a world go through one launch (`_ranks`) and each in-process
run is made once (`_in_process`), so that the file pays a rank's start
(~3 s, mostly importing torch) once a world.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from meng_zhang_tpu_torch.models import annp
from meng_zhang_tpu_torch.parallel import launch
from meng_zhang_tpu_torch.parallel.domain import OVF_COVERAGE, ShardConfig
from meng_zhang_tpu_torch.parallel.domain2d import Shard2DConfig
from meng_zhang_tpu_torch.parallel.domain3d import Shard3DConfig
from meng_zhang_tpu_torch.testing import thermal_fcc
from meng_zhang_tpu_torch.units import MASS_FE
from torch_port_util import (perturbed_bcc, reduced_ni_potential,
                             reduced_potential, thermal_velocities)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M_NI = 58.6934
MPM = (False, True, False)
TIMEOUT = 90.0


def _same_run(got, want):
    """A distributed run against the in-process one."""
    assert got["rebuild_count"] == want["rebuild_count"]
    assert got["migrated"] == want["migrated"]
    np.testing.assert_array_equal(got["overflow"], want["overflow"])
    np.testing.assert_array_equal(got["unsafe"], want["unsafe"])
    assert not want["overflow"].any() and not want["unsafe"].any()
    for key in ("temp", "pe", "ke", "press", "vol", "conserved"):
        np.testing.assert_allclose(got["thermo"][key], want["thermo"][key],
                                   rtol=1e-10, err_msg=key)
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-10)


# ------------------------------------------------------------ the runs
def _slab_spec(**kw):
    """4 slabs of a 608-atom bcc box, `m p m`, y-coupled NPT from 300 K
    with migrate_b 16: each slab boundary splits an x-plane of atoms, whose
    thermal motion moves atoms across it; a small stale_factor makes the
    run rebuild."""
    x, box = perturbed_bcc((19, 4, 4), seed=11, disp=0.04)
    n = len(x)
    cfg = ShardConfig(
        n_devices=4, c_loc=n // 4, cutoff=4.0, skin=0.5, dt=0.001,
        ensemble="npt", t_target=300.0, tau_t=0.1, p_target=(0.0,) * 3,
        p_couple=MPM, tau_p=1.0, thermo_every=4, pbc=MPM, migrate_b=16,
        stale_factor=0.2, **kw)
    return launch.ShardRun(cfg=cfg, pot=reduced_potential(cut=4.0), x=x,
                           box=np.asarray(box), mass=MASS_FE,
                           v=thermal_velocities(n, 300.0, MASS_FE, 2),
                           pbc=MPM, n_blocks=3, migrate_rebuild=True,
                           device="cpu")


def _halo_spec():
    """The slabs' distribute with halo_b 32, short of the cutoff."""
    return dataclasses.replace(_slab_spec(halo_b=32, capacity=48),
                               n_blocks=0, migrate_rebuild=False)


def _grid_spec(layout):
    """600 K NVE on the ni potential (w_out 0.1) through the frame short
    list with migrate_b (a small stale_factor makes the run rebuild): a
    (2, 2) grid of columns over a 1,024-atom fcc
    box, or a (2, 2, 2) grid of bricks over an 864-atom fcc cube, each
    less d atoms (vacancies), so that the block boundaries split planes of
    atoms, whose thermal motion moves atoms across them."""
    if layout == "2d":
        x, box = thermal_fcc((8, 8, 4), seed=5, disp=0.02)
        make, mesh, mb = Shard2DConfig, (2, 2), 16
    else:
        x, box = thermal_fcc((6, 6, 6), seed=8, disp=0.04)
        make, mesh, mb = Shard3DConfig, (2, 2, 2), 8
    d = int(np.prod(mesh))
    x = x[d:]
    n = len(x)
    pot = reduced_ni_potential(w_out=0.1)
    rc = annp.descriptor_cutoff(*annp.make_annp(pot, torch.float64, "cpu"))
    cfg = make(n_devices=d, mesh_shape=mesh, c_loc=n // d, cutoff=rc,
               skin=0.3, dt=0.001, thermo_every=2, migrate_b=mb,
               stale_factor=0.3)
    return launch.ShardRun(cfg=cfg, pot=pot, x=x, box=np.asarray(box),
                           mass=M_NI, v=thermal_velocities(n, 600.0, M_NI, 3),
                           short_delta=0.2, n_blocks=3, migrate_rebuild=True,
                           device="cpu")


def _jax_case():
    """test_torch_domain.py::test_end_to_end_matches_jax's `short` case, 2
    slabs of a 512-atom bcc box, NVT from 100 K: (spec, the config's
    keywords)."""
    x, box = perturbed_bcc((16, 4, 4), seed=11, disp=0.04)
    n = len(x)
    kw = dict(n_devices=2, c_loc=n // 2, cutoff=4.0, skin=0.5, dt=0.001,
              capacity=48, ensemble="nvt", t_target=100.0, thermo_every=2)
    spec = launch.ShardRun(cfg=ShardConfig(**kw),
                           pot=reduced_potential(cut=4.0), x=x,
                           box=np.asarray(box), mass=MASS_FE,
                           v=thermal_velocities(n, 100.0, MASS_FE, 1),
                           n_blocks=2, device="cpu")
    return spec, kw


_SPECS = {"slab": _slab_spec, "halo": _halo_spec,
          "2d": lambda: _grid_spec("2d"), "3d": lambda: _grid_spec("3d"),
          "jax": lambda: _jax_case()[0]}
# the runs of each world, made in one launch
_WORLD_RUNS = {2: ("slab", "2d", "jax"), 4: ("slab", "2d", "3d", "halo")}


@functools.cache
def _in_process(kind):
    return launch.run_sharded(_SPECS[kind](), distributed=False)


@functools.cache
def _ranks(world):
    """{kind: rank 0's run_sharded result} of the world's runs."""
    kinds = _WORLD_RUNS[world]
    out = launch.spawn(launch.run_each, world, "gloo", "cpu",
                       ([_SPECS[k]() for k in kinds],), TIMEOUT)
    return dict(zip(kinds, out.result))


# ------------------------------------------------------------ the mesh
@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_in_process_mesh(world):
    done = launch.spawn(launch.check_collectives, world, "gloo", "cpu",
                        (4, "cpu"), TIMEOUT).result
    for name in ("ppermute partial bool", "ppermute grid-y int64",
                 "ring_shift -1 f64", "all_gather bool", "psum f64",
                 "psum int64", "psum of the ranks' sums", "any"):
        assert name in done, name
    assert len(done) == 3 * 7 + 4


def test_a_raising_rank_fails_the_launch():
    """Rank 1 raises while rank 0 waits in a collective: spawn raises with
    rank 1's traceback and ends rank 0."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised"):
        launch.spawn(launch.check_collectives, 2, "gloo", "cpu",
                     (4, "cpu", 1), TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT


def test_entry_points_default_to_the_card():
    """spawn, ShardRun, check_collectives and dryrun run on the card
    unless the CPU is named, spawn over NCCL on the card unless gloo is
    named; without a card the default raises before starting a rank."""
    import inspect
    assert launch.ShardRun.device == "cuda"
    for fn in (launch.spawn, launch.check_collectives, launch.dryrun):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(launch.spawn).parameters["backend"].default \
        is None
    assert launch._backend("cpu", None) == "gloo"
    if torch.cuda.is_available():
        assert launch._backend("cuda", None) == "nccl"
        assert launch._backend("cuda", "gloo") == "gloo"
    else:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.spawn(launch.check_collectives, 2, args=(4,))
        assert time.monotonic() - t0 < 1.0


# ------------------------------------------------------------ drivers
@pytest.mark.parametrize("world", [2, 4])
def test_slabs_match_in_process(world):
    want = _in_process("slab")
    assert want["rebuild_count"] >= 1 and want["migrated"] >= 1
    got = _ranks(world)["slab"]
    assert (got["world"], got["n_local"]) == (world, 4 // world)
    _same_run(got, want)


@pytest.mark.parametrize("layout,world", [("2d", 2), ("2d", 4), ("3d", 4)])
def test_grids_match_in_process(layout, world):
    want = _in_process(layout)
    assert want["rebuild_count"] >= 1 and want["migrated"] >= 1
    got = _ranks(world)[layout]
    assert (got["world"], got["n_local"]) == (
        world, _SPECS[layout]().cfg.n_devices // world)
    _same_run(got, want)


def test_undersized_halo_latches_coverage_on_the_same_shards():
    want = _in_process("halo")["overflow"]
    got = _ranks(4)["halo"]["overflow"]
    assert (want & OVF_COVERAGE).any()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- end to end against JAX
def test_two_ranks_match_jax_end_to_end():
    """test_torch_domain.py::test_end_to_end_matches_jax's `short` case,
    the port on 2 ranks of one slab each."""
    import jax.numpy as jnp

    from meng_zhang_tpu.models import annp as jannp
    from meng_zhang_tpu.ops.pallas_annp import PallasAnnp
    from meng_zhang_tpu.parallel import domain as JD
    spec, kw = _jax_case()
    got = _ranks(2)["jax"]
    jcfg, jparams = jannp.make_annp(spec.pot, dtype=jnp.float64)
    jmd = JD.ShardedMD(JD.FrameShortModel(PallasAnnp(
        jcfg, jparams, k_short=32, short_delta=0.4)), MASS_FE, spec.box,
        JD.ShardConfig(**kw))
    jst, _ = jmd.distribute(jnp.asarray(spec.x), jnp.asarray(spec.v))
    jst, jth = jmd.run(jst, 2)
    assert not got["overflow"].any()
    for key in ("temp", "conserved"):
        np.testing.assert_allclose(got["thermo"][key],
                                   np.asarray(getattr(jth, key)), rtol=1e-9)
    np.testing.assert_allclose(got["thermo"]["pe"], np.asarray(jth.pe),
                               rtol=1e-9, atol=1e-9 * len(spec.x))
    np.testing.assert_allclose(got["x"],
                               np.asarray(jmd.gather_positions(jst)),
                               rtol=0, atol=1e-9)


# ------------------------------------------------------------ the CLI
def test_launcher_cli_on_two_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "meng_zhang_tpu_torch.parallel.launch",
         "--nproc", "2", "--shards", "4", "--device", "cpu", "--backend",
         "gloo"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    ok = [line for line in res.stdout.splitlines() if " OK" in line]
    assert len(ok) == 4, res.stdout
    assert "4 shards on 2 ranks (2 a rank)" in ok[0]
