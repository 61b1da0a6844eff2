"""The port's tracing layer (`meng_zhang_tpu_torch.profiling`): spans and
counters inside the MD step, on the CPU.

Off, `span` is one shared no-op context and nothing is recorded; on, one
thermo block of a small fe scene (`FusedAnnp(plain=True)`, NPT: the virial
every step) and of a small ni scene (`FusedNi(plain=True)`, NVT: light
steps but the block's last) gives the span names, calls and nesting the
benchmark reads (mdbench/stages.py), counters that match the short list
the block returns, and the same state bit for bit as with tracing off.
"""
import json

import numpy as np
import pytest
import torch

from meng_zhang_tpu_torch import profiling, run
from meng_zhang_tpu_torch.io.potential import write_ann
from meng_zhang_tpu_torch.md import simulation as S
from meng_zhang_tpu_torch.models.annp import effective_cutoff, make_annp
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.testing import thermal_fcc
from meng_zhang_tpu_torch.units import MASS_FE, MASS_NI
from torch_port_util import (perturbed_bcc, reduced_ni_potential,
                             reduced_potential, t64)

# each span's nearest enclosing span (None: opened outside every span)
PARENT = {"md.step": None, "md.integrate": "md.step", "nbr.check": "md.step",
          "eval": "md.step", "eval.gather": "eval", "eval.descriptors": "eval",
          "eval.network": "eval", "eval.forces": "eval",
          "eval.delivery": "eval", "eval.virial": "eval", "md.thermo": None,
          "md.stale_read": None, "nbr.short": None, "nbr.build": None}


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _scene(kind):
    """(Simulator, its initial state, Ks): one thermo block of 10 (fe) or
    5 (ni) steps, one short-list refresh a block, in f64."""
    if kind == "fe":
        pot = reduced_potential(cut=4.0)
        x, box = perturbed_bcc(5, seed=2, disp=0.05)
        ks, delta, mass = 48, 0.4, MASS_FE
        mc = S.MDConfig(dt=0.001, cutoff=effective_cutoff(pot), skin=1.0,
                        capacity=64, nbr_method="n2", ensemble="npt",
                        t_target=300.0, p_couple=(True, True, True),
                        thermo_every=10, short_every=10, short_skin=delta)
        cfg, params = make_annp(pot, torch.float64, device="cpu")
        ev = fa.FusedAnnp(cfg, params, k_short=ks, short_delta=delta,
                          plain=True)
    else:
        pot = reduced_ni_potential(w_out=0.01)
        x, box = thermal_fcc(3, seed=3, disp=0.08)
        ks, delta, mass = 16, 0.2, MASS_NI
        mc = S.MDConfig(dt=0.001, cutoff=effective_cutoff(pot), skin=0.5,
                        capacity=32, nbr_method="n2", ensemble="nvt",
                        t_target=1200.0, thermo_every=5, short_every=5,
                        short_skin=delta)
        cfg, params = make_annp(pot, torch.float64, device="cpu")
        ev = fn.FusedNi(cfg, params, k_short=ks, short_delta=delta,
                        plain=True)
    sim = S.Simulator(
        lambda xx, bb, nb, sh: ev.energy_forces_short(xx, bb, sh),
        torch.full((len(x),), mass, dtype=torch.float64), mc,
        short_build=lambda xx, bb, nb: ev.compact_short(xx, bb, nb.idx),
        force_fn_light=lambda xx, bb, nb, sh: ev.energy_forces_short(
            xx, bb, sh, want_virial=False) + (xx.new_zeros(3, 3),))
    return sim, sim.init_state(t64(x), t64(box), seed=5), ks


def _tensors(st):
    return [st.x, st.v, st.f, st.box, st.pe, st.virial, st.nbrs.idx,
            st.nhc.xi, st.nhc.v_xi, st.v_eps, st.baro_nhc.xi,
            st.baro_nhc.v_xi, st.step, st.overflow, st.stale, st.unsafe,
            st.short.sidx, st.short.ref_x, st.short.overflow]


def test_off_span_is_one_shared_noop():
    a, b = profiling.span("md.step"), profiling.span("eval.gather")
    assert a is b
    with a:
        profiling.count("md.steps", 1)
        profiling.count("nbr.short_lanes", torch.ones(4, dtype=torch.int64))
    assert profiling.totals() == {} and profiling.counts() == {}
    assert profiling.report().splitlines()[1:] == []


@pytest.mark.parametrize("kind", ["fe", "ni"])
def test_block_spans_counts_and_state(kind):
    """Tracing off records nothing; on, the spans and counters of one
    block, and the block's state bit for bit as with tracing off."""
    sim, st0, ks = _scene(kind)
    off, th_off = sim.run(st0, 1)
    assert profiling.totals() == {} and profiling.counts() == {}
    profiling.enable()
    on, th_on = sim.run(st0, 1)
    profiling.enable(False)
    for a, b in zip(_tensors(off) + list(th_off), _tensors(on) + list(th_on)):
        assert torch.equal(a, b)

    every, n = sim.cfg.thermo_every, sim.n
    assert sim.rebuild_count == 0 and not bool(on.short.overflow)
    light = kind == "ni"
    calls = {k: c for k, (_, c) in profiling.totals().items()}
    assert calls == {
        "md.step": every, "md.integrate": 2 * every, "nbr.check": every,
        "eval": every, "eval.gather": every, "eval.descriptors": every,
        "eval.network": every, "eval.forces": every, "eval.delivery": every,
        "eval.virial": 1 if light else every, "md.thermo": 1,
        "md.stale_read": 1, "nbr.short": every // sim.cfg.short_every}
    assert all(t >= 0.0 for t, _ in profiling.totals().values())
    lanes = int((on.short.sidx < n).sum())
    assert profiling.counts() == {"md.steps": every, "nbr.shorts": 1,
                                  "nbr.short_lanes": lanes,
                                  "nbr.short_slots": n * ks}
    assert 0 < lanes < n * ks


@pytest.mark.parametrize("kind", ["fe", "ni"])
def test_counters_count_a_compaction(kind):
    """nbr.short_lanes counts each row's partners within the short list's
    radius, as the compacted ShortList holds them; a skin rebuild counts
    one build and one compaction."""
    sim, st0, ks = _scene(kind)
    profiling.enable()
    st = sim.rebuild(st0)
    profiling.enable(False)
    n = sim.n
    assert profiling.counts() == {
        "nbr.builds": 1, "nbr.shorts": 1, "nbr.short_slots": n * ks,
        "nbr.short_lanes": int((st.short.sidx < n).sum())}
    assert {k: c for k, (_, c) in profiling.totals().items()} == {
        "nbr.build": 1, "nbr.short": 1}


@pytest.mark.parametrize("kind", ["fe", "ni"])
def test_spans_nest_under_the_profiler(kind):
    """Under torch.profiler (CPU) each span is a host event, once a call,
    nested in its parent span, with the ops it ran beneath it."""
    sim, st0, _ = _scene(kind)
    profiling.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim.run(st0, 1)
    profiling.enable(False)
    seen = {}
    for e in prof.events():
        if e.name not in PARENT:
            continue
        seen[e.name] = seen.get(e.name, 0) + 1
        p = e.cpu_parent
        while p is not None and p.name not in PARENT:
            p = p.cpu_parent
        assert (p.name if p is not None else None) == PARENT[e.name], e.name
        if e.name.startswith("eval."):
            assert any(c.name.startswith("aten::") for c in e.cpu_children)
    assert seen == {k: c for k, (_, c) in profiling.totals().items()}


def test_cli_profile_table_trace_and_rebuilds(tmp_path):
    """--profile PATH prints the spans and counters and writes a Chrome
    trace with the spans; the Loop time line counts the rebuilds of every
    block (the skin builds less init_state's)."""
    import contextlib
    import io
    pot = tmp_path / "fe.ann"
    write_ann(str(pot), reduced_potential(cut=4.0))
    trace = tmp_path / "trace.json"
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        run.main(["--potential", str(pot), "--lattice", "bcc", "--cells",
                  "4", "4", "4", "--skin", "0.3", "--capacity", "64",
                  "--temp", "3000", "--steps", "40", "--thermo", "10",
                  "--profile", str(trace)], device="cpu")
    profiling.enable(False)
    lines = err.getvalue().splitlines()
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines if ln.split()}
    assert rows["md_block"][1] == "4" and rows["md.step"][1] == "40"
    assert rows["md.steps"] == ["40"]
    builds = int(rows["nbr.builds"][0])
    loop = next(ln for ln in lines if ln.startswith("Loop time"))
    rebuilds = int(loop.split("atom-steps/s, ")[1].split()[0])
    assert rebuilds == builds - 1 >= 2
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"md_block", "md.step", "eval", "eval.forces"} <= names
    assert np.isfinite(float(rows["md.step"][0]))
