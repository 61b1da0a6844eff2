"""stages.py: the charging of a profiled stretch's device events and idle
gaps to the program's spans, on a hand-made event list; the readers of
its metrics; and a traced CPU run, where only the host-side readings
appear."""
from __future__ import annotations

import json
import os

import pytest

from cpu_cells import run_cpu, small_copy
from mdbench import found, stages
from mdbench.stages import OUTSIDE, PROFILER, UNLINKED, Event


def host(name, a, b, corr=0, annotation=False):
    return Event(name, False, a, b, corr, annotation)


def dev(name, a, b, corr=0, annotation=False):
    return Event(name, True, a, b, corr, annotation)


# window [0, 1000] ns; md.step > eval > eval.forces, then nbr.short
EVENTS = [
    host(stages.WINDOW, 0, 1000, 1, annotation=True),
    host("md.step", 10, 500, 2, annotation=True),
    host("eval", 100, 400, 3, annotation=True),
    host("eval.forces", 150, 250, 4, annotation=True),
    host("nbr.short", 600, 700, 5, annotation=True),
    # launches: runtime calls, by CUPTI correlation id
    host("cudaMemsetAsync", 20, 25, 103),
    host("cudaLaunchKernel", 110, 115, 102),
    host("cudaLaunchKernel", 160, 170, 101),
    host("aten::sort", 610, 650, 7),
    host("cudaLaunchKernel", 620, 625, 998),
    host("cudaLaunchKernel", 800, 805, 104),
    # a launch whose device event the profiler dropped
    host("cudaLaunchKernel", 850, 855, 107),
    # a host op whose own id collides with a launch's
    host("aten::add", 400, 450, 101),
    # the profiler's own, under the same id as aten::sort
    host("Activity Buffer Request", 700, 790, 7),
    dev("Memset (Device)", 30, 40, 103),
    dev("force_harm_kernel<float>", 200, 300, 101),
    dev("eval.forces", 200, 300, 4, annotation=True),
    dev("mdbench.stretch", 30, 950, 1, annotation=True),
    dev("reduce_kernel", 300, 350, 102),
    dev("sort_kernel", 660, 690, 998),
    dev("fill_kernel", 810, 820, 104),
    # no runtime call of its id: unlinked
    dev("stray_kernel", 900, 950, 999),
]


def test_innermost_takes_the_shortest_holding_interval():
    ivs = [(0, 100, "a"), (10, 50, "b"), (40, 120, "c"), (20, 30, "d")]
    got = stages.innermost(ivs, [110, 25, 45, 5, 60, 200, 30])
    assert got == ["c", "d", "b", "a", "c", None, "d"]


def test_charges_partition_device_and_idle_time():
    c = stages.charge(EVENTS, (0, 1000))
    assert c.device == {"eval.forces": 100, "eval": 50, "md.step": 10,
                        "nbr.short": 30, OUTSIDE: 10, UNLINKED: 50}
    assert sum(c.device.values()) == c.device_ns == 250
    assert c.busy_ns == 250 and c.window_ns == 1000
    assert c.idle == {"md.step": 30, "eval": 160, PROFILER: 120,
                      OUTSIDE: 440}
    assert sum(c.idle.values()) == c.window_ns - c.busy_ns
    assert (c.launches, c.lost) == (6, 1)


class Ctx:
    pass


def _ctx(charges, steps=10):
    ctx = Ctx()
    ctx.stages = stages.Readings(
        span_steps=20, span_wall_s=0.1,
        host_s={"md.stale_read": 0.004, "md.step": 0.09},
        counts={"md.steps": 20, "nbr.short_lanes": 300,
                "nbr.short_slots": 400},
        profile_steps=steps, profile_wall_s=1e-6, charges=charges)
    return ctx


DEVICE = ["device_ms." + k for k in stages.DEVICE_LAYERS]
IDLE = ["idle_ms." + k for k in stages.IDLE_LAYERS]


def test_readers_partition_per_step():
    """The eight device_ms readers with outside and unlinked add up to the
    device time a step; the idle_ms readers with profiler and outside to
    the idle time a step."""
    ev = [e for e in EVENTS] + [
        host("md.integrate", 12, 18, 8, annotation=True),
        host("cudaLaunchKernel", 13, 14, 105),
        dev("mul_kernel", 40, 60, 105),
        host("eval.gather", 101, 108, 9, annotation=True),
        host("cudaLaunchKernel", 102, 103, 106),
        dev("gather_kernel", 60, 70, 106)]
    c = stages.charge(ev, (0, 1000))
    ctx = _ctx(c)
    got = {m: found.load("metrics", m).read(ctx) for m in DEVICE + IDLE}
    assert got["device_ms.forces"] == pytest.approx(100 / 1e6 / 10)
    assert got["device_ms.gather"] == pytest.approx(10 / 1e6 / 10)
    assert got["device_ms.driver"] == pytest.approx((50 + 10 + 20) / 1e6
                                                    / 10)
    assert got["device_ms.neighbor"] == pytest.approx(30 / 1e6 / 10)
    rest = (c.device.get(OUTSIDE, 0) + c.device.get(UNLINKED, 0)) / 1e7
    assert sum(got[m] for m in DEVICE) + rest == \
        pytest.approx(c.device_ns / 1e7, rel=1e-12)
    rest = (c.idle.get(OUTSIDE, 0) + c.idle.get(PROFILER, 0)) / 1e7
    assert sum(got[m] for m in IDLE) + rest == \
        pytest.approx((c.window_ns - c.busy_ns) / 1e7, rel=1e-12)
    assert got["idle_ms.evaluate"] == pytest.approx(c.idle["eval"] / 1e7)
    assert found.load("metrics", "sync_wait_ms").read(ctx) == \
        pytest.approx(0.2)
    assert found.load("metrics", "short_lane_fill").read(ctx) == \
        pytest.approx(75.0)


def test_a_span_under_eval_takes_its_own_time():
    """A span that a later path opens inside `eval` (eval.fields, which no
    list in stages.py names) is charged by its namespace: the launch made
    inside it goes to it and not to `eval`'s self time, and the idle gap
    inside it to the evaluator's idle layer."""
    ev = [host(stages.WINDOW, 0, 1000, 1, annotation=True),
          host("md.step", 0, 1000, 2, annotation=True),
          host("eval", 100, 900, 3, annotation=True),
          host("eval.fields", 200, 600, 4, annotation=True),
          host("cudaLaunchKernel", 110, 115, 101),
          host("cudaLaunchKernel", 210, 215, 102),
          dev("phase1_kernel", 120, 200, 101),
          dev("eval.fields", 250, 300, 4, annotation=True),
          dev("fields_kernel", 250, 300, 102)]
    c = stages.charge(ev, (0, 1000))
    assert c.device == {"eval": 80, "eval.fields": 50}
    assert c.idle == {"md.step": 120, "eval.fields": 50, "eval": 700}
    ctx = _ctx(c)
    assert stages.per_step_ms(ctx, "device", ("eval.fields",)) == \
        pytest.approx(50 / 1e7)
    assert found.load("metrics", "device_ms.driver").read(ctx) == \
        pytest.approx(80 / 1e7)
    assert found.load("metrics", "idle_ms.evaluate").read(ctx) == \
        pytest.approx(750 / 1e7)
    assert found.load("metrics", "idle_ms.driver").read(ctx) == \
        pytest.approx(120 / 1e7)
    assert stages.selects(stages.IDLE_LAYERS["evaluate"], "eval.fields")
    assert not stages.is_span("mdbench.stretch")


def test_readers_report_nothing_without_a_profiled_stretch(monkeypatch):
    """No stretch (b) (a CPU run): no device or idle reading; a program
    without spans: no reading at all, and nothing raised."""
    ctx = _ctx(None, steps=0)
    for m in DEVICE + IDLE:
        assert found.load("metrics", m).read(ctx) is None
    assert found.load("metrics", "short_lane_fill").read(ctx) == 75.0
    from meng_zhang_tpu_torch import profiling
    monkeypatch.delattr(profiling, "span")
    bare = Ctx()
    bare.spans = bare.cap = None
    for m in DEVICE + IDLE + ["sync_wait_ms", "short_lane_fill"]:
        assert found.load("metrics", m).read(bare) is None


def test_a_traced_cpu_run_reads_the_host_side(tmp_path):
    """A traced run on the CPU: the short-list fill and the block-end
    wait from the program's counters and spans, no device number."""
    root = small_copy(str(tmp_path))
    path = os.path.join(root, "mdbench", "workloads",
                        "ni-bp.fcc-nvt-1200k.json")
    with open(path) as fh:
        wl = json.load(fh)
    wl["trace"] = {"span_blocks": 2, "profile_blocks": 1}
    with open(path, "w") as fh:
        json.dump(wl, fh)
    out = run_cpu(root, "ni-bp.fcc-nvt-1200k", 11, trace=1)
    got = out["metrics"]
    assert 0.0 < got["short_lane_fill"]["value"] < 100.0
    assert got["sync_wait_ms"]["value"] >= 0.0
    assert not any(k.startswith(("device_ms.", "idle_ms.")) for k in got)
    assert "step_mfu" in got and out["correct"] is True
