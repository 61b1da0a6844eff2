"""Readings from inside the program: its own spans and counters
(meng_zhang_tpu_torch.profiling), taken in two stretches that follow the
harness's traced stretches, on the run's Simulator. The window, the
harness's spans and its profiled stretch run before them with the
program's tracing off, and no reading of theirs comes from here.

(a) `span_blocks` blocks with the program's tracing on and no profiler:
    the host seconds of each span (`md.stale_read`: the host waiting for
    the card at the block's end) and the counters (md.steps,
    nbr.short_lanes, nbr.short_slots);
(b) `profile_blocks` blocks with tracing on under torch.profiler: each
    device event (kernels, memcpy and memset alike) is charged to the
    innermost program span open on the host when its launch ran (the CUDA
    runtime event of its correlation id), `outside` when none was open,
    `(unlinked)` when no launch is found;
    each idle gap of the device, within the stretch, to the innermost
    program span open at its middle, to `profiler` when the innermost host
    event there is the profiler's own (its activity-buffer requests), and
    to `outside` when no program span is open. A stretch in which more
    than 1 % of the kernel, memcpy and memset launches have no device
    event (the profiler dropped records) is run again, twice at most.

The state the stretches start from is the window's end (positions,
velocities, box), given to init_state, then one untraced block. The spans
that count are the program's by namespace (`is_span`): `eval` and every
span named `eval.*`, `nbr.*` or `md.*`, so a span that a path or the
program adds there (`eval.fields`) takes its own device time and idle
gaps from the span that encloses it, with no edit here; the device-side
copies of the spans (user annotations) are not device work. A metric's
reader calls `readings(ctx)`: the stretches run once a run, on its first
call, and `per_step_ms(ctx, table, names)` reads spans by whole name or
by namespace (`"eval.*"`). A program without spans, and a run with no
Simulator left to drive, give None; stretch (b) runs only on a CUDA
device.
"""
from __future__ import annotations

import heapq
import re
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch

NAMESPACES = ("eval.", "nbr.", "md.")     # and `eval` itself
OUTSIDE, UNLINKED, PROFILER = "outside", "(unlinked)", "profiler"
WINDOW = "mdbench.stretch"
# host events of the profiler itself (CUPTI's activity buffers)
PROFILER_OWN = ("Activity Buffer Request",)
# CUDA runtime and driver calls: cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, cudaMemsetAsync, ...; LAUNCH: those that put work on
# the device
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")
DROPPED = 0.01


class Event(NamedTuple):
    """One profiler event: times in ns on the profiler's clock."""
    name: str
    device: bool         # a device activity (else a host event)
    start: int
    end: int
    corr: int            # correlation id
    annotation: bool     # a record_function range, or its device copy


class Charges(NamedTuple):
    """Stretch (b): device ns and idle ns by the span they are charged
    to (or OUTSIDE, UNLINKED, PROFILER); the device events' summed ns, the
    union of their intervals within the stretch, the stretch's ns; the
    launches within it, and those of them with no device event."""
    device: dict
    idle: dict
    device_ns: int
    busy_ns: int
    window_ns: int
    launches: int
    lost: int


class Readings(NamedTuple):
    span_steps: int          # md.steps of stretch (a)
    span_wall_s: float       # its wall, synchronised at both ends
    host_s: dict             # span -> host seconds in stretch (a)
    counts: dict             # counter -> count in stretch (a)
    profile_steps: int       # md.steps of stretch (b), 0 without it
    profile_wall_s: float
    charges: Optional[Charges]


def is_span(name):
    """Whether a host event is one of the program's spans that count."""
    return name == "eval" or name.startswith(NAMESPACES)


def selects(names, span):
    """Whether `names` (whole span names, or `<namespace>.*` for every
    span under it) take `span`."""
    return any(span == k or (k.endswith(".*") and span.startswith(k[:-1]))
               for k in names)


def innermost(intervals, points):
    """For each point, the label of the shortest interval (start, end,
    label) holding it (start <= t <= end), or None."""
    ivs = sorted(intervals, key=lambda iv: iv[0])
    out = [None] * len(points)
    heap, j = [], 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        while j < len(ivs) and ivs[j][0] <= t:
            a, b, label = ivs[j]
            heapq.heappush(heap, (b - a, j, b, label))
            j += 1
        while heap and heap[0][2] < t:
            heapq.heappop(heap)
        if heap:
            out[i] = heap[0][3]
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def charge(events, window):
    """Charges of a profiled stretch: events (Event) and its window (lo,
    hi) on the profiler's clock. The device charges partition the device
    events' summed time and the idle charges the window less the union
    of the device events, each exactly."""
    lo, hi = window
    host = [e for e in events if not e.device]
    work = [e for e in events if e.device and not e.annotation
            and not is_span(e.name)]
    spans = [(e.start, e.end, e.name) for e in host if is_span(e.name)]
    runtime = {}
    for e in host:
        if RUNTIME.match(e.name):
            runtime.setdefault(e.corr, e.start)
    launch = [runtime.get(e.corr) if e.corr > 0 else None for e in work]
    linked = [i for i, t in enumerate(launch) if t is not None]
    device = defaultdict(int)
    for e, t in zip(work, launch):
        if t is None:
            device[UNLINKED] += e.end - e.start
    for i, label in zip(linked, innermost(spans,
                                          [launch[i] for i in linked])):
        device[label or OUTSIDE] += work[i].end - work[i].start

    busy = _union([(max(e.start, lo), min(e.end, hi)) for e in work
                   if e.end > lo and e.start < hi])
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    mids = [0.5 * (a + b) for a, b in gaps]
    under = innermost([(e.start, e.end, e.name) for e in host], mids)
    in_span = innermost(spans, mids)
    idle = defaultdict(int)
    for (a, b), h, s in zip(gaps, under, in_span):
        idle[PROFILER if h in PROFILER_OWN else (s or OUTSIDE)] += b - a
    done = {e.corr for e in work}
    launches = [e.corr for e in host
                if LAUNCH.match(e.name) and lo <= e.start <= hi]
    return Charges(dict(device), dict(idle),
                   sum(e.end - e.start for e in work),
                   sum(b - a for a, b in busy), hi - lo, len(launches),
                   sum(1 for c in launches if c not in done))


def from_kineto(raw):
    """Events of torch.profiler's kineto results (host and CUDA)."""
    from torch.autograd import DeviceType
    out = []
    for ev in raw:
        kind = ev.device_type()
        if kind not in (DeviceType.CPU, DeviceType.CUDA):
            continue
        out.append(Event(ev.name(), kind == DeviceType.CUDA, ev.start_ns(),
                         ev.end_ns(), ev.correlation_id(),
                         bool(ev.is_user_annotation())))
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _log(msg):
    from mdbench import harness
    harness.log("stages: " + msg)


def readings(ctx):
    """The run's Readings (stretches (a) and (b) on the first call), or
    None where the program has no spans."""
    if not hasattr(ctx, "stages"):
        ctx.stages = _measure(ctx)
    return ctx.stages


def _tracing():
    """The program's tracing module, if it has spans and counters."""
    try:
        from meng_zhang_tpu_torch import profiling
    except ImportError:
        return None
    names = ("span", "count", "enable", "reset", "totals", "counts")
    return profiling if all(hasattr(profiling, k) for k in names) else None


def _measure(ctx):
    profiling = _tracing()
    sim = getattr(getattr(ctx, "spans", None), "sim", None)
    if profiling is None or sim is None or ctx.cap is None:
        return None
    t_start = time.monotonic()
    dev = ctx.dev
    s1 = ctx.cap.s1
    st = sim.init_state(s1["x"].clone(), s1["box"].clone(),
                        v=s1["v"].clone(), seed=int(ctx.seed) % (1 << 63))
    st, _ = sim.run(st, 1)
    _sync(dev)
    tr = ctx.wl["trace"]
    profiling.reset()
    profiling.enable()
    try:
        t0 = time.perf_counter()
        for _ in range(tr["span_blocks"]):
            st, _ = sim.run(st, 1)
        _sync(dev)
        wall_a = time.perf_counter() - t0
        host, counts = profiling.totals(), profiling.counts()
        host = {k: v[0] for k, v in host.items()}
        charges, steps_b, wall_b = None, 0, 0.0
        for _ in range(3 if dev.type == "cuda" else 0):
            profiling.reset()
            st, charges, wall_b = _profiled(sim, st, tr["profile_blocks"],
                                            dev)
            steps_b = profiling.counts().get("md.steps", 0)
            if charges.lost <= DROPPED * charges.launches:
                break
            _log(f"(b) {charges.lost} of {charges.launches} launches have "
                 "no device event (records dropped): run again")
    finally:
        profiling.enable(False)
        profiling.reset()
    del st
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r = Readings(counts.get("md.steps", 0), wall_a, host, counts, steps_b,
                 wall_b, charges)
    _report(ctx, r)
    _log(f"{time.monotonic() - t_start:.3f} s for both stretches, set-up "
         "and the charging included")
    return r


def _profiled(sim, st, blocks, dev):
    """Stretch (b): (state, Charges, host-clock wall seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(blocks):
                st, _ = sim.run(st, 1)
            _sync(dev)
            wall = time.perf_counter() - t0
    events = from_kineto(prof.profiler.kineto_results.events())
    win = next(e for e in events if not e.device and e.name == WINDOW)
    return st, charge(events, (win.start, win.end)), wall


def per_step_ms(ctx, table, names):
    """ms a step of stretch (b) charged to the spans `names` select
    (`selects`) in the Charges' `table` ("device" or "idle"); None
    without stretch (b)."""
    r = readings(ctx)
    if r is None or r.charges is None or not r.profile_steps:
        return None
    got = getattr(r.charges, table)
    return sum(v for k, v in got.items() if selects(names, k)) / 1e6 \
        / r.profile_steps


# the spans each device_ms.* and idle_ms.* metric reads; a span added
# under eval.* takes its device time out of `eval`'s self time (driver)
# for a metric of its own, and its idle gaps stay in the evaluator's
DEVICE_LAYERS = {
    "gather": ("eval.gather",), "network": ("eval.network",),
    "delivery": ("eval.delivery",), "virial": ("eval.virial",),
    "descriptors": ("eval.descriptors",), "forces": ("eval.forces",),
    "neighbor": ("nbr.check", "nbr.build", "nbr.short"),
    "driver": ("md.step", "md.integrate", "md.thermo", "md.stale_read",
               "eval")}
IDLE_LAYERS = {"evaluate": ("eval", "eval.*"), "neighbor": ("nbr.*",),
               "driver": ("md.*",)}


def _report(ctx, r):
    """Log lines of the stretches: the cost of tracing when on, and the
    partitions of stretch (b)."""
    if r.span_steps and ctx.steps:
        ms_a = 1e3 * r.span_wall_s / r.span_steps
        ms_w = 1e3 * ctx.wall / ctx.steps
        _log(f"(a) {r.span_steps} steps in {r.span_wall_s:.6f} s: "
             f"{ms_a:.6f} ms a step, the window's {ms_w:.6f}: tracing "
             f"{100.0 * (ms_a / ms_w - 1.0):+.3f} %")
        _log("(a) host ms a step: " + ", ".join(
            f"{k} {1e3 * v / r.span_steps:.6f}"
            for k, v in sorted(r.host_s.items(), key=lambda kv: -kv[1])))
        _log("(a) counters: " + ", ".join(f"{k} {v}" for k, v in
                                          sorted(r.counts.items())))
    c = r.charges
    if c is None or not r.profile_steps:
        return
    n = r.profile_steps
    _log(f"(b) {n} steps, window {c.window_ns / 1e9:.6f} s on the "
         f"profiler's clock, {r.profile_wall_s:.6f} s on the host's; "
         f"busy {c.busy_ns / 1e9:.6f} s; device events "
         f"{c.device_ns / 1e9:.6f} s, charged "
         f"{sum(c.device.values()) / 1e9:.6f} s; launches {c.launches}, "
         f"{c.lost} without a device event")
    _log("(b) device ms a step: " + ", ".join(
        f"{k} {v / 1e6 / n:.6f}"
        for k, v in sorted(c.device.items(), key=lambda kv: -kv[1])))
    _log(f"(b) idle ms a step ({(c.window_ns - c.busy_ns) / 1e6 / n:.6f} "
         f"in all): " + ", ".join(
             f"{k} {v / 1e6 / n:.6f}"
             for k, v in sorted(c.idle.items(), key=lambda kv: -kv[1])))
