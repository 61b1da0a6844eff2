"""The traced run's readings: the harness's own spans around the calls it
makes into the program's layers, and torch.profiler over a stretch of
whole blocks."""
from __future__ import annotations

import re
import time
from collections import defaultdict

import torch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Spans:
    """Wraps, on the Simulator instance, the force callables it was handed
    (evaluators), and `rebuild` and `short_build` (neighbor lists), each
    synchronised on both sides; a short-list refresh inside a rebuild
    counts once, in the rebuild's span."""

    def __init__(self, sim, dev):
        self.sim, self.dev = sim, dev
        self.seconds = defaultdict(float)
        self.depth = 0
        self.saved = {k: sim.__dict__[k] for k in
                      ("force_fn", "force_fn_light", "short_build",
                       "rebuild") if k in sim.__dict__}
        for key, layer in (("force_fn", "evaluate"),
                           ("force_fn_light", "evaluate"),
                           ("short_build", "neighbor"),
                           ("rebuild", "neighbor")):
            fn = getattr(sim, key)
            if fn is not None:
                setattr(sim, key, self._wrap(fn, layer))

    def _wrap(self, fn, layer):
        def span(*args, **kw):
            if self.depth:
                return fn(*args, **kw)
            _sync(self.dev)
            t0 = time.perf_counter()
            self.depth += 1
            try:
                out = fn(*args, **kw)
                _sync(self.dev)
            finally:
                self.depth -= 1
            self.seconds[layer] += time.perf_counter() - t0
            return out
        return span

    def close(self):
        self.sim.__dict__.pop("rebuild", None)
        self.sim.__dict__.update(self.saved)


def profile(run_blocks, dev):
    """torch.profiler (host and device) around run_blocks(); returns
    (its result, Trace)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = run_blocks()
        _sync(dev)
        wall = time.perf_counter() - t0
    return out, Trace(prof.events(), wall)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """Device activity of a profiled stretch: busy seconds (the union of
    the device's operations), the stretch's wall seconds, device time by
    kernel name, and the longest idle gaps by the host operation under
    way."""

    def __init__(self, events, wall):
        from torch.autograd import DeviceType
        self.window_s = wall
        self.kernels = []          # (name, start us, end us)
        host = []
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                self.kernels.append((e.name, tr.start, tr.end))
            elif e.device_type == DeviceType.CPU:
                host.append((e.name, tr.start, tr.end))
        merged = _union([(a, b) for _, a, b in self.kernels])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self.gaps = []             # (seconds, what the host was doing)
        if merged and host:
            lo = min(h[1] for h in host)
            hi = max(h[2] for h in host)
            edges = [(lo, merged[0][0])] + [
                (merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)] + [(merged[-1][1], hi)]
            edges = sorted((e for e in edges if e[1] > e[0]),
                           key=lambda e: e[0] - e[1])[:10]
            for a, b in edges:
                mid = 0.5 * (a + b)
                under = [h for h in host if h[1] <= mid <= h[2]]
                name = min(under, key=lambda h: h[2] - h[1])[0] if under \
                    else "(no host operation)"
                self.gaps.append(((b - a) / 1e6, name))

    def device_ops(self, top=10):
        by = defaultdict(float)
        for name, a, b in self.kernels:
            by[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self):
        """The ten longest gaps, each named by the innermost host operation
        under way at its middle."""
        return [[name, sec] for sec, name in self.gaps]

    def kernel(self, pattern):
        """(device seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [b - a for name, a, b in self.kernels if rx.search(name)]
        return sum(hits) / 1e6, len(hits)
