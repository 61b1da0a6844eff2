"""Off-by-default tracing layer: named spans and counters inside the step.

Counterpart of meng_zhang_tpu/profiling.py (`enable`, `report`, `reset`,
and `torch_trace` where the JAX package has `jax_trace`).

`span(name)` marks a layer boundary. Off (the default), it returns one
shared no-op context: nothing is allocated, recorded or read from the
device. On, it opens `torch.profiler.record_function(name)`, so under
torch.profiler the span is a host event on the clock the device events
use and the parent of every op and launch made inside it; it also adds
its host-clock seconds and a call to in-memory totals. No span
synchronises: a span's host time ends when its work is queued, unless the
work ends in a host read (`md.stale_read` is exactly such a read).

`count(name, n)` adds to a counter when on: a host integer on the host, a
device tensor summed on the device and read only by `counts()`.

The spans and counters of the MD step (names are read by the benchmark,
mdbench/stages.py):

  md.step, md.integrate (twice a step), md.thermo, md.stale_read
                               md/simulation.py
  nbr.check, nbr.build, nbr.short
                               md/simulation.py
  eval                         Simulator._eval_force
  eval.gather, eval.delivery, eval.virial
                               ops/fused_annp.evaluate_pairs
  eval.descriptors, eval.network, eval.forces
                               FusedAnnp._eval_fj, FusedNi._eval_fj
  counters: md.steps, nbr.builds (md/simulation.py); nbr.shorts,
  nbr.short_lanes (partners within the short list's radius), nbr.short_slots
  (rows x Ks) (ops/kernels.compact_short on the card,
  ops/fused_annp.compact_short_plain)
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_ENABLED = False
_SECONDS: dict = defaultdict(float)
_CALLS: dict = defaultdict(int)
_HOST_COUNTS: dict = defaultdict(int)
_DEVICE_COUNTS: dict = {}
_OFF = contextlib.nullcontext()      # the one context `span` returns off


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        _SECONDS[self.name] += dt
        _CALLS[self.name] += 1
        return False


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def span(name: str):
    """A context that marks the named span when tracing is on (see the
    module's docstring); the shared no-op context when off."""
    if not _ENABLED:
        return _OFF
    return _Span(name)


def count(name: str, n) -> None:
    """Add n to the counter `name` when tracing is on: a Python int on the
    host, a tensor summed on its device (no read back)."""
    if not _ENABLED:
        return
    if isinstance(n, torch.Tensor):
        s = n.sum()
        prev = _DEVICE_COUNTS.get(name)
        _DEVICE_COUNTS[name] = s if prev is None else prev + s
    else:
        _HOST_COUNTS[name] += n


def totals() -> dict:
    """{span name: (host seconds, calls)} since the last reset."""
    return {k: (_SECONDS[k], _CALLS[k]) for k in _CALLS}


def counts() -> dict:
    """{counter name: int} since the last reset; reads the device
    counters back (one synchronisation)."""
    out = dict(_HOST_COUNTS)
    for k, v in _DEVICE_COUNTS.items():
        out[k] = out.get(k, 0) + int(v)
    return out


def report() -> str:
    """The span table (host seconds, calls, ms a call; like the GPU
    package's end-of-run device-time summary, device->output_times,
    fe/lib/lal_base_annp.cpp:118-119), then the counters."""
    lines = ["%-24s %10s %8s %12s" % ("span", "total[s]", "calls", "avg[ms]")]
    for name in sorted(_CALLS, key=_SECONDS.get, reverse=True):
        t, c = _SECONDS[name], _CALLS[name]
        lines.append("%-24s %10.3f %8d %12.3f" % (name, t, c, t / c * 1e3))
    cts = counts()
    if cts:
        lines.append("%-24s %10s" % ("counter", "count"))
        for name in sorted(cts):
            lines.append("%-24s %10d" % (name, cts[name]))
    return "\n".join(lines)


def reset() -> None:
    _SECONDS.clear()
    _CALLS.clear()
    _HOST_COUNTS.clear()
    _DEVICE_COUNTS.clear()


@contextlib.contextmanager
def torch_trace(path: str):
    """Trace the enclosed work with torch.profiler (host and, on a CUDA
    build, device activity) and write a Chrome trace to `path`, viewable
    in Perfetto; with tracing on, the spans lie over the kernels they
    launched."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
