"""Off-by-default profiling layer.

Counterpart of meng_zhang_tpu/profiling.py: `enable`, `phase`, `report`
and `reset`, a zero-cost-when-off wall-time phase timer (the reference
accumulates UCL_Timers per phase), and `torch_trace`, a torch.profiler
trace where the JAX package has `jax_trace`.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_ENABLED = False
_TOTALS: dict = defaultdict(float)
_COUNTS: dict = defaultdict(int)


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def phase(name: str):
    """Wall-time a named phase. When enabled, a process that has used the
    card waits for its queued work (torch.cuda.synchronize) before the
    clock stops, so device work is attributed to its phase."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _TOTALS[name] += dt
        _COUNTS[name] += 1


def report() -> str:
    """Per-phase table like the GPU package's end-of-run device-time summary
    (device->output_times, fe/lib/lal_base_annp.cpp:118-119)."""
    lines = ["%-24s %10s %8s %12s" % ("phase", "total[s]", "calls", "avg[ms]")]
    for name in sorted(_TOTALS, key=_TOTALS.get, reverse=True):
        t, c = _TOTALS[name], _COUNTS[name]
        lines.append("%-24s %10.3f %8d %12.3f" % (name, t, c, t / c * 1e3))
    return "\n".join(lines)


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def torch_trace(path: str):
    """Trace the enclosed work with torch.profiler (host and, on a CUDA
    build, device activity) and write a Chrome trace to `path`, viewable
    in Perfetto."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
