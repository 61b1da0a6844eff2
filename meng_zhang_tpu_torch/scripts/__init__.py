"""The port's counterparts of the JAX package's run scripts (`scripts/`):
`scale_demo` (BASELINE.json configs 3 and 5), `disloc_core` (config 4),
`model_bench` (the ni and ANNA-ADP scenes), the per-phase profiles
`profile_bench`, `profile_ni` and `profile_2m`, the sharded demos
`sharded_demo` and `sharded2d_demo`, and `halo_fraction` (the sharded
drivers' ghost rows, planning only); beside them `bench` (bench.py's
headline run). Each runs with
`python -m meng_zhang_tpu_torch.scripts.<name>` on the card, and exposes
`main(argv, device=None)`, which the CPU reaches with `device="cpu"`; each
prints one JSON record on stdout and writes a file only at `--out`."""
from __future__ import annotations

import json
import subprocess
import time

import torch

from ..run import log


def device_label(dev):
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (its name alone if
    nvidia-smi cannot be run), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={index}"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(dev)
    line = smi.stdout.strip()
    return line if smi.returncode == 0 and line else \
        torch.cuda.get_device_name(dev)


def peak_mem_gib(dev):
    """torch.cuda.max_memory_allocated in GiB since the last reset, or None
    off the card."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def time_call(fn, dev, reps, warmup=1):
    """(seconds a call of fn(), its last output): the mean over `reps`
    calls after `warmup` untimed ones, between two CUDA events on the card
    (the card's time), by the host clock on the CPU. Each call's output is
    dropped before the next call starts, so that a phase's peak memory is
    its own."""
    out = None
    for _ in range(warmup):
        out = None
        out = fn()
    if dev.type == "cuda":
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            out = None
            out = fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3 / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = None
        out = fn()
    return (time.perf_counter() - t0) / reps, out


def emit(rec, out=None):
    """Print the record as one JSON line on stdout; with `out`, also write
    it (indented) to that file."""
    if out:
        with open(out, "w") as fh:
            json.dump(rec, fh, indent=1)
        log(f"wrote {out}")
    print(json.dumps(rec), flush=True)
