"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output (one JSON object); the numbers the check compared,
each beside its limit, are the last lines of standard error.

    python -m mdbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for: without CUDA, or with fewer cards, it exits 2 and prints no result.
It also exits non-zero, without a result, when the program cannot be
imported (a directory holding only the benchmark) and when jax, jaxlib,
flax or meng_zhang_tpu is loaded in this process once the window closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_IMPORT = time.monotonic()


def process_start():
    """The monotonic time this process started (from /proc), or when this
    module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def main(argv=None):
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="mdbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()

    import torch
    from mdbench import harness
    cell = next((c for c in harness.manifest(root)["workloads"]
                 if c["name"] == args.workload), None)
    if cell is None:
        harness.log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        harness.log(f"needs {cell['chips']} CUDA device(s): "
                    f"available={torch.cuda.is_available()} "
                    f"count={torch.cuda.device_count()}")
        return 2
    dev = torch.device("cuda", 0)
    out, lines = harness.run(root, args.workload, args.seed, args.seconds,
                             bool(args.trace), dev, t_start)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for line in lines:
        harness.log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
