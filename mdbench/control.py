"""The readings that a cell's limits are set from: for each seed, one run of
the cell (a short window) and, at the state it produced, the numbers of
the program and of the control, the reference computed in TF32 in the
program's place (check.py). The benchmark's own runs do not run it.

    python -m mdbench.control --workload <cell> --seconds 2 \\
        --seeds 11 12 13 [--no-control] [--out chiprun_out/x.jsonl]

One JSON line a seed on standard output: {"seed", "program": {...},
"control": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from mdbench import check, harness


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mdbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    root = os.getcwd()
    for seed in args.seeds:
        t0 = time.monotonic()
        r = harness.simulate(root, args.workload, seed, args.seconds, False,
                             dev, t0)
        ref = check.reference(r.pot).Model(r.pot, dev)
        row = {"seed": seed, "steps": r.steps, "wall": r.wall,
               "setup_s": r.setup_s, "rebuilds": r.rebuilds,
               "program": check.numbers(r.cap, r.pot, r.wl, seed, dev,
                                        ref=ref)}
        t1 = time.monotonic()
        row["check_s"] = t1 - t0 - r.setup_s - r.wall
        if not args.no_control:
            row["control"] = check.numbers(r.cap, r.pot, r.wl, seed, dev,
                                           control=True, ref=ref)
            row["control_s"] = time.monotonic() - t1
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        del r, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
