"""A scene's relaxed positions, kept as data of the benchmark so that no
run relaxes and no change to the program changes a cell's input.

A cell whose scene names `relaxed` (a file under mdbench/) starts from the
scene's positions plus the displacements stored there: int16 in units of
UNIT A, beside a key that hashes the unrelaxed positions, the box and the
configuration's canonical potential, so that a file made for another
geometry or potential is refused rather than used. The file is made once,
on the card, by FIRE through the program (the cell's `relax` options):

    python -m mdbench.relaxed --workload <cell>
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np

UNIT = 1.0e-4                # A a step of the stored displacements
HERE = os.path.dirname(os.path.abspath(__file__))


def key(x, box, canon):
    """sha256 of the unrelaxed positions, the box and the potential, each
    rounded to float32, so that the last bits of a machine's arithmetic do
    not change it."""
    parts = [x, box] + list(canon["weights"]) + list(canon["biases"]) + \
        [canon["norm_row0"], canon["norm_row1"]]
    h = hashlib.sha256()
    for a in parts:
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.hexdigest()


def apply(spec, x, box, canon):
    """x moved by the displacements of spec["relaxed"] (x unchanged where
    the scene names none)."""
    if not spec.get("relaxed"):
        return x
    with np.load(os.path.join(HERE, spec["relaxed"])) as z:
        if str(z["key"]) != key(x, box, canon) or len(z["dx"]) != len(x):
            raise ValueError(f"{spec['relaxed']} was made for another scene "
                             "or potential: make it again "
                             "(python -m mdbench.relaxed)")
        return x + z["dx"].astype(np.float64) * UNIT


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mdbench.relaxed")
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    import torch

    from mdbench import found, potentials
    from mdbench.program import Program
    dev = torch.device("cuda", 0)
    wl = found.data("workloads", args.workload)
    cfg = found.data("configs", wl["config"])
    canon = potentials.canonical(cfg, dev)
    x, box = found.load("scenes", wl["scene"]["builder"]).build(
        wl["scene"], cfg, dev)
    t0 = time.monotonic()
    prog = Program(canon, wl, len(x), box, dev)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    bt = torch.as_tensor(box, dtype=torch.float32, device=dev)
    xr, iters = prog.relax(xt, bt, wl["relax"])
    dx = np.rint((xr.double().cpu().numpy() - x) / UNIT)
    if np.abs(dx).max() > np.iinfo(np.int16).max:
        raise ValueError("a displacement outgrows int16")
    path = os.path.join(HERE, wl["scene"]["relaxed"])
    np.savez_compressed(path, dx=dx.astype(np.int16),
                        key=np.array(key(x, box, canon)))
    print(f"{iters} FIRE iterations in {time.monotonic() - t0:.1f} s, "
          f"largest move {np.abs(dx).max() * UNIT:.4f} A, "
          f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, "
          f"wrote {path} ({os.path.getsize(path)} bytes)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
