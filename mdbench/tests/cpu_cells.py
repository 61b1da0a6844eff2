"""Helpers of the benchmark's tests: a copy of the benchmark whose cells
run small scenes on the CPU (the program's plain versions of its kernels),
and a driver that runs one of them in a subprocess from that copy, with
the program's timed path optionally broken underneath."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# each cell's scene cut to a few hundred atoms, the same settings else
SMALL = {
    "fe-annp.bulk-npt-500k": {
        "scene": {"builder": "lattice", "lattice": "bcc", "cells": 6,
                  "pbc": [True, True, True]},
        "warmup": {"blocks": 1, "rebuild": True},
        "check": {"atoms": 64, "list_rows": 128}},
    "ni-bp.fcc-nvt-1200k": {
        "scene": {"builder": "lattice", "lattice": "fcc", "cells": 6,
                  "pbc": [True, True, True]},
        "warmup": {"blocks": 2, "rebuild": False},
        "check": {"atoms": 64, "list_rows": 128}},
}

DRIVER = r"""
import json, os, sys, time
import torch
torch.set_num_threads(2)
sys.path.insert(0, os.getcwd())
from mdbench import check, harness
a = json.loads(sys.argv[1])
fault = a.get("fault")
if fault == "frozen_step":
    from meng_zhang_tpu_torch.md import simulation
    simulation.Simulator.step = lambda self, s, light=False: s
elif fault == "half_batch":
    from meng_zhang_tpu_torch.ops import fused_annp
    whole = fused_annp.evaluate_pairs
    def half(eval_fj, *args, **kw):
        def ev(dxx, dxy, dxz, el):
            eat, fj = eval_fj(dxx, dxy, dxz, el)
            keep = torch.zeros_like(eat)
            keep[:eat.shape[0] // 2] = 2.0
            return eat * keep, tuple(f * keep[:, None] for f in fj)
        return whole(ev, *args, **kw)
    fused_annp.evaluate_pairs = half
elif fault == "altered_answer":
    from meng_zhang_tpu_torch.ops import fused_annp
    deliver = fused_annp.deliver
    def altered(fj, sidx, n, x_ext=None):
        forces, target = deliver(fj, sidx, n, x_ext)
        forces = forces.clone()
        forces[a["atom"]] += 0.01 * forces.abs().max()
        return forces, target
    fused_annp.deliver = altered
dev = torch.device("cpu")
t0 = time.monotonic()
if a.get("control"):
    r = harness.simulate(os.getcwd(), a["cell"], a["seed"], a["seconds"],
                         False, dev, t0)
    ref = check.reference(r.pot).Model(r.pot, dev)
    out = {k: check.numbers(r.cap, r.pot, r.wl, a["seed"], dev,
                            control=c, ref=ref)
           for k, c in (("program", False), ("control", True))}
    out["limits"] = r.wl["limits"]
else:
    out = harness.run(os.getcwd(), a["cell"], a["seed"], a["seconds"],
                      bool(a.get("trace")), dev, t0)[0]
    out["forbidden"] = harness.forbidden_modules()
print(json.dumps(out))
"""


def small_copy(dst):
    """The benchmark under dst with SMALL's scenes; the program linked."""
    shutil.copytree(os.path.join(REPO, "mdbench"),
                    os.path.join(dst, "mdbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(REPO, "meng_zhang_tpu_torch"),
               os.path.join(dst, "meng_zhang_tpu_torch"))
    for cell, edits in SMALL.items():
        path = os.path.join(dst, "mdbench", "workloads", cell + ".json")
        with open(path) as fh:
            wl = json.load(fh)
        wl.update(edits)
        with open(path, "w") as fh:
            json.dump(wl, fh)
    return dst


def run_cpu(root, cell, seed, seconds=0.2, timeout=900, **kw):
    """The driver's JSON output for one run of `cell` from root."""
    arg = json.dumps(dict(cell=cell, seed=seed, seconds=seconds, **kw))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", DRIVER, arg], cwd=root,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])
