"""One run of one cell: set-up, the measured window, the traced stretches,
then the check of what the window produced.

Set-up (setup_s, from the process's start to the window's first step):
imports, the card, the program's kernels (built once a checkout, under
meng_zhang_tpu_torch/_build/), the potential, the scene (relaxed positions
are data of the benchmark: `relaxed.py`), init_state and the warm-up
blocks, which run every shape the window uses. The window runs whole thermo blocks,
`Simulator.run(state, 1)` each, until `seconds` have passed; rebuilds and
short-list refreshes fall inside it. With trace, two stretches follow it:
`span_blocks` blocks under the harness's synchronised spans, and
`profile_blocks` blocks under torch.profiler.

What belongs to a model comes through hooks found by name, with no
branch here: the program side from the cell's path (`program.py`:
`paths/<name>.py` `build`; the short list's ids, build positions and
overflow through its `short_list`), the reference from the
configuration's reference module (`check.reference`: its own `Model`,
`evaluate` and `forces_on`, or by default the ANNP's in
`reference/model.py`), its census legs and work (`CENSUS_LEGS`, `work`),
and each per-layer metric's reader (`metrics/<name>.py`).
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

from mdbench import check, counts, found, potentials, relaxed
from mdbench.reference.integrate import BOLTZ, MVV2E

FORBIDDEN = ("jax", "jaxlib", "flax", "meng_zhang_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that no run may load, compared
    whole (meng_zhang_tpu_torch is not meng_zhang_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def manifest(root):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def velocities(n, mass, t, seed, dev):
    """Maxwell-Boltzmann velocities at exactly t K, drift removed, drawn
    on the device from seed (float32, A/ps)."""
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    v = torch.randn((n, 3), generator=g, dtype=torch.float64, device=dev)
    v = v * math.sqrt(BOLTZ * t / (mass * MVV2E))
    v = v - v.mean(0)
    t_now = mass * MVV2E * float((v * v).sum()) / ((3 * n - 3) * BOLTZ)
    return (v * math.sqrt(t / t_now)).float()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Recorder:
    """On the Simulator instance: the box each skin list and short list was
    built in, and the input states of the last two steps."""

    def __init__(self, sim):
        self.nbrs_box = self.short_box = None
        self.inputs = [None, None]
        build, short, step = sim.build_nbrs, sim.short_build, sim.step

        def build_nbrs(x, box):
            self.nbrs_box = box
            return build(x, box)

        def short_build(x, box, nbrs):
            self.short_box = box
            return short(x, box, nbrs)

        def rec_step(s, light=False):
            self.inputs = [self.inputs[1], s]
            return step(s, light)

        sim.build_nbrs, sim.short_build, sim.step = build_nbrs, short_build, \
            rec_step


def _state_dict(s, lists=None):
    """A state's tensors the check reads, and `lists` (the skin list's and
    the short list's ids, build positions and boxes) where given."""
    d = {"x": s.x, "v": s.v, "f": s.f, "box": s.box, "pe": s.pe,
         "virial": s.virial, "nhc": (s.nhc.xi, s.nhc.v_xi),
         "v_eps": s.v_eps, "baro": (s.baro_nhc.xi, s.baro_nhc.v_xi)}
    d.update(lists or {})
    return d


class Context:
    """A run: what a per-layer metric's reader (`metrics/<name>.py`,
    `read(ctx)`) may read: the window (steps, wall, rebuilds), the spans,
    the profiled stretch (trace), the census of the end positions and the
    configuration's work per evaluation."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def roofline(self, kernel, pattern):
        """The kernel's share of its roofline over the profiled stretch, in
        %, or None when the stretch holds no launch of it."""
        if self.trace is None or kernel not in self.work:
            return None
        secs, launches = self.trace.kernel(pattern)
        if not launches or secs <= 0.0:
            return None
        flops, nbytes = self.work[kernel]
        return counts.roofline_share(flops * launches, nbytes * launches,
                                     secs)


def run(root, name, seed, seconds, trace, dev, t_start):
    """The cell's result record (the JSON line) and the check lines."""
    return report(simulate(root, name, seed, seconds, trace, dev, t_start))


def simulate(root, name, seed, seconds, trace, dev, t_start):
    """Set-up, the window and the traced stretches: a Context holding what
    they measured and what the program produced (`cap`)."""
    man = manifest(root)
    cell = next(c for c in man["workloads"] if c["name"] == name)
    wl = found.data("workloads", name)
    if (wl["config"], wl["traffic"]) != (cell["config"], cell["traffic"]):
        raise ValueError(f"workloads/{name}.json names another config or "
                         "traffic than BENCHMARK.json")
    cfg = found.data("configs", cell["config"])
    from mdbench.program import Program

    md = wl["md"]
    marks = [("start", t_start), ("imports", time.monotonic())]
    canon = potentials.canonical(cfg, dev)
    pot = potentials.permuted(canon, seed)
    marks.append(("potential", time.monotonic()))
    x_np, box_np = found.load("scenes", wl["scene"]["builder"]).build(
        wl["scene"], cfg, dev)
    x_np = relaxed.apply(wl["scene"], x_np, box_np, canon)
    marks.append(("scene", time.monotonic()))
    n = len(x_np)
    x = torch.as_tensor(x_np, dtype=torch.float32, device=dev)
    box = torch.as_tensor(box_np, dtype=torch.float32, device=dev)
    prog = Program(pot, wl, n, box_np, dev)
    sim = prog.sim
    rec = Recorder(sim)
    v = velocities(n, float(pot["mass"]), md["t_init"], seed, dev)
    st = sim.init_state(x, box, v=v, seed=int(seed) % (1 << 63))
    _sync(dev)
    marks.append(("init_state", time.monotonic()))
    warm = wl["warmup"]
    for _ in range(warm["blocks"]):
        st, _ = sim.run(st, 1)
    if warm.get("rebuild"):
        st = sim.rebuild(st)
    st = st._replace(unsafe=torch.zeros_like(st.unsafe))
    _sync(dev)

    # ---- the measured window ----
    t0 = time.monotonic()
    setup_s = t0 - t_start
    marks.append(("warm-up", t0))
    log("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                               for a, b in zip(marks, marks[1:])))
    blocks = rebuilds = 0
    while True:
        st, _ = sim.run(st, 1)
        blocks += 1
        rebuilds += sim.rebuild_count
        if time.monotonic() - t0 >= seconds:
            break
    _sync(dev)
    wall = time.monotonic() - t0
    steps = blocks * md["thermo_every"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window: {steps} steps in {wall:.3f} s, {rebuilds} rebuilds, "
        f"set-up {setup_s:.3f} s, peak {peak / 2**30:.3f} GiB")

    spans = tr = None
    if trace:
        from mdbench import trace as tracing
        spans = tracing.Spans(sim, dev)
        span_steps = 0
        for _ in range(wl["trace"]["span_blocks"]):
            st, _ = sim.run(st, 1)
            span_steps += md["thermo_every"]
        spans.close()
        spans.steps = span_steps

        def stretch():
            s = st
            for _ in range(wl["trace"]["profile_blocks"]):
                s, _ = sim.run(s, 1)
            return s
        st, tr = tracing.profile(stretch, dev)
        log(f"profiled: {tr.busy_s:.6f} s busy in {tr.window_s:.6f} s")

    # ---- what the timed path produced ----
    th = sim.thermo(st)
    short_idx, short_x, short_overflow = prog.side.short_list(st.short)
    s0 = _state_dict(rec.inputs[1])
    s1 = _state_dict(st, dict(
        nbrs_idx=st.nbrs.idx, nbrs_x=st.nbrs.ref_x, nbrs_box=rec.nbrs_box,
        short_idx=short_idx, short_x=short_x, short_box=rec.short_box))
    nonfinite = not all(bool(torch.isfinite(t).all()) for t in
                        (st.x, st.v, st.f, st.pe, st.virial))
    flags = {"overflow": bool(st.overflow), "unsafe": bool(st.unsafe),
             "short_overflow": bool(short_overflow),
             "nonfinite": nonfinite}
    cap = check.Capture(s0, s1, float(th.press), flags)
    del st, sim, prog, rec, th
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Context(man=man, name=name, wl=wl, pot=pot, n=n, seed=seed,
                   dev=dev, steps=steps, wall=wall, rebuilds=rebuilds,
                   setup_s=setup_s, peak=peak, spans=spans, trace=tr,
                   cap=cap, traced=trace)


def report(r):
    """The result record of a simulated run and the check lines."""
    man, name, wl, pot, n, dev = r.man, r.name, r.wl, r.pot, r.n, r.dev
    steps, wall, peak, trace, tr, cap = (r.steps, r.wall, r.peak, r.traced,
                                         r.trace, r.cap)
    flags = cap.flags
    values = check.numbers(cap, pot, wl, r.seed, dev)
    correct, table, failed = check.verdict(values, wl["limits"])
    for k, val in flags.items():
        if val:
            log(f"flag: {k}")

    metrics = {}
    e2e = {"atom_steps_per_s": (n * steps / wall, "atom-steps/s"),
           "peak_mem_gib": (peak / 2**30, "GiB"),
           "setup_s": (r.setup_s, "s")}

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    out = {"correct": correct, "attempted": len(table), "failed": len(failed)}
    if not trace:
        for m in man["end_to_end"]:
            if applies(m) and m["name"] in e2e:
                val, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": val, "unit": unit}
    else:
        refmod = found.load("reference", pot["reference"])
        cen = counts.census(cap.s1["x"], cap.s1["box"],
                            tuple(wl["scene"]["pbc"]), float(pot["cutoff"]),
                            legs=getattr(refmod, "CENSUS_LEGS", False))
        work = refmod.work(pot, cen)
        r.census, r.work = cen, work
        for m in man["per_layer"]:
            if not applies(m):
                continue
            val = found.load("metrics", m["name"]).read(r)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = device_record(dev, peak)
    if trace:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = table
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in table.items()]
    lines.append(f"check state_off worst gap over its tolerance: "
                 f"{values['_state_worst']!r}")
    return out, lines


def device_record(dev, peak):
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}
