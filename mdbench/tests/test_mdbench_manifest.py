"""BENCHMARK.json against the contract's forms, and the harness finding a
new configuration, cell and metric by their files alone: one more of the
ANNP's, and a model family of another shape (a Morse pair potential with
its own reference, program path, short list and span)."""
from __future__ import annotations

import hashlib
import json
import os
import re

import pytest

from cpu_cells import REPO, run_cpu, small_copy
from mdbench import check, found
from mdbench.reference import model

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_and_forms(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["mdbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/")
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("mdbench/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert w["config"] in {c["name"] for c in bench["configs"]}
        path = os.path.join(REPO, "mdbench", "workloads",
                            w["name"] + ".json")
        with open(path) as fh:
            wl = json.load(fh)
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(REPO, "mdbench", "metrics",
                                           m["name"] + ".py"))


def test_a_new_cell_and_metric_are_found(tmp_path):
    """A throwaway configuration, cell and per-layer metric, added as files
    and manifest entries only, run and report with no edit of the
    harness."""
    root = small_copy(str(tmp_path))
    md = os.path.join(root, "mdbench")
    with open(os.path.join(md, "configs", "fe-annp.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "fe-throwaway"
    with open(os.path.join(md, "configs", "fe-throwaway.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(md, "workloads",
                           "fe-annp.bulk-npt-500k.json")) as fh:
        wl = json.load(fh)
    wl.update(name="fe-throwaway.bulk", config="fe-throwaway",
              traffic="bulk")
    wl["scene"]["pbc"] = [True, True, True]
    wl["md"].update(ensemble="nve", virial="never")
    wl["limits"].pop("virial_gap")
    wl["trace"] = {"span_blocks": 1, "profile_blocks": 1}
    with open(os.path.join(md, "workloads", "fe-throwaway.bulk.json"),
              "w") as fh:
        json.dump(wl, fh)
    with open(os.path.join(md, "metrics", "throwaway.atoms.py"), "w") as fh:
        fh.write('"""atoms of the run."""\n\n\ndef read(ctx):\n'
                 '    return float(ctx.n)\n')
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "fe-throwaway", "source": "x",
                             "file": "mdbench/configs/fe-throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "fe-throwaway.bulk",
                               "config": "fe-throwaway", "traffic": "bulk",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.atoms", "unit": "atoms",
                               "better": "higher", "source": "host_clock",
                               "layer": "MD driver",
                               "moves": "atom_steps_per_s",
                               "workloads": ["fe-throwaway.bulk"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    out = run_cpu(root, "fe-throwaway.bulk", 5, trace=1)
    assert out["metrics"]["throwaway.atoms"]["value"] == 432.0
    assert "step_mfu" in out["metrics"]
    assert out["correct"] is True


MORSE_REFERENCE = '''"""A Morse pair potential with a model of its own:
phi(r) = D (e^(-2a(r - r0)) - 2 e^(-a(r - r0))), shifted to 0 at rc;
E = 1/2 sum over ordered pairs, F = -dE/dx."""
import math

import torch

from mdbench.reference import neighbors as nb


def make_potential(config, device):
    return {"reference": "morse_pair", "cutoff": float(config["cutoff_A"]),
            "mass": config["mass"], "D": config["D_eV"],
            "alpha": config["alpha_per_A"], "r0": config["r0_A"]}


def work(pot, census):
    return {"step": 30 * census["lanes"]}


def pair(pot, r):
    """(phi(r), dphi/dr / r)."""
    d, a, r0, rc = pot["D"], pot["alpha"], pot["r0"], pot["cutoff"]
    ec = math.exp(-a * (rc - r0))
    e1 = torch.exp(-a * (r - r0))
    return (d * (e1 * e1 - 2.0 * e1) - d * (ec * ec - 2.0 * ec),
            -2.0 * a * d * (e1 * e1 - e1) / r)


class Model:
    def __init__(self, pot, device, control=False):
        self.pot, self.cut = pot, float(pot["cutoff"])
        self.dtype = torch.float32 if control else torch.float64


def _rows(model, x, box, pbc, rows):
    x, box = x.to(model.dtype), box.to(model.dtype)
    _, dx, valid = nb.partners(nb.Grid(x, box, pbc, model.cut), rows)
    r = torch.sqrt(torch.where(valid, (dx * dx).sum(-1), 1.0))
    phi, g = pair(model.pot, r)
    return (torch.where(valid, phi, 0.0),
            torch.where(valid, g, 0.0)[..., None] * dx, dx)


def evaluate(model, x, box, pbc, grad=True):
    phi, g, dx = _rows(model, x, box, pbc,
                       torch.arange(x.shape[0], device=x.device))
    e = 0.5 * phi.double().sum()
    if not grad:
        return e, None, None
    return e, -g.sum(1), -0.5 * torch.einsum("rka,rkb->ab", dx, g)


def forces_on(model, x, box, pbc, atoms):
    _, g, _ = _rows(model, x, box, pbc, atoms)
    return -g.sum(1).double()
'''

MORSE_PATH = '''"""A Morse path in plain torch: a short list of its own, forces
gathered from both sides of each pair (no scatter), under a span of its
own (eval.pair); nothing of the reference."""
import math
from typing import NamedTuple

import torch

SCALE = {scale!r}


class Partners(NamedTuple):
    ids: torch.Tensor        # [N, Ks] ascending, sentinel N
    ref_x: torch.Tensor
    full: torch.Tensor       # a row had more than Ks partners


class Side:
    def __init__(self, pot, wl, device):
        self.pot, self.cutoff = pot, float(pot["cutoff"])
        self.rc_s = self.cutoff + wl["short_delta"]
        self.ks, self.pbc = wl["k_short"], tuple(wl["scene"]["pbc"])

    def _dx(self, x, box, ids):
        xp = torch.cat([x, x.new_zeros(1, 3)])
        dx = x[:, None, :] - xp[ids]
        per = torch.tensor(self.pbc, device=x.device)
        return (torch.where(per, dx - box * torch.round(dx / box), dx),
                ids < x.shape[0])

    def short_build(self, x, box, nbrs):
        dx, valid = self._dx(x, box, nbrs.idx)
        keep = valid & ((dx * dx).sum(-1) < self.rc_s ** 2)
        ids = torch.where(keep, nbrs.idx, x.shape[0]).sort(dim=1).values
        ids = torch.nn.functional.pad(ids, (0, max(self.ks - ids.shape[1], 0)),
                                      value=x.shape[0])[:, :self.ks]
        return Partners(ids, x, keep.sum(1).max() > self.ks)

    def energy_forces(self, x, box, nbrs, short, want_virial):
        from meng_zhang_tpu_torch import profiling
        d, a, r0 = self.pot["D"], self.pot["alpha"], self.pot["r0"]
        ec = math.exp(-a * (self.cutoff - r0))
        with profiling.span("eval.pair"):
            dx, valid = self._dx(x, box, short.ids)
            r2 = (dx * dx).sum(-1)
            m = valid & (r2 < self.cutoff ** 2)
            r = torch.sqrt(torch.where(m, r2, 1.0))
            e1 = torch.exp(-a * (r - r0))
            phi = d * (e1 * e1 - 2.0 * e1) - d * (ec * ec - 2.0 * ec)
            g = torch.where(m, -2.0 * a * d * (e1 * e1 - e1) / r,
                            0.0)[..., None] * dx
            e = 0.5 * torch.where(m, phi, 0.0).sum()
            w = -0.5 * torch.einsum("rka,rkb->ab", dx, g) if want_virial \\
                else None
            return e, -SCALE * g.sum(1), w

    @staticmethod
    def short_list(short):
        return short.ids, short.ref_x, short.full


def build(pot, wl, device):
    return Side(pot, wl, device)
'''

MORSE_METRIC = '''"""eval.pair_host_s: host seconds in the path's
eval.pair span over stages.py's stretch (a)."""
from mdbench import stages


def read(ctx):
    r = stages.readings(ctx)
    return None if r is None else r.host_s.get("eval.pair")
'''

MORSE_CONFIG = {"name": "morse-pair", "reference": "morse_pair",
                "element": "Cu", "mass": 63.546, "lattice_A": 3.61,
                "D_eV": 0.3429, "alpha_per_A": 1.3588, "r0_A": 2.866,
                "cutoff_A": 5.0}

MORSE_CELL = {
    "name": "morse-pair.fcc", "config": "morse-pair", "traffic": "fcc",
    "scene": {"builder": "lattice", "lattice": "fcc", "cells": 5,
              "pbc": [True, True, True]},
    "path": "morse_pair", "k_short": 96, "short_delta": 0.4,
    "md": {"dt": 0.002, "ensemble": "nve", "t_target": 300.0,
           "t_init": 300.0, "skin": 1.0, "capacity": 128,
           "cell_capacity": 64, "stale_factor": 0.6, "thermo_every": 10,
           "short_every": 10, "virial": "every"},
    "warmup": {"blocks": 1, "rebuild": True},
    "trace": {"span_blocks": 2, "profile_blocks": 1},
    "check": {"atoms": 64, "list_rows": 128},
    "limits": {"list_misses": 0, "force_gap": 1e-3, "energy_gap": 1e-5,
               "virial_gap": 0.01, "v_gap": 2e-4, "state_off": 0,
               "flags": 0}}


def add_pair_family(root, scale=1.0):
    """The Morse family as files and manifest entries only."""
    md = os.path.join(root, "mdbench")
    for rel, text in (("reference/morse_pair.py", MORSE_REFERENCE),
                      ("paths/morse_pair.py",
                       MORSE_PATH.replace("{scale!r}", repr(scale))),
                      ("metrics/eval.pair_host_s.py", MORSE_METRIC),
                      ("configs/morse-pair.json", json.dumps(MORSE_CONFIG)),
                      ("workloads/morse-pair.fcc.json",
                       json.dumps(MORSE_CELL))):
        assert not os.path.exists(os.path.join(md, rel))
        with open(os.path.join(md, rel), "w") as fh:
            fh.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "morse-pair", "source": "x",
                             "file": "mdbench/configs/morse-pair.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "morse-pair.fcc",
                               "config": "morse-pair", "traffic": "fcc",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "eval.pair_host_s", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "evaluators",
                               "moves": "atom_steps_per_s",
                               "workloads": ["morse-pair.fcc"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)


def digests(root):
    out = {}
    for top, dirs, files in os.walk(os.path.join(root, "mdbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            with open(os.path.join(top, f), "rb") as fh:
                out[os.path.join(top, f)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_model_family_is_found_by_its_files(tmp_path):
    """A pair potential with its own reference model, program path, short
    list (no `sidx`) and span, added as files and manifest entries only:
    its runs are correct, a metric reads its span, and no file that was
    there changed."""
    root = small_copy(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        before_bench = json.load(fh)
    before = digests(root)
    add_pair_family(root)
    traced = run_cpu(root, "morse-pair.fcc", 2**31 + 91, trace=1)
    plain = run_cpu(root, "morse-pair.fcc", 2**31 + 92)
    assert traced["correct"] is True, traced["checks"]
    assert plain["correct"] is True, plain["checks"]
    assert traced["metrics"]["eval.pair_host_s"]["value"] > 0.0
    assert plain["metrics"]["atom_steps_per_s"]["value"] > 0.0
    after = digests(root)
    assert {k: after[k] for k in before} == before
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for key, old in before_bench.items():
        new = bench[key]
        assert new[:len(old)] == old if isinstance(old, list) else new == old


def test_the_new_family_is_judged_by_its_own_reference(tmp_path):
    """The same family with its path's forces scaled by 1.01 fails
    force_gap: the check judges it by the module's reference."""
    root = small_copy(str(tmp_path))
    add_pair_family(root, scale=1.01)
    out = run_cpu(root, "morse-pair.fcc", 2**31 + 92)
    assert out["correct"] is False
    assert out["checks"]["force_gap"]["value"] > \
        out["checks"]["force_gap"]["limit"]


@pytest.mark.parametrize("config", ["fe-annp", "ni-bp"])
def test_annp_configs_are_judged_by_the_default_reference(config):
    """A reference module with no model of its own (chebyshev, behler)
    resolves to reference/model.py's Model, evaluate and forces_on (the
    one-shell sample expansion)."""
    name = found.data("configs", config)["reference"]
    assert not any(hasattr(found.load("reference", name), k)
                   for k in check.HOOKS)
    assert check.reference({"reference": name}) == \
        (model.Model, model.evaluate, model.forces_on)
