"""BENCHMARK.json against the contract's forms, and the harness finding a
new configuration, cell and metric by their files alone."""
from __future__ import annotations

import json
import os
import re

import pytest

from cpu_cells import REPO, run_cpu, small_copy

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
