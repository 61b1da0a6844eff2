"""Files found by name: a configuration's reference (`reference/<name>.py`),
a scene builder (`scenes/<name>.py`), a program path (`paths/<name>.py`), a
per-layer metric's reader (`metrics/<name>.py`) and the data files of
configurations and cells (`configs/<name>.json`, `workloads/<name>.json`).
Python files found so import the rest of the benchmark absolutely
(`mdbench.<module>`).

A later configuration, cell or metric adds files and manifest entries,
and nothing here lists them:

  configs/<config>.json      its sizes; `reference` names its module
  workloads/<cell>.json      scene, `path`, md settings, check sizes and
                             limits
  reference/<name>.py        `make_potential(config, device)` (the
                             potential dict both sides are handed) and
                             `work(pot, census)` (FLOPs and bytes a
                             kernel, `CENSUS_LEGS` for leg pairs); for a
                             model of another shape than the ANNP, its own
                             `Model`, `evaluate` and `forces_on`
                             (check.reference), else the ANNP's judge it
                             (with its `descriptors`)
  paths/<name>.py            `build(pot, wl, device)`: the program side
                             (program.py: cutoff, energy_forces,
                             short_build, short_list)
  scenes/<name>.py           `build(spec, config, device)` -> (x, box)
  metrics/<metric>.py        `read(ctx)`, None where nothing is to read;
                             a span a path opens under `eval.`, `nbr.` or
                             `md.` is read through stages.per_step_ms
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def path(kind, name, ext):
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return os.path.join(HERE, kind, name + ext)


def load(kind, name):
    """The module of `<kind>/<name>.py`, loaded once a process."""
    key = "mdbench._found." + kind + "." + re.sub(r"[^A-Za-z0-9_]", "_",
                                                   name)
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key,
                                                      path(kind, name, ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def data(kind, name):
    """The JSON object of `<kind>/<name>.json`."""
    with open(path(kind, name, ".json")) as fh:
        return json.load(fh)
