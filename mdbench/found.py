"""Files found by name: a configuration's reference (`reference/<name>.py`),
a scene builder (`scenes/<name>.py`), a program path (`paths/<name>.py`), a
per-layer metric's reader (`metrics/<name>.py`) and the data files of
configurations and cells (`configs/<name>.json`, `workloads/<name>.json`).
Later cells and metrics add files; nothing here lists them. Python files
found so import the rest of the benchmark absolutely (`mdbench.<module>`).
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
