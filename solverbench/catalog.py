"""Finding the parts of a cell by name.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; it names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``).  A configuration names its matrix generator
(``problems/<name>.py``) and the entry into the program that it runs
(``entries/<name>.py``).  Every metric, end-to-end or per layer, is read
by ``metrics/<name>.py``.  A later cell, configuration, mix or metric is
new files plus entries in ``BENCHMARK.json``: nothing here changes."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import List, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: List[dict]         # BENCHMARK.json's entries, in its order


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str, traced: bool, here: str = HERE) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration, its mix and
    the metrics a run of it reads: the end-to-end ones untraced, the
    per-layer ones traced.  A metric whose reader finds nothing to read
    in a cell is left out of that cell's line."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    cfgs = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not cfgs:
        raise KeyError(f"no config named {w['config']!r} in BENCHMARK.json")
    config = load_json(os.path.join(os.path.dirname(here), cfgs[0]["file"]))
    traffic = load_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    kind = "per_layer" if traced else "end_to_end"
    return Cell(name, int(w["chips"]), config, traffic,
                list(bench[kind]))


def module(kind: str, name: str, here: str = HERE):
    """``<here>/<kind>/<name>.py`` as a module, loaded from its file (a
    name may hold dots and dashes); it imports what it needs by absolute
    names."""
    path = os.path.join(here, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"solverbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
