"""Finding a cell's parts by name, and a cell, a configuration, a mix and
a metric added by new files and entries alone."""
import json
import os
import shutil
import time

import pytest

from conftest import ROOT
from solverbench import catalog, harness


def test_the_benchmarks_cells_find_their_parts():
    bench = catalog.benchmark(ROOT)
    for w in bench["workloads"]:
        cell = catalog.cell(bench, w["name"], False)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert [m["name"] for m in cell.metrics] == [
            m["name"] for m in bench["end_to_end"]]
        traced = catalog.cell(bench, w["name"], True)
        assert [m["name"] for m in traced.metrics] == [
            m["name"] for m in bench["per_layer"]]
        for m in bench["end_to_end"] + bench["per_layer"]:
            assert callable(catalog.module("metrics", m["name"]).read)
        catalog.module("problems", cell.config["problem"]["generator"])
        catalog.module("entries", cell.config["solver"]["entry"])


def test_an_unknown_name_is_refused():
    bench = catalog.benchmark(ROOT)
    with pytest.raises(KeyError):
        catalog.cell(bench, "no-such.cell", False)
    with pytest.raises(KeyError):
        catalog.module("metrics", "no_such_metric")


def test_a_cell_added_by_data_alone_runs(tmp_path):
    """A copy of the benchmark with a new configuration, a new mix and a
    new per-layer metric, added as files and entries: the harness runs
    the new cell and reports the new metric, with no code edited."""
    here = tmp_path / "solverbench"
    shutil.copytree(catalog.HERE, here, ignore=shutil.ignore_patterns(
        ".cache", "tests", "__pycache__"))
    bench = catalog.benchmark(ROOT)
    cfg = catalog.load_json(os.path.join(
        ROOT, "solverbench/configs/poisson2d-1023-sa.json"))
    cfg.update(name="poisson2d-47-sa", problem={
        "generator": "poisson_2d", "params": {"nx": 47}})
    (here / "configs" / "poisson2d-47-sa.json").write_text(json.dumps(cfg))
    mix = catalog.load_json(os.path.join(
        ROOT, "solverbench/traffic/host-rhs.json"))
    mix.update(name="few-rhs", rhs=dict(mix["rhs"], pool=3, perturb=1e-3),
               trace_seconds=0.2)
    (here / "traffic" / "few-rhs.json").write_text(json.dumps(mix))
    (here / "metrics" / "window_solves.py").write_text(
        "def read(run):\n    return len(run.latencies)\n")
    bench["configs"].append({"name": "poisson2d-47-sa", "source": "test",
                             "file": "solverbench/configs/poisson2d-47-sa.json",
                             "reduced": ["nx"], "why": "test"})
    bench["workloads"].append({"name": "poisson2d-47-sa.few-rhs",
                               "config": "poisson2d-47-sa",
                               "traffic": "few-rhs", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "window_solves", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "solves_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = catalog.cell(catalog.benchmark(str(tmp_path)),
                        "poisson2d-47-sa.few-rhs", True, str(here))
    out = harness.run_cell(cell, 11, 0.3, True, "cpu", time.perf_counter(),
                           here=str(here), cache=str(tmp_path / "cache"))
    assert out["correct"] is True
    assert out["metrics"]["window_solves"]["value"] == out["attempted"]
