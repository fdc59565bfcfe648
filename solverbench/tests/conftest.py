"""The benchmark's own tests: ``python -m pytest solverbench/tests`` from
the root of the repository.  Tests marked ``cuda`` need the card and
decide inside the test (the ``cuda_device`` fixture) whether one is
there."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"poisson2d-1023-sa": {"nx": 31}, "fe-p1-1024-rs": {"n": 32}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips on machines without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def tiny_cell(name: str, traced: bool = False, seconds_traced: float = 0.3):
    """A cell of BENCHMARK.json with its matrix cut to a CPU test's size
    and a short traced stretch."""
    from solverbench import catalog
    cell = catalog.cell(catalog.benchmark(ROOT), name, traced)
    cfg = copy.deepcopy(cell.config)
    cfg["problem"]["params"] = TINY[cfg["name"]]
    mix = dict(cell.traffic, trace_seconds=seconds_traced)
    return cell._replace(config=cfg, traffic=mix)
