"""The harness's logic on the CPU at a test's size, through its functions
with the device given explicitly (the command refuses to run without a
card), and the faults the check has to catch."""
import time

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from solverbench import catalog, check, harness, reference, rhs

CELLS = ["poisson2d-1023-sa.host-rhs", "fe-p1-1024-rs.host-rhs"]
SEED = 2 ** 31 + 4099


def run(cell, tmp_path, traced=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.4, traced, "cpu",
                            time.perf_counter(), cache=str(tmp_path))


@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu_is_correct_and_reports_its_metrics(name, tmp_path):
    cell = tiny_cell(name)
    out = run(cell, tmp_path)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"solves_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"relres", "fine64", "fine32",
                                  "unconverged"}
    assert out["device"]["platform"] == "cpu"


def test_a_traced_run_reads_the_per_layer_metrics_it_can(tmp_path):
    out = run(tiny_cell(CELLS[0], traced=True), tmp_path, traced=True)
    assert out["correct"] is True
    m = out["metrics"]
    assert m["refine_rounds_per_solve"]["unit"] == "rounds"
    assert m["solve_ms_p90"]["value"] > 0
    assert m["inner_iters_per_solve"]["value"] > 0
    # nothing of the device is read on the CPU: no graphs, no card
    for name in ("graph_nodes_per_solve", "fine_spmv_roofline_share",
                 "device_idle_share"):
        assert name not in m


def test_the_same_seed_gives_the_same_right_hand_sides(tmp_path):
    cell = tiny_cell(CELLS[1])
    prob = harness.problem(cell.config, cache=str(tmp_path))
    a = rhs.pool(prob, cell.traffic, SEED, "cpu")
    b = rhs.pool(prob, cell.traffic, SEED, "cpu")
    c = rhs.pool(prob, cell.traffic, SEED + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert len(a) == cell.traffic["rhs"]["pool"]
    # each b is the source's own b, perturbed by its share of b's rms
    rms = np.sqrt(np.mean(prob.rhs ** 2))
    dev = np.sqrt(np.mean((a[0] - prob.rhs) ** 2)) / rms
    assert 0.5 < dev / cell.traffic["rhs"]["perturb"] < 1.5


def test_the_problem_cache_returns_the_generated_arrays(tmp_path):
    cell = tiny_cell(CELLS[0])
    first = harness.problem(cell.config, cache=str(tmp_path))
    again = harness.problem(cell.config, cache=str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 1
    for k in ("indptr", "indices", "data", "coords", "rhs"):
        assert np.array_equal(getattr(first, k), getattr(again, k))


def test_the_sample_is_seeded_and_uniform_in_size():
    a, b = check.Sample(4, 7), check.Sample(4, 7)
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.kept == b.kept and len(a.kept) == 4 and a.seen == 100


def broken(monkeypatch, fault):
    """Make the entry's System break the timed path underneath."""
    real = catalog.module

    def module(kind, name, here=catalog.HERE):
        mod = real(kind, name, here)
        if kind != "entries":
            return mod

        class Broken(mod.System):
            def solve(self, b):
                ans = super().solve(b)
                return ans._replace(x=fault(ans.x))

        class Wrapper:
            Answer = mod.Answer

            @staticmethod
            def setup(problem, spec, device):
                s = Broken(problem, spec, device)
                return s
        return Wrapper
    monkeypatch.setattr(catalog, "module", module)


def _unchanged(x):
    return np.zeros_like(x)         # the solve's state as it started


def _half(x):
    y = x.copy()
    y[len(y) // 2:] = 0.0           # half of the unknowns left out
    return y


def _altered(x):
    y = x.copy()
    k = int(np.argmax(np.abs(y)))
    y[k] *= 1.1                     # one answer altered where produced
    return y


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_a_broken_solve_is_not_correct(name, fault, tmp_path, monkeypatch):
    broken(monkeypatch, fault)
    out = run(tiny_cell(name), tmp_path)
    assert out["correct"] is False
    assert out["checks"]["relres"]["value"] > out["checks"]["relres"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_fine_operators_one_precision_lower_are_not_correct(name, tmp_path):
    """The control at a test's size: the reference's own products, one
    precision below, put in place of each fine operator."""
    cell = tiny_cell(name)
    prob = harness.problem(cell.config, cache=str(tmp_path))
    A = reference.Ell(prob, "cpu")
    solved = [(b, reference.cg(A, torch.as_tensor(b), 1e-10, 2000).numpy())
              for b in rhs.pool(prob, cell.traffic, SEED, "cpu")[:2]]
    inputs = check.operator_inputs([x for _, x in solved])
    for name_, low, dt in (("fine64", torch.float32, torch.float64),
                           ("fine32", torch.bfloat16, torch.float32)):
        outs = {name_: [(v, A.to(low).matvec(v)) for v in
                        (torch.as_tensor(x).to(dt) for x in inputs)]}
        ok, checks = check.judge(cell.config, A, solved, outs, 0)
        assert not ok and checks[name_]["value"] > checks[name_]["limit"]
        assert checks["relres"]["value"] <= checks["relres"]["limit"]


def test_an_unconverged_solve_is_not_correct(tmp_path):
    cell = tiny_cell(CELLS[0])
    prob = harness.problem(cell.config, cache=str(tmp_path))
    A = reference.Ell(prob, "cpu")
    b = rhs.pool(prob, cell.traffic, SEED, "cpu")[0]
    x = reference.cg(A, torch.as_tensor(b), 1e-10, 2000).numpy()
    ok, checks = check.judge(cell.config, A, [(b, x)], {}, 1)
    assert not ok and checks["unconverged"]["value"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_f32_control_fails_at_the_cells_size(name, cuda_device):
    """The plain f32 conjugate-gradient solve in the program's place, at
    the cell's own size on the card, reads a relative residual over the
    configuration's tolerance on three seeds."""
    cell = catalog.cell(catalog.benchmark(), name, False)
    prob = harness.problem(cell.config)
    A = reference.Ell(prob, cuda_device)
    for seed in (SEED, SEED + 1, SEED + 2):
        b = rhs.pool(prob, cell.traffic, seed, cuda_device)[0]
        x = reference.cg(A.to(torch.float32), torch.as_tensor(
            b, device=cuda_device), cell.config["check"]["relres"], 20000)
        r = reference.relres(A, x, torch.as_tensor(b, device=cuda_device))
        assert r > 3 * cell.config["check"]["relres"]


def test_the_p90_leaves_out_the_solves_under_the_profiler():
    p90 = catalog.module("metrics", "solve_ms_p90")
    rec = harness.Run("cpu", "cpu", "cpu")
    rec.latencies = [0.010] * 95 + [1.0] * 5
    assert p90.read(rec) == pytest.approx(1e3 * 0.010)
    rec.latencies += [2.0] * 10
    rec.untraced = 100
    assert p90.read(rec) == pytest.approx(1e3 * 0.010)
    rec.untraced = 0
    assert p90.read(rec) is None
