"""The port's benchmark harness at its own default sizes against the JAX
package's, on the CPU.  ``generated_problems()`` is read with the FDM
generators stubbed, so the 1023^2 and 101^3 matrices are never built:
the same rows (names, orders, b's dtype and shape) in both packages,
and they are the rows phase 11 of chip_smoke.py anchors.  One small 3-D
row then goes through both harnesses' solvers, float64 and the f32
refined mode, with their solver calls spied: the same tolerances,
restart, budgets and precision, the same iteration count and status."""
import contextlib

import jax
import numpy as np
import torch
from native_parity import ensure_native

import chip_smoke
import faspsolver_tpu.benchmark.harness as jax_harness
import faspsolver_tpu.krylov as jax_krylov
import faspsolver_tpu.solvers as jax_solvers
import faspsolver_tpu.testgen as jax_testgen
from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
import faspsolver_tpu_torch.krylov as krylov
import faspsolver_tpu_torch.solvers as solvers
import faspsolver_tpu_torch.testgen as testgen
from faspsolver_tpu_torch.benchmark import harness
from faspsolver_tpu_torch.constants import SolverType
from faspsolver_tpu_torch.testgen import poisson_3d

torch.set_num_threads(2)
ensure_native()

SMALL_3D = 9        # the small 3-D row, 729 dof


class _Grid:
    """What a stubbed generator hands back: the grid's order and
    dimension, its row count, and b = A 1 as the harness forms it."""

    def __init__(self, dim, n):
        self.dim, self.n, self.nrow = dim, n, n ** dim

    def matvec(self, x):
        return np.asarray(x, dtype=np.float64).copy()


def _rows(module, gen_module, monkeypatch):
    for dim, fn in ((2, "poisson_2d"), (3, "poisson_3d")):
        monkeypatch.setattr(gen_module, fn,
                            lambda n, dim=dim: _Grid(dim, n))
    return [(name, A.dim, A.n, A.nrow, b.dtype, b.shape)
            for name, A, b in module.generated_problems()]


def test_default_rows_equal_jax_and_phase_11_anchors(monkeypatch):
    rows = _rows(harness, testgen, monkeypatch)
    assert rows == _rows(jax_harness, jax_testgen, monkeypatch)
    assert [(dim, n) for _, dim, n, *_ in rows] == [
        (2, 255), (2, 511), (2, 1023), (3, 31), (3, 47), (3, 101)]
    assert rows[-1][3] == 1_030_301 and rows[2][3] == 1_046_529
    assert all(dt == np.float64 for *_, dt, _ in rows)
    names = [r[0] for r in rows]
    assert list(chip_smoke.HARNESS_GEN_F64) == names
    assert list(chip_smoke.HARNESS_GEN_F32) == names


@contextlib.contextmanager
def _spied(module, name, calls):
    """``module.name`` recording each call's keyword arguments and result."""
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((kw, out))
        return out

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _its(kw):
    its = kw["its"]
    return (its.itsolver_type, its.tol, its.maxit, its.restart)


def _f64_row(A, b):
    """score_problem through both packages' f64 solvers, krylov_amg spied:
    (BenchResult, its fields, solve status) of the port, then of JAX."""
    out = []
    for h, mod, Am in ((harness, solvers, A),
                       (jax_harness, jax_solvers,
                        JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape))):
        kw = {"device": "cpu"} if h is harness else {}
        with _spied(mod, "krylov_amg", []) as calls:
            r = h.score_problem("fdm3d", Am, b,
                                h._solver_factory("amg", **kw), 1e-9)
        call, (res, _) = calls[-1]
        out.append((r, _its(call), int(res.status), call.get("dtype")))
    return out


def _f32_row(A, b):
    """Both packages' f32 refined modes (JAX with x64 off, as its --tpu
    runs), every refinement and inner vgmres recorded
    (chip_smoke.refined_stages) with the refinement's keywords."""
    out = []
    for h, kr, sv in ((harness, krylov, solvers),
                      (jax_harness, jax_krylov, jax_solvers)):
        calls = []
        if h is jax_harness:
            jax.config.update("jax_enable_x64", False)
        try:
            with chip_smoke.refined_stages(kr, sv) as stages, \
                    _spied(sv, "solve_refined", calls):
                solve = (h._refined_factory("amg", torch.float32, "cpu")
                         if h is harness else h._solver_factory("amg"))
                res = solve(A if h is harness else JaxCSRMatrix(
                    A.indptr, A.indices, A.data, A.shape), b)
        finally:
            jax.config.update("jax_enable_x64", True)
        kw = {k: v for k, v in calls[0][0].items() if k != "device"}
        dt = kw["dtype"]
        kw["dtype"] = getattr(dt, "__name__", str(dt)).rsplit(".", 1)[-1]
        out.append((res, stages, kw))
    return out


def test_small_3d_row_f64_counts_and_status_equal_jax():
    A = poisson_3d(SMALL_3D)
    b = A.matvec(np.ones(A.nrow))
    (r, its, status, dtype), (rj, itsj, statusj, _) = _f64_row(A, b)
    # vGMRES(60) to 1e-8
    assert its == itsj == (int(SolverType.VGMRES), 1e-8, 2000, 60)
    assert dtype == torch.float64
    assert r.converged and rj.converged
    assert (r.name, r.n, r.nnz, r.iters, status) == \
        (rj.name, rj.n, rj.nnz, rj.iters, statusj)


def test_small_3d_row_f32_refined_counts_and_status_equal_jax():
    A = poisson_3d(SMALL_3D)
    b = A.matvec(np.ones(A.nrow))
    (res, stages, kw), (resj, stagesj, kwj) = _f32_row(A, b)
    assert kw == kwj == {"tol": 1e-8, "max_rounds": 8, "dtype": "float32"}
    assert res.converged and resj.converged
    assert res.iters == resj.iters
    # one refinement each (no fallback), the same rounds and the same
    # inner solves: dtype, iterations, convergence and status
    assert len(stages) == len(stagesj) == 1
    assert stages[0]["rounds"] == stagesj[0]["rounds"]
    assert [(dt, it, ok, st) for dt, it, _, ok, st in stages[0]["inner"]] \
        == [(dt, it, ok, st) for dt, it, _, ok, st in stagesj[0]["inner"]]
    np.testing.assert_array_less(
        np.linalg.norm(b - A.matvec(np.asarray(res.x))) / np.linalg.norm(b),
        1e-8)
