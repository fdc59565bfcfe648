"""The port's graph layer (``faspsolver_tpu_torch/utils/graphs.py``) and
the segmented PCG and refiner built on it, on the CPU.

On the CPU the PCG's two segments run eagerly; each branch of the loop
is driven by one seeded case and held to the JAX ``pcg`` in f64: equal
iterations and status, x within 1e-12 (relative to max |x|), and one
host read per iteration plus one per true-residual recompute (``syncs``
equals the number of applies of A).  The graphed path's control flow —
the state cached per (A, M), updated in place across solves, copied out
of the static tensors — is driven here too, with a stand-in for
``graphs.Program`` that runs the captured function at every replay
(what a replay computes), and held equal to the eager path bit for bit.
The graphs themselves run on the card: ``tests/test_torch_gpu.py``."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native

from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.krylov import pcg as jax_pcg
from faspsolver_tpu.krylov.precond import JacobiPrecond as JaxJacobi
from faspsolver_tpu.ops.operators import DiaOperator as JaxDia
from faspsolver_tpu_torch.constants import (ERROR_SOLVER_MISC,
                                            ERROR_SOLVER_SOLSTAG,
                                            ERROR_SOLVER_STAG,
                                            ERROR_SOLVER_TOLSMALL, CycleType,
                                            StopType)
from faspsolver_tpu_torch.formats import CSRMatrix
from faspsolver_tpu_torch.krylov import JacobiPrecond, pcg
from faspsolver_tpu_torch.ops.operators import DiaOperator, MatFreeOperator
from faspsolver_tpu_torch.precond import AMGPrecond, FMGPrecond
from faspsolver_tpu_torch.precond.amg import setup_rs, setup_structured
from faspsolver_tpu_torch.solvers import refine
from faspsolver_tpu_torch.testgen import poisson_2d
from faspsolver_tpu_torch.utils import graphs
from faspsolver_tpu_torch.utils.params import AMGParam

torch.set_num_threads(2)
ensure_native()

N = 20
A = poisson_2d(N)


def _scaled(M, s):
    return CSRMatrix(M.indptr, M.indices, s * M.data, M.shape)


def _indefinite(n):
    d = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return CSRMatrix(np.arange(n + 1), np.arange(n), d, (n, n))


class _Counted:
    """A's applies, counted."""

    def __init__(self, op):
        self.op, self.calls = op, 0
        self.shape = op.shape

    def __call__(self, x):
        self.calls += 1
        return self.op(x)


def _rhs(seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(A.nrow)


_X1E6 = 1e6 * np.ones(A.nrow)


def _noise(seed):
    return 1e-3 * np.random.default_rng(seed).standard_normal(A.nrow)


# name: (matrix, b, x0, Jacobi?, keyword arguments, expected status)
CASES = {
    # p.Ap = 0 at the first step: breakdown
    "breakdown": (_indefinite(A.nrow), np.ones(A.nrow), None, False, {},
                  ERROR_SOLVER_MISC),
    # |x| stays below SMALLREAL while the residual crawls: Check I
    "zero_solution": (_scaled(A, 1e3), _rhs(4, 1e-21), None, False,
                      dict(abstol=0.0, tol=1e-8), ERROR_SOLVER_SOLSTAG),
    # steps far below |x| = 2e7 while the residual crawls: Check II,
    # restarts until its budget runs out
    "stagnation": (A, A.matvec(_X1E6), _X1E6 + _noise(5), False,
                   dict(tol=1e-6, max_stag=2), ERROR_SOLVER_STAG),
    # b = A x_true rounds to a true-residual floor near 2.5e-7 of |r0|
    # while the recursive residual falls smoothly past 1e-9: Check III
    # rechecks the claim, finds it false, and its budget (1) is out
    "false_convergence": (A, A.matvec(_X1E6), _X1E6 + _noise(5), False,
                          dict(tol=1e-9, max_restart=1),
                          ERROR_SOLVER_TOLSMALL),
    # unconverged at maxit with a better iterate earlier: the safe variant
    # returns that one
    "safe_best_iterate": (A, _rhs(6), None, False,
                          dict(tol=1e-12, maxit=17, safe=True), 0),
    "rel_precres": (A, _rhs(8), None, True,
                    dict(tol=1e-10, stop_type=int(StopType.REL_PRECRES)), 0),
    "mod_rel_res": (A, _rhs(8), None, True,
                    dict(tol=1e-10, stop_type=int(StopType.MOD_REL_RES)), 0),
}


def _port_and_jax(name):
    mat, b, x0, jacobi, kw, _ = CASES[name]
    jmat = JaxCSRMatrix(mat.indptr, mat.indices, mat.data, mat.shape)
    op = _Counted(DiaOperator.from_csr(mat))
    M = JacobiPrecond.from_csr(mat) if jacobi else None
    jM = JaxJacobi.from_csr(jmat, dtype=jnp.float64) if jacobi else None
    kw = {"maxit": 300, **kw}
    got = pcg(op, torch.from_numpy(b),
              None if x0 is None else torch.from_numpy(x0), M=M, **kw)
    ref = jax_pcg(JaxDia.from_csr(jmat, dtype=jnp.float64), jnp.asarray(b),
                  None if x0 is None else jnp.asarray(x0), M=jM, **kw)
    return got, ref, op.calls


def _close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= rtol * np.abs(ref).max(), err


@pytest.mark.parametrize("name", sorted(CASES))
def test_segmented_pcg_branch_matches_jax(name):
    got, ref, applies = _port_and_jax(name)
    assert (got.iters, got.status, got.converged) == (
        int(ref.iters), int(ref.status), bool(ref.converged))
    assert got.status == CASES[name][-1]
    # one read per iteration, one more per true-residual recompute (and
    # the initial one): as many as A's applies
    assert got.syncs == applies
    _close(got.x.numpy(), ref.x)


def test_branch_cases_take_their_branch():
    """The recomputes and the safe iterate the cases are there for."""
    stag, _, _ = _port_and_jax("stagnation")
    assert stag.syncs > stag.iters + 2          # restarts recomputed
    fc, _, _ = _port_and_jax("false_convergence")
    assert fc.syncs == fc.iters + 2             # the false claim rechecked
    mat, b, _, _, kw, _ = CASES["safe_best_iterate"]
    op = DiaOperator.from_csr(mat)
    kw = {**kw, "safe": False}
    last = pcg(op, torch.from_numpy(b), **kw)
    best, _, _ = _port_and_jax("safe_best_iterate")
    assert not torch.equal(best.x, last.x)


@pytest.fixture
def graphed_on_cpu(monkeypatch):
    """The graphed path's control flow on CPU tensors: ``graphs.Program``
    replaced by a stand-in whose replay runs the captured function over
    the same static tensors (what the graph computes), made once per
    cache entry as a capture is, with the same undone warm-up run.
    Returns the list of programs made."""
    made = []

    class Replayed:
        def __init__(self, fn, device, keep=(), pool=None):
            saved = [t.clone() for t in keep]
            made.append(self)
            self.fn, self.pool = fn, pool
            out = fn()
            for t, s in zip(keep, saved):
                t.copy_(s)
            self.out = None if out is None else torch.empty_like(out)

        def replay(self):
            out = self.fn()
            if out is not None:
                self.out.copy_(out)
            return self.out

    monkeypatch.setattr(graphs, "active", lambda t: isinstance(
        t, torch.Tensor) and graphs._enabled)
    monkeypatch.setattr(graphs, "Program", Replayed)
    return made


def _structured():
    h = setup_structured(poisson_2d(31), AMGParam(
        smoother=13, polynomial_degree=2, coarse_dof=60,
        tentative_smooth=0.67), dtype=torch.float64, smooth_p=True,
        keep_f64_fine=True)
    return h


def test_graphed_pcg_control_flow_is_the_eager_loop(graphed_on_cpu):
    """Two solves through the cached state (the second replays: no new
    programs) against the eager loop: the same x bit for bit, counts and
    syncs; the returned x is a copy, not the static state."""
    hier = _structured()
    op = hier.levels[0].A
    bs = [torch.from_numpy(np.random.default_rng(s).standard_normal(
        op.shape[0])) for s in (1, 2)]
    with graphs.eager():
        want = [pcg(op, b, M=AMGPrecond(hier), tol=1e-10, maxit=60)
                for b in bs]
    got = [pcg(op, bs[0], M=AMGPrecond(hier), tol=1e-10, maxit=60)]
    assert len(graphed_on_cpu) == 3     # S1, S2 and the cycle's own apply
    got.append(pcg(op, bs[1], M=AMGPrecond(hier), tol=1e-10, maxit=60))
    assert len(graphed_on_cpu) == 3     # the second solve replays them
    for g, w in zip(got, want):
        assert torch.equal(g.x, w.x)
        assert (g.iters, g.status, g.syncs) == (w.iters, w.status, w.syncs)
    st = graphs.peek(op, ("pcg", int(StopType.REL_RES), False))
    assert st is not None and st.x.data_ptr() != got[1].x.data_ptr()
    assert not torch.equal(got[0].x, got[1].x)


def test_graphed_refiner_control_flow_is_the_eager_loop(graphed_on_cpu):
    hier = _structured()
    b = poisson_2d(31).matvec(np.ones(31 * 31))
    with graphs.eager():
        want = refine.solve_refined_resident(hier, b, tol=1e-10)
    got = [refine.solve_refined_resident(hier, b, tol=1e-10)
           for _ in range(2)]
    for g in got:
        assert np.array_equal(g.x, want.x)
        assert (g.rounds, g.inner_iters, g.syncs) == (
            want.rounds, want.inner_iters, want.syncs)
    assert graphs.peek(hier.fine64, ("refine", torch.float64)) is not None


CYCLES = {"V": CycleType.V, "W": CycleType.W, "VW": CycleType.VW,
          "WV": CycleType.WV, "AMLI": CycleType.AMLI,
          "NL_AMLI": CycleType.NL_AMLI}


@pytest.mark.parametrize("cycle", sorted(CYCLES))
def test_every_cycle_of_a_csr_hierarchy_is_capturable(cycle):
    hier = setup_rs(poisson_2d(31), AMGParam(
        coarse_dof=60, cycle_type=int(CYCLES[cycle])))
    assert hier.capturable
    assert AMGPrecond(hier).capturable and FMGPrecond(hier).capturable


def test_what_is_not_capturable_stays_eager(graphed_on_cpu):
    """A MatFree operator declares nothing: the PCG over it runs its
    segments eagerly (no program is made) and solves the same."""
    op = DiaOperator.from_csr(A)
    free = MatFreeOperator(op, A.nrow, torch.float64)
    assert graphs.capturable(op) and not graphs.capturable(free)
    b = torch.from_numpy(_rhs(3))
    got = pcg(free, b, tol=1e-10)
    assert graphed_on_cpu == []
    with graphs.eager():
        want = pcg(op, b, tol=1e-10)
    assert torch.equal(got.x, want.x) and got.iters == want.iters


def test_a_sharded_hierarchy_is_not_capturable():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from faspsolver_tpu_torch.parallel import shard_hierarchy
    hier = setup_rs(poisson_2d(31), AMGParam(coarse_dof=60))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        placed = shard_hierarchy(hier, init_device_mesh("cpu", (1,)),
                                 min_size=64)
        assert not AMGPrecond(placed).capturable
        assert AMGPrecond(hier).capturable
    finally:
        dist.destroy_process_group()


def test_graph_is_dropped_on_a_move_and_not_copied(graphed_on_cpu):
    """A preconditioner's graph is kept by its hierarchy: a new wrapper
    replays it, ``.to()`` drops it, a deep copy starts without one, and a
    hierarchy moved behind the wrapper's back is captured again (its
    buffers' addresses are in the key)."""
    hier = _structured()
    r = torch.from_numpy(np.random.default_rng(9).standard_normal(
        hier.levels[0].A.shape[0]))
    M = AMGPrecond(hier)
    z = M(r)
    assert M._graph is not None and len(graphed_on_cpu) == 1
    assert AMGPrecond(hier)._graph is M._graph
    assert torch.equal(AMGPrecond(hier)(r), z) and len(graphed_on_cpu) == 1
    assert copy.deepcopy(M)._graph is None
    M.to(torch.float64)          # a move: the graph goes
    assert M._graph is None
    M(r)
    assert len(graphed_on_cpu) == 2
    hier.float()                 # new buffers behind the wrapper's back
    M(r.float())
    assert len(graphed_on_cpu) == 3
    assert graphs.fingerprint(hier) != () and M._graph is not None


def test_cpu_tensors_and_the_eager_switch_never_replay():
    graphs.reset_stats()
    assert all(v == 0 for v in graphs.stats.values())
    assert not graphs.active(torch.zeros(3))      # a CPU tensor
    with graphs.eager():
        assert not graphs._enabled
    assert graphs._enabled
    op = DiaOperator.from_csr(A)
    pcg(op, torch.from_numpy(_rhs(1)), tol=1e-8)
    assert graphs.peek(op, ("pcg", int(StopType.REL_RES), False)) is None
    assert graphs.stats["replays"] == 0
