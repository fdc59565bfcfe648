"""The port's graph layer (``faspsolver_tpu_torch/utils/graphs.py``) and
the resident PCG and refiner built on it, on the CPU.

On the CPU the PCG's loop tree runs as the eager loop; each branch of
the loop is driven by one seeded case and held to the JAX ``pcg`` in
f64: equal iterations and status, x within 1e-12 (relative to max |x|),
and one host read per iteration plus one per true-residual recompute
(``syncs`` equals the number of applies of A).  The resident path's
control flow — the state cached per (A, M), updated in place across
solves, copied out of the static tensors, one read per solve — is driven
here too, with a stand-in for ``graphs.Resident`` that runs the loop
tree as the device runs its graph (each If and While decided by its
region's flag, read without a host read), and held equal to the eager
path bit for bit; so are AMG as a solver and FAMG (their state kept
with the hierarchy) and GMG's two loops (kept in the module's cache by
loop, size, dimension, full-MG start, dtype and device).  The graphs
themselves run on the card:
``tests/test_torch_gpu.py``.  GCG / GCR's nested While run the same way
in the card's arithmetic, and the block (BSR) path's modules declare
themselves capturable (a UA or SA hierarchy with or without its
near-kernel basis, block Jacobi, the near-kernel preconditioner), so
its vFGMRES, CG and near-kernel solves run resident too; so do the
STR operator and preconditioners, the BLC operator and block and
sweeping preconditioners, Schwarz, and a MatFree operator whose
function is a capturable module.  A DTensor replays graphs only over an
NCCL mesh (never over gloo), its buffers keyed on their local parts,
and the distribution layer's modules and placed hierarchies declare
themselves capturable."""
import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import resident_cases
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
from faspsolver_tpu_torch.utils import graphs, loops
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
    cache entry as a capture is, with the same undone warm-up run; and
    ``graphs.Resident`` by one whose launch runs the loop tree as the
    device runs the graph: each piece, each If and While decided by its
    region's flag (what the control sets its handle to).  Returns the
    list of programs made."""
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

    class Emulated:
        def __init__(self, tree, device, keep=()):
            saved = [t.clone() for t in keep]
            made.append(self)
            for piece in graphs._pieces(tree):
                piece.fn()
            for t, s in zip(keep, saved):
                t.copy_(s)
            self.tree = tree

        def launch(self):
            def run(items):
                for item in items:
                    if isinstance(item, graphs.Piece):
                        item.fn()
                    elif isinstance(item, graphs.If):
                        if int(item.reg.i[loops.I.NEED]):
                            run(item.body)
                    else:
                        while int(item.reg.i[loops.I.CONT]):
                            run(item.body)
            run(self.tree)

        def account(self, vals):
            pass

    monkeypatch.setattr(graphs, "active", lambda t: isinstance(
        t, torch.Tensor) and graphs._enabled)
    monkeypatch.setattr(graphs, "Program", Replayed)
    monkeypatch.setattr(graphs, "Resident", Emulated)
    return made


def _structured():
    h = setup_structured(poisson_2d(31), AMGParam(
        smoother=13, polynomial_degree=2, coarse_dof=60,
        tentative_smooth=0.67), dtype=torch.float64, smooth_p=True,
        keep_f64_fine=True)
    return h


def test_graphed_pcg_control_flow_is_the_eager_loop(graphed_on_cpu):
    """Two solves through the cached state (the second launches the same
    program: no new programs) against the eager loop: the same x bit for
    bit and counts, one host read per resident solve; the returned x is
    a copy, not the static state."""
    hier = _structured()
    op = hier.levels[0].A
    bs = [torch.from_numpy(np.random.default_rng(s).standard_normal(
        op.shape[0])) for s in (1, 2)]
    with graphs.eager():
        want = [pcg(op, b, M=AMGPrecond(hier), tol=1e-10, maxit=60)
                for b in bs]
    got = [pcg(op, bs[0], M=AMGPrecond(hier), tol=1e-10, maxit=60)]
    assert len(graphed_on_cpu) == 2     # the loop and the cycle's own apply
    got.append(pcg(op, bs[1], M=AMGPrecond(hier), tol=1e-10, maxit=60))
    assert len(graphed_on_cpu) == 2     # the second solve launches them
    for g, w in zip(got, want):
        assert torch.equal(g.x, w.x)
        assert (g.iters, g.status) == (w.iters, w.status)
        assert g.syncs == 1 and w.syncs > w.iters
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
        assert (g.rounds, g.inner_iters, g.recomputes) == (
            want.rounds, want.inner_iters, want.recomputes)
        assert g.syncs == 1
    # the eager loop: a read per round, per inner start, iteration and
    # recompute
    assert want.syncs == (2 * want.rounds + want.inner_iters
                          + want.recomputes)
    assert graphs.peek(hier.fine64, ("refine", torch.float64)) is not None


@pytest.mark.parametrize("method", ["gmres", "vgmres", "vfgmres"])
def test_graphed_gmres_control_flow_is_the_eager_loop(graphed_on_cpu,
                                                      monkeypatch, method):
    """The GMRES family's nested While (restart cycles around Arnoldi
    steps) run as the device runs its graph, in the card's arithmetic
    (the Arnoldi step's j a device index), over structured AMG, plain
    and safe, two windows: x bit for bit the eager loop's with equal
    counts and status, one host read per resident solve against the
    eager loop's 1 + iterations + cycles, the warm-up undone, and one
    kept state per window (the second solve of a window makes no new
    program)."""
    from faspsolver_tpu_torch import krylov
    monkeypatch.setattr(importlib.import_module(
        "faspsolver_tpu_torch.krylov.gmres"), "_on_host", lambda b: False)
    hier = _structured()
    op = hier.levels[0].A
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        op.shape[0]))
    fn = getattr(krylov, method)

    def loops_made():
        return sum(type(p).__name__ == "Emulated" for p in graphed_on_cpu)

    for safe in (False, True):
        for restart in (7, 12):
            kw = dict(M=AMGPrecond(hier), tol=1e-10, maxit=80,
                      restart=restart, safe=safe)
            with graphs.eager():
                want = fn(op, b, **kw)
            made = loops_made()
            got = [fn(op, b, **kw) for _ in range(2)]
            assert loops_made() == made + 1
            for g in got:
                assert torch.equal(g.x, want.x)
                assert (g.iters, g.status, g.converged) == (
                    want.iters, want.status, want.converged)
                assert g.syncs == 1 and want.syncs > 1 + want.iters
                assert g.resident and not want.resident
    for restart in (7, 12):
        assert graphs.peek(op, ("gmres", int(StopType.REL_RES), True,
                                restart, method != "gmres",
                                method == "vfgmres")) is not None


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
    """A MatFree operator over a plain function declares nothing: the
    PCG over it runs its segments eagerly (no program is made) and
    solves the same."""
    op = DiaOperator.from_csr(A)
    free = MatFreeOperator(lambda v: op(v), A.nrow, torch.float64)
    assert graphs.capturable(op) and not graphs.capturable(free)
    b = torch.from_numpy(_rhs(3))
    got = pcg(free, b, tol=1e-10)
    assert graphed_on_cpu == []
    with graphs.eager():
        want = pcg(op, b, tol=1e-10)
    assert torch.equal(got.x, want.x) and got.iters == want.iters


def test_a_sharded_hierarchy_is_not_capturable():
    """A hierarchy placed on a gloo mesh is never captured: it declares
    itself capturable, as its placed pieces do (over an NCCL mesh its
    cycles replay, tests/test_torch_gpu.py), but a gloo mesh's DTensor
    does not replay graphs, so its cycle runs eagerly and keeps no
    graph."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from faspsolver_tpu_torch.parallel import shard_hierarchy
    from faspsolver_tpu_torch.parallel.comm import split
    hier = setup_rs(poisson_2d(31), AMGParam(coarse_dof=60))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        placed = shard_hierarchy(hier, mesh, min_size=64)
        M = AMGPrecond(placed)
        assert M.capturable and AMGPrecond(hier).capturable
        r = torch.from_numpy(np.random.default_rng(3).standard_normal(
            31 * 31))
        rd = split(r, mesh)
        assert not graphs.active(rd)
        z = M(rd)
        assert M._graph is None
        assert torch.equal(z.to_local(), AMGPrecond(hier).eager(r))
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


def test_graphed_amg_solve_control_flow_is_the_eager_loop(graphed_on_cpu):
    """AMG as a solver and FAMG run as the device runs their graph: the
    state kept with the hierarchy per cycle type and FAMG flag (a second
    solve makes no new program; a new b only uploads), x bit for bit the
    eager loop's with equal counts, one host read per resident solve
    against the eager loop's iterations + 1, the returned x a copy."""
    from faspsolver_tpu_torch.precond.amg import amg_solve, famg_solve
    hier = _structured()
    n = hier.levels[0].A.shape[0]
    bs = [torch.from_numpy(np.random.default_rng(s).standard_normal(n))
          for s in (7, 8)]
    for fn, famg in ((amg_solve, False), (famg_solve, True)):
        with graphs.eager():
            want = [fn(hier, b, tol=1e-10, maxit=30) for b in bs]
        made = len(graphed_on_cpu)
        got = [fn(hier, b, tol=1e-10, maxit=30) for b in bs]
        assert len(graphed_on_cpu) == made + 1
        for g, w in zip(got, want):
            assert torch.equal(g.x, w.x)
            assert (g.iters, g.relres, g.converged) == (w.iters, w.relres,
                                                        w.converged)
            assert g.syncs == 1 and g.resident and not w.resident
            assert w.syncs == w.iters + (0 if famg else 1)
        st = graphs.peek(hier, ("amg_solve", hier.cycle_type, famg))
        assert st is not None and st.x.data_ptr() != got[1].x.data_ptr()
        assert not torch.equal(got[0].x, got[1].x)


def test_graphed_gmg_loops_are_kept_per_key_and_are_the_eager_loop(
        graphed_on_cpu):
    """GMG's V-cycle and CG loops run as the device runs their graphs,
    each kept in the module's cache under (loop, n, dimension, full-MG
    start, dtype, device): a second solve of a key makes no new program,
    every solve is x bit for bit the eager loop's with one host read; the
    kept programs hold their levels' masks, so clearing the mask cache
    changes nothing; ``clear_programs`` empties the cache."""
    import chip_smoke
    from faspsolver_tpu_torch.precond import gmg
    gmg.clear_programs()
    runs = [("poisson_gmg_2d", 16, 2, {}), ("poisson_gmg_2d", 16, 2,
                                            {"full_first": True}),
            ("poisson_gmgcg_2d", 16, 2, {}), ("poisson_gmg_3d", 8, 3, {}),
            ("poisson_gmgcg_3d", 8, 3, {})]
    for dt in (torch.float64, torch.float32):
        for fn, n, dim, kw in runs:
            f = torch.from_numpy(chip_smoke.gmg_problem(n, dim)[0]).to(dt)
            with graphs.eager():
                want = getattr(gmg, fn)(f, n, **kw)
            made = len(graphed_on_cpu)
            got = [getattr(gmg, fn)(f, n, **kw) for _ in range(2)]
            assert len(graphed_on_cpu) == made + 1
            for g in got:
                assert torch.equal(g.x, want.x) and g.iters == want.iters
                assert g.syncs == 1 and want.syncs == want.iters + 1
            gmg._MASKS.clear()
            again = getattr(gmg, fn)(f, n, **kw)
            assert torch.equal(again.x, want.x)
    cpu = torch.device("cpu")
    assert set(gmg._PROGRAMS) == {
        (loop, n, dim) + ff + (dt, cpu)
        for dt in (torch.float64, torch.float32)
        for loop, n, dim, ff in (("vcycles", 16, 2, (False,)),
                                 ("vcycles", 16, 2, (True,)),
                                 ("cg", 16, 2, ()), ("vcycles", 8, 3, (False,)),
                                 ("cg", 8, 3, ()))}
    st = gmg._PROGRAMS["vcycles", 16, 2, False, torch.float64, cpu]
    assert [m[0].shape for m in st.masks] == [(17, 17), (9, 9), (5, 5)]
    gmg.clear_programs()
    assert not gmg._PROGRAMS


@pytest.mark.parametrize("method", ["gcr", "gcg"])
def test_graphed_gcr_control_flow_is_the_eager_loop(graphed_on_cpu,
                                                    monkeypatch, method):
    """GCG / GCR's nested While (restart cycles around descent steps) run
    as the device runs its graph, in the card's arithmetic (masked
    full-window products, j a device index), over structured AMG, two
    windows: x bit for bit the eager loop's with equal counts, one host
    read per resident solve against the eager loop's 1 + steps + cycles,
    and one kept state per window (the second solve of a window makes no
    new program)."""
    from faspsolver_tpu_torch import krylov
    monkeypatch.setattr(importlib.import_module(
        "faspsolver_tpu_torch.krylov.gcg_gcr"), "_on_host", lambda b: False)
    hier = _structured()
    op = hier.levels[0].A
    b = torch.from_numpy(np.random.default_rng(12).standard_normal(
        op.shape[0]))
    fn = getattr(krylov, method)

    def loops_made():
        return sum(type(p).__name__ == "Emulated" for p in graphed_on_cpu)

    for restart in (5, 9):
        kw = dict(M=AMGPrecond(hier), tol=1e-10, maxit=80, restart=restart)
        with graphs.eager():
            want = fn(op, b, **kw)
        made = loops_made()
        got = [fn(op, b, **kw) for _ in range(2)]
        assert loops_made() == made + 1
        for g in got:
            assert torch.equal(g.x, want.x)
            assert (g.iters, g.status, g.converged) == (
                want.iters, want.status, want.converged)
            assert g.syncs == 1 and want.syncs > 1 + want.iters
            assert g.resident and not want.resident
        assert graphs.peek(op, ("gcr", int(StopType.REL_RES), False,
                                restart)) is not None


def _bsr_hierarchy(kind, nk):
    import chip_smoke
    from faspsolver_tpu_torch.precond.amg import setup_sa_bsr, setup_ua_bsr
    A, b = chip_smoke.bsr_problem(6)
    basis = chip_smoke.component_basis(A.nrow, A.nb) if nk else None
    setup = setup_ua_bsr if kind == "UA" else setup_sa_bsr
    hier = setup(A, AMGParam(AMG_type=3 if kind == "UA" else 2,
                             aggregation_type=2, coarse_dof=30, smoother=2),
                 dtype=torch.float64, nk=basis)
    return A, b, hier


@pytest.mark.parametrize("nk", [False, True], ids=["plain", "near-kernel"])
@pytest.mark.parametrize("kind", ["UA", "SA"])
def test_a_bsr_hierarchy_is_capturable(kind, nk):
    """setup_bsr's levels (BsrEllOperator, block smoother data and its
    color blocks, the transfers, the near-kernel data) each declare
    themselves capturable, so the hierarchy and its AMG preconditioner
    are."""
    from faspsolver_tpu_torch.ops.operators import BsrEllOperator
    from faspsolver_tpu_torch.precond.amg import (BsrColorBlock,
                                                  BsrSmootherData)
    _, _, hier = _bsr_hierarchy(kind, nk)
    assert hier.num_levels > 1
    for lvl in hier.levels:
        assert isinstance(lvl.A, BsrEllOperator) and graphs.capturable(lvl.A)
        assert (lvl.nk is not None) == nk
        if lvl.smoother is not None:
            assert isinstance(lvl.smoother, BsrSmootherData)
            assert graphs.capturable(lvl.smoother)
            assert all(isinstance(c, BsrColorBlock) and graphs.capturable(c)
                       for c in lvl.smoother.colors)
    assert hier.capturable
    assert AMGPrecond(hier).capturable and FMGPrecond(hier).capturable


def test_block_jacobi_and_near_kernel_preconditioners_are_capturable():
    """Block Jacobi declares itself capturable; the near-kernel
    preconditioner is when its cycles and its operator are (a BSR or a
    CSR operator), and is not over a MatFree operator of a plain
    function."""
    import chip_smoke
    from faspsolver_tpu_torch.krylov import BlockJacobiPrecond
    from faspsolver_tpu_torch.ops.operators import device_operator
    from faspsolver_tpu_torch.precond import AMGNKPrecond
    A, _, hier = _bsr_hierarchy("UA", False)
    assert graphs.capturable(BlockJacobiPrecond.from_bsr(A))
    basis = torch.from_numpy(chip_smoke.component_basis(A.nrow, A.nb))
    gram = torch.eye(A.nb, dtype=torch.float64)
    op = device_operator(A)
    csr = device_operator(A.to_csr())
    for A_op, want in ((op, True), (csr, True),
                       (MatFreeOperator(lambda v: op(v), A.nrow,
                                        torch.float64), False)):
        assert graphs.capturable(AMGNKPrecond(hier, basis, gram,
                                              A_op)) == want


@pytest.mark.parametrize("case", ["vfgmres UA", "vfgmres SA near-kernel",
                                  "cg block Jacobi", "vfgmres AMG-nk"])
def test_graphed_bsr_solves_are_the_eager_loop(graphed_on_cpu, case):
    """vFGMRES over UA-BSR and over SA-BSR with its near-kernel basis, CG
    over block Jacobi and vFGMRES over the near-kernel preconditioner on
    block_poisson_3d(6, nb=3) run as the device runs their graph: x bit
    for bit the eager loop's, equal counts, one host read per resident
    solve."""
    import chip_smoke
    from faspsolver_tpu_torch.krylov import BlockJacobiPrecond, vfgmres
    from faspsolver_tpu_torch.ops.operators import device_operator
    from faspsolver_tpu_torch.precond import AMGNKPrecond
    kind = "SA" if "SA" in case else "UA"
    A, b, hier = _bsr_hierarchy(kind, "near-kernel" in case)
    op = device_operator(A)
    bt = torch.from_numpy(b)
    if case == "cg block Jacobi":
        M = BlockJacobiPrecond.from_bsr(A)
        solve = lambda: pcg(op, bt, M=M, tol=1e-9, maxit=300)  # noqa: E731
    else:
        if case == "vfgmres AMG-nk":
            basis = chip_smoke.component_basis(A.nrow, A.nb)
            gram = np.linalg.pinv(basis.T @ (A.to_scipy() @ basis))
            M = AMGNKPrecond(hier, torch.from_numpy(basis),
                             torch.from_numpy(gram), op)
        else:
            M = AMGPrecond(hier)
        solve = lambda: vfgmres(op, bt, M=M, tol=1e-9,  # noqa: E731
                                maxit=200, restart=30)
    with graphs.eager():
        want = solve()
    got = solve()
    assert graphed_on_cpu and got.resident and not want.resident
    assert torch.equal(got.x, want.x) and got.iters == want.iters > 3
    assert got.syncs == 1 and want.syncs > want.iters


def test_str_blc_schwarz_and_matfree_modules_are_capturable():
    """The STR operator, block diag, ILU, block GS and Schwarz; the BLC
    operator, its block preconditioner in each mode and the sweeping
    one over UA-AMG blocks; Schwarz and its color groups; a MatFree
    operator over the ELL operator: each declares itself capturable.
    A MatFree operator over a plain function does not, nor does a BLC
    preconditioner with such a part."""
    import chip_smoke
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.ops.str_ops import StrOperator
    from faspsolver_tpu_torch.precond import (setup_blc_precond,
                                              setup_blc_sweeping,
                                              setup_schwarz, setup_str_blockgs,
                                              setup_str_diag, setup_str_ilu,
                                              setup_str_schwarz)
    from faspsolver_tpu_torch.precond.blc_precond import (BlcOperator,
                                                          BlcPrecond)
    from faspsolver_tpu_torch.utils.params import SWZParam
    S, _, _ = chip_smoke.str_problem(6)
    B, _ = chip_smoke.blc_problem(6)
    L, _ = chip_smoke.sweep_problem(12, 3)
    swz = setup_schwarz(A, SWZParam(SWZ_type=3))
    ell = device_operator(A, prefer="ell")
    blc = setup_blc_precond(B, mode="sgs")
    yes = [StrOperator.from_str(S), setup_str_diag(S), setup_str_ilu(S),
           setup_str_ilu(S, fill=1), setup_str_blockgs(S),
           setup_str_schwarz(S), BlcOperator.from_blc(B), blc,
           setup_blc_sweeping(L), swz, *swz.groups,
           MatFreeOperator(ell, A.nrow, torch.float64)]
    yes += [setup_blc_precond(B, mode=m) for m in ("diag", "lower", "upper")]
    for m in yes:
        assert graphs.capturable(m), type(m).__name__
    free = MatFreeOperator(lambda v: ell(v), A.nrow, torch.float64)
    assert not graphs.capturable(free)
    assert not graphs.capturable(BlcPrecond(
        list(blc.solvers), {(0, 1): free}, "sgs", blc.sizes))
    assert not graphs.capturable(BlcOperator({(0, 0): free}, [A.nrow],
                                             [A.nrow]))


@pytest.mark.parametrize("case", resident_cases.CASES)
def test_graphed_str_blc_schwarz_solves_are_the_eager_loop(graphed_on_cpu,
                                                           case):
    """CG + STR block diag, vFGMRES + STR ILU(0), block GS and Schwarz on
    block_poisson_3d(8, nb=3) in STR form; vFGMRES + BLC diag and sgs on
    the same matrix as a 3 x 3 BLC; vFGMRES + sweeping on poisson_3d(16)
    in 4 slabs; GMRES + forward and CG + symmetric Schwarz on
    poisson_2d(31); matrix-free CG and GCG over the ELL operator
    (``tests/resident_cases.py``): run as the device runs their graph,
    each gives the eager loop's count, status and x bit for bit, with
    one host read."""
    solve, op, M = resident_cases.build(case, "small", "cpu")
    assert graphs.capturable(op) and graphs.capturable(M)
    with graphs.eager():
        want = solve()
    got = solve()
    assert graphed_on_cpu and got.resident and not want.resident
    assert torch.equal(got.x, want.x)
    assert (got.iters, got.status) == (want.iters, want.status)
    assert got.iters > 3 and want.converged
    assert got.syncs == 1 and want.syncs > want.iters


@pytest.fixture
def gloo_mesh():
    """A one-rank gloo mesh on the CPU (the process group make_mesh
    makes, taken down after the test)."""
    from faspsolver_tpu_torch.parallel import make_mesh, release_mesh
    mesh = make_mesh(device="cpu")
    try:
        yield mesh
    finally:
        release_mesh()


def test_active_admits_a_dtensor_only_over_nccl(gloo_mesh, monkeypatch):
    """A DTensor replays graphs only where its mesh's groups are NCCL's
    and its local part lies on CUDA: over gloo on the CPU it does not,
    and a mesh that reports NCCL does not make a CPU DTensor replay
    either; graphs.eager() and a plain CPU tensor keep everything eager
    too."""
    import torch.distributed as dist
    from faspsolver_tpu_torch.parallel import shard_vector
    x = shard_vector(torch.arange(8.0, dtype=torch.float64), gloo_mesh)
    assert not graphs.over_nccl(gloo_mesh)
    assert not graphs.active(x) and not graphs.active(x.to_local())
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    assert graphs.over_nccl(gloo_mesh)
    assert not graphs.active(x)
    with graphs.eager():
        assert not graphs.active(x)


def test_fingerprint_keys_dtensor_buffers_on_their_local_parts(gloo_mesh):
    """A module whose buffers are DTensors (a row-split ELL operator) is
    keyed on each local part's address, dtype and shape with the mesh's
    size and this rank; a copy of it gets another key, a plain module
    keeps its buffers' own."""
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.parallel import dist_operator
    op = dist_operator(A, gloo_mesh, dtype=torch.float64)
    want = tuple((t.to_local().data_ptr(), t.dtype,
                  tuple(t.to_local().shape), 1, 0) for t in op.buffers())
    assert graphs.fingerprint(op) == want and len(want) == 2
    assert graphs.fingerprint(copy.deepcopy(op)) != want
    ell = device_operator(A, prefer="ell")
    assert graphs.fingerprint(ell) == tuple(
        (t.data_ptr(), t.dtype, tuple(t.shape)) for t in ell.buffers())


def test_distribution_modules_are_capturable(gloo_mesh):
    """The row-split ELL, BSR and DIA operators, the halo operator and
    banded transfers, the placed pieces of a hierarchy (OnWhole,
    PlacedTransfer, WholeSmoother) and the hierarchies that
    shard_hierarchy and halo_shard_hierarchy place (structured and RS,
    with Gauss-Seidel sweeps on the gathered vector) each declare
    themselves capturable, as do AMG preconditioners over them and over
    a replicated hierarchy.  A placed piece over a MatFree operator of a
    plain function does not, nor does a hierarchy that holds one."""
    import chip_smoke
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.parallel import (
        dist_dia_operator, dist_operator, halo_dia_operator,
        halo_shard_hierarchy, replicate, shard_block_rows, shard_hierarchy)
    from faspsolver_tpu_torch.parallel.dist_dia import (OnWhole,
                                                        PlacedTransfer,
                                                        WholeSmoother)
    from faspsolver_tpu_torch.parallel.halo import (HaloBandedProlong,
                                                    HaloBandedRestrict)
    mesh = gloo_mesh
    Ab, _ = chip_smoke.bsr_problem(4)
    P = poisson_2d(64)
    hs = shard_hierarchy(setup_structured(P, AMGParam(coarse_dof=60),
                                          smooth_p=True), mesh, min_size=256)
    hr = setup_rs(P, AMGParam(coarse_dof=60))
    hrs = shard_hierarchy(hr, mesh, min_size=256)
    hh, _ = halo_shard_hierarchy(hr, mesh, min_size=P.nrow // 2)
    kinds = {type(m) for h in (hs, hrs, hh) for lvl in h.levels
             for m in (lvl.A, lvl.P, lvl.R, lvl.smoother)}
    assert {OnWhole, PlacedTransfer, WholeSmoother, HaloBandedProlong,
            HaloBandedRestrict} <= kinds
    yes = [dist_operator(A, mesh), dist_dia_operator(A, mesh),
           halo_dia_operator(A, mesh),
           shard_block_rows(device_operator(Ab), mesh), hs, hrs, hh,
           AMGPrecond(hs), AMGPrecond(hrs), AMGPrecond(hh),
           AMGPrecond(replicate(setup_rs(A, AMGParam(coarse_dof=60)),
                                mesh))]
    yes += [m for h in (hs, hrs, hh) for lvl in h.levels
            for m in (lvl.A, lvl.P, lvl.R, lvl.smoother) if m is not None]
    for m in yes:
        assert graphs.capturable(m), type(m).__name__
    free = MatFreeOperator(lambda v: v, A.nrow, torch.float64)
    placed = OnWhole(free, mesh, A.nrow, True)
    assert not graphs.capturable(placed)
    assert not graphs.capturable(PlacedTransfer(free, mesh, A.nrow, A.nrow,
                                                True, True))
    assert not graphs.capturable(WholeSmoother(hr.levels[0].smoother, free,
                                               mesh, A.nrow))
    hh.levels[0].A = placed
    assert not graphs.capturable(hh) and not graphs.capturable(
        AMGPrecond(hh))
