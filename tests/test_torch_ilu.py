"""The port's ILU preconditioners against the JAX package's (f64, CPU).

The native bindings give bit-equal factors (the same C++ entries); the
level-scheduled solvers hold the JAX package's level arrays and apply
within 1e-12, also where the JAX solver runs its levels as scan segments
(more than 48 levels); block ILU(0) agrees native against NumPy; the
drivers and the CLI give the JAX package's iteration counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from native_parity import ensure_native

import faspsolver_tpu.native as jax_native
import faspsolver_tpu.solvers.drivers as jax_solvers
from faspsolver_tpu.__main__ import main as jax_main
from faspsolver_tpu.formats import BSRMatrix as JaxBSRMatrix
from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.precond import ilu as jax_ilu
from faspsolver_tpu.utils import params as jax_params
import faspsolver_tpu_torch.solvers as solvers
from faspsolver_tpu_torch import native
from faspsolver_tpu_torch.__main__ import main
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.precond import ilu
from faspsolver_tpu_torch.precond.ilu import (TriangularSolver,
                                              setup_bsr_ilu0, setup_ilu)
from faspsolver_tpu_torch.testgen import (block_poisson_3d, convdiff_2d,
                                          poisson_2d,
                                          poisson_2d_manufactured)
from faspsolver_tpu_torch.utils import FaspError
from faspsolver_tpu_torch.utils.params import ILUParam, ITSParam

torch.set_num_threads(2)
ensure_native()


def _j(A):
    return JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _same_levels(got, conv):
    """Two solvers hold the same levels: rows, inverse diagonals and the
    nonzero dependency entries (a scan segment pads its levels wider)."""
    assert got.n == conv.n and got.num_levels == conv.num_levels
    for g, c in zip(got.level_arrays(), conv.level_arrays()):
        np.testing.assert_array_equal(g[0].numpy(), c[0].numpy())
        np.testing.assert_array_equal(g[3].numpy(), c[3].numpy())
        k = g[1].shape[1]
        assert c[1].shape[1] >= k
        np.testing.assert_array_equal(g[2].numpy(), c[2][:, :k].numpy())
        np.testing.assert_array_equal((g[1] * (g[2] != 0)).numpy(),
                                      (c[1] * (c[2] != 0))[:, :k].numpy())
        assert not bool(c[2][:, k:].any())


FACTORS = [("iluk", (0,)), ("iluk", (1,)), ("iluk", (2,)),
           ("ilut", (10, 1e-3)), ("ilutp", (10, 1e-3, 0.05))]


@pytest.mark.parametrize("fn,args", FACTORS,
                         ids=[f"{f}{a}" for f, a in FACTORS])
def test_native_factors_bit_equal(fn, args):
    A = convdiff_2d(14, 30.0, 30.0 / 2)
    got = getattr(native, fn)(A, *args)
    ref = getattr(jax_native, fn)(_j(A), *args)
    for g, r in zip(got[:2], ref[:2]):
        _same_csr(g, r)
    if fn == "ilutp":
        np.testing.assert_array_equal(got[2], ref[2])


def test_level_schedule_native_against_numpy(monkeypatch):
    A = poisson_2d(9)
    L = sp.tril(A.to_scipy()).tocsr()
    depth, nlev = native.level_schedule(L.indptr, L.indices, A.nrow, True)
    ref, jnlev = jax_native.level_schedule(L.indptr, L.indices, A.nrow, True)
    np.testing.assert_array_equal(depth, ref)
    assert nlev == jnlev == 17
    for lower, T in ((True, L), (False, L.T.tocsr())):
        want = ilu._level_depth(T.indptr, T.indices, A.nrow, lower)
        monkeypatch.setattr(native, "level_schedule", lambda *a: None)
        np.testing.assert_array_equal(
            ilu._level_depth(T.indptr, T.indices, A.nrow, lower), want)
        monkeypatch.undo()
        jrows = jax_ilu._level_schedule(T, lower)
        assert len(jrows) == want.max() + 1
        for lv, rows in enumerate(jrows):
            np.testing.assert_array_equal(np.nonzero(want == lv)[0], rows)


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_triangular_solver_exact_on_a_small_factor(lower):
    rng = np.random.default_rng(3)
    n = 60
    T = sp.random(n, n, density=0.1, random_state=3, format="csr")
    T = (sp.tril(T, -1) if lower else sp.triu(T, 1)) + sp.diags(
        2.0 + rng.random(n))
    T = T.tocsr()
    b = rng.standard_normal(n)
    ts = TriangularSolver.from_sparse(T, lower)
    ref = jax_ilu.TriangularSolver.from_sparse(T, lower, dtype=jnp.float64)
    x = ts(torch.from_numpy(b))
    assert _rel(x, spla.spsolve_triangular(T, b, lower=lower)) < 1e-13
    assert _rel(x, jax.jit(lambda v: ref(v))(jnp.asarray(b))) < 1e-13
    conv = from_jax(ref)
    _same_levels(ts, conv)
    np.testing.assert_array_equal(conv(torch.from_numpy(b)).numpy(),
                                  x.numpy())


def test_triangular_solver_past_the_jax_scan_threshold():
    """ILU(0) of a 40 x 40 grid has 79 levels: the JAX solver runs them
    as scan segments with padded rows; the port's loop over plain levels
    and the converted JAX solver give its result."""
    A = poisson_2d(40)
    L, U = native.iluk(A, 0)
    b = np.random.default_rng(5).standard_normal(A.nrow)
    for T, lower in ((L, True), (U, False)):
        ref = jax_ilu.TriangularSolver.from_sparse(T, lower,
                                                   dtype=jnp.float64)
        assert any(type(s).__name__ == "_TriScan" for s in ref.segments)
        ts = TriangularSolver.from_sparse(T, lower)
        assert ts.num_levels == 79
        conv = from_jax(ref)
        _same_levels(ts, conv)
        want = jax.jit(lambda v: ref(v))(jnp.asarray(b))
        x = ts(torch.from_numpy(b))
        assert _rel(x, want) < 1e-12
        assert _rel(conv(torch.from_numpy(b)), want) < 1e-12
        assert _rel(x, spla.spsolve_triangular(T.tocsr(), b, lower=lower)) \
            < 1e-12


SETUPS = [dict(ILU_type=1, ILU_lfil=0), dict(ILU_type=1, ILU_lfil=1),
          dict(ILU_type=1, ILU_lfil=2), dict(ILU_type=2, ILU_droptol=1e-3),
          dict(ILU_type=3, ILU_droptol=1e-3, ILU_permtol=0.05)]


@pytest.mark.parametrize("kw", SETUPS, ids=[
    "ILUk0", "ILUk1", "ILUk2", "ILUt", "ILUtp"])
def test_setup_ilu_matches_jax(kw):
    """The factors' level arrays equal the JAX package's; one apply to
    1e-12; M A is closer to the identity than A."""
    A = convdiff_2d(12, 20.0, 20.0 / 2)
    M = setup_ilu(A, ILUParam(**kw))
    ref = jax_ilu.setup_ilu(_j(A), jax_params.ILUParam(**kw),
                            dtype=jnp.float64)
    conv = from_jax(ref)
    _same_levels(M.Lsolve, conv.Lsolve)
    _same_levels(M.Usolve, conv.Usolve)
    for name in ("perm_in", "perm_out"):
        g, c = getattr(M, name), getattr(conv, name)
        assert (g is None) == (c is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), c.numpy())
    assert (M.perm_out is not None) == (kw["ILU_type"] == 3)
    r = np.random.default_rng(8).standard_normal(A.nrow)
    z = M(torch.from_numpy(r))
    assert _rel(z, jax.jit(lambda v: ref(v))(jnp.asarray(r))) < 1e-12
    assert np.linalg.norm(A.matvec(z.numpy()) - r) < 0.5 * np.linalg.norm(r)


def test_setup_ilu_in_f32():
    A = poisson_2d(10)
    M = setup_ilu(A, dtype=torch.float32, device="cpu")
    assert all(t.dtype in (torch.float32, torch.int32, torch.int64)
               for t in M.buffers())
    z = M(torch.ones(A.nrow, dtype=torch.float32))
    assert z.dtype == torch.float32
    assert _rel(z, setup_ilu(A)(torch.ones(A.nrow, dtype=torch.float64))) \
        < 1e-5


@pytest.mark.parametrize("lfil", [0, 1])
def test_python_iluk_fallback_agrees_with_native(lfil, monkeypatch):
    A = convdiff_2d(8, 10.0, 10.0 / 2)
    L, U = native.iluk(A, lfil)
    Lp, Up = ilu.iluk_factor(A, lfil)
    assert abs(L - Lp).max() < 1e-13 * abs(L).max()
    assert abs(U - Up).max() < 1e-13 * abs(U).max()
    monkeypatch.setattr(native, "iluk", lambda *a: None)
    M = setup_ilu(A, ILUParam(ILU_lfil=lfil))
    r = np.ones(A.nrow)
    monkeypatch.undo()
    assert _rel(M(torch.from_numpy(r)),
                setup_ilu(A, ILUParam(ILU_lfil=lfil))(torch.from_numpy(r))) \
        < 1e-12


def test_scipy_fallbacks_without_the_native_library(monkeypatch):
    """ILUt and ILUtp through SuperLU when the library is unavailable:
    usable preconditioners, the pivoted one with both permutations."""
    A = convdiff_2d(10, 10.0, 10.0 / 2)
    for name in ("iluk", "ilut", "ilutp", "level_schedule"):
        monkeypatch.setattr(native, name, lambda *a: None)
    r = np.random.default_rng(9).standard_normal(A.nrow)
    for t in (2, 3):
        M = setup_ilu(A, ILUParam(ILU_type=t, ILU_droptol=1e-4))
        assert (M.perm_in is not None) == (t == 3)
        z = M(torch.from_numpy(r)).numpy()
        assert np.linalg.norm(A.matvec(z) - r) < 0.2 * np.linalg.norm(r)


def test_block_ilu0_matches_jax_and_numpy():
    A = block_poisson_3d(5, nb=3)
    Aj = JaxBSRMatrix(A.indptr, A.indices, A.data, A.shape)
    M = setup_bsr_ilu0(A)
    ref = jax_ilu.setup_bsr_ilu0(Aj, dtype=jnp.float64)
    conv = from_jax(ref)
    for got, want in ((M.Lsolve, conv.Lsolve), (M.Usolve, conv.Usolve)):
        assert got.sizes == want.sizes
        for g, c in zip(got.level_arrays(), want.level_arrays()):
            for a, b in zip(g[:3], c[:3]):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert M.Lsolve.dinv is None and conv.Lsolve.dinv is None
    np.testing.assert_array_equal(M.Usolve.dinv.numpy(),
                                  conv.Usolve.dinv.numpy())
    r = np.random.default_rng(10).standard_normal(A.nrow)
    z = M(torch.from_numpy(r))
    assert _rel(z, jax.jit(lambda v: ref(v))(jnp.asarray(r))) < 1e-12
    assert _rel(conv(torch.from_numpy(r)), z) < 1e-13
    # the native block factorization against its NumPy twin
    n, nb = A.nrow_block, A.nb
    fv, dinv = native.bsr_ilu0(A.indptr, A.indices, A.data, n, nb)
    pv, pdinv = ilu._bsr_ilu0_py(n, nb, A.indptr, A.indices, A.data)
    np.testing.assert_allclose(fv, pv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dinv, pdinv, rtol=0, atol=1e-12)


def test_block_ilu0_raises_on_a_missing_diagonal_block():
    A = block_poisson_3d(3, nb=2)
    rows = np.repeat(np.arange(A.nrow_block), np.diff(A.indptr))
    keep = ~((rows == 4) & (A.indices == 4))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows[keep], minlength=A.nrow_block))])
    B = type(A)(indptr, A.indices[keep], A.data[keep], A.shape)
    with pytest.raises(FaspError, match="block ILU"):
        setup_bsr_ilu0(B)


def test_apply_on_the_cpu_is_the_eager_loop_and_a_move_drops_the_graph():
    A = poisson_2d(8)
    M = setup_ilu(A)
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(A.nrow))
    np.testing.assert_array_equal(M(r).numpy(), M.eager(r).numpy())
    assert M._graph is None and M.num_levels == 2 * 15
    views = M.Lsolve.levels()
    M._graph = ("stale",)
    M.to(torch.float64)
    assert M._graph is None and M.Lsolve._views is None
    assert M.Lsolve.levels() is not views


_CG = dict(itsolver_type=1, tol=1e-8, maxit=500)
_GMRES = dict(itsolver_type=4, tol=1e-8, maxit=500, restart=30)
ILU_DRIVERS = [
    ("krylov_ilu", _CG, dict(ILU_type=1, ILU_lfil=0)),
    ("krylov_ilu", _CG, dict(ILU_type=1, ILU_lfil=1)),
    ("krylov_ilu", _GMRES, dict(ILU_type=2, ILU_droptol=1e-3)),
    ("krylov_ilu", _GMRES, dict(ILU_type=3, ILU_droptol=1e-3)),
    ("krylov_ilu_m", _CG, dict(ILU_type=1, ILU_lfil=0)),
]


@pytest.mark.parametrize("driver,its,kw", ILU_DRIVERS, ids=[
    "CG+ILUk0", "CG+ILUk1", "GMRES+ILUt", "GMRES+ILUtp", "CG+ILU-M"])
def test_ilu_drivers_match_jax(driver, its, kw):
    A, b, _ = poisson_2d_manufactured(24)
    got = getattr(solvers, driver)(A, b, its=ITSParam(**its),
                                   ilu=ILUParam(**kw), device="cpu")
    ref = getattr(jax_solvers, driver)(_j(A), b,
                                       its=jax_params.ITSParam(**its),
                                       ilu=jax_params.ILUParam(**kw))
    assert (got.iters, got.status, got.converged) == \
        (int(ref.iters), int(ref.status), bool(ref.converged))
    assert got.converged
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)


def test_ilu_drivers_apply_a_grid_matrix_through_the_stencil_operator():
    from faspsolver_tpu_torch.ops.operators import StencilNdOperator
    seen = []
    orig = solvers.drivers.itsolver
    A, b, _ = poisson_2d_manufactured(24)
    try:
        solvers.drivers.itsolver = lambda op, *a, **k: (
            seen.append(op), orig(op, *a, **k))[1]
        solvers.krylov_ilu(A, b, device="cpu")
    finally:
        solvers.drivers.itsolver = orig
    assert isinstance(seen[0], StencilNdOperator)


@pytest.mark.parametrize("driver", ["krylov_ilu", "krylov_ilu_m"])
def test_ilu_drivers_raise_without_a_cuda_device(driver, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b, _ = poisson_2d_manufactured(8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(solvers, driver)(A, b)


def _cli(fn, argv, capsys):
    rc = fn(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Number of iterations")]
    assert len(lines) == 1
    words = lines[0].rstrip(".").split()
    return rc, int(words[4]), float(words[-1])


def test_cli_precond_ilu_matches_jax(capsys):
    argv = ["-ini", "ini/input.dat", "-precond", "4", "-problem",
            "poisson2d", "-size", "31"]
    rc, iters, relres = _cli(main, argv + ["-device", "cpu"], capsys)
    jrc, jiters, jrelres = _cli(jax_main, argv, capsys)
    assert (rc, iters) == (jrc, jiters) and rc == 0
    assert np.isclose(relres, jrelres, rtol=1e-6, atol=1e-13)
