"""The port's block (BSR) path against the JAX package's (CPU).

BsrEllOperator, BlockJacobiPrecond and the block transfers apply within
rounding (f64 1e-13 relative, f32 1e-5); the block smoother's color
blocks, filled here with array operations, equal the JAX package's loop
array for array; the UA-BSR and SA-BSR hierarchies, near-kernel data
included, are equal buffer for buffer and one V-cycle agrees to 1e-12;
every BSR driver gives the JAX package's iterations and status with x
within 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from native_parity import ensure_native

import faspsolver_tpu.solvers.drivers as jax_solvers
from faspsolver_tpu.formats import BSRMatrix as JaxBSRMatrix
from faspsolver_tpu.krylov import BlockJacobiPrecond as JaxBlockJacobi
from faspsolver_tpu.ops.operators import BsrEllOperator as JaxBsrEll
from faspsolver_tpu.precond.amg import bsr_smoothers as jax_bsm
from faspsolver_tpu.precond.amg import setup_bsr as jax_setup_bsr
from faspsolver_tpu.precond.amg import transfer as jax_transfer
from faspsolver_tpu.precond.amg.cycles import mgcycle as jax_mgcycle
from faspsolver_tpu.utils import params as jax_params
import faspsolver_tpu_torch.solvers as solvers
from faspsolver_tpu_torch.constants import SmootherType
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.formats import BSRMatrix
from faspsolver_tpu_torch.krylov import BlockJacobiPrecond
from faspsolver_tpu_torch.ops.operators import (BsrEllOperator,
                                                device_operator)
from faspsolver_tpu_torch.precond.amg import (BlockAggProlong,
                                              BlockAggRestrict,
                                              build_bsr_smoother, mgcycle,
                                              setup_sa_bsr, setup_ua_bsr,
                                              smooth)
from faspsolver_tpu_torch.testgen import block_poisson_3d, poisson_2d
from faspsolver_tpu_torch.utils.params import AMGParam, ILUParam, ITSParam

torch.set_num_threads(2)
ensure_native()

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-13),
          "f32": (jnp.float32, torch.float32, 1e-5)}


def _random_bsr(n, nb, seed):
    """A random-pattern BSR matrix with ragged rows and dominant diagonal
    blocks."""
    rng = np.random.default_rng(seed)
    pat = (sp.random(n, n, density=0.05, random_state=seed, format="csr")
           + sp.eye(n)).tocsr()
    pat.sort_indices()
    data = rng.standard_normal((pat.nnz, nb, nb))
    rows = np.repeat(np.arange(n), np.diff(pat.indptr))
    data[rows == pat.indices] += 4.0 * nb * np.eye(nb)
    return BSRMatrix(pat.indptr, pat.indices, data, (n, n))


PROBLEMS = {"block_poisson_3d(8)": lambda: block_poisson_3d(8, nb=3),
            "block_poisson_3d(12)": lambda: block_poisson_3d(12, nb=3),
            "random nb=2": lambda: _random_bsr(150, 2, 5),
            "random nb=4": lambda: _random_bsr(90, 4, 6)}


def _j(A):
    return JaxBSRMatrix(A.indptr, A.indices, A.data, A.shape)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def assert_same_buffers(got, ref):
    """The port's module against the JAX object carried across: the same
    module tree with equal buffers."""
    conv = from_jax(ref)
    gb = dict(got.named_buffers(remove_duplicate=False))
    cb = dict(conv.named_buffers(remove_duplicate=False))
    assert gb.keys() == cb.keys()
    for k in gb:
        assert gb[k].dtype == cb[k].dtype, k
        np.testing.assert_array_equal(gb[k].numpy(), cb[k].numpy(), err_msg=k)
    assert [type(m).__name__ for m in got.modules()] == \
        [type(m).__name__ for m in conv.modules()]
    return conv


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_bsr_ell_apply_matches_jax(problem, dt):
    jdt, tdt, tol = DTYPES[dt]
    A = PROBLEMS[problem]()
    op = device_operator(A, dtype=tdt)
    ref = JaxBsrEll.from_bsr(_j(A), dtype=jdt)
    assert isinstance(op, BsrEllOperator) and op.dtype == tdt
    assert op.shape == ref.shape and (op.nbrow, op.nb) == (ref.nbrow, ref.nb)
    np.testing.assert_array_equal(op.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(op.vals.numpy(), np.asarray(ref.vals))
    x = np.random.default_rng(1).standard_normal(A.nrow)
    y = op(torch.from_numpy(x).to(tdt))
    assert _rel(y, ref(jnp.asarray(x, dtype=jdt))) < tol
    assert _rel(y, A.matvec(x)) < 10 * tol


def test_f32_block_products_stay_out_of_tf32():
    A = block_poisson_3d(4, nb=3)
    torch.backends.cuda.matmul.allow_tf32 = True
    device_operator(A, dtype=torch.float32)(torch.ones(A.nrow,
                                                       dtype=torch.float32))
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_diag_blocks_keep_the_first_diagonal_entry():
    """The vectorized extraction against the row loop, with a row that
    has no diagonal block and one that stores it twice."""
    indptr = np.array([0, 2, 3, 6])
    indices = np.array([0, 1, 2, 2, 0, 2])
    data = np.arange(6 * 4, dtype=np.float64).reshape(6, 2, 2)
    A = BSRMatrix(indptr, indices, data, (3, 3))
    want = np.zeros((3, 2, 2))
    want[0], want[2] = data[0], data[3]
    np.testing.assert_array_equal(A.diag_blocks(), want)
    B = block_poisson_3d(5, nb=3)
    np.testing.assert_array_equal(B.diag_blocks(), _j(B).diag_blocks())


@pytest.mark.parametrize("problem", ["block_poisson_3d(8)", "random nb=2"])
def test_block_jacobi_and_block_transfers_match_jax(problem):
    A = PROBLEMS[problem]()
    rng = np.random.default_rng(2)
    r = rng.standard_normal(A.nrow)
    M, Mj = BlockJacobiPrecond.from_bsr(A), JaxBlockJacobi.from_bsr(_j(A))
    assert_same_buffers(M, Mj)
    assert _rel(M(torch.from_numpy(r)), Mj(jnp.asarray(r))) < 1e-13
    nagg = A.nrow_block // 4
    agg = rng.integers(0, nagg, A.nrow_block).astype(np.int32)
    dims = (A.nrow_block, nagg, A.nb)
    xc = rng.standard_normal(nagg * A.nb)
    P, R = BlockAggProlong(agg, *dims), BlockAggRestrict(agg, *dims)
    Pj = jax_transfer.BlockAggProlong(jnp.asarray(agg), *dims)
    Rj = jax_transfer.BlockAggRestrict(jnp.asarray(agg), *dims)
    assert (P.shape, R.shape) == (Pj.shape, Rj.shape)
    np.testing.assert_array_equal(P(torch.from_numpy(xc)).numpy(),
                                  np.asarray(Pj(jnp.asarray(xc))))
    assert _rel(R(torch.from_numpy(r)), Rj(jnp.asarray(r))) < 1e-13


KINDS = {"GS": SmootherType.GS, "SGS": SmootherType.SGS,
         "SOR": SmootherType.SOR, "JACOBI": SmootherType.JACOBI}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("problem", ["block_poisson_3d(8)", "random nb=2",
                                     "random nb=4"])
def test_block_smoother_arrays_and_sweeps_match_jax(problem, kind):
    """The vectorized color blocks equal the JAX package's loop, array
    for array; forward, backward and (SGS) symmetric sweeps agree."""
    A = PROBLEMS[problem]()
    relax = 1.2 if kind == "SOR" else 1.0
    sm = build_bsr_smoother(A, int(KINDS[kind]), relax=relax)
    ref = jax_bsm.build_bsr_smoother(_j(A), int(KINDS[kind]), relax=relax,
                                     dtype=jnp.float64)
    assert_same_buffers(sm, ref)
    assert (sm.kind, sm.relax, sm.nb) == (ref.kind, ref.relax, ref.nb)
    assert len(sm.colors) == len(ref.colors)
    for blk, rb in zip(sm.colors, ref.colors):
        np.testing.assert_array_equal(blk.vals.numpy(), np.asarray(rb.vals))
    op, opj = device_operator(A), JaxBsrEll.from_bsr(_j(A), dtype=jnp.float64)
    rng = np.random.default_rng(4)
    x, b = rng.standard_normal((2, A.nrow))
    for forward in (True, False):
        got = smooth(sm, op, torch.from_numpy(x), torch.from_numpy(b), 2,
                     forward)
        want = jax.jit(lambda u, v: jax_bsm.bsr_smooth(
            ref, opj, u, v, 2, forward))(jnp.asarray(x), jnp.asarray(b))
        assert _rel(got, want) < 1e-13


HIER_PARAMS = {
    "VMB": dict(aggregation_type=2, coarse_dof=30, strong_coupled=0.08,
                smoother=int(SmootherType.GS)),
    "PAIRWISE": dict(aggregation_type=1, coarse_dof=90,
                     smoother=int(SmootherType.SGS), presmooth_iter=2,
                     postsmooth_iter=2, coarse_scaling=1),
}
SETUPS = {"ua": (setup_ua_bsr, jax_setup_bsr.setup_ua_bsr),
          "sa": (setup_sa_bsr, jax_setup_bsr.setup_sa_bsr)}


def _component_basis(A):
    B = np.zeros((A.nrow, A.nb))
    for c in range(A.nb):
        B[c::A.nb, c] = 1.0
    return B


@pytest.mark.parametrize("nk", [False, True], ids=["plain", "near-kernel"])
@pytest.mark.parametrize("agg", list(HIER_PARAMS))
@pytest.mark.parametrize("which", list(SETUPS))
def test_bsr_hierarchies_equal_jax(which, agg, nk):
    """Level count, block sizes, coarse blocks, smoothers, transfers and
    per-level near-kernel B / Ainv equal in f64; one cycle (run where it
    includes the near-kernel correction) to 1e-12."""
    A = block_poisson_3d(6, nb=3)
    mine, theirs = SETUPS[which]
    B = _component_basis(A) if nk else None
    got = mine(A, AMGParam(**HIER_PARAMS[agg]), nk=B)
    ref = theirs(_j(A), jax_params.AMGParam(**HIER_PARAMS[agg]),
                 dtype=jnp.float64, nk=B)
    assert got.num_levels == ref.num_levels >= 2
    assert_same_buffers(got, ref)
    for lg, lr in zip(got.levels, ref.levels):
        assert lg.A.shape == lr.A.shape and lg.A.nb == lr.A.nb == 3
        assert (lg.nk is not None) == (lr.nk is not None) == nk
    for f in ("cycle_type", "presmooth_iter", "postsmooth_iter",
              "coarse_scaling", "amli_degree", "amli_coefs"):
        assert getattr(got, f) == getattr(ref, f), f
    if nk:
        b = np.random.default_rng(7).standard_normal(A.nrow)
        want = jax.jit(lambda v: jax_mgcycle(ref, v))(jnp.asarray(b))
        assert _rel(mgcycle(got, torch.from_numpy(b)), want) < 1e-12


def test_bsr_setup_in_f32_and_on_a_device():
    A = block_poisson_3d(6, nb=3)
    hier = setup_ua_bsr(A, AMGParam(coarse_dof=30, aggregation_type=2),
                        dtype=torch.float32, device="cpu")
    assert all(t.dtype != torch.float64 for t in hier.buffers())
    z = mgcycle(hier, torch.ones(A.nrow, dtype=torch.float32))
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())


def test_nk_cycle_correction_projects_kernel():
    """After one V-cycle on r = A B e_0 the near-kernel solve leaves no
    residual along the basis (tests/test_drivers.py's check of the JAX
    cycle)."""
    Absr = BSRMatrix.from_csr(poisson_2d(16), nb=2)
    m = Absr.to_scipy().tocsr()
    B = np.zeros((m.shape[0], 2))
    B[0::2, 0] = 1.0
    B[1::2, 1] = 1.0
    h = setup_ua_bsr(Absr, AMGParam(coarse_dof=16, aggregation_type=2), nk=B)
    rhs = m @ B[:, 0]
    x = mgcycle(h, torch.from_numpy(rhs)).numpy()
    coef = np.linalg.solve(B.T @ (m @ B), B.T @ (rhs - m @ x))
    assert np.abs(coef).max() < 1e-8


_VFGMRES = dict(itsolver_type=6, tol=1e-9, maxit=100, restart=30)
BSR_DRIVERS = [
    ("krylov_amg", dict(its=_VFGMRES, amg=dict(
        AMG_type=3, aggregation_type=2, coarse_dof=30, strong_coupled=0.08,
        smoother=2, presmooth_iter=2, postsmooth_iter=2))),
    ("krylov_amg", dict(its=_VFGMRES, amg=dict(
        AMG_type=2, aggregation_type=2, coarse_dof=30, smoother=2))),
    ("krylov_nk_amg", dict(its=_VFGMRES, nk=True, amg=dict(
        AMG_type=3, aggregation_type=2, coarse_dof=30))),
    ("krylov_nk_amg", dict(its=_VFGMRES, nk=True, amg=dict(
        AMG_type=2, aggregation_type=2, coarse_dof=30))),
    ("krylov_amg_nk", dict(its=_VFGMRES, nk=True, amg=dict(
        AMG_type=3, aggregation_type=2, coarse_dof=30))),
    ("krylov_ilu", dict(its=dict(itsolver_type=4, tol=1e-9, maxit=200,
                                 restart=30))),
    ("krylov_ilu", dict(its=dict(itsolver_type=4, tol=1e-9, maxit=200,
                                 restart=30), ilu=dict(ILU_lfil=1))),
    ("krylov_diag", dict(its=dict(itsolver_type=1, tol=1e-9, maxit=500))),
    ("krylov", dict(its=dict(itsolver_type=1, tol=1e-9, maxit=500))),
]


def _driver_args(A, kw, pkg_params):
    out = {}
    if "its" in kw:
        out["its"] = pkg_params.ITSParam(**kw["its"])
    if "amg" in kw:
        out["amg"] = pkg_params.AMGParam(**kw["amg"])
    if "ilu" in kw:
        out["ilu"] = pkg_params.ILUParam(**kw["ilu"])
    return ([_component_basis(A)] if kw.get("nk") else []), out


@pytest.mark.parametrize("driver,kw", BSR_DRIVERS,
                         ids=[f"{d}-{i}" for i, (d, _)
                              in enumerate(BSR_DRIVERS)])
def test_bsr_drivers_match_jax(driver, kw):
    import faspsolver_tpu_torch.utils.params as port_params
    A = block_poisson_3d(6, nb=3)
    b = A.matvec(np.random.default_rng(11).standard_normal(A.nrow))
    extra, mine = _driver_args(A, kw, port_params)
    _, theirs = _driver_args(A, kw, jax_params)
    got = getattr(solvers, driver)(A, b, *extra, device="cpu", **mine)
    ref = getattr(jax_solvers, driver)(_j(A), b, *extra, **theirs)
    got = got[0] if isinstance(got, tuple) else got
    ref = ref[0] if isinstance(ref, tuple) else ref
    assert (got.iters, got.status, got.converged) == \
        (int(ref.iters), int(ref.status), bool(ref.converged))
    assert got.converged and got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)


NO_DEVICE = ["krylov", "krylov_diag", "krylov_amg", "krylov_ilu",
             "krylov_nk_amg", "krylov_amg_nk"]


@pytest.mark.parametrize("driver", NO_DEVICE)
def test_bsr_drivers_raise_without_a_cuda_device(driver, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = block_poisson_3d(4, nb=3)
    args = [A, np.ones(A.nrow)]
    if driver in ("krylov_nk_amg", "krylov_amg_nk"):
        args.append(_component_basis(A))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(solvers, driver)(*args)


def test_bsr_ilu_with_fill_takes_the_csr_expansion():
    """lfil > 0 on a BSR matrix factors its scalar expansion."""
    from faspsolver_tpu_torch.precond import ILUPrecond
    seen = []
    orig = solvers.drivers.itsolver
    A = block_poisson_3d(5, nb=2)
    try:
        solvers.drivers.itsolver = lambda *a, M=None, **k: (
            seen.append(M), orig(*a, M=M, **k))[1]
        res = solvers.krylov_ilu(A, np.ones(A.nrow), device="cpu",
                                 ilu=ILUParam(ILU_lfil=1),
                                 its=ITSParam(tol=1e-8))
    finally:
        solvers.drivers.itsolver = orig
    assert res.converged and isinstance(seen[0], ILUPrecond)
