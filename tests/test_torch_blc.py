"""The port's block-composite (BLC) family against the JAX package's
(f64, CPU).

BlcOperator applies to rounding, and is the permuted BSR operator of the
same matrix; the block preconditioner in its four modes (diag, lower,
upper, SGS; UA-AMG or Jacobi on the diagonal blocks) and the sweeping
preconditioner apply to 1e-13, set up by either package; krylov_block
and krylov_sweeping give the JAX package's iterations and status with x
within 1e-10, and the drivers that do not take a BLC matrix do what the
JAX package's do."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from native_parity import ensure_native
from small_grid_anchors import _to_jax

import chip_smoke
import faspsolver_tpu.solvers.drivers as jax_solvers
from faspsolver_tpu.precond import blc_precond as jax_blc
from faspsolver_tpu.utils import params as jax_params
import faspsolver_tpu_torch.solvers as solvers
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.formats import BLCMatrix, CSRMatrix
from faspsolver_tpu_torch.ops.operators import device_operator
from faspsolver_tpu_torch.precond import blc_precond as port_blc
from faspsolver_tpu_torch.testgen import poisson_2d
from faspsolver_tpu_torch.utils import FaspError, messages
from faspsolver_tpu_torch.utils.params import AMGParam, ITSParam

torch.set_num_threads(2)
ensure_native()

AMG = dict(coarse_dof=40)
MODES = ["diag", "lower", "upper", "sgs"]


def _saddle():
    """A 2 x 2 BLC with rectangular coupling blocks (after
    tests/test_formats_families.py:_make_blc)."""
    A11, A22 = poisson_2d(10), poisson_2d(7)
    B12 = CSRMatrix.from_scipy(sp.random(A11.nrow, A22.nrow, 0.02,
                                         random_state=1, format="csr") * 0.1)
    return BLCMatrix([[A11, B12], [B12.transpose(), A22]])


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_blc_operator_matches_jax_and_the_permuted_bsr():
    A, b = chip_smoke.blc_problem(5)
    x = np.random.default_rng(1).standard_normal(A.nrow)
    op = port_blc.BlcOperator.from_blc(A)
    ref = jax_blc.BlcOperator.from_blc(_to_jax(A), dtype=jnp.float64)
    y = op(torch.from_numpy(x))
    assert _rel(y, ref(jnp.asarray(x))) < 1e-14
    assert _rel(from_jax(ref)(torch.from_numpy(x)), ref(jnp.asarray(x))) \
        < 1e-14
    Ab, bb = chip_smoke.bsr_problem(5)
    ng = Ab.nrow_block
    field = x.reshape(3, ng).T.reshape(-1)       # BLC order -> BSR order
    yb = device_operator(Ab)(torch.from_numpy(field)).numpy()
    assert _rel(y, yb.reshape(ng, 3).T.reshape(-1)) < 1e-14
    assert np.array_equal(b, bb.reshape(ng, 3).T.reshape(-1))
    holes = _to_jax(chip_smoke.sweep_problem(8, 4)[0])
    assert holes.blocks[0][2] is None
    xs = np.random.default_rng(2).standard_normal(512)
    ref = jax_blc.BlcOperator.from_blc(holes, dtype=jnp.float64)
    assert _rel(from_jax(ref)(torch.from_numpy(xs)), ref(jnp.asarray(xs))) \
        < 1e-14


@pytest.mark.parametrize("mode", MODES)
def test_blc_preconditioner_matches_jax(mode):
    for A in (chip_smoke.blc_problem(5)[0], _saddle()):
        Aj = _to_jax(A)
        r = np.random.default_rng(3).standard_normal(A.nrow)
        for kind in ("amg", "diag"):
            M = port_blc.setup_blc_precond(A, mode=mode, diag_solver=kind,
                                           amg=AMGParam(**AMG))
            Mj = jax_blc.setup_blc_precond(
                Aj, mode=mode, diag_solver=kind,
                amg=jax_params.AMGParam(**AMG), dtype=jnp.float64)
            ref = Mj(jnp.asarray(r))
            assert _rel(M(torch.from_numpy(r)), ref) < 1e-13, kind
            assert _rel(from_jax(Mj)(torch.from_numpy(r)), ref) < 1e-13


def test_blc_sweeping_matches_jax():
    A, _ = chip_smoke.sweep_problem(8, 4)
    Aj = _to_jax(A)
    r = np.random.default_rng(4).standard_normal(A.nrow)
    M = port_blc.setup_blc_sweeping(A, amg=AMGParam(**AMG))
    Mj = jax_blc.setup_blc_sweeping(Aj, amg=jax_params.AMGParam(**AMG),
                                    dtype=jnp.float64)
    ref = Mj(jnp.asarray(r))
    assert _rel(M(torch.from_numpy(r)), ref) < 1e-13
    assert _rel(from_jax(Mj)(torch.from_numpy(r)), ref) < 1e-13
    with pytest.raises(ValueError, match="block-tridiagonal"):
        port_blc.setup_blc_sweeping(chip_smoke.blc_problem(3)[0])
    with pytest.raises(ValueError, match="square block grid"):
        port_blc.setup_blc_precond(BLCMatrix([[poisson_2d(3),
                                               poisson_2d(3)]]))


def _assert_same(got, ref):
    assert (got.iters, got.status, got.converged) == \
        (int(ref.iters), int(ref.status), bool(ref.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)


_ITS = dict(itsolver_type=6, tol=1e-10, maxit=300, restart=30)


@pytest.mark.parametrize("mode", MODES)
def test_krylov_block_matches_jax(mode):
    A, b = chip_smoke.blc_problem(5)
    got = solvers.krylov_block(A, b, its=ITSParam(**_ITS), mode=mode,
                               amg=AMGParam(**AMG), device="cpu")
    ref = jax_solvers.krylov_block(_to_jax(A), b,
                                   its=jax_params.ITSParam(**_ITS),
                                   mode=mode, amg=jax_params.AMGParam(**AMG))
    _assert_same(got, ref)
    assert np.linalg.norm(b - A.matvec(got.x.numpy())) \
        <= 1e-9 * np.linalg.norm(b)


def test_krylov_sweeping_matches_jax():
    A, b = chip_smoke.sweep_problem(8, 4)
    got = solvers.krylov_sweeping(A, b, its=ITSParam(**_ITS),
                                  amg=AMGParam(**AMG), device="cpu")
    ref = jax_solvers.krylov_sweeping(_to_jax(A), b,
                                      its=jax_params.ITSParam(**_ITS),
                                      amg=jax_params.AMGParam(**AMG))
    _assert_same(got, ref)


def test_other_drivers_on_blc_do_what_jax_does(monkeypatch):
    """krylov solves a BLC matrix; the diagonal, ILU and block-smoother
    drivers raise FaspError(-41); the AMG drivers raise the JAX
    package's TypeError and solve_amg falls back to GMRES."""
    A, b = chip_smoke.blc_problem(3)
    Aj = _to_jax(A)
    its = dict(tol=1e-10, maxit=300)
    _assert_same(solvers.krylov(A, b, its=ITSParam(**its), device="cpu"),
                 jax_solvers.krylov(Aj, b, its=jax_params.ITSParam(**its)))
    for fn in ("krylov_diag", "krylov_ilu", "krylov_blockgs"):
        with pytest.raises(FaspError):
            getattr(solvers, fn)(A, b, device="cpu")
        with pytest.raises(Exception, match="needs"):
            getattr(jax_solvers, fn)(Aj, b)
    for fn in ("krylov_amg", "solve_famg"):
        with pytest.raises(TypeError, match="cannot build device operator"):
            getattr(solvers, fn)(A, b, device="cpu")
        with pytest.raises(TypeError, match="cannot build device operator"):
            getattr(jax_solvers, fn)(Aj, b)
    warned = []
    monkeypatch.setattr(messages, "warn", warned.append)
    amg = dict(maxit=30, tol=1e-8)
    got = solvers.solve_amg(A, b, amg=AMGParam(**amg), device="cpu")
    ref = jax_solvers.solve_amg(Aj, b, amg=jax_params.AMGParam(**amg))
    _assert_same(got, ref)
    assert len(warned) == 1 and "falling back to GMRES" in warned[0]


def test_blc_modules_hold_every_block_and_move_together():
    """One .to() moves every block operator and diagonal solver: the
    preconditioner's buffers are all of one dtype after .float()."""
    A, _ = chip_smoke.sweep_problem(8, 4)
    M = port_blc.setup_blc_sweeping(A, amg=AMGParam(**AMG))
    assert sorted(M.lower) == sorted(M.upper) == ["0", "1", "2"]
    op = port_blc.BlcOperator.from_blc(A)
    assert len(op.ops) == 4 + 2 * 3 and op.block(0, 2) is None
    for mod in (M, op):
        mod.float()
        assert {t.dtype for t in mod.buffers()
                if t.is_floating_point()} == {torch.float32}
