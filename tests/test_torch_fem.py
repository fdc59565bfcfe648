"""The port's P1-FE problem generator against the JAX package's, and the
FE matrix through the structured setup (the fe_auto path).

unit_square_mesh(65) assembles bit-equal.  On unit_square_mesh(256)
(65,025 dof) the FE stencil's 7 bands all factor, so the f64 fine
operator is a factored StencilNdOperator as at full size; there the port's
own f64 structured hierarchy gives the JAX package's AMG-PCG iteration
count and status.  On unit_square_mesh(193) the f64 factors exceed 1 MB,
and neither package attaches a fine64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native

from faspsolver_tpu.constants import SmootherType
from faspsolver_tpu.krylov import pcg as jax_pcg
from faspsolver_tpu.precond import AMGPrecond as JaxAMGPrecond
from faspsolver_tpu.precond.amg import setup_structured as jax_setup
from faspsolver_tpu.testgen import assemble_poisson as jax_assemble
from faspsolver_tpu.testgen import unit_square_mesh as jax_mesh
from faspsolver_tpu.utils.params import AMGParam as JaxAMGParam
from faspsolver_tpu_torch.krylov import pcg
from faspsolver_tpu_torch.ops.operators import FactoredBand
from faspsolver_tpu_torch.precond import AMGPrecond
from faspsolver_tpu_torch.precond.amg import setup_structured
from faspsolver_tpu_torch.solvers import solve_refined_resident
from faspsolver_tpu_torch.testgen import assemble_poisson, unit_square_mesh
from faspsolver_tpu_torch.utils.params import AMGParam

torch.set_num_threads(2)
ensure_native()

# the headline's structured SA-AMG settings, which fe_auto reuses
KW = dict(smoother=int(SmootherType.CHEBYSHEV), polynomial_degree=2,
          coarse_dof=800, tentative_smooth=0.67)


def _ones(p):
    return np.ones(len(p))


def _fe(m):
    A, b, _ = assemble_poisson(unit_square_mesh(m), _ones)
    return A, b


@pytest.mark.parametrize("m", [2, 9, 65])
def test_mesh_and_assembly_bit_equal(m):
    mesh, ref_mesh = unit_square_mesh(m), jax_mesh(m)
    np.testing.assert_array_equal(mesh.nodes, ref_mesh.nodes)
    np.testing.assert_array_equal(mesh.elems, ref_mesh.elems)
    assert mesh.elems.dtype == ref_mesh.elems.dtype
    np.testing.assert_array_equal(mesh.boundary, ref_mesh.boundary)

    def f(p):
        return 1.0 + p[:, 0] * p[:, 1]

    def u(p):
        return p[:, 0] - 2.0 * p[:, 1]

    A, b, dofs = assemble_poisson(mesh, f, u)
    Ar, br, dofs_r = jax_assemble(ref_mesh, f, u)
    for got, ref in ((A.indptr, Ar.indptr), (A.indices, Ar.indices),
                     (A.data, Ar.data), (b, br), (dofs, dofs_r)):
        np.testing.assert_array_equal(got, ref)
    assert A.shape == Ar.shape == ((m - 1) ** 2, (m - 1) ** 2)


def test_stencil_counts_reach_the_full_size():
    """The assembled matrix is the 7-point FE stencil on the interior
    grid (centre, four axis neighbours, the (+1,+1)/(-1,-1) pair), so
    unit_square_mesh(1024) is the stored-baseline problem: 1,046,529 dofs
    and 7,317,521 nonzeros."""
    def nnz(n):
        return n * n + 4 * n * (n - 1) + 2 * (n - 1) ** 2

    for m in (9, 65):
        A, _ = _fe(m)
        assert A.nnz == nnz(m - 1)
    assert (1023 ** 2, nnz(1023)) == (1_046_529, 7_317_521)


@pytest.fixture(scope="module")
def fe256():
    A, b = _fe(256)
    ref = jax_setup(A, JaxAMGParam(**KW), dtype=jnp.float64, smooth_p=True,
                    keep_f64_fine=True)
    got = setup_structured(A, AMGParam(**KW), dtype=torch.float64,
                           smooth_p=True, keep_f64_fine=True)
    return A, b, ref, got


def test_fe_auto_levels_and_fine64(fe256):
    A, _, ref, got = fe256
    assert got.num_levels == len(ref.levels)
    for lg, lr in zip(got.levels, ref.levels):
        assert type(lg.A).__name__ == type(lr.A).__name__
        assert lg.A.shape == lr.A.shape
    for op in (got.levels[0].A, got.fine64):
        assert type(op).__name__ == "StencilNdOperator"
        assert len(op.bands) == 7
        assert all(isinstance(b, FactoredBand) for b in op.bands)
    assert got.fine64.device_bytes == ref.fine64.device_bytes == 16_488
    x = np.random.default_rng(4).standard_normal(A.nrow)
    np.testing.assert_allclose(got.fine64(torch.from_numpy(x)).numpy(),
                               A.matvec(x), rtol=0, atol=1e-13)


def test_fe_auto_f64_pcg_iterations_equal(fe256):
    A, b, ref, got = fe256
    r_ref = jax_pcg(ref.levels[0].A, jnp.asarray(b), M=JaxAMGPrecond(ref),
                    tol=1e-8, maxit=100)
    r = pcg(got.levels[0].A, torch.from_numpy(b), M=AMGPrecond(got),
            tol=1e-8, maxit=100)
    assert r.iters == int(r_ref.iters)
    assert r.status == int(r_ref.status)
    assert r.converged
    x_ref = np.asarray(r_ref.x)
    assert np.linalg.norm(r.x.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_fe_auto_without_fine64_past_the_1mb_cut():
    """At 192^2 interior nodes the f64 stencil keeps dense bands (1.47 MB
    of factors), so neither package attaches a fine64 and the port's
    resident refinement refuses the hierarchy."""
    A, b = _fe(193)
    ref = jax_setup(A, JaxAMGParam(**KW), dtype=jnp.float32, smooth_p=True,
                    keep_f64_fine=True)
    got = setup_structured(A, AMGParam(**KW), dtype=torch.float32,
                           smooth_p=True, keep_f64_fine=True)
    assert ref.fine64 is None and got.fine64 is None
    assert type(got.levels[0].A).__name__ == type(ref.levels[0].A).__name__
    with pytest.raises(ValueError, match="no f64 fine operator"):
        solve_refined_resident(got, b)
