"""The slice end to end on the CPU: f32 structured SA-AMG hierarchy with
its f64 fine operator, f64 refinement around f32 AMG-PCG, tol 1e-10 on
poisson_2d(191) — the port against the JAX package.

Rounds must be equal.  Total inner iterations may differ by +-2: the f32
dot products and restrictions sum in another order under XLA than under
torch, which moves the f32 PCG's residual history by rounding.  Both
solutions are verified on the host in f64 against the exact b."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faspsolver_tpu.constants import SmootherType
from faspsolver_tpu.precond.amg import setup_structured as jax_setup
from faspsolver_tpu.solvers import solve_refined_resident as jax_refined
from faspsolver_tpu.testgen import poisson_2d
from faspsolver_tpu.utils.params import AMGParam
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.precond import AMGPrecond
from faspsolver_tpu_torch.precond.amg import setup_structured
from faspsolver_tpu_torch.solvers import (make_resident_refiner,
                                          solve_refined,
                                          solve_refined_device,
                                          solve_refined_resident)

torch.set_num_threads(2)

TOL = 1e-10
PARAM = AMGParam(smoother=int(SmootherType.CHEBYSHEV), polynomial_degree=2,
                 coarse_dof=800, tentative_smooth=0.67)
A = poisson_2d(191)
B_ONES = A.matvec(np.ones(A.nrow))
B_RAND = A.matvec(np.random.default_rng(31).standard_normal(A.nrow))


def _host_relres(x, b):
    return float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def jax_hier():
    return jax_setup(A, PARAM, dtype=jnp.float32, smooth_p=True,
                     keep_f64_fine=True)


@pytest.fixture(scope="module")
def port_hier():
    hier = setup_structured(A, PARAM, dtype=torch.float32, smooth_p=True,
                            keep_f64_fine=True)
    assert hier.levels[0].A.dtype == torch.float32
    assert hier.fine64.dtype == torch.float64
    return hier


@pytest.mark.parametrize("rhs", ["ones", "random"])
def test_refined_solve_matches_jax(jax_hier, port_hier, rhs):
    """The port's own setup + refinement against the JAX package's."""
    b = B_ONES if rhs == "ones" else B_RAND
    ref = jax_refined(jax_hier, b, tol=TOL)
    got = solve_refined_resident(port_hier, b, tol=TOL)
    assert got.converged and ref.converged
    assert got.rounds == ref.rounds
    assert abs(got.inner_iters - ref.inner_iters) <= 2
    assert _host_relres(got.x, b) < TOL
    assert _host_relres(ref.x, b) < TOL
    # the device-reported f64 relres is the true residual
    host = _host_relres(got.x, b)
    assert abs(host - got.relres) <= 1e-12 + 1e-6 * host


def test_refined_solve_on_converted_hierarchy(jax_hier):
    """The port's refinement on exactly the hierarchy JAX built."""
    ref = jax_refined(jax_hier, B_ONES, tol=TOL)
    hier = from_jax(jax_hier)
    run = make_resident_refiner(hier.fine64, hier.levels[0].A,
                                AMGPrecond(hier), tol=TOL)
    out = run(torch.from_numpy(B_ONES))
    assert out.rounds == ref.rounds
    assert abs(out.iters - ref.inner_iters) <= 2
    assert out.x.dtype == torch.float64
    assert _host_relres(out.x.numpy(), B_ONES) < TOL
    # each round reads the f64 residual once, each PCG iteration once
    assert out.syncs >= out.rounds + out.iters


def test_headline_tolerance_and_round_cap(port_hier):
    """The headline's settings (tol 1e-6, 4 rounds, 40 inner iterations)
    converge in one or two rounds; a 1-round cap stops early and reports
    the true residual."""
    got = solve_refined_resident(port_hier, B_ONES, tol=1e-6, max_rounds=4,
                                 maxit_inner=40)
    assert got.converged and got.rounds <= 2
    assert _host_relres(got.x, B_ONES) < 1e-6
    capped = solve_refined_resident(port_hier, B_ONES, tol=1e-14,
                                    max_rounds=1)
    assert capped.rounds == 1 and not capped.converged
    assert abs(_host_relres(capped.x, B_ONES) - capped.relres) <= \
        1e-6 * capped.relres


def _reservoir_pair():
    """The reservoir stanza at a small size in both packages: a BSR
    matrix, the f32 UA-BSR hierarchy (VMB, coarse_dof 30, strong_coupled
    0.08, GS 2 + 2 sweeps) and vFGMRES(30) as the inner solver."""
    from faspsolver_tpu.formats import BSRMatrix as JaxBSRMatrix
    from faspsolver_tpu.krylov import vfgmres as jax_vfgmres
    from faspsolver_tpu.ops.operators import device_operator as jax_operator
    from faspsolver_tpu.precond import AMGPrecond as JaxAMGPrecond
    from faspsolver_tpu.precond.amg.setup_bsr import \
        setup_ua_bsr as jax_setup_ua_bsr
    from faspsolver_tpu_torch.krylov import vfgmres
    from faspsolver_tpu_torch.ops.operators import device_operator
    from faspsolver_tpu_torch.precond.amg import setup_ua_bsr
    from faspsolver_tpu_torch.testgen import block_poisson_3d
    from faspsolver_tpu_torch.utils.params import AMGParam as PortAMGParam
    kw = dict(AMG_type=3, aggregation_type=2, coarse_dof=30,
              strong_coupled=0.08, smoother=2, presmooth_iter=2,
              postsmooth_iter=2)
    Ab = block_poisson_3d(8, nb=3)
    Aj = JaxBSRMatrix(Ab.indptr, Ab.indices, Ab.data, Ab.shape)
    b = Ab.matvec(np.random.default_rng(17).standard_normal(Ab.nrow))
    hier = setup_ua_bsr(Ab, PortAMGParam(**kw), dtype=torch.float32)
    op, M = device_operator(Ab, dtype=torch.float32), AMGPrecond(hier)
    jh = jax_setup_ua_bsr(Aj, AMGParam(**kw), dtype=jnp.float32)
    jop, jM = jax_operator(Aj, dtype=jnp.float32), JaxAMGPrecond(jh)

    def inner(r, tol):
        return vfgmres(op, r, M=M, tol=tol, maxit=100, restart=30)

    def jinner(r, tol):
        return jax_vfgmres(jop, r, M=jM, tol=tol, maxit=100, restart=30)

    return Ab, Aj, b, inner, jinner


@pytest.mark.parametrize("tol,max_rounds", [(1e-6, 4), (1e-10, 6), (1e-12, 1)])
def test_solve_refined_matches_jax(tol, max_rounds):
    """Host-loop refinement around f32 vFGMRES + UA-BSR AMG: rounds
    equal, inner totals within 2, the f64 residual verified."""
    from faspsolver_tpu.solvers import solve_refined as jax_solve_refined
    Ab, Aj, b, inner, jinner = _reservoir_pair()
    got = solve_refined(Ab, b, inner, tol=tol, max_rounds=max_rounds,
                        device="cpu")
    ref = jax_solve_refined(Aj, b, jinner, tol=tol, max_rounds=max_rounds)
    assert (got.converged, got.rounds) == (ref.converged, ref.rounds)
    assert abs(got.inner_iters - ref.inner_iters) <= 2
    relres = float(np.linalg.norm(b - Ab.matvec(got.x)) / np.linalg.norm(b))
    assert abs(relres - got.relres) <= 1e-12 + 1e-6 * relres
    assert (relres < tol) == got.converged == (max_rounds > 1)
    assert got.syncs >= got.rounds + got.inner_iters


def test_solve_refined_device_matches_jax():
    """The device-resident form around the same inner solver, its f64
    operator a BsrEllOperator."""
    from faspsolver_tpu.ops.operators import device_operator as jax_operator
    from faspsolver_tpu.solvers import \
        solve_refined_device as jax_solve_refined_device
    from faspsolver_tpu_torch.ops.operators import device_operator
    Ab, Aj, b, inner, jinner = _reservoir_pair()
    got = solve_refined_device(device_operator(Ab), b, inner, tol=1e-9)
    ref = jax_solve_refined_device(jax_operator(Aj, dtype=jnp.float64), b,
                                   jinner, tol=1e-9)
    assert got.converged and ref.converged and got.rounds == ref.rounds
    assert abs(got.inner_iters - ref.inner_iters) <= 2
    assert float(np.linalg.norm(b - Ab.matvec(got.x))
                 / np.linalg.norm(b)) < 1e-9


def test_solve_refined_needs_a_host_matrix_and_a_device(monkeypatch):
    Ab, _, b, inner, _ = _reservoir_pair()
    with pytest.raises(TypeError, match="host matrix"):
        solve_refined(object(), b, inner, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        solve_refined(Ab, b, inner)
