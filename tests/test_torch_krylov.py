"""The port's Krylov family (BiCGstab, MINRES, GMRES, vGMRES, vFGMRES,
GCR, GCG) against the JAX package's, in f64 on the CPU.

Every method runs with no preconditioner, with Jacobi, and with an AMG
V-cycle built by the JAX package and carried across with ``from_jax``,
on the 2-D Poisson matrix and on a nonsymmetric convection-diffusion
matrix (31^2 = 961 dof): equal iterations and status, x within 1e-10.
Also the three stopping criteria for GMRES and BiCGstab, the safety-net
variants, and the GMRES stagnation exit (status -42) on a cyclic shift,
where restarted GMRES makes no progress at all."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from native_parity import ensure_native

import faspsolver_tpu.krylov as jk
from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.ops.operators import device_operator as jax_device_operator
from faspsolver_tpu.precond import AMGPrecond as JaxAMGPrecond
from faspsolver_tpu.precond.amg import setup_rs as jax_setup_rs
from faspsolver_tpu.utils.params import AMGParam as JaxAMGParam
import faspsolver_tpu_torch.krylov as tk
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.formats import CSRMatrix
from faspsolver_tpu_torch.ops.operators import device_operator
from faspsolver_tpu_torch.testgen import convdiff_2d, poisson_2d

torch.set_num_threads(2)
ensure_native()

METHODS = ("bicgstab", "minres", "gmres", "vgmres", "vfgmres", "gcr", "gcg")
RESTARTED = ("gmres", "vgmres", "vfgmres", "gcr")
_CASES = {}


def _case(problem):
    """(port op, JAX op, b, {precond name: (port M, JAX M)})."""
    if problem not in _CASES:
        A = poisson_2d(31) if problem == "poisson" else \
            convdiff_2d(31, 20.0, -10.0)
        Aj = JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)
        b = np.random.default_rng(7).standard_normal(A.nrow)
        pre = {"none": (None, None),
               "jacobi": (tk.JacobiPrecond.from_csr(A),
                          jk.JacobiPrecond.from_csr(Aj, dtype=jnp.float64))}
        if problem == "poisson":
            hj = jax_setup_rs(Aj, JaxAMGParam(), dtype=jnp.float64)
            pre["amg"] = (from_jax(JaxAMGPrecond(hj)), JaxAMGPrecond(hj))
        _CASES[problem] = (device_operator(A), jax_device_operator(Aj), b,
                           pre)
    return _CASES[problem]


def _run(method, problem, precond, **kw):
    op, jop, b, pre = _case(problem)
    M, jM = pre[precond]
    got = getattr(tk, method)(op, torch.from_numpy(b), M=M, **kw)
    ref = getattr(jk, method)(jop, jnp.asarray(b), M=jM, **kw)
    return got, ref


def _assert_same(got, ref):
    assert got.iters == int(ref.iters)
    assert got.status == int(ref.status)
    assert got.converged == bool(ref.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)
    assert got.syncs >= got.iters


# BiCGstab on the symmetric Poisson matrix with a random b is chaotic in
# rounding: its count there (tol 1e-8, none or Jacobi) moves between 74
# and 86 with nothing but the summation order of the dot products (BLAS
# thread count, reversed or elementwise sums, all on the port alone), so
# it is held to the JAX package with the AMG V-cycle there and on the
# convection-diffusion matrix, where every order gives the same count.
POISSON_CASES = [(m, p) for m in METHODS for p in ("none", "jacobi", "amg")
                 if not (m == "bicgstab" and p != "amg")]


@pytest.mark.parametrize("method,precond", POISSON_CASES)
def test_method_matches_jax_on_poisson(method, precond):
    kw = dict(tol=1e-8, maxit=400)
    if method in RESTARTED:
        kw["restart"] = 20
    got, ref = _run(method, "poisson", precond, **kw)
    _assert_same(got, ref)
    assert got.converged


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("method", ["bicgstab", "gmres", "vgmres", "vfgmres",
                                    "gcr", "gcg"])
def test_method_matches_jax_on_convdiff(method, precond):
    kw = dict(tol=1e-8, maxit=400)
    if method in RESTARTED:
        kw["restart"] = 20
    got, ref = _run(method, "convdiff", precond, **kw)
    _assert_same(got, ref)


@pytest.mark.parametrize("stop_type", [1, 2, 3])
@pytest.mark.parametrize("method", ["gmres", "bicgstab"])
def test_stop_types_match_jax(method, stop_type):
    """tol 1e-7: at 1e-8 BiCGstab's recursive residual relative to |x|
    (stop type 3) crosses tol one iteration apart in the two packages
    (73 against 72), the recursion drifting by rounding while x agrees
    to 2e-13."""
    kw = dict(tol=1e-7, maxit=400, stop_type=stop_type)
    if method == "gmres":
        kw["restart"] = 20
    got, ref = _run(method, "poisson" if method == "gmres" else "convdiff",
                    "jacobi", **kw)
    _assert_same(got, ref)


@pytest.mark.parametrize("method", ["bicgstab", "minres", "gmres", "vgmres",
                                    "vfgmres"])
def test_safe_variants_match_jax(method):
    """Short of tolerance, the safety net returns the best iterate seen."""
    kw = dict(tol=1e-14, maxit=30, safe=True)
    if method in RESTARTED:
        kw["restart"] = 10
    got, ref = _run(method, "convdiff", "none", **kw)
    _assert_same(got, ref)
    assert not got.converged


@pytest.mark.parametrize("method", ["gmres", "vgmres", "vfgmres"])
def test_gmres_stagnation_exit_matches_jax(method):
    """GMRES(5) on the cyclic shift of size 40 keeps relres at exactly 1
    for 39 steps, so after 4 restart cycles without 0.5% gain it exits
    with status -42 after 20 iterations."""
    n = 40
    A = CSRMatrix.from_scipy(sp.csr_matrix(
        (np.ones(n), (np.arange(n), (np.arange(n) + 1) % n)), shape=(n, n)))
    Aj = JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)
    b = np.zeros(n)
    b[0] = 1.0
    kw = dict(tol=1e-8, maxit=400, restart=5)
    got = getattr(tk, method)(device_operator(A), torch.from_numpy(b), **kw)
    ref = getattr(jk, method)(jax_device_operator(Aj), jnp.asarray(b), **kw)
    _assert_same(got, ref)
    assert got.status == -42 and got.iters == 20 and got.relres == 1.0
