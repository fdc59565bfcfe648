"""The port's AMLI, nonlinear AMLI, FMG and W cycles, its preconditioner
adapters and AMG as a solver, against the JAX package's (f64, CPU).

Each cycle runs on a hierarchy the JAX package built, carried across
with ``from_jax``: one cycle agrees to 1e-12 (normwise relative).
``amli_coefs`` agree exactly; ``amg_solve`` and ``famg_solve`` take
equal iteration counts on each package's own hierarchy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native

from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.ops.operators import device_operator as jax_device_operator
from faspsolver_tpu.precond import AMGNKPrecond as JaxAMGNKPrecond
from faspsolver_tpu.precond import AMGPrecond as JaxAMGPrecond
from faspsolver_tpu.precond import FMGPrecond as JaxFMGPrecond
from faspsolver_tpu.precond.amg import cycles as jax_cycles
from faspsolver_tpu.precond.amg import amg_solve as jax_amg_solve
from faspsolver_tpu.precond.amg import famg_solve as jax_famg_solve
from faspsolver_tpu.precond.amg import setup_rs as jax_setup_rs
from faspsolver_tpu.precond.amg import setup_sa as jax_setup_sa
from faspsolver_tpu.precond.amg import setup_ua as jax_setup_ua
from faspsolver_tpu.utils.params import AMGParam as JaxAMGParam
from faspsolver_tpu_torch.constants import AMGType
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.ops.operators import device_operator
from faspsolver_tpu_torch.precond import AMGNKPrecond, AMGPrecond, FMGPrecond
from faspsolver_tpu_torch.precond.amg import (amg_solve, amli_coefs,
                                              famg_solve, setup_rs, setup_sa,
                                              setup_ua)
from faspsolver_tpu_torch.precond.amg import cycles
from faspsolver_tpu_torch.testgen import poisson_2d
from faspsolver_tpu_torch.utils.params import AMGParam

torch.set_num_threads(2)
ensure_native()

SETUPS = {"RS": (setup_rs, jax_setup_rs, {}),
          "SA": (setup_sa, jax_setup_sa, dict(AMG_type=int(AMGType.SA))),
          "UA": (setup_ua, jax_setup_ua, dict(AMG_type=int(AMGType.UA)))}
_HIER = {}


def _problem():
    A = poisson_2d(47)
    return A, JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape), \
        np.random.default_rng(9).standard_normal(A.nrow)


def _jax_hier(kind, **kw):
    key = (kind, tuple(sorted(kw.items())))
    if key not in _HIER:
        _, jax_setup, base = SETUPS[kind]
        _HIER[key] = jax_setup(_problem()[1], JaxAMGParam(**base, **kw),
                               dtype=jnp.float64)
    return _HIER[key]


def _rel(got, want):
    want = np.asarray(want)
    return np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)


@pytest.mark.parametrize("degree", range(5))
def test_amli_coefs_equal(degree):
    for lmax, lmin in ((2.0, 0.5), (1.9, 0.1)):
        assert amli_coefs(lmax, lmin, degree) == \
            jax_cycles.amli_coefs(lmax, lmin, degree)


CYCLES = [("RS", "amli_cycle", dict(cycle_type=3, amli_degree=3)),
          ("RS", "nl_amli_cycle", dict(cycle_type=4)),
          ("RS", "mgcycle", dict(cycle_type=2)),
          ("RS", "mgcycle", dict(cycle_type=2, coarse_scaling=1)),
          ("RS", "amli_cycle", dict(cycle_type=3, coarse_scaling=1)),
          ("SA", "amli_cycle", dict(cycle_type=3)),
          ("UA", "nl_amli_cycle", dict(cycle_type=4)),
          ("UA", "mgcycle", {})]


@pytest.mark.parametrize("kind,cycle,kw", CYCLES,
                         ids=[f"{k}-{c}-{i}" for i, (k, c, _) in
                              enumerate(CYCLES)])
def test_one_cycle_matches_jax(kind, cycle, kw):
    ref = _jax_hier(kind, **kw)
    b = _problem()[2]
    want = jax.jit(lambda v: getattr(jax_cycles, cycle)(ref, v))(
        jnp.asarray(b))
    got = getattr(cycles, cycle)(from_jax(ref), torch.from_numpy(b))
    assert _rel(got, want) < 1e-12


def test_fmg_cycle_matches_jax():
    ref = _jax_hier("RS")
    b = _problem()[2]
    want = jax.jit(lambda v: jax_cycles.fmg_cycle(ref, v))(jnp.asarray(b))
    assert _rel(cycles.fmg_cycle(from_jax(ref), torch.from_numpy(b)),
                want) < 1e-12


@pytest.mark.parametrize("cycle_type", [1, 3, 4])
def test_amg_precond_dispatches_like_jax(cycle_type):
    """AMGPrecond runs the hierarchy's cycle type, ``maxit`` times."""
    ref = _jax_hier("RS", cycle_type=cycle_type)
    b = _problem()[2]
    want = jax.jit(lambda v: JaxAMGPrecond(ref, maxit=2)(v))(jnp.asarray(b))
    got = AMGPrecond(from_jax(ref), maxit=2)(torch.from_numpy(b))
    assert _rel(got, want) < 1e-12


def test_fmg_and_nk_preconds_match_jax():
    A, Aj, b = _problem()
    ref = _jax_hier("RS")
    hier = from_jax(ref)
    want = jax.jit(lambda v: JaxFMGPrecond(ref, maxit=2)(v))(jnp.asarray(b))
    assert _rel(FMGPrecond(hier, maxit=2)(torch.from_numpy(b)), want) < 1e-12
    nk = np.ones((A.nrow, 1))
    gram_inv = np.linalg.pinv(nk.T @ A.to_scipy().dot(nk))
    jnk = JaxAMGNKPrecond(ref, jnp.asarray(nk), jnp.asarray(gram_inv),
                          jax_device_operator(Aj))
    mine = AMGNKPrecond(hier, torch.from_numpy(nk),
                        torch.from_numpy(gram_inv), device_operator(A))
    assert _rel(mine(torch.from_numpy(b)),
                jax.jit(lambda v: jnk(v))(jnp.asarray(b))) < 1e-12


@pytest.mark.parametrize("kind,kw", [
    ("RS", {}), ("RS", dict(cycle_type=2)),
    ("RS", dict(cycle_type=3, amli_degree=3)), ("RS", dict(cycle_type=4)),
    ("SA", {}), ("UA", dict(cycle_type=4))])
def test_amg_solve_iterations_match_jax(kind, kw):
    A, Aj, b = _problem()
    setup, jax_setup, base = SETUPS[kind]
    param = dict(base, tol=1e-10, maxit=60, **kw)
    got = amg_solve(setup(A, AMGParam(**param)), torch.from_numpy(b),
                    tol=1e-10, maxit=60)
    ref = jax_amg_solve(jax_setup(Aj, JaxAMGParam(**param),
                                  dtype=jnp.float64), jnp.asarray(b),
                        tol=1e-10, maxit=60)
    assert got.converged and got.iters == int(ref.iters)
    assert got.syncs == got.iters + 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-10)


def test_famg_solve_iterations_match_jax():
    A, Aj, b = _problem()
    got = famg_solve(setup_rs(A), torch.from_numpy(b), tol=1e-10, maxit=30)
    ref = jax.jit(lambda h, v: jax_famg_solve(h, v, tol=1e-10, maxit=30))(
        jax_setup_rs(Aj, JaxAMGParam(), dtype=jnp.float64), jnp.asarray(b))
    assert got.converged and got.iters == int(ref.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=1e-10)
