"""The port's matrix-free geometric multigrid against the JAX package's
(f64, CPU).

Every stencil helper (Laplacian, residual, red-black Gauss-Seidel,
restriction, prolongation, 2-D and 3-D) agrees to rounding; one V-cycle
agrees; poisson_gmg_1d/2d/3d (with and without the full-multigrid first
sweep) and poisson_gmgcg_2d/3d at n = 32 / 64 (2-D) and 8 / 16 (3-D)
give the JAX package's iterations with u within 1e-10, reading the
stopping test to the host once per iteration.

The JAX solves run with ``jax.disable_jit()``: their ``lax.while_loop``
then runs as a Python loop of the same operations, and the test does not
compile the unrolled V-cycle (tens of seconds per size)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from faspsolver_tpu.precond import gmg as jax_gmg
from faspsolver_tpu_torch.precond import gmg

torch.set_num_threads(2)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _grid(shape, seed):
    u = np.random.default_rng(seed).standard_normal(shape)
    for ax in range(u.ndim):            # zero Dirichlet ring
        u[(slice(None),) * ax + (0,)] = 0.0
        u[(slice(None),) * ax + (-1,)] = 0.0
    return u


@pytest.mark.parametrize("dim,n", [(2, 16), (3, 8)])
def test_stencil_helpers_match_jax(dim, n):
    shape = (n + 1,) * dim
    u, f = _grid(shape, 1), _grid(shape, 2)
    h2 = 1.0 / (n * n)
    d = f"_{dim}d"
    tu, tf = torch.from_numpy(u), torch.from_numpy(f)
    ju, jf = jnp.asarray(u), jnp.asarray(f)
    for name, port_args, jax_args in (
            ("_laplace", (tu, h2), (ju, h2)),
            ("_residual", (tu, tf, h2), (ju, jf, h2)),
            ("_rbgs", (tu, tf, h2, 2), (ju, jf, h2, 2)),
            ("_restrict", (tu,), (ju,)),
            ("_prolong", (torch.from_numpy(_grid((n // 2 + 1,) * dim, 3)),
                          shape),
             (jnp.asarray(_grid((n // 2 + 1,) * dim, 3)), shape))):
        got = getattr(gmg, name + d)(*port_args)
        ref = getattr(jax_gmg, name + d)(*jax_args)
        assert got.shape == ref.shape and _rel(got, ref) < 1e-14, name
    if dim == 2:
        got = gmg._rbgs_2d(tu, tf, h2, 1, parity_first=1)
        assert _rel(got, jax_gmg._rbgs_2d(ju, jf, h2, 1, parity_first=1)) \
            < 1e-14
    assert torch.equal(tu, torch.from_numpy(u))        # inputs untouched


@pytest.mark.parametrize("dim,n", [(2, 32), (3, 8)])
def test_vcycle_matches_jax(dim, n):
    f, _ = chip_smoke.gmg_problem(n, dim)
    u0 = _grid(f.shape, 4)
    got = gmg._vcycle(torch.from_numpy(u0), torch.from_numpy(f), n, dim)
    with jax.disable_jit():
        ref = jax_gmg._vcycle(jnp.asarray(u0), jnp.asarray(f), n, dim)
    assert _rel(got, ref) < 1e-13


SOLVES = [(fn, dim, n, kw) for dim, fn, sizes in (
    (2, "poisson_gmg_2d", (32, 64)), (3, "poisson_gmg_3d", (8, 16)))
    for n in sizes for kw in ({}, {"full_first": True})] \
    + [("poisson_gmgcg_2d", 2, n, {}) for n in (32, 64)] \
    + [("poisson_gmgcg_3d", 3, n, {}) for n in (8, 16)] \
    + [("poisson_gmg_1d", 1, 64, {})]


@pytest.mark.parametrize("fn,dim,n,kw", SOLVES,
                         ids=[f"{f} n={n} {kw}" for f, _, n, kw in SOLVES])
def test_gmg_solves_match_jax(fn, dim, n, kw):
    f, u = chip_smoke.gmg_problem(n, dim)
    got = getattr(gmg, fn)(torch.from_numpy(f), n, **kw)
    with jax.disable_jit():
        ref = getattr(jax_gmg, fn)(jnp.asarray(f), n, **kw)
    assert (got.iters, got.converged, got.status) == \
        (int(ref.iters), bool(ref.converged), int(ref.status))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)
    assert abs(got.relres - float(ref.relres)) \
        <= 1e-6 * float(ref.relres) + 1e-12
    assert got.syncs == got.iters + (0 if dim == 1 else 1)
    assert np.abs(got.x.numpy() - u).max() < 10.0 / n ** 2   # O(h^2)


def test_gmg_checks_its_shapes_and_builds_masks_once():
    f, _ = chip_smoke.gmg_problem(16, 2)
    with pytest.raises(AssertionError):
        gmg.poisson_gmg_2d(torch.from_numpy(f), 8)
    gmg._MASKS.clear()
    gmg.poisson_gmg_2d(torch.from_numpy(f), 16, maxit=3)
    shapes = sorted(k[0] for k in gmg._MASKS)
    assert shapes == [(5, 5), (9, 9), (17, 17)]
    res = gmg.poisson_gmg_2d(torch.from_numpy(f.astype(np.float32)), 16,
                             tol=1e-5)
    assert res.x.dtype == torch.float32 and res.converged


GMG_ENTRY_POINTS = [("poisson_gmg_1d", 1, 16), ("poisson_gmg_2d", 2, 16),
                    ("poisson_gmg_3d", 3, 8), ("poisson_gmgcg_2d", 2, 16),
                    ("poisson_gmgcg_3d", 3, 8)]


@pytest.mark.parametrize("fn,dim,n", GMG_ENTRY_POINTS,
                         ids=[f for f, _, _ in GMG_ENTRY_POINTS])
def test_gmg_entry_points_put_host_arrays_on_the_card(fn, dim, n,
                                                      monkeypatch):
    """device=None puts a NumPy f on the CUDA device, as the drivers do:
    where there is none it raises and names device="cpu"; with
    device="cpu" the same f solves on the CPU, as a CPU tensor does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f, _ = chip_smoke.gmg_problem(n, dim)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(gmg, fn)(f, n)
    res = getattr(gmg, fn)(f, n, device="cpu")
    ref = getattr(gmg, fn)(torch.from_numpy(f), n)
    assert res.x.device.type == "cpu" and res.converged
    assert res.iters == ref.iters and torch.equal(res.x, ref.x)
