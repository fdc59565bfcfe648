"""The port's overlapping Schwarz preconditioner against the JAX
package's (f64, CPU): the same blocks, colors and block inverses; the
forward, backward and symmetric applies within 1e-12; the driver and the
CLI with the JAX package's iteration counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native

import faspsolver_tpu.solvers.drivers as jax_solvers
from faspsolver_tpu.__main__ import main as jax_main
from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.precond import schwarz as jax_schwarz
from faspsolver_tpu.utils import params as jax_params
import faspsolver_tpu_torch.solvers as solvers
from faspsolver_tpu_torch.__main__ import main
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.ops.operators import StencilNdOperator
from faspsolver_tpu_torch.precond.schwarz import (schwarz_blocks,
                                                  setup_schwarz)
from faspsolver_tpu_torch.testgen import (assemble_poisson, poisson_2d,
                                          poisson_2d_manufactured,
                                          unit_square_mesh)
from faspsolver_tpu_torch.utils.params import ITSParam, SWZParam

torch.set_num_threads(2)
ensure_native()


def _j(A):
    return JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)


def _fe(m):
    return assemble_poisson(unit_square_mesh(m), lambda p: np.ones(len(p)))[0]


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


CASES = {"poisson_2d(20) fwd": (lambda: poisson_2d(20), dict(SWZ_type=1)),
         "poisson_2d(20) bwd": (lambda: poisson_2d(20), dict(SWZ_type=2)),
         "poisson_2d(20) sym": (lambda: poisson_2d(20), dict(SWZ_type=3)),
         "fe(14) sym, 3 levels": (lambda: _fe(14),
                                  dict(SWZ_type=3, SWZ_maxlvl=3)),
         "fe(14) capped blocks": (lambda: _fe(14),
                                  dict(SWZ_type=1, SWZ_maxlvl=3,
                                       SWZ_mmsize=9))}


@pytest.mark.parametrize("case", list(CASES))
def test_schwarz_groups_and_apply_match_jax(case):
    make, kw = CASES[case]
    A = make()
    M = setup_schwarz(A, SWZParam(**kw))
    ref = jax_schwarz.setup_schwarz(_j(A), jax_params.SWZParam(**kw),
                                    dtype=jnp.float64)
    conv = from_jax(ref)
    assert len(M.groups) == len(ref.groups) > 1
    assert (M.n, M.swz_type) == (ref.n, ref.swz_type)
    for g, c in zip(M.groups, conv.groups):
        for name in ("dofs", "mask", "inv"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          getattr(c, name).numpy(), name)
    r = np.random.default_rng(12).standard_normal(A.nrow)
    want = jax.jit(lambda v: ref(v))(jnp.asarray(r))
    assert _rel(M(torch.from_numpy(r)), want) < 1e-12
    assert _rel(conv(torch.from_numpy(r)), want) < 1e-12


def test_blocks_cover_every_dof_and_a_color_shares_none():
    A = _fe(12)
    blocks, colors = schwarz_blocks(A, SWZParam(SWZ_maxlvl=2, SWZ_mmsize=7))
    assert max(len(b) for b in blocks) <= 7
    assert np.array_equal(np.unique(np.concatenate(blocks)),
                          np.arange(A.nrow))
    for c in range(int(colors.max()) + 1):
        dofs = np.concatenate([blocks[i] for i in np.nonzero(colors == c)[0]])
        assert len(np.unique(dofs)) == len(dofs)


def test_schwarz_in_f32_applies_a_grid_matrix_through_the_stencil_operator():
    A = poisson_2d(24)
    M = setup_schwarz(A, dtype=torch.float32, device="cpu")
    assert isinstance(M.A, StencilNdOperator) and M.A.dtype == torch.float32
    z = M(torch.ones(A.nrow, dtype=torch.float32))
    assert z.dtype == torch.float32
    assert _rel(z, setup_schwarz(A)(torch.ones(A.nrow, dtype=torch.float64))) \
        < 1e-5


SWZ_DRIVERS = [(dict(itsolver_type=1, tol=1e-8, maxit=300), dict(SWZ_type=3)),
               (dict(itsolver_type=4, tol=1e-8, maxit=300, restart=30),
                dict(SWZ_type=1)),
               (dict(itsolver_type=6, tol=1e-8, maxit=300, restart=30),
                dict(SWZ_type=2, SWZ_maxlvl=3))]


@pytest.mark.parametrize("its,kw", SWZ_DRIVERS, ids=[
    "CG+symmetric", "GMRES+forward", "vFGMRES+backward"])
def test_krylov_swz_matches_jax(its, kw):
    A, b, _ = poisson_2d_manufactured(24)
    got = solvers.krylov_swz(A, b, its=ITSParam(**its), swz=SWZParam(**kw),
                             device="cpu")
    ref = jax_solvers.krylov_swz(_j(A), b, its=jax_params.ITSParam(**its),
                                 swz=jax_params.SWZParam(**kw))
    assert (got.iters, got.status, got.converged) == \
        (int(ref.iters), int(ref.status), bool(ref.converged))
    assert got.converged
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)


def test_krylov_swz_raises_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b, _ = poisson_2d_manufactured(8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        solvers.krylov_swz(A, b)


def _cli(fn, argv, capsys):
    rc = fn(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Number of iterations")]
    assert len(lines) == 1
    words = lines[0].rstrip(".").split()
    return rc, int(words[4]), float(words[-1])


def test_cli_precond_schwarz_matches_jax(capsys):
    argv = ["-ini", "ini/input.dat", "-precond", "5", "-problem",
            "poisson2d", "-size", "31"]
    rc, iters, relres = _cli(main, argv + ["-device", "cpu"], capsys)
    jrc, jiters, jrelres = _cli(jax_main, argv, capsys)
    assert (rc, iters) == (jrc, jiters) and rc == 0
    assert np.isclose(relres, jrelres, rtol=1e-6, atol=1e-13)
