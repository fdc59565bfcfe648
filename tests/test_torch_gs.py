"""The port's multicolor Gauss-Seidel family against the JAX package's.

Both packages color through the same native ``greedy_color``, so the
colorings are equal; the color blocks (rows, columns, values, inverse
diagonals) are equal arrays, and one forward or backward sweep of every
GS-family kind, plain or C/F ordered, agrees to 1e-13 (normwise
relative, f64).  A row of up to 8 entries sums left to right, as the
JAX package's sum does on the CPU, so on such rows the GS sweeps are
bit-equal to JAX's in f32 and f64.  Also the
two repairs this family needed: ``CSRMatrix.multicolor`` takes the
native coloring, and ``setup_rs`` passes the C/F marker when
``smooth_order`` is 1, as the JAX package does."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from native_parity import ensure_native

from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.ops.operators import device_operator as jax_device_operator
from faspsolver_tpu.precond.amg import smoothers as jax_sm
from faspsolver_tpu.precond.amg.setup_rs import setup_rs as jax_setup_rs
from faspsolver_tpu.utils.params import AMGParam as JaxAMGParam
from faspsolver_tpu_torch import native
from faspsolver_tpu_torch.constants import SmootherType
from faspsolver_tpu_torch.formats import CSRMatrix
from faspsolver_tpu_torch.ops.operators import device_operator
from faspsolver_tpu_torch.precond.amg import setup_rs, smoothers
from faspsolver_tpu_torch.precond.amg.coarsen_rs import coarsen
from faspsolver_tpu_torch.testgen import (assemble_poisson, poisson_2d,
                                          unit_square_mesh)
from faspsolver_tpu_torch.utils.params import AMGParam

torch.set_num_threads(2)
ensure_native()

GS_KINDS = ("GS", "SGS", "SOR", "SSOR", "GSOR", "SGSOR", "GSF")


def _j(A):
    return JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)


def _fe(m):
    A, _, _ = assemble_poisson(unit_square_mesh(m), lambda p: np.ones(len(p)))
    return A


def _random_symmetric():
    """A random symmetric sparsity pattern with a dominant diagonal."""
    rng = np.random.default_rng(11)
    m = sp.random(400, 400, density=0.02, random_state=rng, format="csr")
    m = m + m.T + sp.identity(400) * 10.0
    return CSRMatrix.from_scipy(m.tocsr())


MATRICES = {"poisson_2d(63)": lambda: poisson_2d(63),
            "unit_square_mesh(32)": lambda: _fe(32),
            "random symmetric": _random_symmetric}


@pytest.mark.parametrize("name", list(MATRICES))
def test_native_coloring_matches_jax(name):
    A = MATRICES[name]()
    colors, counts = A.multicolor()
    jcolors, jcounts = _j(A).multicolor()
    np.testing.assert_array_equal(colors, jcolors)
    np.testing.assert_array_equal(counts, jcounts)
    # a proper coloring: no edge joins two rows of one color
    rows = np.repeat(np.arange(A.nrow), A.row_nnz())
    off = rows != A.indices
    assert not np.any(colors[rows[off]] == colors[A.indices[off]])


def test_multicolor_takes_the_native_path(monkeypatch):
    """poisson_2d(255): the coloring comes from the native entry, not
    from the NumPy loop."""
    calls = []
    native_color = native.greedy_color

    def spy(*args):
        calls.append(args[2])
        return native_color(*args)

    monkeypatch.setattr(native, "greedy_color", spy)
    A = poisson_2d(255)
    colors, counts = A.multicolor()
    assert calls == [A.nrow]
    assert len(counts) == 2 and counts.sum() == A.nrow


def _assert_same_blocks(got, ref):
    assert got.kind == ref.kind and got.relax == ref.relax
    assert len(got.colors) == len(ref.colors)
    for g, r in zip(got.colors, ref.colors):
        for f in ("rows", "cols", "vals", "dinv"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(r, f)))


@pytest.mark.parametrize("name", ["poisson_2d(63)", "unit_square_mesh(32)"])
def test_default_setup_rs_colors_c_first_like_jax(name):
    """Default AMGParam (GS, smooth_order 1): every level's color blocks
    equal the JAX package's, in order, and the fine level visits its C
    points before its F points."""
    A = MATRICES[name]()
    got = setup_rs(A)
    ref = jax_setup_rs(_j(A), JaxAMGParam(), dtype=jnp.float64)
    assert len(got.levels) == len(ref.levels) >= 2
    for lg, lr in zip(got.levels[:-1], ref.levels[:-1]):
        _assert_same_blocks(lg.smoother, lr.smoother)
    p = AMGParam()
    marker, _ = coarsen(A, p.strong_threshold, p.max_row_sum)
    order = np.concatenate([c.rows.numpy()
                            for c in got.levels[0].smoother.colors])
    is_c = marker[order] >= 1
    assert is_c.any() and not is_c[np.argmin(is_c):].any()


@pytest.fixture(scope="module")
def fe_case():
    A = _fe(32)
    marker, _ = coarsen(A, 0.25, 0.9)
    rng = np.random.default_rng(4)
    return A, marker, rng.standard_normal(A.nrow), rng.standard_normal(A.nrow)


@pytest.mark.parametrize("cf", [False, True], ids=["plain", "cf"])
@pytest.mark.parametrize("kind", GS_KINDS)
def test_gs_sweeps_match_jax(fe_case, kind, cf):
    """One forward and one backward sweep of each GS-family kind (relax
    1.1, so the SOR update runs), with and without C/F ordering."""
    A, marker, x, b = fe_case
    k = int(SmootherType[kind])
    cfm = marker if cf else None
    sm = smoothers.build_smoother(A, k, relax=1.1, cf_marker=cfm)
    ref = jax_sm.build_smoother(_j(A), k, relax=1.1, cf_marker=cfm,
                                dtype=jnp.float64)
    _assert_same_blocks(sm, ref)
    op, jop = device_operator(A), jax_device_operator(_j(A))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    for forward in (True, False):
        got = smoothers.smooth(sm, op, xt, bt, 1, forward).numpy()
        want = np.asarray(jax_sm.smooth(ref, jop, jnp.asarray(x),
                                        jnp.asarray(b), 1, forward))
        assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)
    # the sweep never writes into the caller's iterate
    np.testing.assert_array_equal(xt.numpy(), x)


def _nine_point(m):
    """The 9-point Laplacian on an m x m grid: rows of up to 8 entries
    off the diagonal."""
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(m, m))
    a = -sp.kron(t, t) + 9.0 * sp.identity(m * m)
    return CSRMatrix.from_scipy(a.tocsr())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gs_row_sums_add_in_the_jax_order(dtype):
    """Rows of up to 8 entries sum left to right, bit-equal to the JAX
    package's sum (``torch.sum`` on the CPU adds 5-7 entries in another
    order); wider rows take ``torch.sum``.  GS and SOR sweeps each way on
    the 9-point Laplacian are bit-equal to JAX's."""
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(7)
    for k in range(1, 9):
        p = rng.standard_normal((300, k)).astype(dtype)
        got = smoothers.row_sum(torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.sum(jnp.asarray(p),
                                                         axis=1)))
        seq = p[:, 0].copy()
        for j in range(1, k):
            seq += p[:, j]
        np.testing.assert_array_equal(got.numpy(), seq)
    wide = torch.from_numpy(rng.standard_normal((300, 20)).astype(dtype))
    assert torch.equal(smoothers.row_sum(wide), wide.sum(dim=1))

    A = _nine_point(24)
    x, b = rng.standard_normal(A.nrow), rng.standard_normal(A.nrow)
    xt, bt = torch.from_numpy(x).to(dt), torch.from_numpy(b).to(dt)
    xj, bj = jnp.asarray(x, jdt), jnp.asarray(b, jdt)
    for kind in ("GS", "SOR"):
        k = int(SmootherType[kind])
        sm = smoothers.build_smoother(A, k, relax=1.1, dtype=dt)
        ref = jax_sm.build_smoother(_j(A), k, relax=1.1, dtype=jdt)
        assert {c.cols.shape[1] for c in sm.colors} == {8}
        op = device_operator(A, dtype=dt)
        jop = jax_device_operator(_j(A), dtype=jdt)
        for forward in (True, False):
            np.testing.assert_array_equal(
                smoothers.smooth(sm, op, xt, bt, 1, forward).numpy(),
                np.asarray(jax_sm.smooth(ref, jop, xj, bj, 1, forward)))


def test_kaczmarz_sweep_matches_jax(fe_case):
    A, _, x, b = fe_case
    k = int(SmootherType.GS)
    sm = smoothers.build_smoother(A, k)
    ref = jax_sm.build_smoother(_j(A), k, dtype=jnp.float64)
    got = smoothers.kaczmarz_sweep(sm, None, torch.from_numpy(x),
                                   torch.from_numpy(b)).numpy()
    want = np.asarray(jax_sm.kaczmarz_sweep(ref, None, jnp.asarray(x),
                                            jnp.asarray(b)))
    assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)


def test_reservoir_ids_map_to_gs(fe_case, monkeypatch):
    """The reservoir smoother ids warn and build GS blocks, as in the JAX
    package."""
    from faspsolver_tpu_torch.utils import messages
    warned = []
    monkeypatch.setattr(messages, "warn", warned.append)
    A = fe_case[0]
    for kind in ("BLKOIL", "SPETEN", "CPRGS", "CPTRGS"):
        k = int(SmootherType[kind])
        sm = smoothers.build_smoother(A, k)
        ref = jax_sm.build_smoother(_j(A), k, dtype=jnp.float64)
        assert sm.kind == int(SmootherType.GS)
        _assert_same_blocks(sm, ref)
    assert len(warned) == 4 and all("mapping to GS" in w for w in warned)
