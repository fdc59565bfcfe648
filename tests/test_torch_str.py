"""The port's structured-grid (STR) family against the JAX package's
(f64, CPU).

StrOperator applies to rounding on a 2-D nc=2 and a 3-D 6x5x4 nc=3
grid; the port's vectorised ``STRMatrix.to_csr`` and ``_grid_wavefronts``
give the JAX package's CSR and levels exactly; the banded ILU factor is
equal band for band for fill 0 and 1 (the port's factor follows the
grid's wavefronts, the JAX package's the 1-D index); the diagonal, block
Gauss-Seidel (bipartite and damped), ILU and Schwarz applies agree to
1e-13, built by either package; the STR drivers give the JAX package's
iterations and status with x within 1e-10, and the AMG drivers do with
an STR matrix what the JAX package's do."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native
from small_grid_anchors import _to_jax, jax_str_ilu, str_run

import chip_smoke
import faspsolver_tpu.solvers.drivers as jax_solvers
from faspsolver_tpu.ops.str_ops import StrOperator as JaxStrOperator
from faspsolver_tpu.precond import str_precond as jax_str
from faspsolver_tpu.utils import params as jax_params
import faspsolver_tpu_torch.solvers as solvers
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.formats import STRMatrix
from faspsolver_tpu_torch.ops.str_ops import StrOperator
from faspsolver_tpu_torch.precond import str_precond as port_str
from faspsolver_tpu_torch.utils import messages
from faspsolver_tpu_torch.utils.params import AMGParam, ILUParam, ITSParam

torch.set_num_threads(2)
ensure_native()


def _str(nx, ny, nz, nc, seed=0, extra=()):
    """A symmetric positive definite STR matrix on an nx x ny x nz grid:
    random nc x nc coupling blocks on the +-1, +-nx, +-nx*ny bands (and
    ``extra`` offsets), zero where a band leaves the grid."""
    rng = np.random.default_rng(seed)
    ng = nx * ny * nz
    g = np.arange(ng)
    at = (g % nx, (g // nx) % ny, g // (nx * ny))
    eye = np.eye(nc)
    bands = {}
    steps = [((1, 0, 0), 1), ((0, 1, 0), nx), ((0, 0, 1), nx * ny), *extra]
    for d, o in steps:
        if any(di and n == 1 for di, n in zip(d, (nx, ny, nz))):
            continue
        ok = np.ones(ng, dtype=bool)
        for a, di, n in zip(at, d, (nx, ny, nz)):
            ok &= (a + di >= 0) & (a + di < n)
        B = -(eye + 0.05 * rng.standard_normal((ng, nc, nc))) \
            * ok[:, None, None]
        Bm = np.zeros_like(B)
        Bm[o:] = np.transpose(B[:ng - o], (0, 2, 1))
        bands[o], bands[-o] = B, Bm
    S = 0.05 * rng.standard_normal((ng, nc, nc))
    diag = (len(bands) + 0.5) * eye + S + np.transpose(S, (0, 2, 1))
    offs = sorted(bands, key=lambda o: (abs(o), -o))
    return STRMatrix(nx, ny, nz, nc, diag, tuple(offs),
                     [bands[o] for o in offs])


GRIDS = {"2-D nc=2": (10, 8, 1, 2), "3-D 6x5x4 nc=3": (6, 5, 4, 3)}
# the preconditioners on smaller grids: the JAX ILU applies one level per
# grid point, eagerly
PRE_GRIDS = {"2-D nc=2": (6, 5, 1, 2), "3-D nc=3": (4, 3, 3, 3)}


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("grid", list(GRIDS))
def test_str_operator_and_csr_match_jax(grid):
    A = _str(*GRIDS[grid])
    Aj = _to_jax(A)
    x = np.random.default_rng(1).standard_normal(A.nrow)
    y = StrOperator.from_str(A)(torch.from_numpy(x))
    yj = JaxStrOperator.from_str(Aj, dtype=jnp.float64)(jnp.asarray(x))
    assert _rel(y, yj) < 1e-14
    assert _rel(from_jax(JaxStrOperator.from_str(
        Aj, dtype=jnp.float64))(torch.from_numpy(x)), yj) < 1e-14
    c, cj = A.to_csr(), Aj.to_csr()
    for name in ("indptr", "indices", "data"):
        got, ref = getattr(c, name), getattr(cj, name)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name
    np.testing.assert_allclose(c.matvec(x), A.matvec(x), rtol=1e-13)


WAVEFRONT_OFFSETS = [(-1, -6, -30), (1, 6, 30), (-1, -5, -6, -7, -30, -24),
                     (-6, -30), (5, 30, 31), (-1,), (2, 7)]


@pytest.mark.parametrize("offsets", WAVEFRONT_OFFSETS,
                         ids=[str(o) for o in WAVEFRONT_OFFSETS])
def test_grid_wavefronts_equal_jax(offsets):
    """The vectorised schedule gives the JAX loop's levels, forward and
    backward (only the offsets of the sweep's sign count)."""
    for ng in (1, 7, 120, 241):
        for forward in (True, False):
            got = port_str._grid_wavefronts(ng, offsets, forward)
            ref = jax_str._grid_wavefronts(ng, offsets, forward)
            assert len(got) == len(ref)
            assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def test_grid_steps_drop_only_wrapping_dependencies():
    """On a grid the wavefronts follow the grid (nx + ny + nz - 2 levels
    for ILU(0) of a 7-point stencil) and respect every dependency
    through a nonzero block; periodic couplings keep the 1-D schedule."""
    A = _str(6, 5, 4, 3)
    offs, _ = port_str._band_ilu_pattern(A.offsets, 0)
    steps = port_str._grid_steps(A, offs)
    assert steps is not None
    neg = [o for o in offs if o < 0]
    levels = port_str._grid_wavefronts(A.ngrid, neg, steps=steps)
    assert len(levels) == 6 + 5 + 4 - 2
    depth = np.empty(A.ngrid, dtype=int)
    for lv, rows in enumerate(levels):
        depth[rows] = lv
    for o, band in zip(A.offsets, A.offdiag):
        if o < 0:
            g = np.flatnonzero(np.abs(band).sum(axis=(1, 2)) > 0)
            assert (depth[g] > depth[g + o]).all()
    A.offdiag[0][5] = -0.3 * np.eye(3)      # g=5 -> 6 wraps a grid row
    assert port_str._grid_steps(A, offs) is None


@pytest.mark.parametrize("fill", [0, 1])
def test_str_ilu_factor_equals_jax(fill):
    for grid in GRIDS.values():
        A = _str(*grid)
        bands, offs, steps = port_str.str_ilu_factor_banded(A, fill)
        ref, ref_offs = jax_str.str_ilu_factor_banded(_to_jax(A), fill)
        assert steps is not None and offs == ref_offs
        assert sorted(bands) == sorted(ref)
        for o in ref:
            assert np.array_equal(bands[o], ref[o]), o


def _preconds(A):
    Aj = _to_jax(A)
    f64 = jnp.float64
    return {
        "diag": (port_str.setup_str_diag(A),
                 jax_str.setup_str_diag(Aj, dtype=f64)),
        "block GS": (port_str.setup_str_blockgs(A),
                     jax_str.setup_str_blockgs(Aj, dtype=f64)),
        "ILU(0)": (port_str.setup_str_ilu(A, 0),
                   jax_str.setup_str_ilu(Aj, 0, dtype=f64)),
        "ILU(1)": (port_str.setup_str_ilu(A, 1),
                   jax_str.setup_str_ilu(Aj, 1, dtype=f64)),
        "ILU(2)": (port_str.setup_str_ilu(A, 2),
                   jax_str.setup_str_ilu(Aj, 2, dtype=f64)),
        "Schwarz": (port_str.setup_str_schwarz(A, nsweeps=2),
                    jax_str.setup_str_schwarz(Aj, dtype=f64, nsweeps=2)),
    }


@pytest.mark.parametrize("grid,diagonal", [("2-D nc=2", False),
                                           ("3-D nc=3", False),
                                           ("2-D nc=2", True)])
def test_str_preconditioners_match_jax(grid, diagonal):
    """Each apply, set up by the port and by the JAX package (then
    carried across with from_jax), against the JAX apply; the diagonal
    band (nx + 1) makes the stencil non-bipartite: damped block Jacobi."""
    extra = [((1, 1, 0), PRE_GRIDS[grid][0] + 1)] if diagonal else []
    A = _str(*PRE_GRIDS[grid], extra=extra)
    assert port_str._bipartite(A) != diagonal
    r = np.random.default_rng(2).standard_normal(A.nrow)
    for name, (M, Mj) in _preconds(A).items():
        ref = Mj(jnp.asarray(r))
        assert _rel(M(torch.from_numpy(r)), ref) < 1e-13, name
        assert _rel(from_jax(Mj)(torch.from_numpy(r)), ref) < 1e-13, name


def _assert_same(got, ref):
    got = got[0] if isinstance(got, tuple) else got
    ref = ref[0] if isinstance(ref, tuple) else ref
    assert (got.iters, got.status, got.converged) == \
        (int(ref.iters), int(ref.status), bool(ref.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)


_ITS = dict(itsolver_type=6, tol=1e-10, maxit=300, restart=30)
STR_DRIVERS = [
    ("krylov", {}, dict(itsolver_type=1, tol=1e-10, maxit=300)),
    ("krylov_diag", {}, dict(itsolver_type=1, tol=1e-10, maxit=300)),
    ("krylov_blockgs", dict(smoother="blockgs"), _ITS),
    ("krylov_blockgs", dict(smoother="schwarz"), _ITS),
    ("krylov_ilu", dict(ilu=dict(ILU_lfil=0)), _ITS),
    ("krylov_ilu", dict(ilu=dict(ILU_lfil=1)), _ITS),
    ("krylov_ilu", dict(ilu=dict(ILU_lfil=2)), _ITS),
]


@pytest.mark.parametrize("driver,kw,its", STR_DRIVERS,
                         ids=[f"{d} {k}" for d, k, _ in STR_DRIVERS])
def test_str_drivers_match_jax(driver, kw, its):
    """On chip_smoke's STR problem (block_poisson_3d(4) in band form)."""
    A, Ab, b = chip_smoke.str_problem(4)
    kw = dict(kw)
    ilu = kw.pop("ilu", None)
    got = getattr(solvers, driver)(
        A, b, its=ITSParam(**its), device="cpu", **kw,
        **({} if ilu is None else {"ilu": ILUParam(**ilu)}))
    ref = getattr(jax_solvers, driver)(
        _to_jax(A), b, its=jax_params.ITSParam(**its), **kw,
        **({} if ilu is None else {"ilu": jax_params.ILUParam(**ilu)}))
    _assert_same(got, ref)
    assert np.linalg.norm(b - Ab.matvec(got.x.numpy())) \
        <= 1e-9 * np.linalg.norm(b)


@pytest.mark.parametrize("fill", [0, 1])
def test_str_ilu_anchor_schedule_gives_the_jax_driver_count(fill):
    """The anchors' STR ILU (the JAX factor and solver over the grid's
    wavefronts, built without the port, small_grid_anchors.str_run)
    applies as the JAX setup does over its 1-D schedule, on fewer levels,
    and counts what the JAX driver counts."""
    A, _, b = chip_smoke.str_problem(4)
    anchor = jax_str_ilu(A, fill)
    ref_M = jax_str.setup_str_ilu(_to_jax(A), fill)
    r = jnp.asarray(np.random.default_rng(fill).standard_normal(A.nrow))
    got, want = np.asarray(anchor(r)), np.asarray(ref_M(r))
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    assert len(anchor.Lsolve.levels) < len(ref_M.Lsolve.levels)
    fields = dict(its=_ITS, ilu=dict(ILU_lfil=fill))
    res, x = str_run(A, b, "krylov_ilu", fields)
    ref = jax_solvers.krylov_ilu(_to_jax(A), b,
                                 its=jax_params.ITSParam(**_ITS),
                                 ilu=jax_params.ILUParam(ILU_lfil=fill))
    assert (int(res.iters), int(res.status)) == \
        (int(ref.iters), int(ref.status))
    np.testing.assert_allclose(x, np.asarray(ref.x), rtol=0, atol=1e-10)


def test_amg_drivers_on_str_do_what_jax_does(monkeypatch):
    """The AMG drivers raise the JAX package's TypeError for an STR
    matrix; solve_amg falls back to GMRES as it does, with its count."""
    A, _, b = chip_smoke.str_problem(4)
    Aj = _to_jax(A)
    nk = np.ones((A.nrow, 1))
    for fn, args in (("krylov_amg", ()), ("solve_famg", ()),
                     ("krylov_amg_nk", (nk,))):
        with pytest.raises(TypeError, match="cannot build device operator"):
            getattr(jax_solvers, fn)(Aj, b, *args)
        with pytest.raises(TypeError, match="cannot build device operator"):
            getattr(solvers, fn)(A, b, *args, device="cpu")
    warned = []
    monkeypatch.setattr(messages, "warn", warned.append)
    amg = dict(maxit=30, tol=1e-8)
    got = solvers.solve_amg(A, b, amg=AMGParam(**amg), device="cpu")
    ref = jax_solvers.solve_amg(Aj, b, amg=jax_params.AMGParam(**amg))
    _assert_same(got, ref)
    assert len(warned) == 1 and "falling back to GMRES" in warned[0]
    for fn in ("krylov_swz", "krylov_ilu_m", "krylov_block",
               "krylov_sweeping", "krylov_nk_amg"):
        args = (nk,) if fn == "krylov_nk_amg" else ()
        with pytest.raises(solvers.drivers.FaspError):
            getattr(solvers, fn)(A, b, *args, device="cpu")


def test_str_modules_move_and_copy():
    """Every STR preconditioner holds its arrays as buffers of one dtype
    (a float32 setup too) and deep-copies (the ILU's CUDA graph is not
    copied)."""
    import copy
    A = _str(*GRIDS["3-D 6x5x4 nc=3"])
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(A.nrow))
    for M in (port_str.setup_str_diag(A, torch.float32),
              port_str.setup_str_blockgs(A, dtype=torch.float32),
              port_str.setup_str_ilu(A, 1, torch.float32),
              port_str.setup_str_schwarz(A, torch.float32)):
        floats = {t.dtype for t in M.buffers() if t.is_floating_point()}
        assert floats == {torch.float32}, type(M).__name__
        z = M(r.float())
        assert torch.equal(copy.deepcopy(M)(r.float()), z)
        assert _rel(z.double(), M.double()(r)) < 1e-5
