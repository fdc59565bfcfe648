"""The port's classical Ruge-Stuben AMG path against the JAX package's, on
P1-FE Poisson matrices (the general stanza's problem at reduced size).

Both packages run the same host setup code over the same native C++
entries, so coarsening, interpolation, Galerkin products and the
per-level operators agree bit for bit (unit_square_mesh(129), 16,384
dof, and 256, 65,025 dof).  Operator and transfer applies agree to 1e-13
in f64 and 1e-6 in f32 (normwise relative); f64 AMG-PCG takes the same
iterations with the same status and x agrees to 1e-10; the f32 solve
refined in f64 takes inner-iteration totals within 2 (f32 sums run in
another order under XLA than under torch)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native

from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.krylov import pcg as jax_pcg
from faspsolver_tpu.ops import operators as jax_ops
from faspsolver_tpu.precond import AMGPrecond as JaxAMGPrecond
from faspsolver_tpu.precond.amg import coarsen_rs as jax_coarsen
from faspsolver_tpu.precond.amg import interp as jax_interp
from faspsolver_tpu.precond.amg import smoothers as jax_smoothers
from faspsolver_tpu.precond.amg.cycles import mgcycle as jax_mgcycle
from faspsolver_tpu.precond.amg.setup_rs import _rap as jax_rap
from faspsolver_tpu.precond.amg.setup_rs import \
    _smoothing_bands as jax_smoothing_bands
from faspsolver_tpu.precond.amg.setup_rs import setup_cr as jax_setup_cr
from faspsolver_tpu.precond.amg.setup_rs import setup_rs as jax_setup_rs
from faspsolver_tpu.solvers import solve_refined_resident as jax_refined
from faspsolver_tpu.utils.params import AMGParam as JaxAMGParam
from faspsolver_tpu_torch.constants import InterpType, SmootherType
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.krylov import pcg
from faspsolver_tpu_torch.ops import operators as ops
from faspsolver_tpu_torch.precond import AMGPrecond
from faspsolver_tpu_torch.precond.amg import build_smoother, mgcycle, setup_rs
from faspsolver_tpu_torch.precond.amg.coarsen_rs import coarsen
from faspsolver_tpu_torch.formats import BSRMatrix
from faspsolver_tpu_torch.precond.amg.interp import (interp_energymin,
                                                     interpolate)
from faspsolver_tpu_torch.precond.amg.setup_rs import (_rap,
                                                       _smoothing_bands,
                                                       setup_cr)
from faspsolver_tpu_torch.solvers import solve_refined_resident
from faspsolver_tpu_torch.testgen import assemble_poisson, unit_square_mesh
from faspsolver_tpu_torch.utils.params import AMGParam

torch.set_num_threads(2)
ensure_native()

# the general stanza's settings: Chebyshev(3), 2+2 sweeps, aggressive
# first-level coarsening with standard interpolation
KW = dict(smoother=int(SmootherType.CHEBYSHEV), polynomial_degree=3,
          presmooth_iter=2, postsmooth_iter=2, coarse_dof=800,
          aggressive_level=1)
DTYPES = {"f64": (jnp.float64, torch.float64, 1e-13),
          "f32": (jnp.float32, torch.float32, 1e-6)}
_FE = {}


def _fe(m):
    if m not in _FE:
        A, b, _ = assemble_poisson(unit_square_mesh(m),
                                   lambda p: np.ones(len(p)))
        _FE[m] = (A, b)
    return _FE[m]


def _j(A):
    """The same matrix as the JAX package's CSRMatrix."""
    return JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _japply(op, x):
    """The JAX operator applied as one compiled program (faster on the
    CPU than op-by-op dispatch)."""
    return jax.jit(lambda v: op(v))(jnp.asarray(x))


def _rel(got, ref):
    ref = _np(ref)
    return float(np.linalg.norm(_np(got) - ref) / np.linalg.norm(ref))


# arrays and static fields that define each class, in both packages
_FIELDS = {
    "DiaOperator": ("bands", "offsets", "n"),
    "ConstDiaOperator": ("consts", "masks", "offsets", "n"),
    "CooOperator": ("rows", "cols", "vals", "n", "ncol"),
    "EllOperator": ("cols", "vals", "n", "ncol"),
    "DenseOperator": ("mat", "n"),
    "FactoredBand": ("row_sel", "core", "col_sel"),
    "CooProlong": ("rows", "cols", "vals", "n_fine", "n_coarse"),
    "CooRestrict": ("rows", "cols", "vals", "n_fine", "n_coarse"),
    "BandedProlong": ("fpos", "w", "rem_rows", "rem_cols", "rem_vals", "wc",
                      "wm", "shifts", "n_fine", "n_coarse", "has_rem",
                      "const_mode"),
    "BandedRestrict": ("fpos", "w", "rem_rows", "rem_cols", "rem_vals", "wc",
                       "wm", "shifts", "n_fine", "n_coarse", "has_rem",
                       "const_mode"),
}


def assert_same_tree(got, ref):
    """Same class tree, bit-equal arrays of the same dtype."""
    name = type(ref).__name__
    assert type(got).__name__ == name
    if name == "SumOperator":
        assert len(got.parts) == len(ref.parts)
        for g, r in zip(got.parts, ref.parts):
            assert_same_tree(g, r)
    elif name == "HybridDiaOperator":
        assert_same_tree(got.dia, ref.dia)
        assert_same_tree(got.rem, ref.rem)
    elif name == "StencilNdOperator":
        assert (got.coords, got.dims) == (ref.coords, ref.dims)
        for g, r in zip(got.bands, ref.bands):
            if type(r).__name__ == "FactoredBand":
                assert_same_tree(g, r)
            else:
                np.testing.assert_array_equal(_np(g), _np(r))
    else:
        for f in _FIELDS[name]:
            g, r = getattr(got, f), getattr(ref, f)
            if r is None or isinstance(r, (int, bool, tuple)):
                assert g == r or (g is None and r is None), f
            else:
                assert _np(g).dtype == _np(r).dtype, f
                np.testing.assert_array_equal(_np(g), _np(r))


# ---------------------------------------------------------------------------
# host setup: coarsening, interpolation, Galerkin product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["rs", "aggressive", "pmis", "cr"])
def test_coarsen_equal(method):
    A, _ = _fe(129)
    marker, S = coarsen(A, 0.3, 0.9, method=method, aggressive_path=1)
    mr, Sr = jax_coarsen.coarsen(A, 0.3, 0.9, method=method,
                                 aggressive_path=1)
    np.testing.assert_array_equal(marker, mr)
    for a, b in ((S.indptr, Sr.indptr), (S.indices, Sr.indices),
                 (S.data, Sr.data)):
        np.testing.assert_array_equal(a, b)
    assert 0 < (marker == 1).sum() < A.nrow


@pytest.mark.parametrize("itype", ["STANDARD", "DIRECT", "EXTENDED"])
def test_interpolate_and_rap_equal(itype):
    A, _ = _fe(129)
    marker, S = coarsen(A, 0.3, 0.9, method="rs")
    it = int(InterpType[itype])
    P = interpolate(A, marker, S, interp_type=it, trunc_threshold=0.2)
    Pr = jax_interp.interpolate(A, marker, S, interp_type=it,
                                trunc_threshold=0.2)
    for a, b in ((P.indptr, Pr.indptr), (P.indices, Pr.indices),
                 (P.data, Pr.data)):
        np.testing.assert_array_equal(a, b)
    Ac = _rap(P, A, P.transpose())
    Acr = jax_rap(Pr, A, Pr.transpose())
    for a, b in ((Ac.indptr, Acr.indptr), (Ac.indices, Acr.indices),
                 (Ac.data, Acr.data)):
        np.testing.assert_array_equal(a, b)


def _coarse_level(m):
    """The first aggressive RS coarse level of the FE matrix (a classical
    Galerkin operator: mostly banded with a thin irregular tail)."""
    A, _ = _fe(m)
    marker, S = coarsen(A, 0.3, 0.9, method="aggressive", aggressive_path=1)
    P = interpolate(A, marker, S, interp_type=int(InterpType.STANDARD))
    return _rap(P, A, P.transpose())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("which", ["fine129", "coarse256", "ell", "coo",
                                   "dense"])
def test_operator_formats_equal_and_apply(which, dt):
    """best_operator / device_operator build the JAX package's operator
    (class tree and arrays, including the f32 demotion of near-constant
    band entries into the COO remainder), and apply to seeded vectors
    alike."""
    jdt, tdt, tol = DTYPES[dt]
    if which == "coarse256":
        A = _coarse_level(256)
    else:
        A = _fe(17 if which == "dense" else 129)[0]
    prefer = {"ell": "ell", "coo": "coo", "dense": "dense"}.get(which)
    if prefer is None:
        got = ops.best_operator(A, dtype=tdt)
        ref = jax_ops.best_operator(_j(A), dtype=jdt)
    else:
        got = ops.device_operator(A, dtype=tdt, prefer=prefer)
        ref = jax_ops.device_operator(_j(A), dtype=jdt, prefer=prefer)
    assert_same_tree(got, ref)
    expect = {"fine129": {"f64": "SumOperator", "f32": "StencilNdOperator"},
              "coarse256": {"f64": "HybridDiaOperator",
                            "f32": "HybridDiaOperator"}}.get(which)
    if expect:
        assert type(got).__name__ == expect[dt]
    x = np.random.default_rng(7).standard_normal(A.nrow).astype(jdt)
    assert _rel(got(torch.from_numpy(x)), _japply(ref, x)) < tol
    if hasattr(ref, "diagonal"):
        assert _rel(got.diagonal(), ref.diagonal()) < tol


def test_f32_demotion_split_reaches_the_remainder():
    """On the coarse Galerkin level the f32 path compresses near-constant
    bands by moving their boundary rows into the COO remainder: more
    remainder entries than in f64, the same as JAX's."""
    Ac = _coarse_level(256)
    op32 = ops.best_operator(Ac, dtype=torch.float32)
    op64 = ops.best_operator(Ac, dtype=torch.float64)
    assert op32.rem.vals.numel() > op64.rem.vals.numel()
    assert type(op32.dia.parts[0]).__name__ == "ConstDiaOperator"
    ref = jax_ops.best_operator(_j(Ac), dtype=jnp.float32)
    assert_same_tree(op32, ref)
    words = ops.pack_bits(np.arange(77) % 3 == 0)
    np.testing.assert_array_equal(words, jax_ops.pack_bits(
        np.arange(77) % 3 == 0))
    np.testing.assert_array_equal(
        ops.unpack_bits(torch.from_numpy(words), 77, torch.float64).numpy(),
        (np.arange(77) % 3 == 0).astype(np.float64))


@pytest.mark.parametrize("kind", ["JACOBI", "L1DIAG", "CHEBYSHEV",
                                  "POLY"])
def test_build_smoother_equal(kind):
    A, _ = _fe(129)
    k = int(SmootherType[kind])
    got = build_smoother(A, k, relax=0.8, poly_degree=3,
                         dtype=torch.float32)
    ref = jax_smoothers.build_smoother(A, k, relax=0.8, poly_degree=3,
                                       dtype=jnp.float32)
    assert (got.kind, got.relax, got.nsweep_scale) == \
        (ref.kind, ref.relax, ref.nsweep_scale)
    for f in ("dinv", "l1inv"):
        if getattr(ref, f) is not None:
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          _np(getattr(ref, f)))
    if ref.lambda_max is not None:
        assert got.lambda_max == np.asarray(ref.lambda_max)
        assert got.lambda_max.dtype == np.asarray(ref.lambda_max).dtype


def test_chebyshev_gershgorin_bound_above_200k():
    """Above 200k dof lambda_max is the Gershgorin bound (no power
    iteration), as in the JAX package."""
    A, _ = _fe(449)                          # 448^2 = 200,704 dof
    got = build_smoother(A, int(SmootherType.CHEBYSHEV), poly_degree=3)
    ref = jax_smoothers.build_smoother(A, int(SmootherType.CHEBYSHEV),
                                       poly_degree=3, dtype=jnp.float64)
    assert got.lambda_max == np.asarray(ref.lambda_max)
    assert got.lambda_max >= 1.0


# ---------------------------------------------------------------------------
# the hierarchy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rs256():
    A, b = _fe(256)
    out = {}
    for dt, (jdt, tdt, _) in DTYPES.items():
        ref = jax_setup_rs(_j(A), JaxAMGParam(**KW), dtype=jdt,
                                    keep_f64_fine=True, filter_smoother=True)
        got = setup_rs(A, AMGParam(**KW), dtype=tdt, keep_f64_fine=True,
                       filter_smoother=True)
        out[dt] = (ref, got)
    return A, b, out


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_setup_rs_levels_equal(rs256, dt):
    """Same levels, the same operator/transfer classes and arrays as the
    JAX package's setup (the fine level a factored 7-band stencil, the
    coarse ones classical hybrids, a dense coarsest level)."""
    A, _, out = rs256
    ref, got = out[dt]
    assert got.num_levels == len(ref.levels) == 5
    for lg, lr in zip(got.levels, ref.levels):
        assert_same_tree(lg.A, lr.A)
        assert (lg.Asm is None) == (lr.Asm is None)
        if lr.P is not None:
            assert_same_tree(lg.P, lr.P)
            assert_same_tree(lg.R, lr.R)
            assert lg.smoother.lambda_max == np.asarray(
                lr.smoother.lambda_max)
    assert type(got.levels[0].A).__name__ == "StencilNdOperator"
    assert len(got.levels[0].A.bands) == 7
    assert type(got.levels[1].A).__name__ == "HybridDiaOperator"
    assert_same_tree(got.fine64, ref.fine64)
    assert got.fine64.dtype == torch.float64
    np.testing.assert_array_equal(got.coarse.inv.numpy(),
                                  np.asarray(ref.coarse.inv))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_setup_rs_applies_equal(rs256, dt):
    _, _, out = rs256
    ref, got = out[dt]
    tol = DTYPES[dt][2]
    rng = np.random.default_rng(11)
    jdt = DTYPES[dt][0]
    for lg, lr in zip(got.levels[:-1], ref.levels[:-1]):
        nc, nf = lr.R.shape
        xc = rng.standard_normal(nc).astype(jdt)
        xf = rng.standard_normal(nf).astype(jdt)
        assert _rel(lg.A(torch.from_numpy(xf)), _japply(lr.A, xf)) < tol
        assert _rel(lg.P(torch.from_numpy(xc)), _japply(lr.P, xc)) < tol
        assert _rel(lg.R(torch.from_numpy(xf)), _japply(lr.R, xf)) < tol


def test_setup_rs_filter_smoother_off_same_structure(rs256):
    """filter_smoother False builds the same levels (no grid level of the
    FE problem is gather-based, so neither setting filters here)."""
    A, _, out = rs256
    _, on = out["f32"]
    off = setup_rs(A, AMGParam(**KW), dtype=torch.float32,
                   filter_smoother=False)
    ref = jax_setup_rs(_j(A), JaxAMGParam(**KW), dtype=jnp.float32,
                                filter_smoother=False)
    assert off.num_levels == on.num_levels == len(ref.levels)
    for lo, ln, lr in zip(off.levels, on.levels, ref.levels):
        assert lo.A.shape == ln.A.shape == lr.A.shape
        assert type(lo.A).__name__ == type(ln.A).__name__ == \
            type(lr.A).__name__
        assert type(lo.P).__name__ == type(lr.P).__name__
        assert lo.Asm is None and lr.Asm is None
    assert off.fine64 is None


def test_amg_pcg_f64_matches_jax(rs256):
    A, b, out = rs256
    ref, got = out["f64"]
    r_ref = jax_pcg(ref.levels[0].A, jnp.asarray(b), M=JaxAMGPrecond(ref),
                    tol=1e-8, maxit=100)
    r = pcg(got.levels[0].A, torch.from_numpy(b), M=AMGPrecond(got),
            tol=1e-8, maxit=100)
    assert r.iters == int(r_ref.iters)
    assert r.status == int(r_ref.status)
    assert r.converged
    assert _rel(r.x, r_ref.x) < 1e-10


def test_refinement_matches_jax(rs256):
    """f32 RS-AMG-PCG inside f64 refinement on the exact b, with the
    general stanza's settings."""
    A, b, out = rs256
    ref, got = out["f32"]
    tol = 1e-6
    kw = dict(tol=tol, inner_tol=1e-4, inner_floor=1e-4, max_rounds=6,
              maxit_inner=40)
    r_ref = jax_refined(ref, b, **kw)
    r = solve_refined_resident(got, b, **kw)
    assert r.converged and r_ref.converged
    assert r.rounds == r_ref.rounds
    assert abs(r.inner_iters - r_ref.inner_iters) <= 2
    host = float(np.linalg.norm(b - A.matvec(r.x)) / np.linalg.norm(b))
    assert host < tol


def test_fine64_fallback_past_the_1mb_cut():
    """On unit_square_mesh(193) the f64 stencil factors only 2 of its 7
    bands (1.47 MB), so the fine64 is best_operator's f64 constant-band
    operator in both packages."""
    A, _ = _fe(193)
    p = dataclasses.replace(AMGParam(**KW), max_levels=2)
    jp = dataclasses.replace(JaxAMGParam(**KW), max_levels=2)
    got = setup_rs(A, p, dtype=torch.float32, keep_f64_fine=True)
    ref = jax_setup_rs(_j(A), jp, dtype=jnp.float32,
                                keep_f64_fine=True)
    assert type(got.fine64).__name__ == "SumOperator"
    assert_same_tree(got.fine64, ref.fine64)
    x = np.random.default_rng(2).standard_normal(A.nrow)
    np.testing.assert_allclose(got.fine64(torch.from_numpy(x)).numpy(),
                               A.matvec(x), rtol=0, atol=1e-13)


def test_from_jax_round_trip(rs256):
    """from_jax carries an RS hierarchy across: the arrays of the port's
    own setup, and a COO transfer pair keeps one set of arrays."""
    _, _, out = rs256
    for ref, got in out.values():
        conv = from_jax(ref)
        assert conv.num_levels == got.num_levels
        for lc, lg in zip(conv.levels, got.levels):
            assert_same_tree(lc.A, lg.A)
            if lg.P is not None:
                assert_same_tree(lc.P, lg.P)
                assert_same_tree(lc.R, lg.R)
                if type(lc.P).__name__ == "CooProlong":
                    assert lc.R.vals is lc.P.vals
        assert_same_tree(conv.fine64, got.fine64)
        b = torch.from_numpy(np.random.default_rng(5).standard_normal(
            got.levels[0].A.n)).to(got.levels[0].A.dtype)
        np.testing.assert_array_equal(mgcycle(conv, b).numpy(),
                                      mgcycle(got, b).numpy())


def test_filtered_smoothing_on_gather_levels():
    """A randomly renumbered FE matrix has no banded structure: its levels
    are ELL, and filter_smoother gives them the banded smoothing
    operator (AMGLevel.Asm) the JAX package builds; one V-cycle through
    it agrees to 1e-12."""
    A, _ = _fe(65)
    perm = np.random.default_rng(3).permutation(A.nrow)
    Ap = A.permute(perm)
    kw = dict(KW, aggressive_level=0)
    got = setup_rs(Ap, AMGParam(**kw), filter_smoother=True)
    ref = jax_setup_rs(_j(Ap), JaxAMGParam(**kw), dtype=jnp.float64,
                                filter_smoother=True)
    assert type(got.levels[0].A).__name__ == "EllOperator"
    assert type(got.levels[0].Asm).__name__ == "DiaOperator"
    for lg, lr in zip(got.levels, ref.levels):
        assert (lg.Asm is None) == (lr.Asm is None)
        if lr.Asm is not None:
            assert_same_tree(lg.Asm, lr.Asm)
    assert_same_tree(_smoothing_bands(Ap, torch.float64),
                     jax_smoothing_bands(Ap, jnp.float64))
    b = np.random.default_rng(8).standard_normal(A.nrow)
    z_ref = np.asarray(jax.jit(lambda v: jax_mgcycle(ref, v))(
        jnp.asarray(b)))
    assert _rel(mgcycle(got, torch.from_numpy(b)), z_ref) < 1e-12


def test_not_ported_branches_raise():
    """The branches that used to wait for later items are ported: ILU and
    Schwarz level smoothers, energy-minimizing interpolation, a BSR
    operator.  What is not a host matrix still raises."""
    A, _ = _fe(33)
    for kw in (dict(ILU_levels=1), dict(SWZ_levels=1)):
        hier = setup_rs(A, AMGParam(**dict(KW, coarse_dof=100, **kw)))
        assert type(hier.levels[0].smoother).__name__ == "PrecondSmoother"
    marker, S = coarsen(A, 0.3, 0.9)
    P = interpolate(A, marker, S, interp_type=int(InterpType.ENERGYMIN))
    assert P.shape[0] == A.nrow
    bsr = BSRMatrix.from_csr(A, 1)
    assert type(ops.device_operator(bsr)).__name__ == "BsrEllOperator"
    with pytest.raises(TypeError, match="cannot build device operator"):
        ops.device_operator(object())


SMOOTHER_LEVELS = {
    "ILU_levels=1": dict(ILU_levels=1),
    "ILU_levels=2 ILUt": dict(ILU_levels=2, ILU_type=2, ILU_droptol=1e-2),
    "SWZ_levels=1": dict(SWZ_levels=1, SWZ_maxlvl=2, SWZ_type=3),
}


@pytest.mark.parametrize("case", list(SMOOTHER_LEVELS))
def test_precond_smoother_levels_match_jax(case):
    """ILU / Schwarz as the smoother of the finest levels: the same
    levels carry a PrecondSmoother in both packages and one V-cycle
    agrees to 1e-12."""
    A, _ = _fe(33)
    kw = dict(coarse_dof=100, presmooth_iter=1, postsmooth_iter=1,
              **SMOOTHER_LEVELS[case])
    got = setup_rs(A, AMGParam(**kw))
    ref = jax_setup_rs(_j(A), JaxAMGParam(**kw), dtype=jnp.float64)
    names = [type(l.smoother).__name__ for l in got.levels]
    assert names == [type(l.smoother).__name__ for l in ref.levels]
    nsm = kw.get("ILU_levels", 0) + kw.get("SWZ_levels", 0)
    assert names[:nsm] == ["PrecondSmoother"] * nsm
    assert names[nsm] != "PrecondSmoother"
    inner = "ILUPrecond" if "ILU_levels" in kw else "SchwarzPrecond"
    assert type(got.levels[0].smoother.M).__name__ == inner
    b = np.random.default_rng(9).standard_normal(A.nrow)
    z_ref = np.asarray(jax.jit(lambda v: jax_mgcycle(ref, v))(jnp.asarray(b)))
    assert _rel(mgcycle(got, torch.from_numpy(b)), z_ref) < 1e-12
    assert _rel(mgcycle(from_jax(ref), torch.from_numpy(b)), z_ref) < 1e-12


def test_level_smoother_falls_back_on_host_factorization_errors_only(
        monkeypatch):
    """A FaspError from the host factorization leaves the level its
    standard smoother, as the reference does; any other error raises."""
    from faspsolver_tpu_torch.precond import ilu as port_ilu
    from faspsolver_tpu_torch.utils import FaspError
    A, _ = _fe(33)
    param = AMGParam(coarse_dof=100, ILU_levels=1)

    def fail(exc):
        def setup(*args, **kwargs):
            raise exc
        return setup

    monkeypatch.setattr(port_ilu, "setup_ilu", fail(FaspError(-45, "ILU")))
    hier = setup_rs(A, param)
    assert type(hier.levels[0].smoother).__name__ == "SmootherData"
    for exc in (RuntimeError("CUDA error"), NotImplementedError("later")):
        monkeypatch.setattr(port_ilu, "setup_ilu", fail(exc))
        with pytest.raises(type(exc)):
            setup_rs(A, param)


def test_interp_energymin_bit_equal_to_jax():
    A, _ = _fe(33)
    marker, S = coarsen(A, 0.3, 0.9)
    jmarker, jS = jax_coarsen.coarsen(_j(A), 0.3, 0.9)
    np.testing.assert_array_equal(marker, jmarker)
    P = interp_energymin(A, marker, S)
    Pj = jax_interp.interp_energymin(_j(A), jmarker, jS)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(P, f), getattr(Pj, f))
    assert P.shape == Pj.shape
    # partition of unity on the rows that interpolate
    rs = np.asarray(P.to_scipy().sum(axis=1)).ravel()
    assert np.allclose(rs[np.abs(rs) > 0], 1.0)
    got = setup_rs(A, AMGParam(coarse_dof=100,
                               interpolation_type=int(InterpType.ENERGYMIN)))
    ref = jax_setup_rs(_j(A), JaxAMGParam(
        coarse_dof=100, interpolation_type=int(InterpType.ENERGYMIN)),
        dtype=jnp.float64)
    for lg, lr in zip(got.levels, ref.levels):
        assert_same_tree(lg.A, lr.A)


def test_setup_cr_hierarchy_equal_to_jax():
    A, _ = _fe(33)
    kw = dict(coarse_dof=100)
    got = setup_cr(A, AMGParam(**kw))
    ref = jax_setup_cr(_j(A), JaxAMGParam(**kw), dtype=jnp.float64)
    assert got.num_levels == ref.num_levels >= 2
    for lg, lr in zip(got.levels, ref.levels):
        assert_same_tree(lg.A, lr.A)
        if lr.P is not None:
            assert_same_tree(lg.P, lr.P)
    b = np.random.default_rng(10).standard_normal(A.nrow)
    z_ref = np.asarray(jax.jit(lambda v: jax_mgcycle(ref, v))(jnp.asarray(b)))
    assert _rel(mgcycle(got, torch.from_numpy(b)), z_ref) < 1e-12
