"""The port's structured SA-AMG setup against the JAX package's on
poisson_2d(191): 36,481 dof (>= 2^15, so the fine level is a factored
StencilNdOperator) with ragged 3-aggregation (191 -> 64 -> 22).  Both
packages run the same host band algebra and the same native smoothed
RAP (compiled from the one C++ source), so the arrays must be bit-equal;
the transfer applies agree to 1e-13 (normwise relative)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native

from faspsolver_tpu.constants import SmootherType
from faspsolver_tpu.precond.amg import setup_structured as jax_setup
from faspsolver_tpu.testgen import poisson_2d
from faspsolver_tpu.utils.params import AMGParam
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.ops.operators import FactoredBand
from faspsolver_tpu_torch.precond.amg import setup_structured
from faspsolver_tpu_torch.precond.amg.structured import (
    _compact_vec, _prolong_once, _restrict_once, detect_dims)

torch.set_num_threads(2)
ensure_native()       # both packages on the one race-free native build

PARAM = AMGParam(smoother=int(SmootherType.CHEBYSHEV), polynomial_degree=2,
                 coarse_dof=800, tentative_smooth=0.67)
A = poisson_2d(191)
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    jdt, tdt = DTYPES[request.param]
    ref = jax_setup(A, PARAM, dtype=jdt, smooth_p=True, keep_f64_fine=True)
    got = setup_structured(A, PARAM, dtype=tdt, smooth_p=True,
                           keep_f64_fine=True)
    return ref, got


def _leaves(op):
    """Arrays that define an operator, in a fixed order."""
    name = type(op).__name__
    if name == "StencilNdOperator":
        out = []
        for b in op.bands:
            if type(b).__name__ == "FactoredBand":
                out += [b.row_sel, b.core, b.col_sel]
            else:
                out.append(b)
        return out
    if name == "DenseOperator":
        return [op.mat]
    return [op.bands]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, ref):
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max() / np.abs(ref).max())


def test_same_levels_and_operator_classes(pair):
    ref, got = pair
    assert got.num_levels == len(ref.levels) == 3
    for lg, lr in zip(got.levels, ref.levels):
        assert type(lg.A).__name__ == type(lr.A).__name__
        assert lg.A.shape == lr.A.shape
        assert type(lg.P).__name__ == type(lr.P).__name__
    assert type(got.levels[0].A).__name__ == "StencilNdOperator"
    assert all(isinstance(b, FactoredBand) for b in got.levels[0].A.bands)
    assert type(got.coarse).__name__ == type(ref.coarse).__name__
    assert type(got.fine64).__name__ == type(ref.fine64).__name__


def test_operators_bit_equal(pair):
    ref, got = pair
    for lg, lr in zip(got.levels, ref.levels):
        for a, b in zip(_leaves(lg.A), _leaves(lr.A)):
            assert _np(a).dtype == _np(b).dtype
            np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(_leaves(got.fine64), _leaves(ref.fine64)):
        assert _np(a).dtype == np.float64
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(got.coarse.inv.numpy(),
                                  np.asarray(ref.coarse.inv))


def test_smoother_data_equal(pair):
    ref, got = pair
    for lg, lr in zip(got.levels[:-1], ref.levels[:-1]):
        sg, sr = lg.smoother, lr.smoother
        assert (sg.kind, sg.relax, sg.nsweep_scale) == \
            (sr.kind, sr.relax, sr.nsweep_scale)
        np.testing.assert_array_equal(sg.dinv.numpy(), np.asarray(sr.dinv))
        assert sg.lambda_max == np.asarray(sr.lambda_max)
        assert sg.lambda_max.dtype == np.asarray(sr.lambda_max).dtype
    # the fine dinv stays compacted to shape (1,)
    assert tuple(got.levels[0].smoother.dinv.shape) == (1,)


def test_transfer_applies_equal(pair):
    ref, got = pair
    rng = np.random.default_rng(17)
    for lg, lr in zip(got.levels[:-1], ref.levels[:-1]):
        nc, nf = lr.R.shape
        dt = _np(_leaves(lr.A)[0]).dtype
        tol = 1e-13 if dt == np.float64 else 1e-6
        xc = rng.standard_normal(nc).astype(dt)
        r = rng.standard_normal(nf).astype(dt)
        assert _rel(lg.P(torch.from_numpy(xc)), lr.P(jnp.asarray(xc))) < tol
        assert _rel(lg.R(torch.from_numpy(r)), lr.R(jnp.asarray(r))) < tol
        assert _rel(lg.A(torch.from_numpy(r)), lr.A(jnp.asarray(r))) < tol


def test_convert_round_trip(pair):
    """from_jax carries the JAX hierarchy across: the same arrays as the
    port's own setup, with the level's A shared by its transfers."""
    ref, got = pair
    conv = from_jax(ref)
    for lc, lg in zip(conv.levels, got.levels):
        if lc.P is not None:
            assert lc.P.A is lc.A and lc.R.A is lc.A
        for a, b in zip(_leaves(lc.A), _leaves(lg.A)):
            np.testing.assert_array_equal(_np(a), _np(b))
    assert tuple(conv.levels[0].smoother.dinv.shape) == (1,)
    assert conv.levels[0].smoother.dinv is conv.levels[0].P.dinv
    for a, b in zip(_leaves(conv.fine64), _leaves(got.fine64)):
        np.testing.assert_array_equal(_np(a), _np(b))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(A.nrow))
    np.testing.assert_array_equal(conv.fine64(x).numpy(),
                                  got.fine64(x).numpy())


@pytest.mark.parametrize("d,s", [(9, 3), (10, 3), (11, 3), (7, 2)])
def test_restrict_prolong_adjoint_ragged(d, s):
    """Ragged pair transfers: R and P are exact adjoints (P = R^T) and
    match the JAX package's."""
    from faspsolver_tpu.precond.amg.structured import (
        _prolong_once as jp, _restrict_once as jr)
    dims = (d, 5)
    rng = np.random.default_rng(d)
    r = rng.standard_normal(d * 5)
    xc = rng.standard_normal(((d + s - 1) // s) * 5)
    Rr = _restrict_once(torch.from_numpy(r), dims, 0, s).numpy()
    Px = _prolong_once(torch.from_numpy(xc), dims, 0, s).numpy()
    np.testing.assert_allclose(Rr, np.asarray(jr(jnp.asarray(r), dims, 0, s)),
                               rtol=1e-14)
    np.testing.assert_array_equal(Px, np.asarray(jp(jnp.asarray(xc), dims,
                                                    0, s)))
    assert abs(Rr @ xc - r @ Px) < 1e-12


def test_detect_dims_and_compact_vec():
    from faspsolver_tpu.precond.amg.structured import detect_dims as jdd
    for offs, n in (([-1023, -1, 0, 1, 1023], 1023 * 1023),
                    ([-30, -6, -1, 0, 1, 6, 30], 120), ([-1, 0, 1], 50)):
        assert detect_dims(offs, n) == jdd(offs, n)
    assert _compact_vec(np.full(9, 2.5)).shape == (1,)
    w = np.arange(4.0)
    assert _compact_vec(w) is w


def test_native_helper_survives_a_lost_build_race():
    """A worker whose JAX loader lost the build race (``_tried`` set, no
    library) gets both packages' native libraries from the helper, and
    the structured setup of both takes the native fused RAP."""
    code = """
import faspsolver_tpu.native as jn
jn._tried, jn._lib = True, None
assert not jn.available()
from native_parity import ensure_native
ensure_native()
from faspsolver_tpu_torch import native as tn
assert jn.available() and tn.available()
calls = []
for mod in (jn, tn):
    def spy(*a, _f=mod.smoothed_rap, _m=mod.__name__, **k):
        out = _f(*a, **k)
        calls.append((_m, out is not None))
        return out
    mod.smoothed_rap = spy
import jax
jax.config.update("jax_enable_x64", True)
from faspsolver_tpu.precond.amg import setup_structured as jax_setup
from faspsolver_tpu.testgen import poisson_2d
from faspsolver_tpu_torch.precond.amg import setup_structured
A = poisson_2d(191)
jax_setup(A, smooth_p=True)
setup_structured(A, smooth_p=True)
assert {m for m, ok in calls if ok} == {jn.__name__, tn.__name__}, calls
assert all(ok for _, ok in calls), calls
print("ok")
"""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")
