"""The port's aggregation, SA and UA setups against the JAX package's.

The host code is the JAX package's over the same native matchers, so the
aggregation maps are equal for PAIRWISE, VMB and NPAIR (including the
NPAIR -> VMB fallback), and the SA and UA hierarchies are equal buffer
for buffer (level operators, transfers, smoothers with their color
blocks, coarse inverses), with equal cycle types, AMLI coefficients and
UA level visits.  The boolean transfers apply within 1e-14 (f64)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from native_parity import ensure_native

from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.precond.amg import aggregation as jax_agg
from faspsolver_tpu.precond.amg import setup_sa as jax_setup_sa
from faspsolver_tpu.precond.amg import setup_ua as jax_setup_ua
from faspsolver_tpu.precond.amg.setup_ua import \
    build_hierarchy_from_host as jax_build
from faspsolver_tpu.utils.params import AMGParam as JaxAMGParam
from faspsolver_tpu_torch.constants import AggregationType, AMGType, CycleType
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.formats import CSRMatrix
from faspsolver_tpu_torch.precond.amg import aggregation, setup_sa, setup_ua
from faspsolver_tpu_torch.precond.amg.setup_ua import build_hierarchy_from_host
from faspsolver_tpu_torch.testgen import (assemble_poisson, poisson_2d,
                                          unit_square_mesh)
from faspsolver_tpu_torch.utils.params import AMGParam

torch.set_num_threads(2)
ensure_native()

AGG = {"PAIRWISE": int(AggregationType.PAIRWISE),
       "VMB": int(AggregationType.VMB), "NPAIR": int(AggregationType.NPAIR)}


def _j(A):
    return JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)


def _fe(m):
    A, _, _ = assemble_poisson(unit_square_mesh(m), lambda p: np.ones(len(p)))
    return A


PROBLEMS = {"poisson_2d(63)": lambda: poisson_2d(63),
            "unit_square_mesh(48)": lambda: _fe(48)}


def assert_same_hierarchy(got, ref):
    """The port's hierarchy against the JAX one carried across: the same
    module tree, equal buffers, equal cycle fields."""
    conv = from_jax(ref)
    gb = dict(got.named_buffers(remove_duplicate=False))
    cb = dict(conv.named_buffers(remove_duplicate=False))
    assert gb.keys() == cb.keys()
    for k in gb:
        assert gb[k].dtype == cb[k].dtype, k
        np.testing.assert_array_equal(gb[k].numpy(), cb[k].numpy(), err_msg=k)
    assert [type(m).__name__ for m in got.modules()] == \
        [type(m).__name__ for m in conv.modules()]
    for f in ("cycle_type", "amli_degree", "amli_coefs", "level_visits",
              "presmooth_iter", "postsmooth_iter", "coarse_scaling"):
        assert getattr(got, f) == getattr(conv, f), f


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("agg", list(AGG))
def test_aggregation_maps_match_jax(agg, problem):
    A = PROBLEMS[problem]()
    kw = dict(aggregation_type=AGG[agg])
    got = aggregation.aggregate(A, AMGParam(**kw), 0.08)
    ref = jax_agg.aggregate(_j(A), JaxAMGParam(**kw), 0.08)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] < A.nrow


def test_npair_stall_falls_back_to_vmb():
    """On a strongly shifted Poisson matrix no pair clears the quality
    bound, so NPAIR falls back to VMB in both packages."""
    A = CSRMatrix.from_scipy(
        (poisson_2d(15).to_scipy() + 1e3 * sp.identity(225)).tocsr())
    _, nagg = aggregation.aggregate_nsympair(A, 2, 8.0)
    assert nagg * 2 > A.nrow
    kw = dict(aggregation_type=AGG["NPAIR"])
    got = aggregation.aggregate(A, AMGParam(**kw), 0.08)
    ref = jax_agg.aggregate(_j(A), JaxAMGParam(**kw), 0.08)
    vmb = aggregation.aggregate_vmb(A, 0.08, AMGParam().max_aggregation)
    for a, b in ((got, ref), (got, vmb)):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


@pytest.mark.parametrize("nk", [False, True], ids=["plain", "near-kernel"])
@pytest.mark.parametrize("agg", ["VMB", "PAIRWISE"])
def test_sa_hierarchy_matches_jax(agg, nk):
    A = _fe(48)
    kw = dict(AMG_type=int(AMGType.SA), aggregation_type=AGG[agg],
              cycle_type=int(CycleType.AMLI), amli_degree=3)
    basis = np.ones((A.nrow, 1)) if nk else None
    got = setup_sa(A, AMGParam(**kw), nk=basis)
    ref = jax_setup_sa(_j(A), JaxAMGParam(**kw), dtype=jnp.float64, nk=basis)
    assert got.num_levels == ref.num_levels >= 2
    assert_same_hierarchy(got, ref)


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("agg", list(AGG))
def test_ua_hierarchy_matches_jax(agg, problem):
    A = PROBLEMS[problem]()
    kw = dict(AMG_type=int(AMGType.UA), aggregation_type=AGG[agg])
    got = setup_ua(A, AMGParam(**kw))
    ref = jax_setup_ua(_j(A), JaxAMGParam(**kw), dtype=jnp.float64)
    assert got.num_levels == ref.num_levels >= 2
    assert_same_hierarchy(got, ref)
    # the visit rule runs from three levels on
    assert len(got.level_visits) == (got.num_levels - 1
                                     if got.num_levels > 2 else 0)


def test_ua_structured_route_matches_jax():
    """``structured=True`` takes the structured hierarchy in both."""
    A = poisson_2d(63)
    kw = dict(AMG_type=int(AMGType.UA))
    got = setup_ua(A, AMGParam(**kw), structured=True)
    ref = jax_setup_ua(_j(A), JaxAMGParam(**kw), dtype=jnp.float64,
                       structured=True)
    assert [type(lvl.A).__name__ for lvl in got.levels] == \
        [type(lvl.A).__name__ for lvl in ref.levels]
    assert type(got.levels[0].P).__name__ == "PairProlong"


def test_ua_complexity_rule_upgrades_to_nl_amli_like_jax():
    """Four host levels of equal nnz: operator complexity 4 > 3 turns a
    V-cycle request into NL-AMLI, with the same level visits."""
    A = poisson_2d(31)
    levels = [A] * 4
    aggs = [(np.arange(A.nrow), A.nrow)] * 3
    got = build_hierarchy_from_host(levels, aggs, AMGParam(), torch.float64)
    ref = jax_build([_j(A)] * 4, aggs, JaxAMGParam(), jnp.float64)
    assert got.cycle_type == int(CycleType.NL_AMLI) == ref.cycle_type
    assert got.level_visits == ref.level_visits == (1, 1, 1)
    assert_same_hierarchy(got, ref)


def test_agg_transfers_match_jax():
    A = _fe(48)
    kw = dict(AMG_type=int(AMGType.UA))
    got = setup_ua(A, AMGParam(**kw))
    ref = jax_setup_ua(_j(A), JaxAMGParam(**kw), dtype=jnp.float64)
    rng = np.random.default_rng(2)
    for lg, lr in zip(got.levels[:-1], ref.levels[:-1]):
        xc = rng.standard_normal(lg.P.n_coarse)
        xf = rng.standard_normal(lg.P.n_fine)
        for mine, theirs, v in ((lg.P, lr.P, xc), (lg.R, lr.R, xf)):
            want = np.asarray(theirs(jnp.asarray(v)))
            out = mine(torch.from_numpy(v)).numpy()
            assert out.shape == (mine.shape[0],)
            assert np.linalg.norm(out - want) <= 1e-14 * np.linalg.norm(want)
