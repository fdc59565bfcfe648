"""The resident loops' control (``faspsolver_tpu_torch/utils/loops.py``,
the plain twin of ``csrc/loop_control.cu``) and the loop bodies built on
it, on the CPU.

1. The twin's decisions are those of the eager loops' NumPy checks as
   they stood before the control existed (``_numpy_control`` below keeps
   them: NumPy scalars of b's dtype, Python's max / min, the roundings
   of the JAX package's traced scalar arithmetic), bit for bit, over the
   edge-case table chip_smoke.py holds the kernel to (every branch) and
   over the whole scalar sequences of real solves (poisson_2d(31) and
   poisson_fe_manufactured(16), in f32 and f64).
2. The port's PCG, BiCGstab, MINRES and ``_refine_body``, run through
   their loop trees and the twin, against the JAX functions on the same
   seeded inputs: status equal; in f64 iterations equal and x within
   1e-12 of max |x| (BiCGstab: its allowance of 3 iterations); in f32
   within 2 iterations and 1e-4 of max |x| (the f32 dot products sum in
   another order under XLA than under torch: test_torch_refine.py's
   reason and allowance), and the f32-inner refiner with equal rounds.
   Each test says where the eager loop before the control already
   differed from JAX.
The kernel itself runs only on the card: ``tests/test_torch_gpu.py`` and
chip_smoke.py's phase 3 hold it bit-equal to the twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native

import chip_smoke
import faspsolver_tpu.krylov as jk
from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.ops.operators import device_operator as jax_operator
from faspsolver_tpu.precond import AMGPrecond as JaxAMGPrecond
from faspsolver_tpu.precond.amg import setup_structured as jax_setup
from faspsolver_tpu.solvers.refine import _refine_body as jax_refine_body
from faspsolver_tpu.utils.params import AMGParam as JaxAMGParam
import faspsolver_tpu_torch.krylov as tk
from faspsolver_tpu_torch.constants import STAG_RATIO, StopType
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.ops.operators import device_operator
from faspsolver_tpu_torch.precond import AMGPrecond
from faspsolver_tpu_torch.solvers.refine import _refine_body
from faspsolver_tpu_torch.testgen import poisson_2d, poisson_fe_manufactured
from faspsolver_tpu_torch.utils import loops
from faspsolver_tpu_torch.utils.loops import F, I

torch.set_num_threads(2)
ensure_native()

KRYLOV = ("pcg", "bicgstab", "minres")
DTYPES = {"f32": torch.float32, "f64": torch.float64}


# ---------------------------------------------------------------------------
# the eager loops' NumPy checks, as they stood
# ---------------------------------------------------------------------------

def _krylov_decide_np(absres_true, f, i):
    t = f.dtype.type
    mod = i[I.STOP] == StopType.MOD_REL_RES
    need, stagnated, claim = (bool(i[k]) for k in (I.NEED, I.STAGNATED,
                                                   I.CLAIM))
    breakdown, zero_sol = bool(i[I.BREAKDOWN]), bool(i[I.ZERO_SOL])
    absres, relres = f[F.ABSRES], f[F.RELRES]
    if need:
        absres = t(absres_true)
        relres = absres / (f[F.NORMU_NEW] if mod else f[F.NORMR0])
    conv = need and relres < f[F.TOL]
    stag_fail = stagnated and not conv and i[I.STAG] >= i[I.MAX_STAG]
    tol_fail = claim and not conv and i[I.MORE] >= i[I.MAX_RESTART]
    restart = need and not conv and not stag_fail and not tol_fail
    if restart:
        i[I.STAG] += int(stagnated)
        i[I.MORE] += int(claim)
    done = bool(breakdown or zero_sol or stag_fail or tol_fail
                or (stagnated and conv) or (claim and conv))
    i[I.STATUS] = (-50 if breakdown else -43 if zero_sol else
                   -42 if stag_fail else -44 if tol_fail else 0)
    f[F.ABSRES] = f[F.ABSRES0] = absres
    f[F.RELRES] = relres
    if mod:
        f[F.NORMU] = f[F.NORMU_NEW]
    better = bool(i[I.SAFE]) and absres < f[F.BEST]
    if better:
        f[F.BEST] = absres
    i[I.CONV], i[I.RESTART], i[I.BETTER] = conv, restart, better
    i[I.CONT] = not done and i[I.IT] < i[I.MAXIT]


def _numpy_control(kind, phase, inp, f, i, inner=None):
    """One control step on NumPy copies of a region's fields (``f`` in
    the loop's dtype, ``i`` int32), updated in place."""
    if kind == "refine":
        relres = 1.0 if phase == loops.INIT else float(inp[0])
        if phase == loops.INIT:
            i[I.IT] = 0
            i[I.NINIT] += 1
        else:
            i[I.IT] += 1
            i[I.NBODY] += 1
        f[F.RELRES] = relres
        i[I.CONT] = relres >= f[F.TOL] and i[I.IT] < i[I.MAXIT]
        inner[F.TOL] = min(max(0.3 * float(f[F.TOL]) / max(relres, 1e-300),
                               float(f[F.INNER_FLOOR])),
                           float(f[F.INNER_TOL]))
        return
    t = f.dtype.type
    small, small2, slow = t(1e-20), t(1e-40), t(0.9)
    mod = i[I.STOP] == StopType.MOD_REL_RES
    inp = [t(v) for v in inp]
    if phase == loops.INIT:
        absres0 = inp[0]
        f[F.MAXDIFF] = f[F.TOL] * t(STAG_RATIO)
        f[F.NORMR0] = max(small, absres0)
        f[F.NORMU] = max(small, np.sqrt(inp[1]))
        f[F.ABSRES0] = f[F.ABSRES] = f[F.BEST] = absres0
        f[F.RELRES] = absres0 / (f[F.NORMU] if mod else f[F.NORMR0])
        i[I.IT], i[I.STAG], i[I.MORE], i[I.STATUS] = 0, 1, 1, 0
        i[I.NEED] = i[I.CONV] = i[I.RESTART] = i[I.BETTER] = 0
        i[I.NINIT] += 1
        done = (bool(f[F.RELRES] < f[F.TOL]) or bool(absres0 < f[F.ABSTOL])
                or (kind == "minres" and inp[2] <= small))
        if kind == "minres":
            f[F.BEST] = f[F.RELRES]
        i[I.CONT] = not done and 0 < i[I.MAXIT]
        return
    if kind == "minres":
        if phase == loops.CHECK:
            i[I.IT] += 1
            i[I.NBODY] += 1
            relres = abs(inp[0]) / f[F.NORMR0]
            claim = relres < f[F.TOL]
            f[F.RELRES] = relres
            i[I.BREAKDOWN] = inp[1] <= small
            i[I.CLAIM] = i[I.NEED] = claim
            i[I.NIF] += int(claim)
            i[I.STATUS] = 0
            i[I.CONT] = not i[I.BREAKDOWN] and i[I.IT] < i[I.MAXIT]
            return
        relres = f[F.RELRES]
        if i[I.NEED]:
            f[F.NORMU_NEW] = max(small, np.sqrt(inp[1]))
            f[F.ABSRES] = inp[0]
            relres = inp[0] / (f[F.NORMU_NEW] if mod else f[F.NORMR0])
        done = bool(i[I.CLAIM] and relres < f[F.TOL]) or bool(i[I.BREAKDOWN])
        f[F.RELRES] = relres
        better = bool(i[I.SAFE]) and relres < f[F.BEST]
        if better:
            f[F.BEST] = relres
        i[I.BETTER], i[I.STATUS] = better, 0
        i[I.CONT] = not done and i[I.IT] < i[I.MAXIT]
        return
    if phase == loops.DECIDE:
        return _krylov_decide_np(inp[0], f, i)
    i[I.IT] += 1
    i[I.NBODY] += 1
    if kind == "pcg":
        temp2, alpha, absres, normuinf, xx, pp = inp
        breakdown = abs(temp2) <= small2
    else:
        sigma, tt, absres, xx, ss = inp
        breakdown = abs(sigma) <= small2 or tt <= small2
    relres = absres / (f[F.NORMU] if mod else f[F.NORMR0])
    factor = absres / f[F.ABSRES0]
    normu_new = max(small, np.sqrt(xx))
    if kind == "pcg":
        zero_sol = factor > slow and normuinf <= small
        reldiff = abs(alpha) * np.sqrt(pp) / normu_new
    else:
        zero_sol = False
        reldiff = np.sqrt(ss) / normu_new
    stagnated = (factor > slow and not zero_sol
                 and i[I.STAG] <= i[I.MAX_STAG] and reldiff < f[F.MAXDIFF])
    claim = relres < f[F.TOL] and not stagnated and not zero_sol
    need = stagnated or claim
    f[F.ABSRES], f[F.RELRES], f[F.NORMU_NEW] = absres, relres, normu_new
    i[I.BREAKDOWN], i[I.ZERO_SOL] = breakdown, zero_sol
    i[I.STAGNATED], i[I.CLAIM], i[I.NEED] = stagnated, claim, need
    i[I.NIF] += int(need)
    i[I.STATUS] = -50 if breakdown else -43 if zero_sol else 0
    i[I.CONT] = not (breakdown or zero_sol) and i[I.IT] < i[I.MAXIT]


def _bits(a):
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint64)


def _numpy_blocks(name, dtype):
    """chip_smoke.LOOP_CASES[name] through the NumPy checks: the block's
    bytes after every step, as loop_case_blocks returns the twin's."""
    kind, params, steps = chip_smoke.LOOP_CASES[name]
    if kind == "refine":
        blk = loops.Block("cpu", [("refine", torch.float64),
                                  ("inner", dtype)])
        p = {**chip_smoke.LOOP_REFINE, **params}
        blk.upload({"refine": {("f", F.TOL): p["tol"],
                               ("f", F.INNER_TOL): p["inner_tol"],
                               ("f", F.INNER_FLOOR): p["inner_floor"],
                               ("i", I.MAXIT): p["max_rounds"]}})
    else:
        blk = loops.Block("cpu", [(kind, dtype)])
        blk.upload({kind: loops.krylov_values(
            **{**chip_smoke.LOOP_KRYLOV, **params})})
    raw = blk.bytes.numpy()
    host = blk.decode(raw)
    name0 = "refine" if kind == "refine" else kind
    out = []
    for phase, vals in steps:
        inner = host["inner"].f if kind == "refine" else None
        _numpy_control(kind, phase, vals, host[name0].f, host[name0].i,
                       inner)
        out.append(torch.from_numpy(raw.copy()))
    return out


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(chip_smoke.LOOP_CASES))
def test_twin_decides_as_the_numpy_checks_on_the_edge_cases(name, dt):
    want = _numpy_blocks(name, DTYPES[dt])
    got = chip_smoke.loop_case_blocks(torch, name, DTYPES[dt], "cpu",
                                      plain=True)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (name, dt, k)


def test_the_edge_cases_take_their_branches():
    """What the cases are there for, read from the twin's blocks."""
    def last(name, region=None):
        kind = chip_smoke.LOOP_CASES[name][0]
        blk = loops.Block("cpu", [("refine", torch.float64),
                                  ("inner", torch.float32)]
                          if kind == "refine" else [(kind, torch.float32)])
        out = chip_smoke.loop_case_blocks(torch, name, torch.float32, "cpu",
                                          plain=True)
        return [blk.decode(o.numpy())[region or kind] for o in out]

    i = last("pcg breakdown")[-1].i
    assert (i[I.STATUS], i[I.CONT]) == (-50, 0)
    assert last("pcg zero solution")[-1].i[I.STATUS] == -43
    steps = last("pcg stagnation restart, then its budget")
    assert steps[2].i[I.RESTART] and steps[2].i[I.STAG] == 2
    assert steps[-1].i[I.STATUS] == -42
    steps = last("pcg false claim restarts")
    assert steps[2].i[I.RESTART] and steps[2].i[I.MORE] == 2
    assert steps[-1].i[I.CONV] and not steps[-1].i[I.CONT]
    assert last("pcg false claim out of budget")[-1].i[I.STATUS] == -44
    assert not last("pcg maxit")[-1].i[I.CONT]
    assert not last("pcg done at entry")[-1].i[I.CONT]
    assert [s.i[I.BETTER] for s in last("pcg safe iterate")[2::2]] == [1, 1,
                                                                       0]
    assert last("bicgstab breakdown of t.t")[-1].i[I.STATUS] == -50
    assert last("bicgstab breakdown of rstar.v")[-1].i[I.STATUS] == -50
    assert last("bicgstab stagnation restart")[2].i[I.RESTART]
    assert last("minres Lanczos breakdown")[-1].i[I.CONT] == 0
    assert not last("minres done at entry")[-1].i[I.CONT]
    steps = last("minres false claim continues")
    assert steps[2].i[I.CONT] and not steps[-1].i[I.CONT]
    tols = [s.f[F.TOL] for s in last("refine inner tolerance clamps",
                                     "inner")]
    # relres 1 and 0.1 ask for less than the floor, 3e-2 for exactly
    # inner_tol, 7e-4 for more (capped)
    assert tols == [np.float32(5e-6), np.float32(5e-6), np.float32(1e-5),
                    np.float32(1e-5)]
    floor = last("refine relres floor", "inner")
    assert floor[1].f[F.TOL] != floor[2].f[F.TOL]   # 1e-300 clamps relres
    assert not last("refine max rounds", "refine")[-1].i[I.CONT]
    assert not last("refine no round", "refine")[-1].i[I.CONT]


# ---------------------------------------------------------------------------
# the twin on the scalar sequences of real solves
# ---------------------------------------------------------------------------

@pytest.fixture
def checked_twin(monkeypatch):
    """Every twin call of a solve also run through the NumPy checks on a
    copy of the region before it, and the two held bit-equal.  Returns
    the number of calls checked, by entry point."""
    calls = {}

    def wrap(kind, twin):
        def run(phase, inp, reg, *inner):
            f0, i0 = reg.f.numpy().copy(), reg.i.numpy().copy()
            in0 = inner[0].f.numpy().copy() if inner else None
            _numpy_control(kind, phase, inp.numpy(), f0, i0, in0)
            twin(phase, inp, reg, *inner)
            assert np.array_equal(_bits(reg.f.numpy()), _bits(f0)), kind
            assert np.array_equal(reg.i.numpy(), i0), (kind, phase)
            if inner:
                assert np.array_equal(_bits(inner[0].f.numpy()), _bits(in0))
            calls[kind] = calls.get(kind, 0) + 1
        return run

    for kind in KRYLOV:
        monkeypatch.setitem(loops.PLAIN, kind, wrap(kind, loops.PLAIN[kind]))
    monkeypatch.setattr(loops, "refine_plain",
                        wrap("refine", loops.refine_plain))
    return calls


def _problem(name):
    A = poisson_2d(31) if name == "poisson" else \
        poisson_fe_manufactured(16)[0]
    return A, np.random.default_rng(11).standard_normal(A.nrow)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("problem", ["poisson", "fe"])
@pytest.mark.parametrize("method", KRYLOV)
def test_twin_decides_as_the_numpy_checks_in_real_solves(
        checked_twin, method, problem, dt):
    A, b = _problem(problem)
    op = device_operator(A, dtype=DTYPES[dt])
    M = tk.JacobiPrecond.from_csr(A, DTYPES[dt])
    for kw in ({}, {"stop_type": int(StopType.MOD_REL_RES), "safe": True}):
        res = getattr(tk, method)(op, torch.from_numpy(b).to(DTYPES[dt]),
                                  M=M, tol=1e-8, maxit=400, **kw)
        assert res.iters > 10
    assert checked_twin[method] >= 2 * res.iters


# ---------------------------------------------------------------------------
# the loop bodies against the JAX package
# ---------------------------------------------------------------------------

def _jax_pair(method, problem, dt, **kw):
    A, b = _problem(problem)
    jdt = {"f32": jnp.float32, "f64": jnp.float64}[dt]
    Aj = JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)
    got = getattr(tk, method)(
        device_operator(A, dtype=DTYPES[dt]),
        torch.from_numpy(b).to(DTYPES[dt]),
        M=tk.JacobiPrecond.from_csr(A, DTYPES[dt]), **kw)
    ref = getattr(jk, method)(
        jax_operator(Aj, dtype=jdt), jnp.asarray(b, dtype=jdt),
        M=jk.JacobiPrecond.from_csr(Aj, dtype=jdt), **kw)
    xr = np.asarray(ref.x, dtype=np.float64)
    err = np.abs(got.x.double().numpy() - xr).max() / np.abs(xr).max()
    assert got.status == int(ref.status) and got.converged == bool(
        ref.converged)
    assert got.syncs > got.iters
    return got.iters, int(ref.iters), err


@pytest.mark.parametrize("stop", [1, 2, 3])
@pytest.mark.parametrize("problem", ["poisson", "fe"])
@pytest.mark.parametrize("method", KRYLOV)
def test_loop_matches_jax_f64(method, problem, stop):
    """f64, tol 1e-10: PCG and MINRES to the iteration, x within 1e-12.
    BiCGstab within 3 iterations (the allowance chip_smoke.py and PERF.md
    give it: its short recurrences amplify the reordered f64 dot sums —
    the port's eager loop before the control counted 85 against JAX's 84
    on poisson_2d(31) here), and x then within 1e-7 of max |x|: both meet
    relres 1e-10, and cond(A) is below 1e3 on both problems."""
    got, ref, err = _jax_pair(method, problem, "f64", tol=1e-10, maxit=400,
                              stop_type=stop)
    if method == "bicgstab":
        assert abs(got - ref) <= 3 and err <= 1e-7, (got, ref, err)
    else:
        assert got == ref and err <= 1e-12, (got, ref, err)


@pytest.mark.parametrize("problem", ["poisson", "fe"])
@pytest.mark.parametrize("method", KRYLOV)
def test_loop_matches_jax_f32(method, problem):
    """f32, REL_RES, tol 1e-5: within 2 iterations (the f32 dot products
    sum in another order under XLA than under torch: test_torch_refine's
    allowance; the eager loop before the control counted 55 / 71 against
    JAX's 54 / 70 for BiCGstab / MINRES on poisson_2d(31)) and x within
    1e-4 of max |x|."""
    got, ref, err = _jax_pair(method, problem, "f32", tol=1e-5, maxit=400)
    assert abs(got - ref) <= 2 and err <= 1e-4, (got, ref, err)


@pytest.fixture(scope="module")
def hierarchies():
    A = poisson_2d(63)
    param = JaxAMGParam(smoother=13, polynomial_degree=2, coarse_dof=60,
                        tentative_smooth=0.67)
    out = {}
    for dt, jdt in (("f64", jnp.float64), ("f32", jnp.float32)):
        jh = jax_setup(A, param, dtype=jdt, smooth_p=True,
                       keep_f64_fine=True)
        out[dt] = (jh, from_jax(jh))
    return A, out


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_refine_body_matches_jax(hierarchies, dt):
    """The port's rounds and inner PCG on exactly the hierarchy JAX
    built, f64 or f32 inner solves: rounds equal, inner iterations equal
    (f64) or within 2 (f32), x within the dtype's tolerance."""
    A, hs = hierarchies
    jh, h = hs[dt]
    b = A.matvec(np.random.default_rng(5).standard_normal(A.nrow))
    args = (1e-10, 1e-5, 5e-6, 4, 40)
    got = _refine_body(h.fine64, h.levels[0].A, AMGPrecond(h),
                       torch.from_numpy(b), *args)
    x, relres, rnd, iters = jax_refine_body(
        jh.fine64, jh.levels[0].A, JaxAMGPrecond(jh), jnp.asarray(b), *args)
    assert got.rounds == int(rnd)
    if dt == "f64":
        assert got.iters == int(iters)
    else:
        assert abs(got.iters - int(iters)) <= 2
    # f32 inner: both meet the f64 relres 1e-10, so they differ by at
    # most about 2 cond(A) 1e-10 ~ 1e-6 of |x| (cond ~ 2e3 at 63^2)
    xr = np.asarray(x)
    err = np.abs(got.x.numpy() - xr).max()
    assert err <= (1e-12 if dt == "f64" else 1e-6) * np.abs(xr).max(), err
    assert got.syncs == 2 * got.rounds + got.iters + got.recomputes
