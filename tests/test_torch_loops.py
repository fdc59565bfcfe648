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
3. The GMRES family's control (``loops.gmres_plain``): its twin against
   the NumPy arithmetic of the host loop it replaced (the Arnoldi step's
   rotations and the per-cycle restart rules, copied; the window's
   back-substitution in the order the control states), bit for bit,
   over chip_smoke.GMRES_CASES and over the whole control sequences of
   real solves; the eager loop tree against the JAX ``gmres`` /
   ``vgmres`` / ``vfgmres`` in f64 and f32 with its reads.
4. The twins' square roots are correctly rounded, as the kernel's are
   (``torch.sqrt`` on the CPU is not, in the last bit, for about 1% of
   its inputs).
5. The multigrid loops' control (``loops.mg_plain``) against the host
   loops' tests as they stood (AMG's ``not relres < tol``, GMG's
   ``relres >= tol``) over chip_smoke.MG_CASES; the AMG tree (RS, SA, UA
   hierarchies; V, W, AMLI, NL-AMLI; FAMG) and the GMG V-cycle and CG
   trees (2-D, 3-D, full-MG start) against copies of the host loops they
   replaced, bit for bit with reads = iterations + 1; and each tree
   against the JAX function on the same hierarchy or grid (x within
   atol 1e-10, equal counts; a NaN relres runs AMG to maxit and stops
   GMG, in both packages).
6. GCG / GCR's control (``loops.gcr_plain``) against the host loop's
   NumPy scalars as they stood (the step's breakdown and residual test,
   the cycle's true-residual test) over chip_smoke.GCR_CASES and over the
   control sequences of real solves; the loop tree on the CPU against a
   copy of that host loop (``_host_loop_gcr``), bit for bit with its
   reads; and the tree against the JAX ``gcr`` / ``gcg`` in f64, in the
   CPU's arithmetic and in the card's (masked full-window products).
The kernel itself runs only on the card: ``tests/test_torch_gpu.py`` and
chip_smoke.py's phase 3 hold it bit-equal to the twin."""
import importlib

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

def _jax_pair(method, problem, dt, port=None, **kw):
    """(port's iterations, JAX's, max |x - x_jax| / max |x_jax|); the
    port's result appended to ``port`` when given."""
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
    if port is not None:
        port.append(got)
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


# ---------------------------------------------------------------------------
# the GMRES family's control: the twin against the host loop it replaced
# ---------------------------------------------------------------------------

GMRES = ("gmres", "vgmres", "vfgmres")
GMRES_MODULE = importlib.import_module("faspsolver_tpu_torch.krylov.gmres")


def _numpy_gmres(phase, inp, f, i, ia, arr, R):
    """One GMRES control step on NumPy copies of the regions (``f``, ``i``
    the restart cycles', ``ia`` the Arnoldi steps') and of the window's
    arrays, updated in place: the eager host loop's arithmetic as it
    stood before the control existed (its Arnoldi step's rotations and
    its per-cycle restart rules, copied), and the back-substitution in
    the order the control states (by columns, column j - 1 first: y[k] =
    g[k] / H[k, k], then g[m] -= H[m, k] y[k] for m < k), which replaced
    its LAPACK solve."""
    t = f.dtype.type
    small, happy_tol = t(1e-20), t(1e-20 * 1e-8)
    H = arr[:(R + 1) * R].reshape(R + 1, R)
    g = arr[(R + 1) * R:(R + 1) * (R + 1)]
    cs, sn, y = arr[(R + 1) * (R + 1):].reshape(3, R)
    mod = i[I.STOP] == StopType.MOD_REL_RES
    tol = f[F.TOL]
    if phase == loops.INIT:
        absres0, xx, r_norm = (t(v) for v in inp[:3])
        normr0 = max(small, absres0)
        normu = max(small, np.sqrt(xx))
        relres = absres0 / (normu if mod else normr0)
        done = bool(relres < tol) or bool(absres0 < f[F.ABSTOL])
        f[F.MAXDIFF] = tol * t(STAG_RATIO)
        f[F.NORMR0], f[F.NORMU] = normr0, normu
        f[F.ABSRES0] = f[F.ABSRES] = absres0
        f[F.RELRES] = f[F.BEST] = f[F.STAG_BEST] = relres
        f[F.R_NORM] = f[F.R_NORM_OLD] = r_norm
        i[I.IT], i[I.STAG], i[I.MORE], i[I.STATUS] = 0, 0, 1, 0
        i[I.NEED] = i[I.CONV] = i[I.RESTART] = i[I.BETTER] = 0
        i[I.CYCLES], i[I.CUR_RESTART], i[I.J] = 0, R, 0
        i[I.NINIT] += 1
        i[I.CONT] = not done and 0 < i[I.MAXIT]
        return
    if phase == loops.CYCLE:
        r_norm = f[F.R_NORM]
        arr[:] = 0
        g[0] = r_norm
        f[F.SCALE] = t(1.0) / r_norm if r_norm > small else t(0.0)
        i[I.J] = 0
        ia[I.CONT] = 0 < i[I.CUR_RESTART] and i[I.IT] < i[I.MAXIT]
        return
    if phase == loops.ARNOLDI:
        j = int(i[I.J])
        *h, hn = (t(v) for v in inp[:j + 1].tolist() + [inp[R + 1]])
        happy = hn <= happy_tol
        # previous rotations on the column, then the new one
        hcol = np.zeros(R + 1, dtype=t)
        hcol[:j + 1] = h
        hcol[j + 1] = hn
        for k in range(j):
            hk, hk1 = hcol[k], hcol[k + 1]
            hcol[k] = cs[k] * hk + sn[k] * hk1
            hcol[k + 1] = -sn[k] * hk + cs[k] * hk1
        a_, b_ = hcol[j], hcol[j + 1]
        den = np.sqrt(a_ * a_ + b_ * b_)
        c, s = (a_ / den, b_ / den) if den > small else (t(1.0), t(0.0))
        hcol[j] = c * a_ + s * b_
        hcol[j + 1] = 0.0
        gj = g[j]
        g[j] = c * gj
        g[j + 1] = -s * gj
        H[:, j] = hcol
        cs[j], sn[j] = c, s
        brk = happy or abs(g[j + 1]) / f[F.NORMR0] < tol
        j += 1
        i[I.J] = j
        ia[I.NBODY] += 1
        ia[I.CONT] = (j < i[I.CUR_RESTART] and i[I.IT] + j < i[I.MAXIT]
                      and not brk)
        return
    if phase == loops.SOLVE:
        y[:] = _numpy_solve_columns(H, g, int(i[I.J]), len(y))
        return
    j = int(i[I.J])
    i[I.IT] += j
    cur, cycles = int(i[I.CUR_RESTART]), int(i[I.CYCLES])
    r_norm_old = f[F.R_NORM]
    r_norm, absres, xx = (t(v) for v in inp[:3])
    normu_new = max(small, np.sqrt(xx))
    relres = absres / (normu_new if mod else f[F.NORMR0])
    if i[I.ADAPTIVE]:
        # reference rule (KryPvgmres.c:200-210)
        cr = r_norm / max(r_norm_old, small)
        shrunk = cur - 3 if cur - 3 > 3 else R
        cur = (R if cr > 0.99 or cycles == 0
               else cur if cr < 0.174 else shrunk)
    stag_best = f[F.STAG_BEST]
    stag = i[I.STAG] + 1 if relres > 0.995 * stag_best else 0
    stag_best = min(stag_best, relres)
    stalled = stag >= 4 and relres > 4.0 * tol
    done = bool(relres < tol) or j == 0 or stalled
    better = bool(i[I.SAFE]) and relres < f[F.BEST]
    if better:
        f[F.BEST] = relres
    f[F.STAG_BEST], f[F.R_NORM_OLD], f[F.R_NORM] = stag_best, r_norm_old, \
        r_norm
    f[F.ABSRES], f[F.RELRES], f[F.NORMU_NEW] = absres, relres, normu_new
    i[I.BETTER], i[I.CUR_RESTART], i[I.STAG] = better, cur, stag
    i[I.CYCLES] = cycles + 1
    i[I.STATUS] = -42 if stalled else 0
    i[I.NBODY] += 1
    i[I.CONT] = not done and i[I.IT] < i[I.MAXIT]


def _numpy_solve_columns(H, g, j, R):
    """y (length R) from H[:j, :j] y = g[:j] by columns, one NumPy scalar
    operation at a time: y[k] = g[k] / H[k, k], then g[m] -= H[m, k] y[k]
    for m < k, k from j - 1 down (the reference BLAS dtrsm's order)."""
    y = np.zeros(R, dtype=H.dtype)
    gw = g[:j].copy()
    with np.errstate(divide="ignore", invalid="ignore"):  # den guard
        for k in range(j - 1, -1, -1):
            y[k] = gw[k] / H[k, k]
            for m in range(k):
                gw[m] = gw[m] - H[m, k] * y[k]
    return y


def _numpy_gmres_blocks(name, dtype):
    """chip_smoke.GMRES_CASES[name] through the NumPy oracle: the block's
    and the arrays' bytes after every step."""
    blk, reg, inner, arr, R = chip_smoke.gmres_case_state(torch, name, dtype,
                                                          "cpu")
    raw, a = blk.bytes.numpy(), arr.numpy()
    host = blk.decode(raw)
    out = []
    for phase, vals in chip_smoke.GMRES_CASES[name][1]:
        _numpy_gmres(phase, np.asarray(vals, dtype=a.dtype), host["gmres"].f,
                     host["gmres"].i, host["arnoldi"].i, a, R)
        out.append((torch.from_numpy(raw.copy()), torch.from_numpy(a.copy())))
    return out


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(chip_smoke.GMRES_CASES))
def test_gmres_twin_computes_as_the_host_loop_on_the_edge_cases(name, dt):
    want = _numpy_gmres_blocks(name, DTYPES[dt])
    got = chip_smoke.gmres_case_blocks(torch, name, DTYPES[dt], "cpu",
                                       plain=True)
    assert len(got) == len(want)
    for k, ((gb, ga), (wb, wa)) in enumerate(zip(got, want)):
        assert torch.equal(gb, wb), (name, dt, k)
        assert np.array_equal(_bits(ga.numpy()), _bits(wa.numpy())), \
            (name, dt, k)


def test_the_gmres_cases_take_their_branches():
    """What the cases are there for, read from the twin's blocks."""
    def steps(name, dt=torch.float32):
        blk, _, _, _, R = chip_smoke.gmres_case_state(torch, name, dt, "cpu")
        out = chip_smoke.gmres_case_blocks(torch, name, dt, "cpu",
                                           plain=True)
        return [(blk.decode(b.numpy()), a.numpy()) for b, a in out], R

    def last(name):
        d = steps(name)[0][-1][0]
        return d["gmres"], d["arnoldi"]

    g, a = last("gmres converges in its first window")
    assert (g.i[I.IT], g.i[I.CONT], g.i[I.STATUS]) == (2, 0, 0)
    s, _ = steps("gmres converges in its first window")
    assert [x[0]["arnoldi"].i[I.CONT] for x in s[2:4]] == [1, 0]   # conv
    s, _ = steps("gmres happy breakdown")
    assert s[2][0]["arnoldi"].i[I.CONT] == 0 and s[-1][0]["gmres"].i[
        I.IT] == 1
    s, R = steps("gmres den guard")
    arrs = s[2][1]
    assert arrs[(R + 1) * (R + 1)] == 1 and arrs[(R + 1) * (R + 1) + R] == 0
    g, _ = last("gmres full window restarts")
    assert (g.i[I.IT], g.i[I.CYCLES], g.i[I.CONT]) == (4, 2, 0)
    g, _ = last("gmres maxit inside a window")
    assert (g.i[I.IT], g.i[I.CONT]) == (6, 0)
    s, _ = steps("vgmres adaptive restart rule")
    curs = [x[0]["gmres"].i[I.CUR_RESTART] for x in s]
    restarts = [c for c, (ph, _) in zip(curs, chip_smoke.GMRES_CASES[
        "vgmres adaptive restart rule"][1]) if ph == loops.RESTART]
    # cycles == 0, cr 0.5 (shrink), cr > cr_max, cr < cr_min (keep), cr
    # 0.5 (shrink), cr 0.5 below the minimum (back to R)
    assert restarts == [8, 5, 8, 8, 5, 8]
    g, _ = last("gmres stagnation exits")
    assert (g.i[I.STATUS], g.i[I.CONT], g.i[I.STAG]) == (-42, 0, 4)
    g, _ = last("gmres crawl within 4 tol")
    assert (g.i[I.STATUS], g.i[I.CONT]) == (0, 1) and g.i[I.STAG] >= 4
    s, _ = steps("gmres safe iterate")
    better = [x[0]["gmres"].i[I.BETTER] for x, (ph, _) in zip(
        s, chip_smoke.GMRES_CASES["gmres safe iterate"][1])
        if ph == loops.RESTART]
    assert better == [1, 0, 1]
    assert last("gmres done at entry")[0].i[I.CONT] == 0
    g, _ = last("gmres MOD_REL_RES")        # relres against |x| = 1
    assert g.i[I.CONT] == 1 and g.f[F.NORMU] == np.float32(2.0)
    assert g.f[F.RELRES] == np.float32(1e-6)
    g, _ = last("gmres empty window ends")
    assert (g.i[I.IT], g.i[I.CONT]) == (0, 0)
    for R in (30, 60):
        s, _ = steps(f"gmres window {R}", torch.float64)
        assert s[-3][0]["gmres"].i[I.J] == R          # the window full
        H = s[-2][1][:(R + 1) * R].reshape(R + 1, R)[:R]
        g = s[-2][1][(R + 1) * R:(R + 1) * R + R]
        y = s[-2][1][-R:]
        # the back-substitution solves the triangular system
        assert np.allclose(np.triu(H) @ y, g, rtol=0, atol=1e-10)


def _hessenberg_arrays(R, seed, dtype):
    """The window's arrays after R seeded Arnoldi columns through the
    twin (``chip_smoke._window``): H's R x R upper triangle rotated, g."""
    blk = loops.Block("cpu", [("gmres", dtype), ("arnoldi", dtype)])
    blk.upload({"gmres": loops.gmres_values(1e-30, 1e-18, 10 ** 6, 1, False,
                                            False)})
    arr = torch.zeros(loops.gmres_arrays(R), dtype=dtype)
    for phase, vals in chip_smoke._window(R, seed)[:R + 2]:
        loops.gmres_plain(phase, torch.tensor(vals or [0.0], dtype=dtype),
                          blk["gmres"], blk["arnoldi"], arr, R)
    return blk, arr


@pytest.mark.parametrize("j", [1, 2, 31, 32, 33, 60, 168])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gmres_solve_is_the_column_order_back_substitution(dt, j):
    """The twin's SOLVE over the first j columns of a window of R = 168
    (the lanes' slot edges at 32): y bit for bit the NumPy column-order
    back-substitution's, zero past j, g untouched; and within a few ulp
    of scipy's solve_triangular (LAPACK) on the same j x j system."""
    import scipy.linalg
    R = 168
    blk, arr = _hessenberg_arrays(R, 7, DTYPES[dt])
    blk["gmres"].i[I.J] = j
    before = arr.clone()
    loops.gmres_plain(loops.SOLVE, arr[:1], blk["gmres"], blk["arnoldi"],
                      arr, R)
    H, g, _, _, y = (t.numpy() for t in loops.gmres_views(arr, R))
    want = _numpy_solve_columns(H, g, j, R)
    assert np.array_equal(_bits(y), _bits(want))
    assert np.array_equal(_bits(arr[:-R].numpy()), _bits(before[:-R].numpy()))
    ref = scipy.linalg.solve_triangular(H[:j, :j], g[:j])
    eps = np.finfo(H.dtype).eps
    assert np.abs(y[:j] - ref).max() <= 8 * eps * np.abs(ref).max()


def _arnoldi_as_it_stood(inp, f, i, ia, arr, R):
    """The twin's ARNOLDI phase as the control first had it (a copy): the
    column written into H, the earlier rotations read back from H, the
    new rotation, g, cs, sn and the step's flags."""
    dt = f.dtype
    H, g, cs, sn, _ = loops.gmres_views(arr, R)
    small = torch.tensor(loops.SMALLREAL, dtype=dt)
    j = int(i[I.J])
    hn = inp[R + 1]
    H[:, j] = inp[:R + 1]
    H[j + 1, j] = hn
    for k in range(j):
        hk, hk1 = H[k, j].clone(), H[k + 1, j].clone()
        H[k, j] = cs[k] * hk + sn[k] * hk1
        H[k + 1, j] = -sn[k] * hk + cs[k] * hk1
    a, b = H[j, j].clone(), H[j + 1, j].clone()
    den = loops._sqrt(a * a + b * b)
    den_ok = den > small
    c = torch.where(den_ok, a / den, torch.tensor(1.0, dtype=dt))
    s = torch.where(den_ok, b / den, torch.tensor(0.0, dtype=dt))
    H[j, j] = c * a + s * b
    H[j + 1, j] = 0
    gj = g[j].clone()
    g[j] = c * gj
    g[j + 1] = -s * gj
    cs[j] = c
    sn[j] = s
    happy = hn <= torch.tensor(loops.HAPPY, dtype=dt)
    conv = g[j + 1].abs() / f[F.NORMR0] < f[F.TOL]
    i[I.J] = j + 1
    ia[I.NBODY] += 1
    ia[I.CONT] = ((j + 1 < i[I.CUR_RESTART]) & (i[I.IT] + j + 1 < i[I.MAXIT])
                  & ~happy & ~conv)


@pytest.mark.parametrize("R", [30, 60])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gmres_arnoldi_twin_is_unchanged(dt, R):
    """The twin's ARNOLDI phase over a full seeded window bit for bit the
    rendering it had before the kernel chained its rotations in
    registers (the arithmetic did not change, only the kernel's memory
    traffic)."""
    steps = chip_smoke._window(R, R)[:R + 2]
    got = _hessenberg_arrays(R, R, DTYPES[dt])
    blk = loops.Block("cpu", [("gmres", DTYPES[dt]),
                              ("arnoldi", DTYPES[dt])])
    blk.upload({"gmres": loops.gmres_values(1e-30, 1e-18, 10 ** 6, 1, False,
                                            False)})
    arr = torch.zeros(loops.gmres_arrays(R), dtype=DTYPES[dt])
    reg, inner = blk["gmres"], blk["arnoldi"]
    for phase, vals in steps:
        inp = torch.tensor(vals or [0.0], dtype=DTYPES[dt])
        if phase == loops.ARNOLDI:
            _arnoldi_as_it_stood(inp, reg.f, reg.i, inner.i, arr, R)
        else:
            loops.gmres_plain(phase, inp, reg, inner, arr, R)
    assert torch.equal(got[0].bytes, blk.bytes)
    assert np.array_equal(_bits(got[1].numpy()), _bits(arr.numpy()))


# ---------------------------------------------------------------------------
# the GMRES family's loop tree against the host loop and the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture
def checked_gmres_twin(monkeypatch):
    """Every GMRES twin call of a solve also run through the NumPy oracle
    on copies of the regions and arrays before it, and the two held
    bit-equal.  Returns the calls checked, by phase."""
    calls = {}
    twin = loops.gmres_plain

    def run(phase, inp, reg, inner, arr, R):
        f0, i0 = reg.f.numpy().copy(), reg.i.numpy().copy()
        ia0, a0 = inner.i.numpy().copy(), arr.numpy().copy()
        _numpy_gmres(phase, inp.numpy(), f0, i0, ia0, a0, R)
        twin(phase, inp, reg, inner, arr, R)
        assert np.array_equal(_bits(reg.f.numpy()), _bits(f0)), phase
        assert np.array_equal(reg.i.numpy(), i0), phase
        assert np.array_equal(inner.i.numpy(), ia0), phase
        assert np.array_equal(_bits(arr.numpy()), _bits(a0)), phase
        calls[phase] = calls.get(phase, 0) + 1

    monkeypatch.setattr(loops, "gmres_plain", run)
    return calls


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("method", GMRES)
def test_gmres_twin_computes_as_the_host_loop_in_real_solves(
        checked_gmres_twin, method, dt):
    A, b = _problem("fe")
    op = device_operator(A, dtype=DTYPES[dt])
    M = tk.JacobiPrecond.from_csr(A, DTYPES[dt])
    res = getattr(tk, method)(op, torch.from_numpy(b).to(DTYPES[dt]), M=M,
                              tol=1e-8, maxit=200, restart=10, safe=True,
                              stop_type=int(StopType.MOD_REL_RES))
    assert res.iters > 20
    assert checked_gmres_twin[loops.ARNOLDI] == res.iters
    assert checked_gmres_twin[loops.RESTART] >= 3


@pytest.fixture
def gmres_cycles(monkeypatch):
    """The restart cycles of the solves run in the test, counted at the
    control's restart phase."""
    seen = [0]
    twin = loops.gmres_plain

    def run(phase, *args):
        seen[0] += phase == loops.RESTART
        twin(phase, *args)

    monkeypatch.setattr(loops, "gmres_plain", run)
    return seen


@pytest.mark.parametrize("arithmetic", ["cpu", "card"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("problem", ["poisson", "fe"])
@pytest.mark.parametrize("method", GMRES)
def test_gmres_tree_matches_jax(gmres_cycles, monkeypatch, method, problem,
                                dt, arithmetic):
    """The eager loop tree against the JAX package on the CPU, restart 20
    (vGMRES shrinks its window), in the CPU's arithmetic (products over
    the first j + 1 rows, LAPACK's y) and in the card's (masked
    full-window products, the control's back-substitution): in f64 (tol
    1e-10) iterations equal and x within 1e-12 of max |x|; in f32 (tol
    1e-5) within 2 iterations and 1e-4 of max |x| (the f32 products sum
    in another order under XLA than under torch: the allowance of the
    other loops above).  The status equal, and the eager loop's reads
    the module docstring's 1 + iterations + cycles."""
    if arithmetic == "card":
        monkeypatch.setattr(GMRES_MODULE, "_on_host", lambda b: False)
    tol = 1e-10 if dt == "f64" else 1e-5
    port = []
    got, ref, err = _jax_pair(method, problem, dt, port=port, tol=tol,
                              maxit=400, restart=20)
    if dt == "f64":
        assert got == ref and err <= 1e-12, (got, ref, err)
    else:
        assert abs(got - ref) <= 2 and err <= 1e-4, (got, ref, err)
    # the last solve _jax_pair ran is the port's: its cycles
    assert gmres_cycles[0] >= 1
    assert port[0].syncs == 1 + port[0].iters + gmres_cycles[0]


def _host_loop_gmres(A, b, M, tol, maxit, restart, stop_type, adaptive,
                     flexible, safe):
    """The GMRES family's host loop as it stood before its loop tree (a
    copy): a column read per Arnoldi step, CGS2 over V[:j + 1], the
    rotations in NumPy, y by LAPACK over the j x j system.  Returns (x,
    iterations, status)."""
    from faspsolver_tpu_torch.krylov.common import (abs_residual, dot,
                                                    initial_norms,
                                                    residual_norms)
    t = np.float32 if b.dtype == torch.float32 else np.float64
    small = t(loops.SMALLREAL)
    precres = stop_type == StopType.REL_PRECRES
    R = int(min(restart, maxit))
    x = torch.zeros_like(b)
    r = b - A(x)
    absres0, xx, r_norm = (t(v.item()) for v in (
        abs_residual(stop_type, r, M(r)), dot(x, x), torch.sqrt(dot(r, r))))
    absres0, normr0, _, relres = initial_norms(stop_type, absres0, xx)
    done = bool(relres < tol) or bool(absres0 < 1e-18)
    V = torch.zeros(R + 1, b.shape[0], dtype=b.dtype)
    Z = torch.zeros(R, b.shape[0], dtype=b.dtype) if flexible else None
    it, cycles, cur, status = 0, 0, R, 0
    stag, stag_best = 0, relres
    best_x, best_relres = x, relres
    while not done and it < maxit:
        V[0] = r * (t(1.0) / r_norm if r_norm > small else t(0.0))
        H = np.zeros((R + 1, R), dtype=t)
        g = np.zeros(R + 1, dtype=t)
        g[0] = r_norm
        cs, sn = np.zeros(R, dtype=t), np.zeros(R, dtype=t)
        j, brk = 0, False
        while j < cur and it + j < maxit and not brk:
            z = M(V[j])
            w = A(z)
            if flexible:
                Z[j] = z
            Vj = V[:j + 1]
            h1 = Vj @ w
            w = w - h1 @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            *h, hn = torch.cat([h1 + h2, torch.sqrt(dot(w, w)).reshape(1)]
                               ).numpy()
            happy = hn <= t(loops.HAPPY)
            V[j + 1] = w * (t(0.0) if happy else t(1.0) / hn)
            hcol = np.zeros(R + 1, dtype=t)
            hcol[:j + 1] = h
            hcol[j + 1] = hn
            for k in range(j):
                hk, hk1 = hcol[k], hcol[k + 1]
                hcol[k] = cs[k] * hk + sn[k] * hk1
                hcol[k + 1] = -sn[k] * hk + cs[k] * hk1
            a_, b_ = hcol[j], hcol[j + 1]
            den = np.sqrt(a_ * a_ + b_ * b_)
            c, s = (a_ / den, b_ / den) if den > small else (t(1.0), t(0.0))
            hcol[j] = c * a_ + s * b_
            hcol[j + 1] = 0.0
            gj = g[j]
            g[j], g[j + 1] = c * gj, -s * gj
            H[:, j] = hcol
            cs[j], sn[j] = c, s
            brk = happy or abs(g[j + 1]) / normr0 < tol
            j += 1
        if j:
            y = torch.linalg.solve_triangular(
                torch.from_numpy(H[:j, :j].copy()),
                torch.from_numpy(g[:j].copy())[:, None], upper=True)[:, 0]
            x = x + (y @ Z[:j] if flexible else M(y @ V[:j]))
        it += j
        r = b - A(x)
        z = M(r) if precres else r
        r_norm_old = r_norm
        r_norm, absres, xx = (t(v.item()) for v in (
            torch.sqrt(dot(r, r)), abs_residual(stop_type, r, z), dot(x, x)))
        normu_new = max(small, np.sqrt(xx))
        absres, relres = residual_norms(stop_type, absres, normr0, normu_new)
        if adaptive:
            cr = r_norm / max(r_norm_old, small)
            shrunk = (cur - loops.RESTART_DEC
                      if cur - loops.RESTART_DEC > loops.RESTART_MIN else R)
            cur = (R if cr > loops.CR_MAX or cycles == 0
                   else cur if cr < loops.CR_MIN else shrunk)
        stag = stag + 1 if relres > loops.STAG_FACTOR * stag_best else 0
        stag_best = min(stag_best, relres)
        stalled = stag >= loops.MAX_STAG_CYCLES and relres > 4.0 * tol
        done = bool(relres < tol) or j == 0 or stalled
        status = -42 if stalled else 0
        cycles += 1
        if safe and relres < best_relres:
            best_x, best_relres = x, relres
    if safe and not bool(relres < tol) and best_relres < relres:
        x = best_x
    return x, it, status


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("method", GMRES)
def test_gmres_tree_on_the_cpu_computes_as_the_host_loop(method, dt):
    """On the CPU the loop tree gives the host loop's numbers bit for bit
    (:func:`_host_loop_gmres`), plain and safe, under three stopping
    criteria: an f32 solve at its floor turns on the last bit of each
    sum, and the CPU is where the port is held to the JAX package."""
    A, b = _problem("fe")
    op = device_operator(A, dtype=DTYPES[dt])
    M = tk.JacobiPrecond.from_csr(A, DTYPES[dt])
    bt = torch.from_numpy(b).to(DTYPES[dt])
    for stop, safe, tol in ((1, False, 1e-8), (2, True, 1e-6),
                            (3, True, 1e-12)):
        kw = dict(tol=tol, maxit=150, restart=12, stop_type=stop, safe=safe)
        got = getattr(tk, method)(op, bt, M=M, **kw)
        x, it, status = _host_loop_gmres(
            op, bt, M, tol, 150, 12, stop, method != "gmres",
            method == "vfgmres", safe)
        assert (got.iters, got.status) == (it, status), (stop, safe)
        assert torch.equal(got.x, x), (stop, safe)


def test_twin_square_roots_are_correctly_rounded():
    """``torch.sqrt`` on the CPU misrounds about 1% of its results in the
    last bit (AVX-512 builds; sqrt(0.5) in f64 among them); the twins
    take the correctly rounded root, as NumPy and the kernel's
    ``sqrt_rn`` do."""
    x = np.random.default_rng(3).uniform(0.0, 10.0, 2000)
    for ndt, dt in ((np.float64, torch.float64), (np.float32, torch.float32)):
        for v in [*x.astype(ndt), ndt(0.5), ndt(0.0)]:
            assert loops._sqrt(torch.tensor(v, dtype=dt)).item() == np.sqrt(v)


# ---------------------------------------------------------------------------
# the multigrid solve loops: AMG as a solver, FAMG, GMG's V-cycles, GMG-CG
# ---------------------------------------------------------------------------

def _numpy_mg_blocks(name, dtype):
    """chip_smoke.MG_CASES[name] through the host loops' tests as they
    stood (NumPy scalars of b's dtype): AMG's ``not relres < tol and it <
    maxit``, GMG's ``relres >= tol and it < maxit``; the block's bytes
    after every step."""
    form, params, steps = chip_smoke.MG_CASES[name]
    p = {**chip_smoke.MG_PARAMS, **params}
    blk = loops.Block("cpu", [("mg", dtype)])
    blk.upload({"mg": loops.mg_values(form=form, **p)})
    raw = blk.bytes.numpy()
    f, i = blk.decode(raw)["mg"].f, blk.decode(raw)["mg"].i
    t = f.dtype.type
    tol, out = t(p["tol"]), []
    for phase, (relres,) in steps:
        relres = t(relres)
        if phase == loops.INIT:
            i[I.IT] = 0
            i[I.NINIT] += 1
        else:
            i[I.IT] += 1
            i[I.NBODY] += 1
        more = relres >= tol if form == "gmg" else not relres < tol
        f[F.RELRES] = relres
        i[I.CONT] = bool(more and i[I.IT] < p["maxit"])
        out.append(torch.from_numpy(raw.copy()))
    return out


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(chip_smoke.MG_CASES))
def test_mg_twin_decides_as_the_host_loops_on_the_edge_cases(name, dt):
    want = _numpy_mg_blocks(name, DTYPES[dt])
    got = chip_smoke.mg_case_blocks(torch, name, DTYPES[dt], "cpu",
                                    plain=True)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (name, dt, k)


def test_the_mg_cases_take_their_branches():
    """What the cases are there for, read from the twin's blocks: both
    forms go on at relres == tol; on a NaN AMG's runs to maxit and GMG's
    stops; maxit 0 and 1; convergence at entry."""
    def last(name, dt=torch.float32):
        blk = loops.Block("cpu", [("mg", dt)])
        out = chip_smoke.mg_case_blocks(torch, name, dt, "cpu", plain=True)
        return [blk.decode(o.numpy())["mg"] for o in out]

    def run(name):
        return [(int(s.i[I.IT]), int(s.i[I.CONT])) for s in last(name)]

    for form in ("amg", "gmg"):
        assert run(f"{form} converged at entry") == [(0, 0)]
        assert run(f"{form} maxit 0") == [(0, 0)]
        assert run(f"{form} maxit 1") == [(0, 1), (1, 0)]
        assert run(f"{form} relres exactly tol") == [(0, 1), (1, 1), (2, 0)]
        assert run(f"{form} converges") == [(0, 1), (1, 1), (2, 0)]
    assert run("amg NaN runs to maxit") == [(0, 1), (1, 1), (2, 1), (3, 0)]
    assert run("gmg NaN stops") == [(0, 1), (1, 0)]
    assert run("gmg NaN at entry") == [(0, 0)]
    assert run("amg runs to maxit")[-1] == (4, 0)
    steps = last("amg runs to maxit", torch.float64)
    assert [int(s.i[I.NINIT]) for s in steps] == [1] * 5
    assert [int(s.i[I.NBODY]) for s in steps] == [0, 1, 2, 3, 4]


def _host_loop_amg(hier, b, x0, tol, maxit):
    """AMG as a solver as it stood before its loop tree (a copy): one
    host read of the relres per cycle.  Returns (x, iterations, relres,
    reads)."""
    from faspsolver_tpu_torch.krylov.common import HostReads
    from faspsolver_tpu_torch.precond.amg.cycles import cycle_fn
    A = hier.levels[0].A
    cycle = cycle_fn(hier.cycle_type)
    host = HostReads(b.dtype)
    tol = host.t(tol)
    x = torch.zeros_like(b) if x0 is None else x0
    normb = torch.clamp_min(torch.sqrt(torch.dot(b, b)), 1e-20)

    def relres_of(x):
        r = b - A(x)
        return host(torch.sqrt(torch.dot(r, r)) / normb)[0]

    relres = relres_of(x)
    it = 0
    while not relres < tol and it < maxit:
        x = cycle(hier, b, x)
        relres = relres_of(x)
        it += 1
    return x, it, relres, host.count


def _host_loop_gmg(f, n, dim, tol, maxit, full_first):
    """GMG's V-cycle loop as it stood (a copy of ``_gmg_solve``'s):
    (u, iterations, relres, reads)."""
    from faspsolver_tpu_torch.krylov.common import HostReads
    from faspsolver_tpu_torch.precond import gmg
    h2 = 1.0 / (n * n)
    res, _, restr, prol = gmg._OPS[dim]
    host = HostReads(f.dtype)
    u = torch.zeros_like(f)
    if full_first:
        fs = [f]
        nn_ = n
        while nn_ > 4:
            fs.append(restr(fs[-1]))
            nn_ //= 2
        u = torch.zeros_like(fs[-1])
        for lvl in range(len(fs) - 1, -1, -1):
            if lvl < len(fs) - 1:
                u = prol(u, fs[lvl].shape)
            u = gmg._vcycle(u, fs[lvl], n >> lvl, dim)
    normb = torch.clamp(gmg._norm(f), min=1e-30)
    tol = host.t(tol)
    it = 0
    relres, = host(gmg._norm(res(u, f, h2)) / normb)
    while relres >= tol and it < maxit:
        u = gmg._vcycle(u, f, n, dim)
        relres, = host(gmg._norm(res(u, f, h2)) / normb)
        it += 1
    return u, it, relres, host.count


def _host_loop_gmgcg(f, n, dim, tol, maxit):
    """GMG-CG as it stood (a copy of ``_gmgcg``'s): (u, iterations,
    relres, reads)."""
    from faspsolver_tpu_torch.krylov.common import HostReads
    from faspsolver_tpu_torch.precond import gmg
    h2 = 1.0 / (n * n)
    res = gmg._OPS[dim][0]
    host = HostReads(f.dtype)

    def Aop(u):
        return -res(u, torch.zeros_like(u), h2)

    def Mop(r):
        return gmg._vcycle(torch.zeros_like(r), r, n, dim)

    normb = torch.clamp(gmg._norm(f), min=1e-30)
    u = torch.zeros_like(f)
    r = f - Aop(u)
    z = Mop(r)
    p = z
    rz = torch.sum(r * z)
    tol = host.t(tol)
    it = 0
    relres, = host(gmg._norm(r) / normb)
    while relres >= tol and it < maxit:
        Ap = Aop(p)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) > 1e-30, denom, 1.0)
        u = u + alpha * p
        r = r - alpha * Ap
        z = Mop(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) > 1e-30, rz, 1.0)
        p = z + beta * p
        rz = rz_new
        relres, = host(gmg._norm(r) / normb)
        it += 1
    return u, it, relres, host.count


MG_CYCLES = {"V": 1, "W": 2, "AMLI": 3, "NL_AMLI": 4}


def _mg_setups():
    from faspsolver_tpu_torch.constants import AMGType
    from faspsolver_tpu_torch.precond.amg import setup_rs, setup_sa, setup_ua
    return {"RS": (setup_rs, {}),
            "SA": (setup_sa, dict(AMG_type=int(AMGType.SA))),
            "UA": (setup_ua, dict(AMG_type=int(AMGType.UA)))}


@pytest.mark.parametrize("cycle", sorted(MG_CYCLES))
@pytest.mark.parametrize("kind", ["RS", "SA", "UA"])
def test_amg_tree_on_the_cpu_computes_as_the_host_loop(kind, cycle):
    """On the CPU ``amg_solve`` and ``famg_solve`` give the host loop's
    numbers bit for bit (:func:`_host_loop_amg`): x, iterations, relres;
    the reads are iterations + 1 (FAMG: its sweep counts as an iteration
    and is not a read); in f64 and f32, from zero and from an x0, to
    convergence and to maxit."""
    from faspsolver_tpu_torch.precond.amg import amg_solve, famg_solve
    from faspsolver_tpu_torch.precond.amg.cycles import fmg_cycle
    from faspsolver_tpu_torch.utils.params import AMGParam
    setup, base = _mg_setups()[kind]
    A = poisson_2d(31)
    rng = np.random.default_rng(11)
    b, x0 = rng.standard_normal(A.nrow), rng.standard_normal(A.nrow)
    for dt, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        hier = setup(A, AMGParam(coarse_dof=60, amli_degree=2,
                                 cycle_type=MG_CYCLES[cycle], **base),
                     dtype=dt)
        bt, xt = torch.from_numpy(b).to(dt), torch.from_numpy(x0).to(dt)
        for maxit, start in ((40, None), (40, xt), (3, None)):
            got = amg_solve(hier, bt, start, tol=tol, maxit=maxit)
            x, it, relres, reads = _host_loop_amg(hier, bt, start, tol,
                                                  maxit)
            assert torch.equal(got.x, x), (dt, maxit)
            assert (got.iters, got.relres, got.syncs) == (
                it, float(relres), reads), (dt, maxit)
            assert got.syncs == got.iters + 1 and not got.resident
            assert got.converged == bool(relres < np.dtype(
                relres.dtype).type(tol))
            got = famg_solve(hier, bt, tol=tol, maxit=maxit)
            x, it, relres, reads = _host_loop_amg(
                hier, bt, fmg_cycle(hier, bt), tol, max(maxit - 1, 1))
            assert torch.equal(got.x, x), (dt, maxit)
            assert (got.iters, got.relres, got.syncs) == (
                it + 1, float(relres), reads), (dt, maxit)


GMG_TREES = [("vcycles", 2, 32, False), ("vcycles", 2, 32, True),
             ("vcycles", 3, 16, False), ("vcycles", 3, 8, True),
             ("cg", 2, 32, False), ("cg", 3, 16, False)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("loop,dim,n,full_first", GMG_TREES)
def test_gmg_tree_on_the_cpu_computes_as_the_host_loop(loop, dim, n,
                                                       full_first, dt):
    """On the CPU GMG's V-cycle and CG trees give the host loops' numbers
    bit for bit (:func:`_host_loop_gmg`, :func:`_host_loop_gmgcg`): u,
    iterations, relres, and reads iterations + 1; to convergence and to
    maxit."""
    from faspsolver_tpu_torch.precond import gmg
    f, _ = chip_smoke.gmg_problem(n, dim)
    ft = torch.from_numpy(f).to(DTYPES[dt])
    tol = 1e-9 if dt == "f64" else 1e-5
    for maxit in (50, 1):
        if loop == "cg":
            got = gmg._gmgcg(ft, n, dim, tol, maxit)
            want = _host_loop_gmgcg(ft, n, dim, tol, maxit)
        else:
            got = gmg._gmg_solve(ft, n, dim, tol, maxit, full_first)
            want = _host_loop_gmg(ft, n, dim, tol, maxit, full_first)
        u, it, relres, reads = want
        assert torch.equal(got.x, u), maxit
        assert (got.iters, got.relres, got.syncs) == (it, float(relres),
                                                      reads), maxit
        assert got.syncs == got.iters + 1 and not got.resident
        assert got.converged == (maxit == 50) == (it < maxit)


@pytest.fixture(scope="module")
def mg_pairs():
    """poisson_2d(31): hierarchies the JAX package built (f64), carried
    across with ``from_jax``, by (setup, cycle), and a seeded b."""
    import faspsolver_tpu.precond.amg as jamg
    from faspsolver_tpu.utils.params import AMGParam as JaxParam
    A = poisson_2d(31)
    Aj = JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)
    out = {}
    for kind, cycle in (("RS", "V"), ("SA", "W"), ("UA", "NL_AMLI"),
                        ("RS", "AMLI")):
        base = _mg_setups()[kind][1]
        jh = getattr(jamg, f"setup_{kind.lower()}")(Aj, JaxParam(
            coarse_dof=60, cycle_type=MG_CYCLES[cycle], **base),
            dtype=jnp.float64)
        out[kind, cycle] = (jh, from_jax(jh))
    return out, np.random.default_rng(12).standard_normal(A.nrow)


MG_JAX = [("RS", "V", False), ("SA", "W", False), ("UA", "NL_AMLI", False),
          ("RS", "AMLI", False), ("RS", "V", True), ("SA", "W", True)]


@pytest.mark.parametrize("kind,cycle,famg", MG_JAX)
def test_amg_tree_matches_jax(mg_pairs, kind, cycle, famg):
    """``amg_solve`` / ``famg_solve`` through the tree against the JAX
    functions on the same hierarchy and b (f64): equal iterations and
    convergence, x within atol 1e-10, relres within 1e-6 relative; to
    convergence and to maxit."""
    import faspsolver_tpu.precond.amg as jamg
    from faspsolver_tpu_torch.precond.amg import amg_solve, famg_solve
    pairs, b = mg_pairs
    jh, th = pairs[kind, cycle]
    for maxit in (40, 3):
        got = (famg_solve if famg else amg_solve)(
            th, torch.from_numpy(b), tol=1e-10, maxit=maxit)
        ref = (jamg.famg_solve if famg else jamg.amg_solve)(
            jh, jnp.asarray(b), tol=1e-10, maxit=maxit)
        assert (got.iters, got.converged) == (int(ref.iters),
                                              bool(ref.converged)), maxit
        np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                                   rtol=0, atol=1e-10)
        assert abs(got.relres - float(ref.relres)) \
            <= 1e-6 * float(ref.relres) + 1e-300


def test_mg_trees_on_a_nan_right_hand_side_stop_as_in_jax(mg_pairs):
    """A NaN relres: AMG's loop runs on to maxit, GMG's (V-cycles and
    CG) stops at entry, in both packages."""
    import jax
    import faspsolver_tpu.precond.amg as jamg
    from faspsolver_tpu.precond import gmg as jax_gmg
    from faspsolver_tpu_torch.precond import gmg
    from faspsolver_tpu_torch.precond.amg import amg_solve
    pairs, b = mg_pairs
    jh, th = pairs["RS", "V"]
    b = b.copy()
    b[7] = np.nan
    got = amg_solve(th, torch.from_numpy(b), tol=1e-10, maxit=4)
    ref = jamg.amg_solve(jh, jnp.asarray(b), tol=1e-10, maxit=4)
    assert got.iters == int(ref.iters) == 4 and got.syncs == 5
    assert np.isnan(got.relres) and np.isnan(float(ref.relres))
    f, _ = chip_smoke.gmg_problem(16, 2)
    f[3, 4] = np.nan
    for fn in ("poisson_gmg_2d", "poisson_gmgcg_2d"):
        got = getattr(gmg, fn)(torch.from_numpy(f), 16)
        with jax.disable_jit():
            ref = getattr(jax_gmg, fn)(jnp.asarray(f), 16)
        assert got.iters == int(ref.iters) == 0 and got.syncs == 1, fn
        assert not got.converged and not bool(ref.converged)


# ---------------------------------------------------------------------------
# GCG / GCR: the control against the host loop, the tree against it and JAX
# ---------------------------------------------------------------------------

GCR = ("gcr", "gcg")
GCR_MODULE = importlib.import_module("faspsolver_tpu_torch.krylov.gcg_gcr")


def _numpy_gcr(phase, inp, f, i, ia, R):
    """One GCR control step as the host loop took it (NumPy scalars of
    b's dtype) on NumPy copies of the regions, updated in place."""
    t = f.dtype.type
    small = t(loops.SMALLREAL)
    if phase == loops.INIT:
        _numpy_control("pcg", loops.INIT, inp[:2], f, i)
        i[I.J] = 0
        return
    if phase == loops.CYCLE:
        i[I.J] = 0
        ia[I.CONT] = 0 < R and i[I.IT] < i[I.MAXIT]
        return
    qn, rn = (t(v) for v in inp[:2])
    if phase == loops.STEP:
        brk = qn <= small or rn / f[F.NORMR0] < f[F.TOL]
        i[I.J] += 1
        ia[I.NBODY] += 1
        ia[I.CONT] = i[I.J] < R and i[I.IT] + i[I.J] < i[I.MAXIT] \
            and not brk
        return
    absres, xx = qn, rn
    mod = i[I.STOP] == StopType.MOD_REL_RES
    i[I.IT] += i[I.J]
    normu = max(small, np.sqrt(xx))
    relres = absres / (normu if mod else f[F.NORMR0])
    done = bool(relres < f[F.TOL]) or i[I.J] == 0
    f[F.ABSRES], f[F.RELRES], f[F.NORMU_NEW] = absres, relres, normu
    i[I.STATUS] = 0
    i[I.NBODY] += 1
    i[I.CONT] = not done and i[I.IT] < i[I.MAXIT]


def _numpy_gcr_blocks(name, dtype):
    """chip_smoke.GCR_CASES[name] through :func:`_numpy_gcr`: the block's
    bytes after every step."""
    blk, _, _, R = chip_smoke.gcr_case_state(torch, name, dtype, "cpu")
    raw = blk.bytes.numpy()
    host = blk.decode(raw)
    out = []
    for phase, vals in chip_smoke.GCR_CASES[name][1]:
        _numpy_gcr(phase, np.asarray(vals or [0.0]), host["gcr"].f,
                   host["gcr"].i, host["descent"].i, R)
        out.append(torch.from_numpy(raw.copy()))
    return out


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(chip_smoke.GCR_CASES))
def test_gcr_twin_decides_as_the_host_loop_on_the_edge_cases(name, dt):
    want = _numpy_gcr_blocks(name, DTYPES[dt])
    got = chip_smoke.gcr_case_blocks(torch, name, DTYPES[dt], "cpu",
                                     plain=True)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (name, dt, k)


def test_the_gcr_cases_take_their_branches():
    """What the cases are there for, read from the twin's last block:
    the entry test, a breakdown ending a window after its first step, a
    claim the true residual refutes, maxit inside a window, j == 0
    ending the outer loop, NaN running to maxit, and convergence under
    each stop type."""
    def last(name, dt=torch.float64):
        blk = chip_smoke.gcr_case_blocks(torch, name, dt, "cpu",
                                         plain=True)[-1]
        ref, *_ = chip_smoke.gcr_case_state(torch, name, dt, "cpu")
        host = ref.decode(blk.numpy())
        return host["gcr"], host["descent"]

    def after(name, k):
        blk = chip_smoke.gcr_case_blocks(torch, name, torch.float64, "cpu",
                                         plain=True)[k]
        ref, *_ = chip_smoke.gcr_case_state(torch, name, torch.float64,
                                            "cpu")
        host = ref.decode(blk.numpy())
        return host["gcr"], host["descent"]

    o, _ = last("gcr done at entry")
    assert o.i[I.CONT] == 0 and o.f[F.ABSRES0] < 1e-18   # absres0 < abstol
    assert last("gcr maxit 0")[0].i[I.CONT] == 0
    o, d = after("gcr breakdown at step 0", 2)
    assert d.i[I.CONT] == 0 and o.i[I.J] == 1
    o, d = after("gcr breakdown at step 0", 3)
    assert o.i[I.CONT] == 1 and o.i[I.IT] == 1
    o, d = after("gcr tol met mid-window", 3)
    assert d.i[I.CONT] == 0 and o.i[I.J] == 2
    o, d = after("gcr relres exactly tol", 2)
    assert d.i[I.CONT] == 1
    o, _ = after("gcr relres exactly tol", 4)
    assert o.i[I.CONT] == 1
    o, _ = after("gcr false claim restarts", 3)
    assert o.i[I.CONT] == 1 and o.i[I.IT] == 1
    o, d = after("gcr full window restarts", 4)
    assert d.i[I.CONT] == 0 and o.i[I.J] == 3
    o, d = after("gcr maxit inside a window", 9)
    assert d.i[I.CONT] == 0 and o.i[I.J] == 2
    o, _ = last("gcr maxit inside a window")
    assert o.i[I.IT] == 6 and o.i[I.CONT] == 0
    o, d = after("gcr empty window ends", 1)
    assert d.i[I.CONT] == 0
    o, _ = last("gcr empty window ends")
    assert o.i[I.CONT] == 0 and o.i[I.IT] == 0 and o.f[F.RELRES] == 1.0
    o, d = last("gcr NaN runs to maxit")
    assert o.i[I.IT] == 3 and o.i[I.CONT] == 0 and np.isnan(o.f[F.RELRES])
    assert d.i[I.NBODY] == 3
    for name, stop in (("gcr MOD_REL_RES", 3), ("gcr REL_PRECRES", 2)):
        o, _ = last(name)
        assert o.i[I.STOP] == stop and o.i[I.CONT] == 0
        assert o.f[F.RELRES] < 1e-6 and o.i[I.STATUS] == 0


@pytest.fixture
def checked_gcr_twin(monkeypatch):
    """Every GCR twin call of a solve also run through the host loop's
    NumPy arithmetic on copies of the regions before it, and the two held
    bit-equal.  Returns the calls checked, by phase."""
    calls = {}
    twin = loops.gcr_plain

    def run(phase, inp, reg, inner, R):
        f0, i0, ia0 = (reg.f.numpy().copy(), reg.i.numpy().copy(),
                       inner.i.numpy().copy())
        _numpy_gcr(phase, inp.numpy(), f0, i0, ia0, R)
        twin(phase, inp, reg, inner, R)
        assert np.array_equal(_bits(reg.f.numpy()), _bits(f0)), phase
        assert np.array_equal(reg.i.numpy(), i0), phase
        assert np.array_equal(inner.i.numpy(), ia0), phase
        calls[phase] = calls.get(phase, 0) + 1

    monkeypatch.setattr(loops, "gcr_plain", run)
    return calls


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("method", GCR)
def test_gcr_twin_computes_as_the_host_loop_in_real_solves(
        checked_gcr_twin, method, dt):
    A, b = _problem("fe")
    op = device_operator(A, dtype=DTYPES[dt])
    M = tk.JacobiPrecond.from_csr(A, DTYPES[dt])
    res = getattr(tk, method)(op, torch.from_numpy(b).to(DTYPES[dt]), M=M,
                              tol=1e-8 if dt == "f64" else 1e-5, maxit=200,
                              restart=10, stop_type=int(StopType.MOD_REL_RES))
    assert res.iters > 10
    assert checked_gcr_twin[loops.STEP] == res.iters
    assert checked_gcr_twin[loops.END] >= 2


def _host_loop_gcr(A, b, M, tol, maxit, restart, stop_type):
    """GCR's host loop as it stood before its loop tree (a copy): CGS2
    over the first j rows of P and Q, (qn, |r|) read after every step,
    the true residual once per cycle.  Returns (x, iterations, relres,
    host reads)."""
    from faspsolver_tpu_torch.krylov.common import (
        HostReads, abs_residual, initial_norms, residual_norms)
    host = HostReads(b.dtype)
    t = host.t
    tol, abstol = t(tol), t(1e-18)
    small = t(loops.SMALLREAL)
    R = int(min(restart, maxit))
    n = b.shape[0]
    x = torch.zeros_like(b)
    r = b - A(x)
    absres0, normr0, _, relres = initial_norms(
        stop_type, *host(abs_residual(stop_type, r, M(r)),
                         torch.dot(x, x)))
    done = bool(relres < tol) or bool(absres0 < abstol)
    P = torch.zeros((R, n), dtype=b.dtype)
    Q = torch.zeros((R, n), dtype=b.dtype)
    it = 0
    while not done and it < maxit:
        j, brk = 0, False
        while j < R and it + j < maxit and not brk:
            p = M(r)
            q = A(p)
            Pj, Qj = P[:j], Q[:j]
            h1 = Qj @ q
            p = p - h1 @ Pj
            q = q - h1 @ Qj
            h2 = Qj @ q
            p = p - h2 @ Pj
            q = q - h2 @ Qj
            qn = torch.sqrt(torch.dot(q, q))
            bad = qn <= loops.SMALLREAL
            inv = torch.where(bad, torch.zeros_like(qn),
                              1.0 / torch.where(bad, torch.ones_like(qn), qn))
            p = p * inv
            q = q * inv
            alpha = torch.dot(q, r)
            x = x + alpha * p
            r = r - alpha * q
            P[j] = p
            Q[j] = q
            qn_h, rn = host(qn, torch.sqrt(torch.dot(r, r)))
            brk = qn_h <= small or rn / normr0 < tol
            j += 1
        it += j
        r = b - A(x)
        z = M(r) if stop_type == StopType.REL_PRECRES else r
        absres, xx = host(abs_residual(stop_type, r, z), torch.dot(x, x))
        relres = residual_norms(stop_type, absres, normr0,
                                max(small, np.sqrt(xx)))[1]
        done = bool(relres < tol) or j == 0
    return x, it, float(relres), host.count


@pytest.mark.parametrize("stop", [1, 2, 3])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("method", GCR)
def test_gcr_tree_on_the_cpu_computes_as_the_host_loop(method, dt, stop):
    """On the CPU the loop tree gives the host loop's numbers bit for bit
    (:func:`_host_loop_gcr`): x, iterations, relres and the reads (1 +
    steps + cycles), for GCR's window, GCG's full-memory one and an
    empty window."""
    A, b = _problem("fe")
    op = device_operator(A, dtype=DTYPES[dt])
    M = tk.JacobiPrecond.from_csr(A, DTYPES[dt])
    bt = torch.from_numpy(b).to(DTYPES[dt])
    tol = 1e-9 if dt == "f64" else 1e-5
    for restart in ((7, 0) if method == "gcr" else (None, 5)):
        kw = {} if restart is None else {"restart": restart}
        got = getattr(tk, method)(op, bt, M=M, tol=tol, maxit=150,
                                  stop_type=stop, **kw)
        R = (max(8, min(150, 1024)) if restart is None else restart)
        x, it, relres, syncs = _host_loop_gcr(op, bt, M, tol, 150, R, stop)
        assert (got.iters, got.status, got.syncs) == (it, 0, syncs), restart
        assert got.relres == relres and not got.resident
        assert torch.equal(got.x, x), restart


@pytest.mark.parametrize("arithmetic", ["cpu", "card"])
@pytest.mark.parametrize("stop", [1, 3])
@pytest.mark.parametrize("problem", ["poisson", "fe"])
@pytest.mark.parametrize("method", GCR)
def test_gcr_tree_matches_jax(monkeypatch, method, problem, stop,
                              arithmetic):
    """The eager loop tree against the JAX package on the CPU in f64 (tol
    1e-10, restart 12 for GCR, GCG's full window), in the CPU's
    arithmetic (products over the first j rows) and in the card's
    (masked full-window products, j a device index): iterations and
    status equal, x within 1e-10 of max |x|, and the eager loop's reads
    more than its steps."""
    if arithmetic == "card":
        monkeypatch.setattr(GCR_MODULE, "_on_host", lambda b: False)
    kw = {"restart": 12} if method == "gcr" else {}
    got, ref, err = _jax_pair(method, problem, "f64", tol=1e-10, maxit=400,
                              stop_type=stop, **kw)
    assert got == ref and err <= 1e-10, (got, ref, err)
