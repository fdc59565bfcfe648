"""Mixed-precision iterative refinement: f32 inner solves, f64 accuracy
(port of ``solve_refined``, ``solve_refined_device``,
``make_resident_refiner`` / ``_refine_body`` and
``solve_refined_resident`` of ``faspsolver_tpu/solvers/refine.py``).

``solve_refined`` keeps the f64 residuals on the host (any host matrix,
any inner solver); ``solve_refined_device`` keeps them on the device
behind an f64 operator.  In the resident form the outer loop computes
f64 true residuals with the hierarchy's exact f64 fine operator and
accumulates the f64 solution on the device; the inner solve is an f32
AMG-PCG.  Each round multiplies the achieved
accuracy, so 2-3 rounds of an inner 1e-5 solve reach 1e-10.  The rounds
are a Python loop: one host read of the f64 relative residual per round
(the inner PCG reads once per iteration), counted in ``syncs``.  A
round's f64 stages — the scale and the f32 residual before the inner
solve, the update, the true residual and its norm after it — update
static tensors in place; on a CUDA device, when the f64 operator
declares itself capturable (``utils.graphs``), they replay from two CUDA
graphs kept with that operator, as the inner PCG replays its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import default_device
from ..formats import BSRMatrix, CSRMatrix
from ..krylov.common import HostReads
from ..utils import graphs


@dataclass
class RefinedResult:
    x: np.ndarray               # f64 solution (host)
    rounds: int                 # outer refinement rounds used
    inner_iters: int            # total inner Krylov iterations
    relres: float               # f64 relative residual (device-computed)
    converged: bool
    syncs: int = 0              # device-to-host reads during the solve


class RefineOutcome(NamedTuple):
    x: torch.Tensor             # f64 solution, on the device of b
    relres: float
    rounds: int
    iters: int
    syncs: int


def _need(tol, relres, inner_tol, inner_floor) -> float:
    """The inner tolerance of one round: the remaining reduction times a
    safety factor, between the f32 floor and ``inner_tol``."""
    return max(min(inner_tol, 0.3 * tol / relres), inner_floor)


def solve_refined(A_host, b, inner_solve: Callable, *, tol: float = 1e-8,
                  max_rounds: int = 6, inner_tol: float = 1e-5,
                  inner_floor: float = 5e-6, dtype=torch.float32,
                  device=None) -> RefinedResult:
    """Outer f64 refinement on the host around an inner reduced-precision
    solver on ``device`` (``None``: the CUDA device; it raises where
    there is none).

    ``A_host`` is a host matrix (CSRMatrix / BSRMatrix) for the exact f64
    residuals; ``inner_solve(r, tol) -> SolveResult`` solves A d = r
    approximately for a ``dtype`` tensor r on ``device`` (say AMG-vFGMRES
    in f32).  The inner tolerance adapts: each round asks only for the
    remaining reduction, so late rounds cost a couple of iterations."""
    if not isinstance(A_host, (BSRMatrix, CSRMatrix)):
        raise TypeError("solve_refined needs a host matrix for f64 residuals")
    device = torch.device(device) if device is not None else default_device()

    b64 = np.asarray(b, dtype=np.float64)
    bnorm = max(float(np.linalg.norm(b64)), 1e-300)
    x = np.zeros_like(b64)
    total_inner = syncs = 0
    prev_relres = np.inf
    slow_rounds = 0
    best_x, best_relres = x, np.inf
    for rnd in range(max_rounds):
        r = b64 - A_host.matvec(x)
        relres = float(np.linalg.norm(r)) / bnorm
        if relres < best_relres:
            best_x, best_relres = x, relres
        if relres < tol:
            return RefinedResult(x=x, rounds=rnd, inner_iters=total_inner,
                                 relres=relres, converged=True, syncs=syncs)
        # stall guard: refinement converges geometrically when it works.
        # Two consecutive rounds gaining less than 2x while still more
        # than 10x away from tol mean the inner precision is exhausted:
        # stop and return the best iterate seen (a diverged inner
        # correction is not handed back).  One slow round alone is not a
        # stall, and within 10x of tol the last rounds may crawl.
        if relres > 0.5 * prev_relres and relres > 10 * tol:
            slow_rounds += 1
            if slow_rounds >= 2:
                return RefinedResult(x=best_x, rounds=rnd,
                                     inner_iters=total_inner,
                                     relres=best_relres, converged=False,
                                     syncs=syncs)
        else:
            slow_rounds = 0
        prev_relres = relres
        # the residual scaled to O(1) keeps the f32 solve's dynamic range
        scale = max(float(np.abs(r).max()), 1e-300)
        res = inner_solve(
            torch.as_tensor(r / scale).to(device=device, dtype=dtype),
            _need(tol, relres, inner_tol, inner_floor))
        total_inner += int(res.iters)
        syncs += int(getattr(res, "syncs", 0)) + 1
        x = x + scale * res.x.to(torch.float64).cpu().numpy()
    relres = float(np.linalg.norm(b64 - A_host.matvec(x))) / bnorm
    if relres > best_relres:               # the last round made it worse
        x, relres = best_x, best_relres
    return RefinedResult(x=x, rounds=max_rounds, inner_iters=total_inner,
                         relres=relres, converged=relres < tol, syncs=syncs)


def solve_refined_device(op_hi, b, inner_solve: Callable, *,
                         tol: float = 1e-8, max_rounds: int = 6,
                         inner_tol: float = 1e-5, inner_floor: float = 5e-6,
                         dtype=torch.float32) -> RefinedResult:
    """Device-resident refinement around any inner solver: the f64
    operator ``op_hi``, the solution and the residuals stay on
    ``op_hi``'s device, and each round reads two scalars back.
    ``inner_solve(r, tol) -> SolveResult`` as in :func:`solve_refined`."""
    device = next(op_hi.buffers()).device
    b64 = torch.as_tensor(np.asarray(b, dtype=np.float64), device=device)
    bnorm = max(float(torch.linalg.vector_norm(b64)), 1e-300)
    x = torch.zeros_like(b64)
    total_inner, syncs, converged = 0, 1, False
    for rnd in range(max_rounds + 1):
        r = b64 - op_hi(x)
        relres = float(torch.linalg.vector_norm(r)) / bnorm
        syncs += 1
        converged = relres < tol
        if converged or rnd == max_rounds:
            break
        scale = float(r.abs().max())
        syncs += 1
        res = inner_solve((r / scale).to(dtype),
                          _need(tol, relres, inner_tol, inner_floor))
        total_inner += int(res.iters)
        syncs += int(getattr(res, "syncs", 0))
        x = x + scale * res.x.to(torch.float64)
    return RefinedResult(x=x.cpu().numpy(), rounds=rnd,
                         inner_iters=total_inner, relres=relres,
                         converged=converged, syncs=syncs)


def make_resident_refiner(op64, op32, M, *, tol: float = 1e-6,
                          max_rounds: int = 4, inner_tol: float = 1e-5,
                          inner_floor: float = 5e-6, maxit_inner: int = 40):
    """Return ``run(b64) -> RefineOutcome``: rounds of f64 true residual
    via ``op64`` -> scale -> f32 AMG-PCG (``op32``, ``M``) -> f64 update,
    until the f64 relative residual drops below ``tol``."""
    args = (float(tol), float(inner_tol), float(inner_floor),
            int(max_rounds), int(maxit_inner))

    def run(b64: torch.Tensor) -> RefineOutcome:
        return _refine_body(op64, op32, M, b64, *args)

    return run


class _Rounds:
    """The tensors a resident refinement updates in place, and, when
    graphed, its two stage programs (kept with the f64 operator)."""

    def __init__(self, b64: torch.Tensor, dtype):
        self.b, self.x, self.r = (torch.zeros_like(b64) for _ in range(3))
        self.bnorm, self.scale = (b64.new_zeros(()) for _ in range(2))
        self.r32 = torch.zeros_like(b64, dtype=dtype)
        self.d = torch.zeros_like(self.r32)
        self.pre = self.post = None         # graphs.Program, when graphed


def _pre(st: _Rounds) -> None:
    """The round's scale and its f32 right-hand side r / scale."""
    st.scale.copy_(torch.clamp_min(torch.max(torch.abs(st.r)), 1e-300))
    st.r32.copy_((st.r / st.scale).to(st.r32.dtype))


def _post(st: _Rounds, op64) -> torch.Tensor:
    """x += scale d; r = b - A x; the f64 relative residual."""
    torch.add(st.x, st.scale * st.d.to(st.x.dtype), out=st.x)
    torch.sub(st.b, op64(st.x), out=st.r)
    return (torch.sqrt(torch.dot(st.r, st.r)) / st.bnorm).reshape(1)


def _rounds(op64, b64, dtype):
    """(rounds state, graphed)."""
    if not (graphs.active(b64) and graphs.capturable(op64)):
        return _Rounds(b64, dtype), False
    home, static = graphs.identity(op64)
    key = (b64.shape[0], b64.device, static, graphs.fingerprint(home))
    return graphs.cached((home,), ("refine", dtype), key,
                         lambda: _Rounds(b64, dtype)), True


def _refine_body(op64, op32, M, b64, tol_, inner_tol, inner_floor,
                 max_rounds, maxit_inner) -> RefineOutcome:
    from ..krylov import pcg

    st, graphed = _rounds(op64, b64, op32.dtype)
    if graphed and st.pre is None:
        st.pre = graphs.Program(lambda: _pre(st), b64.device,
                                [st.scale, st.r32])
        st.post = graphs.Program(lambda: _post(st, op64), b64.device,
                                 [st.x, st.r], pool=st.pre.pool)
    st.b.copy_(b64)
    st.bnorm.copy_(torch.clamp_min(torch.sqrt(torch.dot(b64, b64)), 1e-300))
    st.x.zero_()
    st.r.copy_(b64)
    host = HostReads(b64.dtype)
    relres, rnd, iters, syncs = 1.0, 0, 0, 0
    while relres >= tol_ and rnd < max_rounds:
        if graphed:
            st.pre.replay()
        else:
            _pre(st)
        need = min(max(0.3 * tol_ / max(relres, 1e-300), inner_floor),
                   inner_tol)
        # tight safeguard budgets: when the inner f32 solve hits its
        # residual floor, Check II/III restarts would burn ~20 dead
        # iterations per round — the outer f64 loop is the recovery
        res = pcg(op32, st.r32, M=M, tol=need, maxit=maxit_inner,
                  max_stag=2, max_restart=2)
        st.d.copy_(res.x)
        relres = float(host.vec(st.post.replay() if graphed
                                else _post(st, op64))[0])
        rnd += 1
        iters += res.iters
        syncs += res.syncs + 1
    return RefineOutcome(st.x.clone() if graphed else st.x, relres, rnd,
                         iters, syncs)


def solve_refined_resident(hier, b, M=None, *, tol: float = 1e-6,
                           max_rounds: int = 4, inner_tol: float = 1e-5,
                           inner_floor: float = 5e-6,
                           maxit_inner: int = 40) -> RefinedResult:
    """Refinement driven by an AMG hierarchy that carries its f64 fine
    operator (``setup_structured(..., keep_f64_fine=True)``), on the
    hierarchy's device.  ``b`` is the exact f64 right-hand side."""
    if hier.fine64 is None:
        raise ValueError("hierarchy has no f64 fine operator "
                         "(setup_structured(..., keep_f64_fine=True))")
    if M is None:
        from ..precond import AMGPrecond
        M = AMGPrecond(hier)
    device = next(hier.fine64.buffers()).device
    run = make_resident_refiner(hier.fine64, hier.levels[0].A, M, tol=tol,
                                max_rounds=max_rounds, inner_tol=inner_tol,
                                inner_floor=inner_floor,
                                maxit_inner=maxit_inner)
    b64 = torch.as_tensor(np.asarray(b, dtype=np.float64), device=device)
    out = run(b64)
    return RefinedResult(x=out.x.cpu().numpy(), rounds=out.rounds,
                         inner_iters=out.iters, relres=out.relres,
                         converged=out.relres < tol, syncs=out.syncs)
