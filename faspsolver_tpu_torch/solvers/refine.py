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
are the JAX package's ``lax.while_loop`` around the inner PCG's as a
``utils.graphs`` tree: its f64 stages — the scale and the f32 residual
before the inner solve, the update, the true residual and its norm
after it — update static tensors in place, and the loop-control kernel
(``utils.loops``) counts the rounds, tests the f64 relative residual and
sets the next inner tolerance on the device.  On a CUDA device, when
the f64 operator, the f32 operator and M declare themselves capturable
(``utils.graphs``), the whole refinement is one CUDA graph with the
inner PCG's WHILE nested in the rounds' WHILE, kept with the f64
operator and M: one launch and one host read per solve (``syncs``).
Elsewhere the same tree runs as the eager loop: one read of the f64
relative residual per round plus the inner PCG's reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import default_device
from ..constants import StopType
from ..formats import BSRMatrix, CSRMatrix
from ..krylov.common import HostReads
from ..utils import graphs, loops
from ..utils.loops import INIT, ROUND, F, I


@dataclass
class RefinedResult:
    x: np.ndarray               # f64 solution (host)
    rounds: int                 # outer refinement rounds used
    inner_iters: int            # total inner Krylov iterations
    relres: float               # f64 relative residual (device-computed)
    converged: bool
    syncs: int = 0              # device-to-host reads during the solve
    recomputes: int = 0         # inner true-residual recomputes


class RefineOutcome(NamedTuple):
    x: torch.Tensor             # f64 solution, on the device of b
    relres: float
    rounds: int
    iters: int
    syncs: int
    recomputes: int = 0         # inner true-residual recomputes


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


class _Rounds(graphs.LoopState):
    """The tensors a resident refinement updates in place: the f64
    solution and residual, the round's scale and f32 right-hand side,
    and the inner PCG's state, whose b is that right-hand side; one
    block with the rounds' region and the inner PCG's."""

    def __init__(self, b64: torch.Tensor, dtype):
        from ..krylov.pcg import _State
        self.b, self.x, self.r = (torch.zeros_like(b64) for _ in range(3))
        self.bnorm, self.scale = (b64.new_zeros(()) for _ in range(2))
        self.r32 = torch.zeros_like(b64, dtype=dtype)
        self.block = loops.Block(b64.device, [("refine", torch.float64),
                                              ("pcg", dtype)])
        self.reg = self.block["refine"]
        self.pcg = _State(self.r32, False, False, b=self.r32,
                          reg=self.block["pcg"])


def _start(st: _Rounds) -> None:
    """bnorm, x = 0, r = b; the entry test and the first inner tol."""
    b = st.b
    st.bnorm.copy_(torch.clamp_min(torch.sqrt(torch.dot(b, b)), 1e-300))
    st.x.zero_()
    st.r.copy_(b)
    loops.refine(INIT, st.reg.f, st.reg, st.pcg.reg)


def _pre(st: _Rounds) -> None:
    """The round's scale and its f32 right-hand side r / scale; the
    inner solve starts from 0."""
    st.scale.copy_(torch.clamp_min(torch.max(torch.abs(st.r)), 1e-300))
    st.r32.copy_((st.r / st.scale).to(st.r32.dtype))
    st.pcg.x.zero_()


def _post(st: _Rounds, op64) -> None:
    """x += scale d; r = b - A x; the round's control over the f64
    relative residual."""
    torch.add(st.x, st.scale * st.pcg.x.to(st.x.dtype), out=st.x)
    torch.sub(st.b, op64(st.x), out=st.r)
    loops.refine(ROUND, (torch.sqrt(torch.dot(st.r, st.r))
                         / st.bnorm).reshape(1), st.reg, st.pcg.reg)


def _tree(st: _Rounds, op64, op32, M, entry: bool):
    """The rounds as a ``utils.graphs`` tree: the start, then a While
    whose body is the round's f32 right-hand side, the inner PCG (its
    start and its own While) and the f64 update."""
    from ..krylov.pcg import _loop, _start as _pcg_start
    rel = int(StopType.REL_RES)
    return [graphs.Piece(lambda: _start(st)), graphs.While(st.reg, (
        graphs.Piece(lambda: _pre(st)),
        graphs.Piece(lambda: _pcg_start(st.pcg, op32, M, rel)),
        _loop(st.pcg, op32, M, rel),
        graphs.Piece(lambda: _post(st, op64))), entry=entry)]


def _rounds(op64, op32, M, b64):
    """(rounds state, resident): kept with the f64 operator and M when
    the whole program can be captured (op64, op32 and M capturable)."""
    dtype = op32.dtype
    if not (graphs.active(b64) and all(
            graphs.capturable(m) for m in (op64, op32, M))):
        return _Rounds(b64, dtype), False
    (home, static), (hm, sm) = graphs.identity(op64), graphs.identity(M)
    key = (b64.shape[0], b64.device, static, sm, graphs.fingerprint(home),
           graphs.fingerprint(op32), graphs.fingerprint(hm))
    return graphs.cached((home, hm), ("refine", dtype), key,
                         lambda: _Rounds(b64, dtype)), True


def _refine_body(op64, op32, M, b64, tol_, inner_tol, inner_floor,
                 max_rounds, maxit_inner) -> RefineOutcome:
    """The rounds (``faspsolver_tpu/solvers/refine.py`` ``_refine_body``):
    each an f64 residual's scale, an f32 AMG-PCG to the round's inner
    tolerance (the remaining reduction times 0.3, between
    ``inner_floor`` and ``inner_tol``, computed by the control in f64),
    and the f64 update, until the f64 relative residual is below
    ``tol_`` or ``max_rounds`` ran.  Tight safeguard budgets inside
    (``max_stag=2``, ``max_restart=2``): when the inner f32 solve hits
    its residual floor, Check II/III restarts would burn ~20 dead
    iterations per round — the outer f64 loop is the recovery.  Resident
    on a CUDA vector when op64, op32 and M are capturable: one launch
    and one read (``syncs`` 1); else the eager loop, one read per round
    plus the inner PCG's."""
    st, resident = _rounds(op64, op32, M, b64)
    st.b.copy_(b64)
    st.block.upload({
        "refine": {("f", F.TOL): tol_, ("f", F.INNER_TOL): inner_tol,
                   ("f", F.INNER_FLOOR): inner_floor,
                   ("i", I.MAXIT): max_rounds},
        "pcg": loops.krylov_values(0.0, 1e-18, maxit_inner,
                                   StopType.REL_RES, False, 2, 2)})
    host = HostReads(b64.dtype)
    entry = 1.0 >= tol_ and 0 < max_rounds
    vals = graphs.run_loop(st, lambda: _tree(st, op64, op32, M, entry),
                           host, resident)
    if vals is None:              # the eager loop ran no round
        return RefineOutcome(st.x, 1.0, 0, 0, host.count)
    ref, inner = vals["refine"], vals["pcg"]
    return RefineOutcome(st.x.clone() if resident else st.x,
                         float(ref.f[F.RELRES]), int(ref.i[I.IT]),
                         int(inner.i[I.NBODY]), host.count,
                         int(inner.i[I.NIF]))


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
                         converged=out.relres < tol, syncs=out.syncs,
                         recomputes=out.recomputes)
