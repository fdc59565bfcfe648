"""Preconditioned conjugate gradient with the reference's full safeguard
suite (port of ``faspsolver_tpu/krylov/pcg.py``).

Reference: base/src/KryPcg.c:96 (fasp_solver_dcsr_pcg).  Safeguards
reproduced (they decide iteration counts):
- breakdown guard on p·Ap                  (KryPcg.c:172-177)
- Check I:  near-zero solution abort        (KryPcg.c:215-222)
- Check II: stagnation restart (p <- 0)     (KryPcg.c:224-274)
- Check III: false-convergence true-residual recheck (KryPcg.c:277-324),
  sharing one true-residual recompute with Check II
Safety-net variant (safe=True) tracks the best iterate and returns it on
non-convergence (reference: KrySPcg.c:81-85,190-196).

The loop is a Python loop around two device segments (the port's
counterpart of the JAX package's ONE jitted ``lax.while_loop``):

- S1: ``tp = A p``, the breakdown-guarded alpha, the x and r updates,
  ``z = M r`` under REL_PRECRES, and the six scalars that steer the loop
  (p.Ap, alpha, the residual norm, |x|_inf, x.x, p.p) stacked;
- S2: ``z = M r`` (other criteria), ``temp2n = z.r``, the p update and
  ``temp1 = temp2n``.

The scalars come to the host in ONE read per iteration, where the checks
run on NumPy scalars of b's dtype — the same roundings as the JAX
package's traced scalar arithmetic (its ``tol`` is cast to b's dtype
too).  The rare branches run between the segments: the true-residual
recompute (one more read), the restart's ``p = 0`` and the safe
iterate.  ``SolveResult.syncs`` counts the reads.

The state (x, r, z, p, temp1 and the safe iterate) lives in tensors the
segments update in place, with the operations of the plain expressions
(``torch.add(x, alpha * p, out=x)`` is ``x + alpha * p``).  On a CUDA
vector, when A and M declare themselves capturable
(``utils.graphs.capturable``), S1 and S2 are CUDA graphs captured at the
first solve and replayed by later iterations, rounds and solves over the
same A and M (cached by their buffers, dtype, length and criterion); a
failed capture raises.  Elsewhere — the CPU, DTensors, under
``utils.graphs.eager()``, or a module that does not declare it — the
same segments run eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import (ERROR_SOLVER_MISC, ERROR_SOLVER_SOLSTAG,
                         ERROR_SOLVER_STAG, ERROR_SOLVER_TOLSMALL, MAX_RESTART,
                         MAX_STAG, STAG_RATIO, StopType)
from ..utils import graphs
from .common import (SMALLREAL, SMALLREAL2, HostReads, abs_residual, dot,
                     initial_norms, residual_norms, resolve_precond)
from .result import SolveResult


class _State:
    """The tensors one solve updates in place; when graphed, kept with
    the segments' programs for the next solve over the same A and M."""

    def __init__(self, b, precres: bool, safe: bool):
        self.x, self.r, self.p = (torch.zeros_like(b) for _ in range(3))
        self.z = torch.zeros_like(b) if precres else None
        self.best_x = torch.zeros_like(b) if safe else None
        self.temp1 = None                   # 0-d, set by the first solve
        self.s1 = self.s2 = None            # graphs.Program, when graphed

    def set_temp1(self, t: torch.Tensor) -> None:
        if self.temp1 is None:
            self.temp1 = t
        else:
            self.temp1.copy_(t)


def _seg1(st: _State, A, M, stop_type: int) -> torch.Tensor:
    x, r, p = st.x, st.r, st.p
    tp = A(p)
    temp2 = dot(tp, p)
    bd = temp2.abs() <= SMALLREAL2
    # on breakdown leave the iterate untouched (reference breaks first)
    alpha = torch.where(bd, torch.zeros_like(temp2),
                        st.temp1 / torch.where(bd, torch.ones_like(temp2),
                                               temp2))
    torch.add(x, alpha * p, out=x)
    torch.sub(r, alpha * tp, out=r)
    if st.z is not None:
        st.z.copy_(M(r))
    return torch.stack((temp2, alpha, abs_residual(stop_type, r, st.z),
                        torch.max(torch.abs(x)), dot(x, x), dot(p, p)))


def _seg2(st: _State, M) -> None:
    z = st.z if st.z is not None else M(st.r)
    temp2n = dot(z, st.r)
    torch.add(z, (temp2n / st.temp1) * st.p, out=st.p)
    st.temp1.copy_(temp2n)


def _state(A, M, b, stop_type: int, safe: bool):
    """(state, graphed): the cached state of a graphed solve, or a fresh
    one for an eager solve."""
    precres = stop_type == StopType.REL_PRECRES
    if not (graphs.active(b) and graphs.capturable(A)
            and graphs.capturable(M)):
        return _State(b, precres, safe), False
    (ha, sa), (hm, sm) = graphs.identity(A), graphs.identity(M)
    key = (b.dtype, b.shape[0], b.device, sa, sm, graphs.fingerprint(ha),
           graphs.fingerprint(hm))
    return graphs.cached((ha, hm), ("pcg", int(stop_type), bool(safe)), key,
                         lambda: _State(b, precres, safe)), True


def pcg(A, b, x0=None, M=None, *, tol: float = 1e-6, abstol: float = 1e-18,
        maxit: int = 500, stop_type: int = int(StopType.REL_RES),
        safe: bool = False, max_stag: int = MAX_STAG,
        max_restart: int = MAX_RESTART) -> SolveResult:
    """Solve A x = b with preconditioned CG.

    ``max_stag``/``max_restart`` default to the reference's safeguard
    budgets; inner solves under mixed-precision refinement pass small
    values so a solve pinned at the f32 residual floor exits after a
    couple of restarts (the outer f64 loop supplies the robustness).
    """
    M = resolve_precond(M)
    host = HostReads(b.dtype)
    t = host.t
    tol, abstol = t(tol), t(abstol)
    maxdiff = tol * t(STAG_RATIO)
    small, small2, slow = t(SMALLREAL), t(SMALLREAL2), t(0.9)
    precres = stop_type == StopType.REL_PRECRES
    st, graphed = _state(A, M, b, stop_type, safe)

    x, r, p = st.x, st.r, st.p
    if x0 is None:
        x.zero_()
    else:
        x.copy_(x0)
    torch.sub(b, A(x), out=r)
    z = M(r)
    if precres:
        st.z.copy_(z)
    p.copy_(z)
    st.set_temp1(dot(z, r))
    absres0, normr0, normu, relres = initial_norms(
        stop_type, *host(abs_residual(stop_type, r, z), dot(x, x)))
    done = bool(relres < tol) or bool(absres0 < abstol)
    it, stag, more, status = 0, 1, 1, 0
    best_absres = absres0
    if safe:
        st.best_x.copy_(x)

    while not done and it < maxit:
        it += 1
        if graphed and st.s1 is None:
            # captured at the first iteration, over the initialized state;
            # each warm-up run is undone (``keep``)
            changed = [v for v in (x, r, st.z) if v is not None]
            st.s1 = graphs.Program(lambda: _seg1(st, A, M, stop_type),
                                   b.device, changed)
            st.s2 = graphs.Program(lambda: _seg2(st, M), b.device,
                                   [p, st.temp1], pool=st.s1.pool)
        (temp2_h, alpha_h, absres, normuinf, xx, pp) = host.vec(
            st.s1.replay() if graphed else _seg1(st, A, M, stop_type))
        absres, relres = residual_norms(stop_type, absres, normr0, normu)
        breakdown = abs(temp2_h) <= small2
        factor = absres / absres0

        # ---- Check I + II (only when converging slowly: factor > 0.9) ----
        zero_sol = factor > slow and normuinf <= small
        normu_new = max(small, np.sqrt(xx))
        reldiff = abs(alpha_h) * np.sqrt(pp) / normu_new
        stagnated = (factor > slow and not zero_sol and stag <= max_stag
                     and reldiff < maxdiff)
        # Check III on claimed convergence; one true-residual recompute
        # serves both checks
        claim = relres < tol and not stagnated and not zero_sol
        need = stagnated or claim
        if need:
            torch.sub(b, A(x), out=r)
            if precres:
                st.z.copy_(M(r))
            absres, relres = residual_norms(
                stop_type, *host(abs_residual(stop_type, r, st.z)), normr0,
                normu_new)

        conv = need and relres < tol
        stag_fail = stagnated and not conv and stag >= max_stag
        tol_fail = claim and not conv and more >= max_restart
        restart = need and not conv and not stag_fail and not tol_fail
        if restart:
            p.zero_()
            stag += int(stagnated)
            more += int(claim)

        # ---- prepare next direction ----
        if graphed:
            st.s2.replay()
        else:
            _seg2(st, M)

        done = bool(breakdown or zero_sol or stag_fail or tol_fail
                    or (stagnated and conv) or (claim and conv))
        status = (ERROR_SOLVER_MISC if breakdown else
                  ERROR_SOLVER_SOLSTAG if zero_sol else
                  ERROR_SOLVER_STAG if stag_fail else
                  ERROR_SOLVER_TOLSMALL if tol_fail else 0)
        absres0 = absres
        if stop_type == StopType.MOD_REL_RES:
            normu = normu_new
        if safe and absres < best_absres:
            st.best_x.copy_(x)
            best_absres = absres

    converged = bool(relres < tol)
    if safe and not converged and best_absres < absres0:
        # best-so-far iterate on non-convergence (KrySPcg.c:190-196)
        x = st.best_x
    return SolveResult(x=x.clone() if graphed else x, iters=it,
                       relres=float(relres), converged=converged,
                       status=int(status), syncs=host.count)
