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

The loop is the JAX package's ONE jitted ``lax.while_loop`` as a tree of
``utils.graphs`` (:func:`_tree`): a start piece (the initial residual and
norms), then a While whose body is

- half 1: ``tp = A p``, the breakdown-guarded alpha, the x and r updates,
  ``z = M r`` under REL_PRECRES, and the loop-control check
  (``utils.loops``) over p.Ap, alpha, the residual norm, |x|_inf, x.x
  and p.p;
- an If (the ``lax.cond``): the true residual, when stagnation or a
  claimed convergence asks for it;
- half 2: the control's decide, the restart's ``p = 0`` and the safe
  iterate as masked updates, ``z = M r`` (other criteria), ``temp2n =
  z.r``, the p update and ``temp1 = temp2n``.

The decisions are the control's, in b's dtype: on a CUDA vector its
kernel, on the CPU its plain twin, bit for bit the roundings of the JAX
package's traced scalar arithmetic (its ``tol`` is cast to b's dtype
too).  The state (x, r, z, p, temp1, the safe iterate and the control's
block) lives in tensors the pieces update in place.

On a CUDA vector (or a DTensor over an NCCL mesh, whose collectives
the graph captures), when A and M declare themselves capturable
(``utils.graphs.capturable``), the tree is captured at the first solve
as one CUDA graph (``graphs.Resident``: conditional WHILE and IF nodes
set by the control kernel) kept with A and M, and a solve is one launch
and ONE host read at the end (``SolveResult.syncs`` = 1).  Elsewhere —
the CPU, a gloo mesh's DTensors, under ``utils.graphs.eager()``, or a
module that does not declare it — the same tree runs as the eager loop,
which reads the control's block once per iteration and once more per
recompute.
"""
from __future__ import annotations

import torch

from ..constants import MAX_RESTART, MAX_STAG, StopType
from ..utils import graphs, loops
from ..utils.loops import CHECK, DECIDE, INIT, F, I
from .common import (SMALLREAL2, HostReads, abs_residual, dot, like,
                     local_device, loop_state, resolve_precond)
from .result import SolveResult


class _State(graphs.LoopState):
    """The tensors one solve updates in place; when resident, kept with
    its program for the next solve over the same A and M.  ``b`` is the
    right-hand side the program reads (a static copy unless given), and
    ``reg`` the control's region (a block of its own unless given)."""

    def __init__(self, like_b, precres: bool, safe: bool, b=None, reg=None):
        self.b = torch.zeros_like(like_b) if b is None else b
        self.x, self.r, self.p = (torch.zeros_like(like_b) for _ in range(3))
        self.z = torch.zeros_like(like_b) if precres else None
        self.best_x = torch.zeros_like(like_b) if safe else None
        self.temp1 = torch.zeros_like(dot(like_b, like_b))
        self.rt = torch.zeros(1, dtype=like_b.dtype,
                              device=local_device(like_b))
        if reg is None:
            self.block = loops.Block(local_device(like_b),
                                     [("pcg", like_b.dtype)])
            reg = self.block["pcg"]
        self.reg = reg


def _start(st: _State, A, M, stop_type: int) -> None:
    """r = b - A x, z = M r, p = z, temp1 = z.r; the initial norms."""
    x, r = st.x, st.r
    torch.sub(st.b, A(x), out=r)
    z = M(r)
    if st.z is not None:
        st.z.copy_(z)
    st.p.copy_(z)
    st.temp1.copy_(dot(z, r))
    if st.best_x is not None:
        st.best_x.copy_(x)
    loops.control("pcg", INIT, torch.stack(
        (abs_residual(stop_type, r, z), dot(x, x))), st.reg)


def _half1(st: _State, A, M, stop_type: int) -> None:
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
    loops.control("pcg", CHECK, torch.stack(
        (temp2, alpha, abs_residual(stop_type, r, st.z),
         torch.max(torch.abs(x)), dot(x, x), dot(p, p))), st.reg)


def _recompute(st: _State, A, M, stop_type: int) -> None:
    """The true residual and its norm (Checks II and III)."""
    torch.sub(st.b, A(st.x), out=st.r)
    if st.z is not None:
        st.z.copy_(M(st.r))
    st.rt.copy_(loops.local(abs_residual(stop_type, st.r, st.z)).reshape(1))


def _half2(st: _State, M) -> None:
    loops.control("pcg", DECIDE, st.rt, st.reg)
    p = st.p
    p.masked_fill_(like(st.reg.flag(I.RESTART), p), 0)
    z = st.z if st.z is not None else M(st.r)
    temp2n = dot(z, st.r)
    torch.add(z, (temp2n / st.temp1) * p, out=p)
    st.temp1.copy_(temp2n)
    if st.best_x is not None:
        torch.where(like(st.reg.flag(I.BETTER), p), st.x, st.best_x,
                    out=st.best_x)


def _tree(st: _State, A, M, stop_type: int):
    """The PCG loop as a ``utils.graphs`` tree: the start, then the
    While over half 1, the recompute's If and half 2."""
    return [graphs.Piece(lambda: _start(st, A, M, stop_type)),
            _loop(st, A, M, stop_type)]


def _loop(st: _State, A, M, stop_type: int):
    return graphs.While(st.reg, (
        graphs.Piece(lambda: _half1(st, A, M, stop_type)),
        graphs.If(st.reg, (
            graphs.Piece(lambda: _recompute(st, A, M, stop_type)),)),
        graphs.Piece(lambda: _half2(st, M))))


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
    precres = stop_type == StopType.REL_PRECRES
    st, resident = loop_state("pcg", A, M, b, stop_type, safe,
                              lambda: _State(b, precres, safe))
    st.b.copy_(b)
    if x0 is None:
        st.x.zero_()
    else:
        st.x.copy_(x0)
    st.block.upload({"pcg": loops.krylov_values(
        tol, abstol, maxit, stop_type, safe, max_stag, max_restart)})
    host = HostReads(b.dtype)
    vals = graphs.run_loop(st, lambda: _tree(st, A, M, stop_type), host,
                           resident)["pcg"]
    return result(st, vals, host.count, resident)


def result(st: _State, vals, syncs: int, resident: bool) -> SolveResult:
    """The solve's result from the region's last read: x (the best
    iterate of a safe solve that did not converge and had a better one,
    KrySPcg.c:190-196), a copy when the state is kept."""
    f, i = vals.f, vals.i
    converged = bool(f[F.RELRES] < f[F.TOL])
    x = st.x
    if st.best_x is not None and not converged and f[F.BEST] < f[F.ABSRES]:
        x = st.best_x
    return SolveResult(x=x.clone() if resident else x, iters=int(i[I.IT]),
                       relres=float(f[F.RELRES]), converged=converged,
                       status=int(i[I.STATUS]), syncs=syncs,
                       resident=resident)
