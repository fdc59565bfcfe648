"""Preconditioned BiCGstab (port of ``faspsolver_tpu/krylov/bicgstab.py``).

Reference: base/src/KryPbcgs.c, with breakdown guards on rho and omega,
the stagnation restart, the false-convergence true-residual recheck and
the safety-net best-iterate mode (KrySPbcgs.c).  The JAX package's
``lax.while_loop`` as a ``utils.graphs`` tree, built as PCG's is
(``krylov/pcg.py``): a start piece, then a While over half 1 (the
BiCGstab step and the loop-control check over rstar.v, t.t, the residual
norm, x.x and step.step), an If around the true residual (the
``lax.cond``) and half 2 (the control's decide, and the restart — p,
rstar and rho from the current residual — and the safe iterate as
masked updates).  Resident (one launch, one host read) on a CUDA vector
over capturable A and M; elsewhere the eager loop, one read of the
control's block per iteration plus one per recompute
(``SolveResult.syncs``).
"""
from __future__ import annotations

import torch

from ..constants import MAX_RESTART, MAX_STAG, StopType
from ..utils import graphs, loops
from ..utils.loops import CHECK, DECIDE, INIT, I
from .common import (SMALLREAL2, HostReads, abs_residual, like,
                     local_device, loop_state, resolve_precond)
from .pcg import result
from .result import SolveResult


def _guard(bad, v):
    """v where not ``bad``, else 1 (the divisor of a guarded quotient)."""
    return torch.where(bad, torch.ones_like(v), v)


class _State(graphs.LoopState):
    def __init__(self, b, safe: bool):
        (self.b, self.x, self.r, self.rstar,
         self.p) = (torch.zeros_like(b) for _ in range(5))
        self.best_x = torch.zeros_like(b) if safe else None
        self.rho, self.rho_new = (torch.zeros_like(torch.dot(b, b))
                                  for _ in range(2))
        self.rt = torch.zeros(1, dtype=b.dtype, device=local_device(b))
        self.block = loops.Block(local_device(b), [("bicgstab", b.dtype)])
        self.reg = self.block["bicgstab"]


def _start(st: _State, A, M, stop_type: int) -> None:
    x, r = st.x, st.r
    torch.sub(st.b, A(x), out=r)
    st.rstar.copy_(r)
    st.p.copy_(r)
    st.rho.copy_(torch.dot(r, r))
    if st.best_x is not None:
        st.best_x.copy_(x)
    loops.control("bicgstab", INIT, torch.stack(
        (abs_residual(stop_type, r, M(r)), torch.dot(x, x))), st.reg)


def _half1(st: _State, A, M, stop_type: int) -> None:
    x, r, rstar, p, rho = st.x, st.r, st.rstar, st.p, st.rho
    phat = M(p)
    v = A(phat)
    sigma = torch.dot(rstar, v)
    bd1 = sigma.abs() <= SMALLREAL2
    alpha = torch.where(bd1, torch.zeros_like(sigma),
                        rho / _guard(bd1, sigma))
    sv = r - alpha * v
    shat = M(sv)
    tv = A(shat)
    tt = torch.dot(tv, tv)
    bd2 = tt <= SMALLREAL2
    omega = torch.where(bd2, torch.zeros_like(tt),
                        torch.dot(tv, sv) / _guard(bd2, tt))
    torch.add(x + alpha * phat, omega * shat, out=x)
    torch.sub(sv, omega * tv, out=r)
    rho_new = torch.dot(rstar, r)
    bd3 = (rho * omega).abs() <= SMALLREAL2
    beta = torch.where(
        bd3, torch.zeros_like(rho),
        (rho_new / _guard(rho.abs() <= SMALLREAL2, rho))
        * (alpha / _guard(bd2, omega)))
    torch.add(r, beta * (p - omega * v), out=p)
    st.rho_new.copy_(rho_new)
    step = alpha * phat + omega * shat
    z = M(r) if stop_type == StopType.REL_PRECRES else r
    loops.control("bicgstab", CHECK, torch.stack(
        (sigma, tt, abs_residual(stop_type, r, z), torch.dot(x, x),
         torch.dot(step, step))), st.reg)


def _recompute(st: _State, A, M, stop_type: int) -> None:
    r = st.r
    torch.sub(st.b, A(st.x), out=r)
    z = M(r) if stop_type == StopType.REL_PRECRES else r
    st.rt.copy_(loops.local(abs_residual(stop_type, r, z)).reshape(1))


def _half2(st: _State) -> None:
    loops.control("bicgstab", DECIDE, st.rt, st.reg)
    r = st.r
    # a restart resets the search space from the current residual
    restart = like(st.reg.flag(I.RESTART), r)
    torch.where(restart, r, st.p, out=st.p)
    torch.where(restart, r, st.rstar, out=st.rstar)
    torch.where(restart, torch.dot(r, r), st.rho_new, out=st.rho)
    if st.best_x is not None:
        torch.where(like(st.reg.flag(I.BETTER), r), st.x, st.best_x,
                    out=st.best_x)


def _tree(st: _State, A, M, stop_type: int):
    return [graphs.Piece(lambda: _start(st, A, M, stop_type)),
            graphs.While(st.reg, (
                graphs.Piece(lambda: _half1(st, A, M, stop_type)),
                graphs.If(st.reg, (
                    graphs.Piece(lambda: _recompute(st, A, M, stop_type)),)),
                graphs.Piece(lambda: _half2(st))))]


def bicgstab(A, b, x0=None, M=None, *, tol: float = 1e-6,
             abstol: float = 1e-18, maxit: int = 500,
             stop_type: int = int(StopType.REL_RES),
             safe: bool = False) -> SolveResult:
    """Solve A x = b with right-preconditioned BiCGstab."""
    M = resolve_precond(M)
    st, resident = loop_state("bicgstab", A, M, b, stop_type, safe,
                              lambda: _State(b, safe))
    st.b.copy_(b)
    if x0 is None:
        st.x.zero_()
    else:
        st.x.copy_(x0)
    st.block.upload({"bicgstab": loops.krylov_values(
        tol, abstol, maxit, stop_type, safe, MAX_STAG, MAX_RESTART)})
    host = HostReads(b.dtype)
    vals = graphs.run_loop(st, lambda: _tree(st, A, M, stop_type), host,
                           resident)["bicgstab"]
    return result(st, vals, host.count, resident)
