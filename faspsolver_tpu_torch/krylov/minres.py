"""Preconditioned MINRES (port of ``faspsolver_tpu/krylov/minres.py``).

Reference: base/src/KryPminres.c.  Preconditioned Lanczos with Givens
rotations for symmetric (possibly indefinite) systems with an SPD
preconditioner.  The residual is tracked by the |eta| recurrence and the
true residual is recomputed when convergence is claimed (the
reference's false-convergence guard).  The JAX package's
``lax.while_loop`` as a ``utils.graphs`` tree, built as PCG's is
(``krylov/pcg.py``): a start piece, then a While over half 1 (the
Lanczos step, the rotations — the Givens scalars stay 0-d tensors on the
device, the vectors rotate by copies into static tensors — and the
loop-control check over eta and the next Lanczos norm), an If around the
true residual of a claim (the ``lax.cond``) and half 2 (the control's
decide and the safe iterate).  Resident (one launch, one host read) on a
CUDA vector over capturable A and M; elsewhere the eager loop, one read
of the control's block per iteration plus one per claim
(``SolveResult.syncs``).
"""
from __future__ import annotations

import torch

from ..constants import MAX_RESTART, MAX_STAG, StopType
from ..utils import graphs, loops
from ..utils.loops import CHECK, DECIDE, INIT, F, I
from .common import (SMALLREAL, HostReads, abs_residual, like, local_device,
                     loop_state, resolve_precond)
from .result import SolveResult


def _safe(v):
    """v where v > SMALLREAL, else 1."""
    return torch.where(v > SMALLREAL, v, torch.ones_like(v))


class _State(graphs.LoopState):
    def __init__(self, b, safe: bool):
        (self.b, self.x, self.v_old, self.v, self.z, self.w_oold,
         self.w_old) = (torch.zeros_like(b) for _ in range(7))
        self.best_x = torch.zeros_like(b) if safe else None
        (self.beta, self.eta, self.c_old, self.c, self.s_old,
         self.s) = (torch.zeros_like(torch.dot(b, b)) for _ in range(6))
        self.rt = torch.zeros(2, dtype=b.dtype, device=local_device(b))
        self.block = loops.Block(local_device(b), [("minres", b.dtype)])
        self.reg = self.block["minres"]


def _start(st: _State, A, M, stop_type: int) -> None:
    x = st.x
    r0 = st.b - A(x)
    z0 = M(r0)
    beta0 = torch.sqrt(torch.clamp_min(torch.dot(r0, z0), 0.0))
    inp = torch.stack((abs_residual(stop_type, r0, z0), torch.dot(x, x),
                       beta0))
    st.v_old.zero_()
    torch.div(r0, _safe(beta0), out=st.v)
    torch.div(z0, _safe(beta0), out=st.z)
    st.beta.copy_(beta0)
    st.eta.copy_(beta0)
    for t, val in ((st.c_old, 1.0), (st.c, 1.0), (st.s_old, 0.0),
                   (st.s, 0.0)):
        t.fill_(val)
    st.w_oold.zero_()
    st.w_old.zero_()
    if st.best_x is not None:
        st.best_x.copy_(x)
    loops.control("minres", INIT, inp, st.reg)


def _half1(st: _State, A, M) -> None:
    z, v, v_old, beta, eta = st.z, st.v, st.v_old, st.beta, st.eta
    c_old, c, s_old, s = st.c_old, st.c, st.s_old, st.s
    # Lanczos step in the M-inner product
    Az = A(z)
    alpha = torch.dot(Az, z)
    r_new = Az - alpha * v - beta * v_old
    z_unnorm = M(r_new)
    beta_new = torch.sqrt(torch.clamp_min(torch.dot(r_new, z_unnorm), 0.0))

    # Givens rotations on the tridiagonal
    rho0 = c * alpha - c_old * s * beta
    rho1 = torch.sqrt(rho0 * rho0 + beta_new * beta_new)
    rho2 = s * alpha + c_old * c * beta
    rho3 = s_old * beta
    rho1s = _safe(rho1)
    c_new = rho0 / rho1s
    s_new = beta_new / rho1s
    w = (z - rho3 * st.w_oold - rho2 * st.w_old) / rho1s
    torch.add(st.x, c_new * eta * w, out=st.x)
    eta_new = -s_new * eta

    # the next step's vectors and scalars
    v_old.copy_(v)
    torch.div(r_new, _safe(beta_new), out=v)
    torch.div(z_unnorm, _safe(beta_new), out=z)
    beta.copy_(beta_new)
    c_old.copy_(c)
    c.copy_(c_new)
    s_old.copy_(s)
    s.copy_(s_new)
    st.w_oold.copy_(st.w_old)
    st.w_old.copy_(w)
    eta.copy_(eta_new)
    loops.control("minres", CHECK, torch.stack((eta_new, beta_new)), st.reg)


def _recompute(st: _State, A, M, stop_type: int) -> None:
    """The true-residual recheck of a claimed convergence."""
    rt = st.b - A(st.x)
    zt = M(rt) if stop_type == StopType.REL_PRECRES else rt
    st.rt.copy_(loops.local(torch.stack(
        (abs_residual(stop_type, rt, zt), torch.dot(st.x, st.x)))))


def _half2(st: _State) -> None:
    loops.control("minres", DECIDE, st.rt, st.reg)
    if st.best_x is not None:
        torch.where(like(st.reg.flag(I.BETTER), st.x), st.x, st.best_x,
                    out=st.best_x)


def _tree(st: _State, A, M, stop_type: int):
    return [graphs.Piece(lambda: _start(st, A, M, stop_type)),
            graphs.While(st.reg, (
                graphs.Piece(lambda: _half1(st, A, M)),
                graphs.If(st.reg, (
                    graphs.Piece(lambda: _recompute(st, A, M, stop_type)),)),
                graphs.Piece(lambda: _half2(st))))]


def minres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
           stop_type=int(StopType.REL_RES), safe: bool = False
           ) -> SolveResult:
    """Solve A x = b (A symmetric) with preconditioned MINRES."""
    M = resolve_precond(M)
    st, resident = loop_state("minres", A, M, b, stop_type, safe,
                              lambda: _State(b, safe))
    st.b.copy_(b)
    if x0 is None:
        st.x.zero_()
    else:
        st.x.copy_(x0)
    st.block.upload({"minres": loops.krylov_values(
        tol, abstol, maxit, stop_type, safe, MAX_STAG, MAX_RESTART)})
    host = HostReads(b.dtype)
    vals = graphs.run_loop(st, lambda: _tree(st, A, M, stop_type), host,
                           resident)["minres"]
    f, i = vals.f, vals.i
    converged = bool(f[F.RELRES] < f[F.TOL])
    x = st.x
    if st.best_x is not None and not converged and f[F.BEST] < f[F.RELRES]:
        x = st.best_x
    return SolveResult(x=x.clone() if resident else x, iters=int(i[I.IT]),
                       relres=float(f[F.RELRES]), converged=converged,
                       status=0, syncs=host.count, resident=resident)
