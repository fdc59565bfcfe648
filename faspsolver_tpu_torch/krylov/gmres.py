"""GMRES family: restarted, adaptive-restart and flexible, right-
preconditioned (port of ``faspsolver_tpu/krylov/gmres.py``).

Reference: base/src/KryPgmres.c (fixed restart), KryPvgmres.c (adaptive
restart, the cr_max/cr_min rule at :79-80, :200-210), KryPvfgmres.c
(flexible).  One core serves all three.  The Krylov basis is a dense
(R + 1, n) tensor, R the window (restart, at most maxit), orthogonalised
by CGS2 (classical Gram-Schmidt twice) as masked full-window products:
``h = (V @ w) * (k <= j)``, ``w -= h @ V``, twice — the JAX package's
design, which keeps every shape static (up to twice the bytes of products
over the first j + 1 rows).

The JAX package's two nested ``lax.while_loop`` as a ``utils.graphs``
tree (:func:`_tree`): a start piece (r0 = b - A x0, the initial norms and
the control's ``INIT``), then a While over the restart cycles whose body
is

- the cycle's start: the control's ``CYCLE`` (it clears the Hessenberg
  matrix H, g, the rotations and y, sets g[0] = |r| and the scale of
  V[0]), the per-cycle clear of V (and Z) and V[0] = r / |r|;
- a While over the Arnoldi steps: v = V[j] with j a device index of the
  control's region, z = M v, w = A z (Z[j] = z when flexible), the masked
  CGS2, hn = |w|, V[j + 1] = w / hn (0 on a happy breakdown) and the
  control's ``ARNOLDI`` over the column (h, hn): the Givens rotations,
  the least-squares residual's test and the Arnoldi While's condition;
- the cycle's end: the control's ``SOLVE`` (y from the j x j triangular
  system), x += M(y @ V[:R]) (x += y @ Z when flexible), the true
  residual, the control's ``RESTART`` (relres, the adaptive restart rule,
  stagnation with status -42, the restart While's condition) and the
  safe iterate as a masked update.

All scalar work is the control's (``utils/loops.py``: on a CUDA vector
its kernel, on the CPU its plain twin), in b's dtype, bit for bit the
roundings of the JAX package's traced scalar arithmetic.  On the CPU
(:func:`_on_host`) the Arnoldi step reads j on the host and the tree
computes as the host loop it replaced did: CGS2 over the first j + 1
rows of V, y by LAPACK's triangular solve over the j x j system and x
updated over those j rows, bit for bit.  An f32 solve at its floor
turns on the last bit of each such sum (the refined harness's fallback
on jump_2d at a contrast of 1e6 takes another branch under the masked
products), and the CPU is where the port is held to the JAX package.
On a CUDA vector, when A and M declare themselves capturable, the tree
is captured at the first solve as one CUDA graph kept with A and M (per
criterion, ``safe``, R and variant) and a solve is one launch and ONE
host read (``SolveResult.syncs`` = 1, ``resident``); so over DTensors
of an NCCL mesh.  Elsewhere — the CPU, a gloo mesh's DTensors, under
``utils.graphs.eager()``, or a module that does not declare it — the
same tree runs as the eager loop, which reads the control's block once
at the start, once after every Arnoldi step and once after every cycle:
``syncs`` = 1 + iterations + cycles.
"""
from __future__ import annotations

import torch

from ..constants import StopType
from ..utils import graphs, loops
from ..utils.loops import ARNOLDI, CYCLE, INIT, RESTART, SOLVE, F, I
from .common import (HostReads, abs_residual, dot, like, local_device,
                     loop_state, put_row, replicated, resolve_precond,
                     take_row, zeros_rows)
from .result import SolveResult


def gmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
          restart=25, stop_type=int(StopType.REL_RES),
          safe: bool = False) -> SolveResult:
    """Restarted right-preconditioned GMRES (reference:
    fasp_solver_dcsr_pgmres)."""
    return _gmres(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                  adaptive=False, flexible=False, safe=safe)


def vgmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
           restart=25, stop_type=int(StopType.REL_RES),
           safe: bool = False) -> SolveResult:
    """Adaptive-restart GMRES (reference: fasp_solver_dcsr_pvgmres)."""
    return _gmres(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                  adaptive=True, flexible=False, safe=safe)


def vfgmres(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
            restart=25, stop_type=int(StopType.REL_RES),
            safe: bool = False) -> SolveResult:
    """Flexible GMRES with variable restart (reference:
    fasp_solver_dcsr_pvfgmres).  The preconditioner may change from step
    to step, so the preconditioned basis Z is stored."""
    return _gmres(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
                  adaptive=True, flexible=True, safe=safe)


def _on_host(b) -> bool:
    """Whether a solve of b takes j on the host (the CPU's arithmetic in
    the module docstring); on the card j stays on the device."""
    return local_device(b).type == "cpu"


class _State(graphs.LoopState):
    """The tensors one solve updates in place; when resident, kept with
    its program for the next solve over the same A and M: b, x, the
    residual r, the basis V (and Z), the safe iterate, the control's
    block (the restart cycles' region and the Arnoldi steps') and the
    window's arrays (``loops.gmres_arrays``)."""

    def __init__(self, like_b, R: int, flexible: bool, safe: bool):
        self.R = R
        self.b, self.x, self.r = (torch.zeros_like(like_b) for _ in range(3))
        self.best_x = torch.zeros_like(like_b) if safe else None
        self.V = zeros_rows(R + 1, like_b)
        self.Z = zeros_rows(R, like_b) if flexible else None
        dev, dt = local_device(like_b), like_b.dtype
        self.host = _on_host(like_b)
        self.rows = torch.arange(R + 1, device=dev)
        self.arr = torch.zeros(loops.gmres_arrays(R), dtype=dt, device=dev)
        self.block = loops.Block(dev, [("gmres", dt), ("arnoldi", dt)])
        self.reg, self.inner = self.block["gmres"], self.block["arnoldi"]


def _control(st: _State, phase: int, inp=None) -> None:
    loops.gmres(phase, st.arr[:1] if inp is None else inp, st.reg, st.inner,
                st.arr, st.R)


def _start(st: _State, A, M, stop_type: int) -> None:
    """r0 = b - A x0; the initial norms."""
    x, r = st.x, st.r
    torch.sub(st.b, A(x), out=r)
    z = M(r) if stop_type == StopType.REL_PRECRES else None
    if st.best_x is not None:
        st.best_x.copy_(x)
    _control(st, INIT, torch.stack((abs_residual(stop_type, r, z),
                                    dot(x, x), torch.sqrt(dot(r, r)))))


def _cycle(st: _State) -> None:
    """A window's start: its arrays cleared, V (and Z) zeroed, V[0] =
    r / |r|."""
    _control(st, CYCLE)
    st.V.zero_()
    if st.Z is not None:
        st.Z.zero_()
    st.V[0] = st.r * like(st.reg.f[F.SCALE], st.r)


def _arnoldi(st: _State, A, M) -> None:
    """Arnoldi step j (a device index): z = M V[j], w = A z, CGS2,
    V[j + 1] = w / |w|; the control's rotations.  On the card the
    products run over the whole window, masked to k <= j; on the CPU over
    the first j + 1 rows."""
    V, b = st.V, st.b
    j = st.reg.i[I.J:I.J + 1].long()
    z = M(take_row(V, j, b))
    w = A(z)
    if st.Z is not None:
        put_row(st.Z, j, z)
    if st.host:
        Vj, mask = V[:int(j) + 1], 1
    else:
        Vj, mask = V, like((st.rows <= j).to(st.arr.dtype), b)
    h1 = replicated(Vj @ w) * mask
    w = w - h1 @ Vj
    h2 = replicated(Vj @ w) * mask
    w = w - h2 @ Vj
    hn = torch.sqrt(dot(w, w))
    happy = hn <= loops.HAPPY
    inv = torch.where(happy, torch.zeros_like(hn),
                      1.0 / torch.where(happy, torch.ones_like(hn), hn))
    put_row(V, j + 1, w * inv)
    h = torch.nn.functional.pad(h1 + h2, (0, st.R + 1 - Vj.shape[0]))
    _control(st, ARNOLDI, torch.cat([h, hn.reshape(1)]))


def _finish(st: _State, A, M, stop_type: int) -> None:
    """A window's end: y (on the card the control's back-substitution,
    on the CPU LAPACK's), the update of x, the true residual (it doubles
    as the safeguard's recheck), the restart rules, the safe iterate."""
    if st.host:
        j = int(st.reg.i[I.J])
        H, g, *_ = loops.gmres_views(st.arr, st.R)
        if j:
            y = like(torch.linalg.solve_triangular(
                H[:j, :j].contiguous(), g[:j, None], upper=True)[:, 0], st.b)
            dx = y @ st.Z[:j] if st.Z is not None else M(y @ st.V[:j])
            torch.add(st.x, dx, out=st.x)
    else:
        _control(st, SOLVE)
        y = like(st.arr[st.arr.numel() - st.R:], st.b)
        dx = y @ st.Z if st.Z is not None else M(y @ st.V[:st.R])
        torch.add(st.x, dx, out=st.x)
    x, r = st.x, st.r
    torch.sub(st.b, A(x), out=r)
    z = M(r) if stop_type == StopType.REL_PRECRES else r
    _control(st, RESTART, torch.stack((torch.sqrt(dot(r, r)),
                                       abs_residual(stop_type, r, z),
                                       dot(x, x))))
    if st.best_x is not None:
        torch.where(like(st.reg.flag(I.BETTER), x), x, st.best_x,
                    out=st.best_x)


def _tree(st: _State, A, M, stop_type: int):
    """The restart cycles around the Arnoldi steps.  An Arnoldi While
    always runs its first step (the cycles' condition implies it for any
    window), so the eager loop reads nothing at its entry."""
    return [graphs.Piece(lambda: _start(st, A, M, stop_type)),
            graphs.While(st.reg, (
                graphs.Piece(lambda: _cycle(st)),
                graphs.While(st.inner, (
                    graphs.Piece(lambda: _arnoldi(st, A, M)),),
                    entry=st.R > 0),
                graphs.Piece(lambda: _finish(st, A, M, stop_type))))]


def _gmres(A, b, x0, M, tol, abstol, maxit, restart, stop_type,
           adaptive, flexible, safe):
    M = resolve_precond(M)
    R = int(min(restart, maxit))
    make = lambda: _State(b, R, flexible, safe)  # noqa: E731
    # a window of 0 takes no Arnoldi step: nothing to capture
    st, resident = (loop_state("gmres", A, M, b, stop_type, safe, make,
                               (R, bool(adaptive), bool(flexible)))
                    if R > 0 else (make(), False))
    st.b.copy_(b)
    if x0 is None:
        st.x.zero_()
    else:
        st.x.copy_(x0)
    st.block.upload({"gmres": loops.gmres_values(
        tol, abstol, maxit, stop_type, safe, adaptive)})
    host = HostReads(b.dtype)
    vals = graphs.run_loop(st, lambda: _tree(st, A, M, stop_type), host,
                           resident)["gmres"]
    f, i = vals.f, vals.i
    converged = bool(f[F.RELRES] < f[F.TOL])
    x = st.x
    if st.best_x is not None and not converged and f[F.BEST] < f[F.RELRES]:
        x = st.best_x
    return SolveResult(x=x.clone() if resident else x, iters=int(i[I.IT]),
                       relres=float(f[F.RELRES]), converged=converged,
                       status=int(i[I.STATUS]), syncs=host.count,
                       resident=resident)
