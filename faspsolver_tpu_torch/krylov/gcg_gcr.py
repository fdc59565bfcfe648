"""GCG and GCR: restarted full-orthogonalisation descent methods (port of
``faspsolver_tpu/krylov/gcg_gcr.py``).

Reference: base/src/KryPgcg.c (generalized CG) and KryPgcr.c
(generalized conjugate residual).  Both keep a window of previous
directions P and their images Q = A P as dense (R, n) tensors, R the
window (restart, at most maxit), Q orthogonalised by CGS2 as the GMRES
basis is.

The JAX package's two nested ``lax.while_loop`` as a ``utils.graphs``
tree (:func:`_tree`): a start piece (r0 = b - A x0 and the control's
``INIT``), then a While over the restart cycles whose body is

- the cycle's start: P and Q cleared (JAX makes them anew each cycle;
  a masked 0 times a stale non-finite row would be NaN) and the
  control's ``CYCLE`` (j = 0, the descent While's condition);
- a While over the descent steps: p = M r, q = A p, CGS2 of q against
  Q (p alongside against P), qn = |q|, p and q scaled by 1 / qn (0 on
  a breakdown), alpha = q.r, x += alpha p, r -= alpha q, P[j] = p,
  Q[j] = q (j a device index of the control's region), and the
  control's ``STEP`` over (qn, |r|): the breakdown and the residual's
  test, j + 1, the descent While's condition;
- the cycle's end: the true residual r = b - A x (z = M r under
  ``REL_PRECRES``) and the control's ``END`` over (absres, x.x): the
  count, relres, the restart While's condition.

All scalar work is the control's (``utils/loops.py``: on a CUDA vector
its kernel, on the CPU its plain twin ``loops.gcr_plain``), in b's
dtype, bit for bit the roundings of the JAX package's traced scalar
arithmetic.  On the card the CGS2 products run over the whole window,
masked to k < j: ``h = (Q @ q) * (k < j)``, JAX's own form
(``faspsolver_tpu/krylov/gcg_gcr.py:84-91``), which reads all R rows
whatever j is.  On the CPU (:func:`_on_host`) the step reads j on the
host and the tree computes as the host loop it replaced did, products
over the first j rows of P and Q, bit for bit.  On a CUDA vector, when
A and M declare themselves capturable, the tree is captured at the
first solve as one CUDA graph kept with A and M (per criterion and
window) and a solve is one launch and ONE host read
(``SolveResult.syncs`` = 1, ``resident``); so over DTensors of an NCCL
mesh.  Elsewhere — the CPU, a gloo mesh's DTensors, under
``utils.graphs.eager()``, a window of 0, or a module
that does not declare it — the same tree runs as the eager loop, which
reads the control's block once at the start, once after every descent
step and once after every cycle: ``syncs`` = 1 + steps + cycles.
"""
from __future__ import annotations

import torch

from ..constants import StopType
from ..utils import graphs, loops
from ..utils.loops import CYCLE, END, INIT, STEP, I
from .common import (HostReads, abs_residual, dot, like, local_device,
                     loop_state, put_row, replicated, resolve_precond,
                     zeros_rows)
from .result import SolveResult


def gcr(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
        restart=25, stop_type=int(StopType.REL_RES)) -> SolveResult:
    """Restarted GCR (reference: fasp_solver_dcsr_pgcr, KryPgcr.c)."""
    return _gcr(A, b, x0, M, tol, abstol, maxit, restart, stop_type)


def gcg(A, b, x0=None, M=None, *, tol=1e-6, abstol=1e-18, maxit=500,
        restart=None, stop_type=int(StopType.REL_RES)) -> SolveResult:
    """Generalized CG (reference: fasp_solver_dcsr_pgcg, KryPgcg.c).

    The reference stores ALL MaxIt directions (KryPgcg.c:70 allocates
    MaxIt*m: full-memory descent, its itparam restart ignored), so the
    default window is the full maxit, capped so the two (R, n) direction
    buffers stay within 2 GiB of device memory.  Pass ``restart`` for a
    smaller window.  It runs GCR's minimal-residual engine over the
    preconditioned residual directions; for SPD systems full-memory GCG
    coincides with CG in exact arithmetic."""
    if restart is None:
        budget = 2 << 30                   # bytes across P and Q buffers
        per_dir = 2 * b.shape[0] * b.element_size()
        restart = max(8, min(int(maxit), 1024, budget // max(per_dir, 1)))
    return _gcr(A, b, x0, M, tol, abstol, maxit, restart, stop_type)


def _on_host(b) -> bool:
    """Whether a solve of b takes j on the host (the CPU's arithmetic in
    the module docstring); on the card j stays on the device."""
    return local_device(b).type == "cpu"


class _State(graphs.LoopState):
    """The tensors one solve updates in place; when resident, kept with
    its program for the next solve over the same A and M: b, x, the
    residual r, the windows P and Q, the row index and the control's
    block (the restart cycles' region and the descent steps')."""

    def __init__(self, like_b, R: int):
        self.R = R
        self.b, self.x, self.r = (torch.zeros_like(like_b) for _ in range(3))
        self.P, self.Q = zeros_rows(R, like_b), zeros_rows(R, like_b)
        dev, dt = local_device(like_b), like_b.dtype
        self.host = _on_host(like_b)
        self.rows = torch.arange(R, device=dev)
        self.block = loops.Block(dev, [("gcr", dt), ("descent", dt)])
        self.reg, self.inner = self.block["gcr"], self.block["descent"]


def _control(st: _State, phase: int, inp=None) -> None:
    loops.gcr(phase, st.reg.f[:1] if inp is None else inp, st.reg,
              st.inner, st.R)


def _start(st: _State, A, M, stop_type: int) -> None:
    """r0 = b - A x0; the initial norms and the entry test."""
    x, r = st.x, st.r
    torch.sub(st.b, A(x), out=r)
    z = M(r) if stop_type == StopType.REL_PRECRES else None
    _control(st, INIT, torch.stack((abs_residual(stop_type, r, z),
                                    dot(x, x))))


def _cycle(st: _State) -> None:
    """A window's start: P and Q cleared, j = 0."""
    st.P.zero_()
    st.Q.zero_()
    _control(st, CYCLE)


def _step(st: _State, A, M) -> None:
    """Descent step j (a device index): p = M r, q = A p, CGS2 against
    the window, the normalised pair stored at row j, x and r updated;
    the control's test.  On the card the products run over the whole
    window, masked to k < j; on the CPU over the first j rows."""
    P, Q, r = st.P, st.Q, st.r
    j = st.reg.i[I.J:I.J + 1].long()
    p = M(r)
    q = A(p)
    if st.host:
        n = int(j)
        Pj, Qj, mask = P[:n], Q[:n], 1
    else:
        Pj, Qj = P, Q
        mask = like((st.rows < j).to(st.reg.dtype), r)
    h1 = replicated(Qj @ q) * mask
    p = p - h1 @ Pj
    q = q - h1 @ Qj
    h2 = replicated(Qj @ q) * mask
    p = p - h2 @ Pj
    q = q - h2 @ Qj
    qn = torch.sqrt(dot(q, q))
    bad = qn <= loops.SMALLREAL
    inv = torch.where(bad, torch.zeros_like(qn),
                      1.0 / torch.where(bad, torch.ones_like(qn), qn))
    p = p * inv
    q = q * inv
    alpha = dot(q, r)
    torch.add(st.x, alpha * p, out=st.x)
    torch.sub(r, alpha * q, out=r)
    put_row(P, j, p)
    put_row(Q, j, q)
    _control(st, STEP, torch.stack((qn, torch.sqrt(dot(r, r)))))


def _finish(st: _State, A, M, stop_type: int) -> None:
    """A window's end: the true residual and the restart test."""
    x, r = st.x, st.r
    torch.sub(st.b, A(x), out=r)
    z = M(r) if stop_type == StopType.REL_PRECRES else r
    _control(st, END, torch.stack((abs_residual(stop_type, r, z),
                                   dot(x, x))))


def _tree(st: _State, A, M, stop_type: int):
    """The restart cycles around the descent steps.  A descent While
    always runs its first step when the window is not empty (the cycles'
    condition implies it), so the eager loop reads nothing at its
    entry."""
    return [graphs.Piece(lambda: _start(st, A, M, stop_type)),
            graphs.While(st.reg, (
                graphs.Piece(lambda: _cycle(st)),
                graphs.While(st.inner, (
                    graphs.Piece(lambda: _step(st, A, M)),),
                    entry=st.R > 0),
                graphs.Piece(lambda: _finish(st, A, M, stop_type))))]


def _gcr(A, b, x0, M, tol, abstol, maxit, restart, stop_type):
    M = resolve_precond(M)
    R = int(min(restart, maxit))
    make = lambda: _State(b, R)  # noqa: E731
    # a window of 0 takes no descent step: nothing to capture
    st, resident = (loop_state("gcr", A, M, b, stop_type, False, make, (R,))
                    if R > 0 else (make(), False))
    st.b.copy_(b)
    if x0 is None:
        st.x.zero_()
    else:
        st.x.copy_(x0)
    st.block.upload({"gcr": loops.gcr_values(tol, abstol, maxit,
                                             stop_type)})
    host = HostReads(b.dtype)
    vals = graphs.run_loop(st, lambda: _tree(st, A, M, stop_type), host,
                           resident)["gcr"]
    f, i = vals.f, vals.i
    return SolveResult(x=st.x.clone() if resident else st.x,
                       iters=int(i[I.IT]), relres=float(f[loops.F.RELRES]),
                       converged=bool(f[loops.F.RELRES] < f[loops.F.TOL]),
                       status=0, syncs=host.count, resident=resident)
