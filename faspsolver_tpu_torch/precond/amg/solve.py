"""AMG as a standalone iterative solver: cycle until converged (port of
``faspsolver_tpu/precond/amg/solve.py``).

Reference: fasp_amg_solve (PreMGSolve.c:49): while iter < maxit
{mgcycle; r = b - Ax; relres check}; the AMLI / nonlinear AMLI variants
(:142, :230) by the hierarchy's cycle type; full-MG solve
(fasp_solver_famg, SolFAMG.c:41).

The loop is the JAX package's one jitted ``lax.while_loop`` as a tree of
``utils.graphs`` (:func:`_tree`): a start piece (FAMG's FMG sweep, the
initial residual, the control's ``INIT``), then a While whose body is a
cycle of the hierarchy's type, the true residual and the control's
``CHECK`` (``utils.loops``, entry point ``mg`` in AMG's form: a NaN
relres runs on to maxit, as ``~(relres < tol)`` does in JAX).  The
relres is computed by torch ops in the piece; the control only tests
and counts.

On a CUDA vector, when the hierarchy declares itself capturable, the
tree is captured at the first solve as one CUDA graph kept with the
hierarchy (per cycle type, FAMG flag, and b's dtype, length and device),
and a solve is one launch and ONE host read (``SolveResult.syncs`` = 1,
``resident``).  Elsewhere — the CPU, under ``utils.graphs.eager()``, a
hierarchy that is not capturable — the same tree runs as the eager
loop, which reads the control's block once per cycle and once at entry
(``syncs`` = iterations + 1).
"""
from __future__ import annotations

import torch

from ...krylov.common import HostReads, local_device
from ...krylov.result import SolveResult
from ...utils import graphs, loops
from ...utils.loops import CHECK, INIT, F, I
from .cycles import cycle_fn, fmg_cycle
from .hierarchy import AMGHierarchy


class _State(graphs.LoopState):
    """The tensors one solve updates in place; when resident, kept with
    the hierarchy for its next solve: b, x, the clamped |b| and the
    control's block."""

    def __init__(self, like_b):
        self.b, self.x = torch.zeros_like(like_b), torch.zeros_like(like_b)
        dev, dt = local_device(like_b), like_b.dtype
        self.normb = torch.zeros((), dtype=dt, device=dev)
        self.block = loops.Block(dev, [("mg", dt)])
        self.reg = self.block["mg"]


def _check(st: _State, hier: AMGHierarchy, phase: int) -> None:
    """r = b - A x, relres = |r| / |b|, the control's test."""
    r = st.b - hier.levels[0].A(st.x)
    loops.control("mg", phase, (torch.sqrt(torch.dot(r, r))
                                / st.normb).reshape(1), st.reg)


def _start(st: _State, hier: AMGHierarchy, famg: bool) -> None:
    if famg:
        st.x.copy_(fmg_cycle(hier, st.b))
    st.normb.copy_(torch.clamp_min(torch.sqrt(torch.dot(st.b, st.b)),
                                   1e-20))
    _check(st, hier, INIT)


def _body(st: _State, hier: AMGHierarchy) -> None:
    st.x.copy_(cycle_fn(hier.cycle_type)(hier, st.b, st.x))
    _check(st, hier, CHECK)


def _tree(st: _State, hier: AMGHierarchy, famg: bool):
    return [graphs.Piece(lambda: _start(st, hier, famg)),
            graphs.While(st.reg, (graphs.Piece(lambda: _body(st, hier)),))]


def _solve(hier: AMGHierarchy, b: torch.Tensor, x0, tol, maxit,
           famg: bool) -> SolveResult:
    """The loop over ``hier`` (FAMG: its FMG sweep first, which sets x),
    resident where it can be."""
    resident = graphs.active(b) and graphs.capturable(hier)
    make = lambda: _State(b)  # noqa: E731
    if resident:
        key = (b.dtype, b.shape[0], b.device, graphs.fingerprint(hier))
        st = graphs.cached((hier,), ("amg_solve", hier.cycle_type,
                                     bool(famg)), key, make)
    else:
        st = make()
    st.b.copy_(b)
    if x0 is None:
        st.x.zero_()
    else:
        st.x.copy_(x0)
    st.block.upload({"mg": loops.mg_values(tol, maxit, "amg")})
    host = HostReads(b.dtype)
    vals = graphs.run_loop(st, lambda: _tree(st, hier, famg), host,
                           resident)["mg"]
    f, i = vals.f, vals.i
    return SolveResult(x=st.x.clone() if resident else st.x,
                       iters=int(i[I.IT]), relres=float(f[F.RELRES]),
                       converged=bool(f[F.RELRES] < f[F.TOL]), status=0,
                       syncs=host.count, resident=resident)


def amg_solve(hier: AMGHierarchy, b: torch.Tensor, x0=None, *,
              tol: float = 1e-6, maxit: int = 20) -> SolveResult:
    """Iterate multigrid cycles of the hierarchy's cycle type to
    tolerance ||b - A x|| / ||b|| < tol."""
    return _solve(hier, b, x0, tol, maxit, famg=False)


def famg_solve(hier: AMGHierarchy, b: torch.Tensor, x0=None, *,
               tol: float = 1e-6, maxit: int = 20) -> SolveResult:
    """Full-multigrid solve: one FMG sweep, then cycles to tolerance
    (reference: fasp_solver_famg, SolFAMG.c:41).  ``x0`` is not read:
    the FMG sweep builds the first iterate, as in the reference.  The
    sweep counts as an iteration and takes one of ``maxit`` (at least one
    cycle is allowed), as in the JAX package."""
    res = _solve(hier, b, None, tol, max(maxit - 1, 1), famg=True)
    res.iters += 1
    return res
