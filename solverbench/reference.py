"""The plain reference: the benchmark's own products with the matrix it
generated, in plain PyTorch, and a plain conjugate-gradient solve for the
lower-precision control.  It imports nothing of the program under test
and takes nothing the program made: the CSR arrays come from
``problems/``, the right-hand sides from ``rhs.py``.

The matrix is held as a padded ELL table (rows x the widest row), so one
product is a gather, a multiply and a sum over each row, in the dtype the
table was made in: float64 for the checks, float32 or bfloat16 for the
controls."""
from __future__ import annotations

import numpy as np
import torch


class Ell:
    """A CSR matrix as an ELL table on ``device`` in ``dtype``; padding
    entries hold column 0 and value 0."""

    def __init__(self, problem, device, dtype=torch.float64):
        n = problem.nrows
        counts = np.diff(problem.indptr)
        width = int(counts.max()) if n else 0
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        slot = np.arange(problem.nnz, dtype=np.int64) - np.repeat(
            problem.indptr[:-1], counts)
        cols = np.zeros((n, width), dtype=np.int64)
        vals = np.zeros((n, width), dtype=np.float64)
        cols[rows, slot] = problem.indices
        vals[rows, slot] = problem.data
        self.n, self.dtype = n, dtype
        self.cols = torch.as_tensor(cols, device=device)
        self.vals = torch.as_tensor(vals, device=device).to(dtype)

    def to(self, dtype) -> "Ell":
        out = object.__new__(Ell)
        out.n, out.dtype, out.cols = self.n, dtype, self.cols
        out.vals = self.vals.to(dtype)
        return out

    def matvec(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """A x in the table's dtype (``x`` is cast to it); ``rows`` a
        slice of rows, to work in blocks."""
        rows = rows or slice(0, self.n)
        x = x.to(self.dtype)
        return (self.vals[rows] * x[self.cols[rows]]).sum(dim=1)

    def abs_matvec(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """|A| |x|: the scale of each row's sum, for a componentwise
        error."""
        rows = rows or slice(0, self.n)
        x = x.to(self.dtype).abs()
        return (self.vals[rows].abs() * x[self.cols[rows]]).sum(dim=1)


BLOCK = 1 << 18                 # rows per block of a checking product


def relres(A: Ell, x: torch.Tensor, b: torch.Tensor) -> float:
    """||b - A x|| / ||b|| in float64, in blocks of rows."""
    x, b = x.to(torch.float64), b.to(torch.float64)
    ss = 0.0
    for lo in range(0, A.n, BLOCK):
        s = slice(lo, min(lo + BLOCK, A.n))
        ss += float(torch.sum((b[s] - A.matvec(x, s)) ** 2))
    return float(np.sqrt(ss) / max(float(torch.linalg.vector_norm(b)),
                                   1e-300))


def op_error(A: Ell, x: torch.Tensor, y: torch.Tensor) -> float:
    """max_i |y_i - (A x)_i| / (|A| |x|)_i: how far an operator's output
    ``y`` for the input ``x`` lies from the exact product, as a share of
    each row's scale (rows of scale 0 must give 0 exactly).  ``A`` is the
    float64 table; ``x`` the input exactly as the operator got it."""
    x, y = x.to(torch.float64), y.to(torch.float64)
    worst = 0.0
    for lo in range(0, A.n, BLOCK):
        s = slice(lo, min(lo + BLOCK, A.n))
        scale = A.abs_matvec(x, s)
        err = (y[s] - A.matvec(x, s)).abs()
        zero = scale == 0
        if bool(torch.any(err[zero] != 0)):
            return float("inf")
        worst = max(worst, float(torch.max(
            err[~zero] / scale[~zero]))) if bool(torch.any(~zero)) else worst
    return worst


def cg(A: Ell, b: torch.Tensor, tol: float, maxit: int,
       check_every: int = 50) -> torch.Tensor:
    """Plain unpreconditioned conjugate gradients in ``A``'s dtype from
    x = 0, until the recursive residual's norm falls under tol ||b||
    (read every ``check_every`` steps) or ``maxit`` steps ran."""
    b = b.to(A.dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    stop = (tol * torch.linalg.vector_norm(b)) ** 2
    for k in range(maxit):
        Ap = A.matvec(p)
        alpha = rr / torch.dot(p, Ap)
        x += alpha * p
        r -= alpha * Ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        if (k + 1) % check_every == 0 and bool(rr <= stop):
            break
    return x
