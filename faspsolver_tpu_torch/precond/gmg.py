"""Geometric multigrid for Poisson on structured grids, matrix-free (port
of ``faspsolver_tpu/precond/gmg.py``).

Reference: base/src/SolGMGPoisson.c (fasp_poisson_gmg{1,2,3}d :48, :172,
:308, full-MG fgmg* :442-650, CG-accelerated gmgcg* :754-959) with the
stencils of base/src/PreGMG.inl (residual :34-:180, restriction2d5pt
:387, interpolation2d5pt :495, red-black GS gs2d_2color :604).

Grids are dense (n+1)^d tensors that carry the zero Dirichlet boundary;
the stencils are shift-adds of slices and ``torch.roll``; red-black
Gauss-Seidel uses checkerboard masks, built once per grid shape and
device (not once per sweep).  The V-cycle recursion runs eagerly; the
solve loops (``lax.while_loop`` in the JAX package) are Python loops that
read their stopping test to the host once per iteration through
:class:`~..krylov.common.HostReads`, as the Krylov loops do
(``SolveResult.syncs`` counts the reads).  Plain PyTorch: the JAX
package computes these outside any Pallas kernel.

Every entry point takes ``device``: ``None`` keeps a tensor ``f`` where
it lies and puts a host array on the CUDA device (raising where there is
none); ``"cpu"`` asks for the CPU.

Problem convention (reference testgmg.c): -Δu = f on the unit interval /
square / cube, homogeneous Dirichlet, mesh width h = 1/n, unknowns at the
interior points i = 1..n-1; n is a power of two (the restriction maps
n + 1 points to n/2 + 1).
"""
from __future__ import annotations

import torch

from .. import default_device
from ..krylov.common import HostReads
from ..krylov.result import SolveResult

_MASKS = {}


def _masks(shape, device):
    """(interior, parity) of a grid shape: the interior points and the
    parity (sum of indices mod 2) of every point."""
    key = (tuple(shape), str(device))
    if key not in _MASKS:
        idx = torch.meshgrid(*[torch.arange(s, device=device)
                               for s in shape], indexing="ij")
        interior = torch.ones(shape, dtype=torch.bool, device=device)
        for ax, i in enumerate(idx):
            interior &= (i > 0) & (i < shape[ax] - 1)
        _MASKS[key] = (interior, sum(idx) % 2)
    return _MASKS[key]


def _tensor(f, device) -> torch.Tensor:
    """f on ``device``.  ``None``: a tensor stays where it lies, a host
    array goes to the CUDA device (an error where there is none;
    ``device="cpu"`` asks for the CPU), as in the drivers."""
    if isinstance(f, torch.Tensor):
        return f if device is None else f.to(device)
    return torch.as_tensor(f, device=device if device is not None
                           else default_device())


# ---------------------------------------------------------------------------
# stencils
# ---------------------------------------------------------------------------

def _laplace_2d(u, h2):
    """5-point -Δ applied to the interior (zero Dirichlet halo)."""
    return (4.0 * u[1:-1, 1:-1] - u[:-2, 1:-1] - u[2:, 1:-1]
            - u[1:-1, :-2] - u[1:-1, 2:]) / h2


def _residual_2d(u, f, h2):
    r = torch.zeros_like(u)
    r[1:-1, 1:-1] = f[1:-1, 1:-1] - _laplace_2d(u, h2)
    return r


def _rbgs_2d(u, f, h2, sweeps: int, parity_first: int = 0):
    """Red-black Gauss-Seidel (reference: gs2d_2color, PreGMG.inl:604)."""
    interior, parity = _masks(u.shape, u.device)
    for s in range(2 * sweeps):
        color = parity == ((parity_first + s) % 2)
        nb = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
              + torch.roll(u, 1, 1) + torch.roll(u, -1, 1))
        unew = (h2 * f + nb) / 4.0
        u = torch.where(interior & color, unew, u)
    return u


def _restrict_2d(r):
    """Full-weighting restriction to the half grid."""
    c = r[2:-2:2, 2:-2:2] * 0.25 \
        + (r[1:-3:2, 2:-2:2] + r[3:-1:2, 2:-2:2]
           + r[2:-2:2, 1:-3:2] + r[2:-2:2, 3:-1:2]) * 0.125 \
        + (r[1:-3:2, 1:-3:2] + r[3:-1:2, 1:-3:2]
           + r[1:-3:2, 3:-1:2] + r[3:-1:2, 3:-1:2]) * 0.0625
    out = r.new_zeros((r.shape[0] // 2 + 1, r.shape[1] // 2 + 1))
    out[1:-1, 1:-1] = c
    return out


def _prolong_2d(e, shape):
    """Bilinear interpolation to the fine grid."""
    out = e.new_zeros(shape)
    # even-even fine points coincide with coarse points
    out[::2, ::2] = e
    # odd rows / cols by averaging
    out[1:-1:2, ::2] = 0.5 * (out[:-2:2, ::2] + out[2::2, ::2])
    out[:, 1:-1:2] = 0.5 * (out[:, :-2:2] + out[:, 2::2])
    # re-zero the boundary
    out[0, :] = 0.0
    out[-1, :] = 0.0
    out[:, 0] = 0.0
    out[:, -1] = 0.0
    return out


def _laplace_3d(u, h2):
    return (6.0 * u[1:-1, 1:-1, 1:-1]
            - u[:-2, 1:-1, 1:-1] - u[2:, 1:-1, 1:-1]
            - u[1:-1, :-2, 1:-1] - u[1:-1, 2:, 1:-1]
            - u[1:-1, 1:-1, :-2] - u[1:-1, 1:-1, 2:]) / h2


def _residual_3d(u, f, h2):
    r = torch.zeros_like(u)
    r[1:-1, 1:-1, 1:-1] = f[1:-1, 1:-1, 1:-1] - _laplace_3d(u, h2)
    return r


def _rbgs_3d(u, f, h2, sweeps: int):
    interior, parity = _masks(u.shape, u.device)
    for s in range(2 * sweeps):
        color = parity == (s % 2)
        nb = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
              + torch.roll(u, 1, 1) + torch.roll(u, -1, 1)
              + torch.roll(u, 1, 2) + torch.roll(u, -1, 2))
        unew = (h2 * f + nb) / 6.0
        u = torch.where(interior & color, unew, u)
    return u


def _restrict_3d(r):
    """Trilinear full weighting by separable averages, then sampling."""
    s = r
    for ax in range(3):
        s = 0.25 * (2 * s + torch.roll(s, 1, ax) + torch.roll(s, -1, ax))
    out = r.new_zeros(tuple(d // 2 + 1 for d in r.shape))
    out[1:-1, 1:-1, 1:-1] = s[2:-2:2, 2:-2:2, 2:-2:2]
    return out


def _prolong_3d(e, shape):
    out = e.new_zeros(shape)
    out[::2, ::2, ::2] = e
    out[1:-1:2, ::2, ::2] = 0.5 * (out[:-2:2, ::2, ::2] + out[2::2, ::2, ::2])
    out[:, 1:-1:2, ::2] = 0.5 * (out[:, :-2:2, ::2] + out[:, 2::2, ::2])
    out[:, :, 1:-1:2] = 0.5 * (out[:, :, :-2:2] + out[:, :, 2::2])
    for ax in range(3):
        out.select(ax, 0).zero_()
        out.select(ax, -1).zero_()
    return out


_OPS = {2: (_residual_2d, _rbgs_2d, _restrict_2d, _prolong_2d),
        3: (_residual_3d, _rbgs_3d, _restrict_3d, _prolong_3d)}


# ---------------------------------------------------------------------------
# V-cycle and solve loops
# ---------------------------------------------------------------------------

def _vcycle(u, f, n, dim, presm=2, postsm=2, min_n=4):
    h2 = 1.0 / (n * n)
    res, smoothf, restr, prol = _OPS[dim]
    if n <= min_n:
        return smoothf(u, f, h2, 20)
    u = smoothf(u, f, h2, presm)
    rc = restr(res(u, f, h2))
    ec = _vcycle(torch.zeros_like(rc), rc, n // 2, dim, presm, postsm,
                 min_n)
    u = u + prol(ec, u.shape)
    return smoothf(u, f, h2, postsm)


def _norm(v):
    return torch.sqrt(torch.sum(v * v))


def _gmg_solve(f, n, dim, tol, maxit, full_first: bool) -> SolveResult:
    """Shared solve loop (reference: fasp_poisson_gmg2d,
    SolGMGPoisson.c:172; full-MG first sweep per fgmg*, :442-650)."""
    h2 = 1.0 / (n * n)
    res, _, restr, prol = _OPS[dim]
    host = HostReads(f.dtype)
    u = torch.zeros_like(f)
    if full_first:
        # full multigrid initial guess: restrict f down, solve upward
        fs = [f]
        nn_ = n
        while nn_ > 4:
            fs.append(restr(fs[-1]))
            nn_ //= 2
        u = torch.zeros_like(fs[-1])
        for lvl in range(len(fs) - 1, -1, -1):
            if lvl < len(fs) - 1:
                u = prol(u, fs[lvl].shape)
            u = _vcycle(u, fs[lvl], n >> lvl, dim)

    normb = torch.clamp(_norm(f), min=1e-30)
    tol = host.t(tol)
    it = 0
    relres, = host(_norm(res(u, f, h2)) / normb)
    while relres >= tol and it < maxit:
        u = _vcycle(u, f, n, dim)
        relres, = host(_norm(res(u, f, h2)) / normb)
        it += 1
    return SolveResult(x=u, iters=it, relres=float(relres),
                       converged=bool(relres < tol), status=0,
                       syncs=host.count)


def poisson_gmg_2d(f, n: int, *, tol: float = 1e-8, maxit: int = 50,
                   full_first: bool = False, device=None
                   ) -> SolveResult:
    """Solve -Δu = f on the unit square, u = 0 on the boundary, on the
    (n+1) x (n+1) grid including the boundary (reference:
    fasp_poisson_gmg2d)."""
    f = _tensor(f, device)
    assert f.shape == (n + 1, n + 1)
    return _gmg_solve(f, n, 2, tol, maxit, full_first)


def poisson_gmg_3d(f, n: int, *, tol: float = 1e-8, maxit: int = 50,
                   full_first: bool = False, device=None
                   ) -> SolveResult:
    """Solve -Δu = f on the unit cube (reference: fasp_poisson_gmg3d)."""
    f = _tensor(f, device)
    assert f.shape == (n + 1, n + 1, n + 1)
    return _gmg_solve(f, n, 3, tol, maxit, full_first)


def poisson_gmg_1d(f, n: int, *, tol: float = 1e-8, maxit: int = 50,
                   device=None) -> SolveResult:
    """1-D Poisson (reference: fasp_poisson_gmg1d) by a direct solve of
    the (n-1) x (n-1) tridiagonal system on the device, as in the JAX
    package: one iteration, one host read."""
    f = _tensor(f, device)
    h2 = 1.0 / (n * n)
    opts = dict(dtype=f.dtype, device=f.device)
    A = (torch.diag(torch.full((n - 1,), 2.0 / h2, **opts))
         + torch.diag(torch.full((n - 2,), -1.0 / h2, **opts), 1)
         + torch.diag(torch.full((n - 2,), -1.0 / h2, **opts), -1))
    u_in = torch.linalg.solve(A, f[1:-1])
    u = torch.zeros_like(f)
    u[1:-1] = u_in
    host = HostReads(f.dtype)
    relres, = host(_norm(f[1:-1] - A @ u_in)
                   / torch.clamp(_norm(f), min=1e-30))
    return SolveResult(x=u, iters=1, relres=float(relres),
                       converged=bool(relres < host.t(tol)), status=0,
                       syncs=host.count)


# ---------------------------------------------------------------------------
# CG-accelerated GMG (reference: gmgcg1/2/3d, SolGMGPoisson.c:754-959)
# ---------------------------------------------------------------------------

def _gmgcg(f, n, dim, tol, maxit) -> SolveResult:
    """CG on the grid-function Laplacian, preconditioned by one GMG
    V-cycle per iteration."""
    h2 = 1.0 / (n * n)
    res = _OPS[dim][0]
    host = HostReads(f.dtype)

    def Aop(u):
        # full-grid operator: -Δu on the interior, 0 on the boundary ring
        return -res(u, torch.zeros_like(u), h2)

    def Mop(r):
        return _vcycle(torch.zeros_like(r), r, n, dim)

    normb = torch.clamp(_norm(f), min=1e-30)
    u = torch.zeros_like(f)
    r = f - Aop(u)
    z = Mop(r)
    p = z
    rz = torch.sum(r * z)
    tol = host.t(tol)
    it = 0
    relres, = host(_norm(r) / normb)
    while relres >= tol and it < maxit:
        Ap = Aop(p)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) > 1e-30, denom, 1.0)
        u = u + alpha * p
        r = r - alpha * Ap
        z = Mop(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) > 1e-30, rz, 1.0)
        p = z + beta * p
        rz = rz_new
        relres, = host(_norm(r) / normb)
        it += 1
    return SolveResult(x=u, iters=it, relres=float(relres),
                       converged=bool(relres < tol), status=0,
                       syncs=host.count)


def poisson_gmgcg_2d(f, n: int, *, tol: float = 1e-8, maxit: int = 100,
                     device=None) -> SolveResult:
    """GMG-preconditioned CG for 2-D Poisson (reference:
    fasp_poisson_gmgcg2d, SolGMGPoisson.c:754)."""
    f = _tensor(f, device)
    assert f.shape == (n + 1, n + 1)
    return _gmgcg(f, n, 2, tol, maxit)


def poisson_gmgcg_3d(f, n: int, *, tol: float = 1e-8, maxit: int = 100,
                     device=None) -> SolveResult:
    """GMG-preconditioned CG for 3-D Poisson (reference:
    fasp_poisson_gmgcg3d, SolGMGPoisson.c:877)."""
    f = _tensor(f, device)
    assert f.shape == (n + 1, n + 1, n + 1)
    return _gmgcg(f, n, 3, tol, maxit)
