"""Structured-grid (STR) preconditioners and smoothers (port of
``faspsolver_tpu/precond/str_precond.py``).

Reference: base/src/PreSTR.c (fasp_precond_dstr_diag :49, _ilu0/_ilu1,
_blockgs) and ItrSmootherSTR.c (fasp_smoother_dstr_jacobi/gs/sor/swz and
fasp_generate_diaginv_block).

- block-diagonal preconditioner: one batched (ng, nc, nc) x (ng, nc)
  product with precomputed block inverses;
- block Gauss-Seidel: red-black over the grid parity when the stencil is
  bipartite (exact GS ordering for 5/7-point stencils), each color a
  masked batched update; a 2/3-damped block Jacobi sweep otherwise;
- ILU(0)/ILU(1): factored in band space on the host (banded-block
  wavefront elimination, A is never expanded to CSR), applied by the
  port's batched block level-scheduled solves (:class:`BlockTriangularSolver`
  in :class:`BSRILUPrecond`, which replays its levels from a CUDA graph
  on the card);
- Schwarz: per grid node the {node + stencil neighbours} patch solved
  exactly, color-batched so that the patches of one color are disjoint.

Everything here is plain PyTorch; the JAX package computes it outside
any Pallas kernel.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from .. import as_tensor, np_dtype, torch_dtype
from ..constants import ILUType
from ..formats.str_grid import STRMatrix
from ..krylov.precond import BlockJacobiPrecond
from ..ops.operators import _buf, block_diag_apply, block_ell_layout
from ..ops.str_ops import StrOperator
from ..utils.graphs import capturable
from ..utils.params import ILUParam
from .ilu import BlockTriangularSolver, BSRILUPrecond, setup_ilu


# z = blockdiag(A)^{-1} r with the (ng, nc, nc) inverses of the diagonal
# blocks (reference: fasp_precond_dstr_diag, PreSTR.c:49): the BSR block
# Jacobi preconditioner's apply
StrDiagPrecond = BlockJacobiPrecond


def _grid_parity(A: STRMatrix) -> np.ndarray:
    z, y, x = np.meshgrid(np.arange(A.nz), np.arange(A.ny),
                          np.arange(A.nx), indexing="ij")
    return ((x + y + z) % 2).reshape(-1)


def _bipartite(A: STRMatrix) -> bool:
    """Stencil offsets all flip grid parity -> red-black GS is exact."""
    for off in A.offsets:
        o, parity = abs(int(off)), 0
        for s in (A.nx * A.ny, A.nx, 1):
            c = int(np.rint(o / s)) if s > 1 else o
            parity += c
            o -= c * s
        if (parity + o) % 2 == 0:
            return False
    return True


class StrBlockGSPrecond(nn.Module):
    """Block Gauss-Seidel sweeps (reference: fasp_precond_dstr_blockgs,
    PreSTR.c; fasp_smoother_dstr_gs).  Red-black masked when the stencil
    is bipartite, a damped block Jacobi sweep otherwise; ``masks`` is
    (colors, ng).  Walking ``masks`` yields views of its rows (two, or
    the one damping row of the Jacobi fallback), so the apply reads
    nothing back to the host: it is capturable when its operator is."""

    @property
    def capturable(self) -> bool:
        return capturable(self.A)

    def __init__(self, A: StrOperator, dinv, masks, nsweeps: int = 2):
        super().__init__()
        self.A = A
        self.register_buffer("dinv", _buf(dinv))          # (ng, nc, nc)
        self.register_buffer("masks", torch.stack([_buf(m) for m in masks]))
        self.nsweeps = int(nsweeps)

    def _sweep(self, x, b, mask):
        r = b - self.A(x)
        upd = block_diag_apply(self.dinv, r.reshape(self.A.ng, self.A.nc))
        return x + (mask[:, None] * upd).reshape(-1)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        x = torch.zeros_like(r)
        for _ in range(self.nsweeps):
            for m in self.masks:
                x = self._sweep(x, r, m)
        return x


def _dinv(A: STRMatrix, dtype) -> torch.Tensor:
    return as_tensor(np.linalg.inv(A.diag.astype(np.float64)), dtype)


def setup_str_diag(A: STRMatrix, dtype=None) -> StrDiagPrecond:
    return StrDiagPrecond(_dinv(A, torch_dtype(dtype)))


def setup_str_blockgs(A: STRMatrix, nsweeps: int = 2, dtype=None
                      ) -> StrBlockGSPrecond:
    dtype = torch_dtype(dtype)
    nd = np_dtype(dtype)
    if _bipartite(A):
        parity = _grid_parity(A).astype(nd)
        masks = (1.0 - parity, parity)
    else:
        # damped Jacobi fallback: one full mask with 2/3 damping
        masks = (np.full(A.ngrid, 2.0 / 3.0, dtype=nd),)
    return StrBlockGSPrecond(StrOperator.from_str(A, dtype=dtype),
                             _dinv(A, dtype), [as_tensor(m) for m in masks],
                             nsweeps=nsweeps)


def _band_ilu_pattern(offsets: Tuple[int, ...], fill: int
                      ) -> Tuple[Tuple[int, ...], dict]:
    """Symbolic ILU(k) on the band-offset set: fill offset o1+o2 (o1 a
    lower offset, o2 any nonzero offset of the eliminated row) enters at
    level lvl(o1)+lvl(o2)+1, kept while <= fill (level-of-fill on the
    Toeplitz pattern graph; boundaries are handled numerically by range
    masks, not symbolically)."""
    lvl = {int(o): 0 for o in offsets}
    lvl[0] = 0
    for _ in range(max(fill, 0)):
        new = {}
        for o1, l1 in lvl.items():
            if o1 >= 0:
                continue
            for o2, l2 in lvl.items():
                if o2 <= 0:
                    continue     # fill comes via the pivot row's U part
                s = o1 + o2
                lv = l1 + l2 + 1
                if s != 0 and s not in lvl and lv <= fill:
                    new[s] = min(lv, new.get(s, lv))
        if not new:
            break
        lvl.update(new)
    offs = tuple(sorted(o for o in lvl if o != 0))
    return offs, lvl


def _longest_path_levels(ng: int, deps) -> np.ndarray:
    """lvl[g] = max over (d, mask) in ``deps`` with g - d >= 0 and
    mask[g] of lvl[g - d] + 1 (0 where there is none), for positive
    distances d; a mask of None means every g.

    Chunks of the smallest distance other than 1 depend only on earlier
    chunks.  Inside a chunk the distance-1 chain is a running maximum:
    with M(g) = lvl(g) - g, M(g) = max(M(g - 1), others(g) - g), started
    afresh where the chain is masked off (a segmented maximum: each
    segment is lifted above the last by ``lift``)."""
    deps = dict(deps)
    dists = sorted(deps)
    chain = bool(dists) and dists[0] == 1
    far = dists[1:] if chain else dists
    step = far[0] if far else max(ng, 1)
    lift = 4 * (ng + 1)
    lvl = np.zeros(ng, dtype=np.int64)
    for s in range(0, ng, step):
        e = min(s + step, ng)
        others = np.zeros(e - s, dtype=np.int64)
        for d in far:
            lo = max(s, d)                  # first g of the chunk with g-d >= 0
            if lo < e:
                cand = lvl[lo - d:e - d] + 1
                if deps[d] is not None:
                    cand = np.where(deps[d][lo:e], cand, 0)
                np.maximum(others[lo - s:], cand, out=others[lo - s:])
        if not chain:
            lvl[s:e] = others
            continue
        g = np.arange(s, e, dtype=np.int64)
        m = others - g
        linked = (np.ones(e - s, dtype=bool) if deps[1] is None
                  else deps[1][s:e].copy())
        if s == 0:
            linked[0] = False
        elif linked[0]:
            m[0] = max(m[0], lvl[s - 1] + 1 - s)
        seg = np.cumsum(~linked) * lift
        lvl[s:e] = np.maximum.accumulate(m + seg) - seg + g
    return lvl


def _grid_wavefronts(ng: int, offsets, forward: bool = True, steps=None
                     ) -> List[np.ndarray]:
    """Dependency levels of the banded triangular graph: node g depends
    on g+o for the given offsets (o<0 forward-substitution, o>0 back-
    substitution), the topological schedule the CSR TriangularSolver
    computes, derived straight from the offsets (longest path).  The JAX
    package walks the nodes one by one; here the recurrence runs by
    array operations (:func:`_longest_path_levels`), with the same
    levels.  ``steps`` ({o: (ng,) bool}, see :func:`_grid_steps`) drops
    the dependencies of the nodes whose step o leaves the grid."""
    deps = {}
    for o in offsets:
        if o < 0 if forward else o > 0:
            mask = None if steps is None else steps[int(o)]
            deps[abs(int(o))] = (mask if mask is None or forward
                                 else mask[::-1])
    lvl = _longest_path_levels(ng, deps)
    if not forward:
        lvl = lvl[::-1]
    order = np.argsort(lvl, kind="stable")
    bounds = np.searchsorted(lvl[order], np.arange(lvl.max() + 2))
    return [order[bounds[i]:bounds[i + 1]]
            for i in range(len(bounds) - 1) if bounds[i] < bounds[i + 1]]


def _grid_steps(A: STRMatrix, offs):
    """{o: (ng,) bool}: whether the step from grid point g to g+o stays
    on the nx x ny x nz grid (wraps across no grid row or plane), for
    each offset of the ILU pattern ``offs``.

    The JAX package schedules the banded solves on the 1-D index alone,
    so a band at offset -1 chains every node to the one before it and a
    64^3 grid has 262,144 levels per factor.  On a grid whose blocks on
    wrapping steps are zero (every STR matrix of a structured grid), and
    whose ILU fill offsets are the sums of the steps that make them, the
    factor's blocks on wrapping steps stay exactly zero (a fill block is
    the product of two blocks, one of which wraps), so those
    dependencies can be dropped: 190 levels per factor on the 64^3 grid.
    The factor and the solves compute the same values; only blocks that
    are zero are skipped.  None when A is not such a grid (then the JAX
    package's schedule applies)."""
    ng = A.ngrid
    coords = {int(o): _linear_to_coords(int(o), A.nx, A.ny)
              for o in list(offs) + [0]}
    g = np.arange(ng, dtype=np.int64)
    at = (g % A.nx, (g // A.nx) % A.ny, g // (A.nx * A.ny))
    dims = (A.nx, A.ny, A.nz)
    steps = {}
    for o in offs:
        ok = np.ones(ng, dtype=bool)
        for a, d, n in zip(at, coords[int(o)], dims):
            ok &= (a + d >= 0) & (a + d < n)
        steps[int(o)] = ok
    for o, band in zip(A.offsets, A.offdiag):
        wraps = ~steps[int(o)] & (g + o >= 0) & (g + o < ng)
        if np.any(band[wraps]):
            return None
    for o1 in offs:
        for o2 in offs:
            t = o1 + o2
            if o1 < 0 < o2 and t in coords and coords[t] != tuple(
                    a + b for a, b in zip(coords[o1], coords[o2])):
                return None
    return steps


def str_ilu_factor_banded(A: STRMatrix, fill: int = 0):
    """Banded-BLOCK ILU(0)/ILU(1) factorization IN BAND SPACE
    (reference: fasp_ilu_dstr_setup0/setup1, BlaILUSetupSTR.c:1282 — the
    reference also factorizes on the dSTR bands with nc x nc blocks).

    The grid loop is vectorized by wavefront: all points on a dependency
    level factor as ONE batched nc-block elimination (einsum + batched
    inverse), so setup is O(levels) NumPy calls instead of an ng-long
    Python loop.  Returns ({offset: (ng, nc, nc) band}, offsets) for the
    unified LU storage (L unit-lower at negative offsets, U at >= 0).
    """
    ng, nc = A.ngrid, A.nc
    offs, _ = _band_ilu_pattern(A.offsets, fill)
    steps = _grid_steps(A, offs)
    bands = {}
    f64 = np.float64
    for o in offs:
        bands[o] = np.zeros((ng, nc, nc), dtype=f64)
    bands[0] = A.diag.astype(f64).copy()
    for o, band in zip(A.offsets, A.offdiag):
        bands[int(o)][:] = band.astype(f64)
    neg = sorted(o for o in offs if o < 0)
    all_offs = sorted(list(offs) + [0])

    for rows in _grid_wavefronts(ng, neg, steps=steps):
        # eliminate columns k = g + o in increasing k order (IKJ); rows
        # within a wavefront only read earlier-level U rows, so each
        # step is one batched block op over the wavefront
        for o in neg:                       # most negative first = k asc
            g = rows[rows + o >= 0]
            if steps is not None:           # a zero block: L stays zero
                g = g[steps[o][g]]
            if g.size == 0:
                continue
            k = g + o
            dk = bands[0][k]
            # L entry: a[g,k] <- a[g,k] @ inv(U[k,k])
            lk = np.einsum("gab,gbc->gac", bands[o][g], np.linalg.inv(dk))
            bands[o][g] = lk
            # update the remainder of row g on the kept pattern with the
            # U part of the pivot row (columns k+o2 > k only)
            for o2 in all_offs:
                if o2 <= 0:
                    continue
                t = o + o2                  # target offset in row g
                if t not in bands and t != 0:
                    continue                # dropped fill
                gg = g[(k + o2 >= 0) & (k + o2 < ng)]
                if gg.size == 0:
                    continue
                kk = gg + o
                upd = np.einsum("gab,gbc->gac", bands[o][gg],
                                bands[o2][kk])
                if t == 0:
                    bands[0][gg] -= upd
                else:
                    sel = (gg + t >= 0) & (gg + t < ng)
                    if sel.any():
                        bands[t][gg[sel]] -= upd[sel]
    return bands, tuple(all_offs), steps


def _banded_block_solver(bands: dict, offs, ng: int, nc: int,
                         lower: bool, dtype, steps=None
                         ) -> BlockTriangularSolver:
    """One triangle of the factored bands as the flat buffers of a
    :class:`BlockTriangularSolver`, straight from band space: every
    wavefront is one level of k = (offsets in the triangle) block
    columns, those that leave the grid (or, with ``steps``, wrap) point
    at the zero row ng; the L factor has a unit diagonal (``dinv``
    None)."""
    npdt = np_dtype(dtype)
    tri = sorted(o for o in offs if (o < 0 if lower else o > 0))
    k = max(len(tri), 1)
    levels = _grid_wavefronts(ng, tri, forward=lower, steps=steps)
    rows = np.concatenate(levels)
    cols = np.full((ng, k), ng, dtype=np.int32)
    blks = np.zeros((ng, k, nc, nc), dtype=npdt)
    for s, o in enumerate(tri):
        h = rows + o
        ok = (h >= 0) & (h < ng)
        if steps is not None:
            ok &= steps[o][rows]
        cols[ok, s] = h[ok]
        blks[ok, s] = bands[o][rows[ok]]
    dinv = None if lower else as_tensor(
        np.linalg.inv(bands[0])[rows].astype(npdt))
    return BlockTriangularSolver(
        torch.from_numpy(rows), torch.from_numpy(cols.reshape(-1)),
        block_ell_layout(torch.from_numpy(blks)).reshape(-1), dinv,
        [(len(lv), k) for lv in levels], ng, nc)


def setup_str_ilu(A: STRMatrix, fill: int = 0, dtype=None):
    """STR ILU(0)/ILU(1) (reference: fasp_ilu_dstr_setup0/1,
    BlaILUSetupSTR.c:1282; applier fasp_precond_dstr_ilu0/1, PreSTR.c).

    Factored in band space (:func:`str_ilu_factor_banded`) and applied by
    the batched block level-scheduled solves of a
    :class:`BSRILUPrecond`, both on the grid's wavefronts where A is a
    grid (:func:`_grid_steps`).  ``fill >= 2`` falls back to the CSR ILU(k)
    (the reference's dstr setups exist for 0 and 1 only)."""
    dtype = torch_dtype(dtype)
    if fill >= 2:
        return setup_ilu(A.to_csr(), ILUParam(ILU_type=int(ILUType.ILUK),
                                              ILU_lfil=fill), dtype=dtype)
    bands, offs, steps = str_ilu_factor_banded(A, fill)
    return BSRILUPrecond(*(
        _banded_block_solver(bands, offs, A.ngrid, A.nc, lower, dtype,
                             steps) for lower in (True, False)), A.nc)


# ---------------------------------------------------------------------------
# Schwarz smoother on the structured grid
# (reference: fasp_smoother_dstr_swz + fasp_generate_diaginv_block,
#  ItrSmootherSTR.c:1665/1565 — per grid node, solve the overlapping
#  {node + stencil neighbours} patch exactly and add the correction)
# ---------------------------------------------------------------------------

def _linear_to_coords(d: int, nx: int, ny: int) -> Tuple[int, int, int]:
    """Decompose a linear grid offset into (dx, dy, dz) for the standard
    STR offset convention (+-1, +-nx, +-nx*ny and combinations)."""
    nxy = nx * ny
    dz = int(np.rint(d / nxy)) if nxy > 1 else 0
    rem = d - dz * nxy
    dy = int(np.rint(rem / nx)) if nx > 1 else 0
    dx = rem - dy * nx
    return dx, dy, dz


class StrSchwarzSmoother(nn.Module):
    """Schwarz as a smoother (reference: fasp_smoother_dstr_swz,
    ItrSmootherSTR.c:1665): for each grid node, gather the residual on
    the overlapping patch {node} + stencil neighbours, solve the dense
    patch system with a precomputed inverse, and add the correction to
    the node and its neighbours.

    Nodes are color-batched so that the patches of one color are
    disjoint: each color is one batched dense (m, m) product, with the
    residual refreshed between colors (multiplicative across colors,
    additive within one, as in the JAX package).  The patch data
    (``inv`` (ng, m, m), ``members`` / ``valid`` (ng, k1)) is stored in
    color order, so a color reads slices and gathers nothing but the
    residual.  The slices come from ``sizes``, a tuple fixed at setup, so
    the apply reads nothing back to the host: it is capturable when its
    operator is."""

    @property
    def capturable(self) -> bool:
        return capturable(self.A)

    def __init__(self, A: StrOperator, inv, members, valid, colors,
                 nsweeps: int = 1):
        super().__init__()
        self.A = A
        colors = [_buf(c).to(torch.int64) for c in colors]
        order = torch.cat(colors)
        self.sizes = tuple(int(c.numel()) for c in colors)
        self.register_buffer("inv", _buf(inv)[order])
        members = _buf(members).to(torch.int64)[order]
        valid = _buf(valid)[order]
        self.register_buffer("valid", valid)
        # residual rows to gather (clipped) and rows to scatter into
        # (invalid members -> the scratch row ng)
        self.register_buffer("gather", members.clamp(0, A.ng - 1))
        self.register_buffer("scatter", torch.where(valid > 0, members,
                                                    A.ng))
        self.nsweeps = int(nsweeps)

    def _color_update(self, x, b, sl):
        ng, nc = self.A.ng, self.A.nc
        r = (b - self.A(x)).reshape(ng, nc)
        val = self.valid[sl]                               # (q, k1)
        q, k1 = val.shape
        ri = r[self.gather[sl]] * val[:, :, None]          # (q, k1, nc)
        e = block_diag_apply(self.inv[sl], ri.reshape(q, k1 * nc))
        e = (e.reshape(q, k1, nc) * val[:, :, None]).reshape(-1, nc)
        xb = torch.cat([x.reshape(ng, nc), x.new_zeros(1, nc)])
        # index_add_ is atomic on CUDA, but the patches of one color are
        # disjoint: every grid row gets at most one contribution, so the
        # sum is that of the JAX scatter.  Only the scratch row ng (the
        # invalid members) takes many, and it is dropped.
        xb.index_add_(0, self.scatter[sl].reshape(-1), e)
        return xb[:ng].reshape(-1)

    def _slices(self):
        s = 0
        for q in self.sizes:
            yield slice(s, s + q)
            s += q

    def smooth(self, x: torch.Tensor, b: torch.Tensor,
               nsweeps: int) -> torch.Tensor:
        for _ in range(nsweeps):
            for sl in self._slices():
                x = self._color_update(x, b, sl)
        return x

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return self.smooth(torch.zeros_like(r), r, self.nsweeps)


def _schwarz_patches(A: STRMatrix):
    """(members (ng, k1), valid (ng, k1), patch inverses (ng, m, m)) in
    float64: the {node + neighbours} patch of every grid node, its
    members off the grid (or wrapped across a grid row) invalid, and the
    inverse of its dense patch matrix (identity rows in the invalid slots
    keep the batch invertible)."""
    ng, nc = A.ngrid, A.nc
    offs = [0] + [int(o) for o in A.offsets]
    k1 = len(offs)
    m = k1 * nc
    g = np.arange(ng, dtype=np.int64)
    members = np.stack([g + o for o in offs], axis=1)        # (ng, k1)
    valid = (members >= 0) & (members < ng)
    # row-boundary validity: an x-offset must not wrap across grid rows
    gx = g % A.nx
    gy = (g // A.nx) % A.ny
    for s, o in enumerate(offs):
        dx, dy, _ = _linear_to_coords(o, A.nx, A.ny)
        valid[:, s] &= ((gx + dx >= 0) & (gx + dx < A.nx)
                        & (gy + dy >= 0) & (gy + dy < A.ny))
    members = np.where(valid, members, ng).astype(np.int32)

    # patch matrices: blocks between patch members (offset differences
    # that are themselves stencil offsets)
    off_idx = {int(o): i for i, o in enumerate(A.offsets)}
    P = np.zeros((ng, m, m), dtype=np.float64)
    for a in range(k1):
        ga = np.clip(g + offs[a], 0, ng - 1)
        va = valid[:, a]
        for b_ in range(k1):
            d = offs[b_] - offs[a]
            if d == 0:
                blocks = A.diag[ga]
            elif d in off_idx:
                blocks = A.offdiag[off_idx[d]][ga]
            else:
                continue
            vb = valid[:, b_] & va
            P[:, a * nc:(a + 1) * nc, b_ * nc:(b_ + 1) * nc] = np.where(
                vb[:, None, None], blocks, 0.0)
    # identity rows for invalid slots keep the batch invertible
    for a in range(k1):
        bad = ~valid[:, a]
        if bad.any():
            for j in range(nc):
                P[bad, a * nc + j, :] = 0.0
                P[bad, a * nc + j, a * nc + j] = 1.0
    return members, valid, np.linalg.inv(P)


def _schwarz_colors(A: STRMatrix) -> List[np.ndarray]:
    """Conflict-free node coloring: the patches of g and h intersect iff
    h - g is a difference of two patch offsets; color on grid
    coordinates modulo (max|dx| + 1, ...) per axis."""
    ng = A.ngrid
    offs = [0] + [int(o) for o in A.offsets]
    coords = [_linear_to_coords(o, A.nx, A.ny) for o in offs]
    mx, my, mz = (max(abs(ca[i] - cb[i]) for ca in coords for cb in coords)
                  for i in range(3))
    cx, cy, cz = (min(mx + 1, A.nx), min(my + 1, max(A.ny, 1)),
                  min(mz + 1, max(A.nz, 1)))
    g = np.arange(ng, dtype=np.int64)
    gx = g % A.nx
    gy = (g // A.nx) % max(A.ny, 1)
    gz = g // (A.nx * max(A.ny, 1))
    color = (gx % cx) + cx * ((gy % cy) + cy * (gz % cz))
    return [np.flatnonzero(color == c).astype(np.int32)
            for c in range(cx * cy * cz) if np.any(color == c)]


def setup_str_schwarz(A: STRMatrix, dtype=None,
                      nsweeps: int = 1) -> StrSchwarzSmoother:
    """The patch inverses and the conflict-free node coloring of a
    :class:`StrSchwarzSmoother` (reference setup:
    fasp_generate_diaginv_block, ItrSmootherSTR.c:1565, an LU of each
    (node + neighbours) patch)."""
    dtype = torch_dtype(dtype)
    members, valid, inv = _schwarz_patches(A)
    return StrSchwarzSmoother(
        StrOperator.from_str(A, dtype=dtype), as_tensor(inv, dtype),
        torch.from_numpy(members), as_tensor(valid, dtype),
        [torch.from_numpy(c) for c in _schwarz_colors(A)], nsweeps=nsweeps)
