"""Explicit halo-exchange distributed DIA SpMV (port of
``faspsolver_tpu/parallel/halo.py``).

- vectors and band arrays are split by rows over a 1-D mesh: rank i owns
  the contiguous flat slab [i * n_loc, (i + 1) * n_loc);
- a banded SpMV with largest offset ``h`` needs the h entries on either
  side of the slab, which the two neighbours send (:func:`comm.exchange`:
  P2P, where the JAX package's ``shard_map`` region uses ``ppermute``),
  never a gather of the whole vector;
- the interior terms read only the local slab (zero-filled at its edges)
  and the halo terms, h entries per edge, are added after them, in the
  JAX package's order;
- the Krylov solvers run unchanged on the sharded vectors.

The JAX package checks the communication on the compiled HLO text; here
:func:`comm_pattern` and :func:`cycle_comm_pattern` record one apply or
one whole multigrid cycle as it runs (:class:`comm.CommRecord`), and
:func:`assert_neighbor_comm_only` reads that record.  The coarse levels
stay replicated in ``dist_dia.shard_hierarchy``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import as_tensor, np_dtype
from ..formats import CSRMatrix
from ..ops.operators import dia_bands_from_csr, unpack_bits
from ..utils.messages import warn
from .comm import (emit, exchange, local_part, mesh_device, neighbour_blocks,
                   record, sharded, split)


@dataclasses.dataclass(frozen=True)
class CommMap:
    """Per-level communication plan, fixed at setup: what each SpMV
    exchanges (the reference's OpenMP row partition has none)."""
    n_shards: int
    n_local: int                # rows per shard (padded-equal)
    halo: int                   # entries exchanged per neighbour edge
    replicated: bool = False    # True = no comm (coarse level)

    @property
    def bytes_per_exchange(self) -> int:
        if self.replicated:
            return 0
        return 2 * self.halo    # elements; x2 for both directions


def halo_dia_apply(bands_l: torch.Tensor, offsets, x, mesh, n: int):
    """y = A x on this rank's slab of an n-row vector for row-split flat
    bands ``bands_l`` (k, n_loc): the halo from the neighbours, the
    interior terms, then the halo terms (the JAX ``_local_apply``)."""
    x_l = local_part(x, mesh, n)
    h = max(max(abs(o) for o in offsets), 1)
    n_loc = x_l.shape[0]
    # rank i - 1 sends its last h entries right, rank i + 1 its first h
    # left; the end ranks receive the matrix boundary's zeros
    left_halo, right_halo = exchange(mesh, x_l[:h], x_l[n_loc - h:])
    xp = F.pad(x_l, (h, h))
    y = torch.zeros_like(x_l)
    for k, off in enumerate(offsets):
        y = y + bands_l[k] * xp[h + off:h + off + n_loc]
    for k, off in enumerate(offsets):
        if off < 0:
            m = -off
            y[:m] += bands_l[k][:m] * left_halo[h - m:]
        elif off > 0:
            y[n_loc - off:] += bands_l[k][n_loc - off:] * right_halo[:off]
    return sharded(y, mesh, n)


class HaloDiaOperator(nn.Module):
    """Row-split DIA operator with explicit neighbour exchange: ``bands``
    (k, n) split by columns (``Shard(1)``), x split by rows."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, bands, offsets, n: int, axis: str = "rows",
                 mesh=None):
        super().__init__()
        self.register_buffer("bands", bands)
        self.offsets = tuple(int(o) for o in offsets)
        self.n = int(n)
        self.axis = axis
        self.mesh = mesh

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def ncol(self):
        return self.n

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def halo(self) -> int:
        return max(max(abs(o) for o in self.offsets), 1)

    @property
    def comm_map(self) -> CommMap:
        ns = self.mesh.size()
        return CommMap(n_shards=ns, n_local=self.n // ns, halo=self.halo)

    def diagonal(self):
        for k, off in enumerate(self.offsets):
            if off == 0:
                return self.bands[k]
        return torch.zeros_like(self.bands[0])

    def forward(self, x):
        return halo_dia_apply(self.bands.to_local(), self.offsets, x,
                              self.mesh, self.n)


def halo_dia_operator(A: CSRMatrix, mesh, dtype=None, axis: str = "rows"):
    """A halo-exchange row-split DIA operator from a host matrix.  Rows
    are zero-padded to a multiple of the mesh size; the halo (largest
    band offset) must fit within one shard, else the GSPMD-form
    ``dist_dia_operator`` is returned."""
    offsets, bands = dia_bands_from_csr(A)
    ns = mesh.size()
    target = ((A.nrow + ns - 1) // ns) * ns
    h = max(int(np.max(np.abs(offsets))), 1)
    if h > target // ns:
        warn(f"halo {h} exceeds shard size {target // ns}; "
             "falling back to the GSPMD-form DIA operator")
        from .dist_dia import dist_dia_operator
        return dist_dia_operator(A, mesh, dtype=dtype, axis=axis)
    return halo_from_bands(offsets, bands.astype(np_dtype(dtype)), mesh,
                           axis=axis)


def comm_pattern(op):
    """The communication record of one apply on a sharded zero vector
    (the JAX package returns the apply's HLO text)."""
    mesh = op.mesh
    x = split(torch.zeros(op.n, dtype=op.dtype, device=mesh_device(mesh)),
              mesh)
    with record(mesh) as rec:
        op(x)
    return rec


def _flat_level_bands(op) -> Optional[Tuple[np.ndarray, Tuple[int, ...]]]:
    """Host (k, n) row-aligned flat bands and offsets of any banded level
    operator (Dia / DiaNd / StencilNd / ConstDia / Sum).  Grid-shaped
    bands are re-zeroed at off-grid positions so the flat reading cannot
    wrap across grid rows (a compressed stencil band broadcasts its
    interior constant there; the grid operator's padding kills it, a
    flat operator must store zeros)."""
    from ..ops.operators import (ConstDiaOperator, DiaNdOperator,
                                 DiaOperator, FactoredBand,
                                 StencilNdOperator, SumOperator)

    def host(t):
        return t.detach().cpu().numpy()

    if isinstance(op, DiaOperator):
        return host(op.bands), op.offsets
    if isinstance(op, DiaNdOperator):
        return host(op.bands).reshape(len(op.coords), -1), _nd_offsets(op)
    if isinstance(op, StencilNdOperator):
        dims = op.dims
        d0 = dims[0]
        rest = op.n // d0
        rows = []
        for co, b in zip(op.coords, op.bands):
            if isinstance(b, FactoredBand):
                m = host(b.row_sel) @ (host(b.core) @ host(b.col_sel))
                g = np.ascontiguousarray(
                    np.broadcast_to(m, (d0, rest))).reshape(dims).copy()
            else:
                a = host(b)
                g = (np.broadcast_to(a, dims) if a.ndim == len(dims)
                     else a.reshape(dims)).copy()
            for ax, (c, d) in enumerate(zip(co, dims)):
                if c == 0:
                    continue
                idx = [slice(None)] * len(dims)
                idx[ax] = slice(d - c, d) if c > 0 else slice(0, -c)
                g[tuple(idx)] = 0.0
            rows.append(g.reshape(-1))
        return np.stack(rows), _nd_offsets(op)
    if isinstance(op, ConstDiaOperator):
        consts = op.consts
        m = unpack_bits(op.masks, op.n, consts.dtype)
        return host(consts[:, None] * m), op.offsets
    if isinstance(op, SumOperator):
        parts = [_flat_level_bands(p) for p in op.parts]
        if any(p is None for p in parts):
            return None
        bands = np.concatenate([b for b, _ in parts])
        offs = tuple(o for _, po in parts for o in po)
        return bands, offs
    return None


def _nd_offsets(op) -> Tuple[int, ...]:
    """Flat offsets of a grid operator's per-axis coordinates."""
    strides = np.cumprod((1,) + tuple(op.dims[::-1]))[:-1][::-1]
    return tuple(int(np.dot(c, strides)) for c in op.coords)


def halo_from_bands(offsets, bands: np.ndarray, mesh, dtype=None,
                    axis: str = "rows") -> Optional[HaloDiaOperator]:
    """HaloDiaOperator from host flat bands (rows padded to a multiple of
    the mesh size); None if the halo does not fit within one shard."""
    k, n = bands.shape
    ns = mesh.size()
    target = ((n + ns - 1) // ns) * ns
    if target != n:
        bands = np.pad(bands, ((0, 0), (0, target - n)))
    h = max(int(np.max(np.abs(np.asarray(offsets)))), 1)
    if h > target // ns:
        return None
    dev = as_tensor(bands, np_dtype(dtype if dtype is not None
                                    else bands.dtype), mesh_device(mesh))
    return HaloDiaOperator(split(dev, mesh, dim=1),
                           tuple(int(o) for o in offsets), target,
                           axis=axis, mesh=mesh)


def halo_shard_hierarchy(hier, mesh, axis: str = "rows",
                         min_size: int = 4096):
    """The production distributed placement of an AMG hierarchy: every
    level large enough gets a :class:`HaloDiaOperator` (P2P halo, its
    plan in a :class:`CommMap`), a banded transfer its halo form
    (:func:`halo_banded_transfer`), the rest is placed by
    ``shard_hierarchy``, the coarse levels replicated.

    Returns (hierarchy, comm_maps), one CommMap per level
    (``replicated=True`` where the level has no halo operator)."""
    from ..precond.amg.transfer import BandedProlong
    from .dist_dia import shard_hierarchy

    placed = shard_hierarchy(hier, mesh, axis=axis, min_size=min_size)
    nsh = mesh.size()
    comm_maps = []
    for l, (lvl, lvl_p) in enumerate(zip(hier.levels, placed.levels)):
        n = lvl.A.shape[0]
        fb = _flat_level_bands(lvl.A)
        halo_op = None
        if fb is not None and n >= min_size and n % nsh == 0:
            halo_op = halo_from_bands(fb[1], fb[0], mesh, dtype=lvl.A.dtype,
                                      axis=axis)
        if halo_op is None:
            comm_maps.append(CommMap(n_shards=nsh, n_local=n, halo=0,
                                     replicated=True))
            continue
        lvl_p.A = halo_op
        # the fpos embed / extract of a banded transfer would gather the
        # vector; its halo form exchanges adjacent shard blocks only
        if isinstance(lvl.P, BandedProlong):
            hb = halo_banded_transfer(lvl.P, mesh, axis)
            if hb is not None:
                coarse_sharded = placed.sharded_levels[l + 1]
                hb[1].shard_out = coarse_sharded
                lvl_p.P, lvl_p.R = hb
        comm_maps.append(halo_op.comm_map)
    return placed, tuple(comm_maps)


def cycle_comm_pattern(hier, mesh, axis: str = "rows"):
    """The communication record of one whole multigrid cycle on the
    placed hierarchy (a sharded zero residual), so a test can hold the
    whole cycle's communication, not one SpMV's."""
    from ..precond.preconditioners import AMGPrecond

    n = hier.levels[0].A.shape[0]
    dt = hier.levels[0].A.dtype
    r = split(torch.zeros(n, dtype=dt, device=mesh_device(mesh)), mesh)
    with record(mesh) as rec:
        AMGPrecond(hier)(r)
    return rec


def assert_neighbor_comm_only(rec, fine_n: int) -> None:
    """Raise unless the record shows neighbour P2P (at more than one
    rank) and every gather or scatter of a vector is a coarse one, of
    fewer than fine_n / 2 elements: the contract of the production
    distributed cycle."""
    if rec.world_size > 1 and rec.p2p_sends == 0:
        raise AssertionError("no neighbour P2P exchange in the record")
    for name, elems in rec.collectives:
        if ("gather" in name or "scatter" in name) and elems >= fine_n // 2:
            raise AssertionError(
                f"fine-level-sized {name} of {elems} elements in the "
                f"record ({rec.summary()})")


# ---------------------------------------------------------------------------
# Distributed banded grid transfers (general / RS path).
#
# BandedProlong / BandedRestrict (precond/amg/transfer.py) pin coarse dof
# j to its C point's fine position fpos[j], so P is static fine-space
# shifts plus an fpos embed / extract.  fpos is sorted and the C points
# are near-uniform, so the coarse entries a fine shard embeds, and the
# fine rows a coarse shard extracts, lie on the same or the adjacent
# shards: the exchange is the neighbours' blocks, the halo pattern of
# the operator SpMV.  The index tables are planned on the host.
# ---------------------------------------------------------------------------


class HaloBandedProlong(nn.Module):
    """y_f = P x_c with neighbour-only communication: per fine shard, the
    adjacent coarse blocks, the embed of the planned local C entries,
    and the fine-space shift bands over the local slab and its halo."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, w, emb_pos, emb_src, shifts, nf: int, nc: int,
                 axis: str = "rows", mesh=None):
        super().__init__()
        self.register_buffer("w", w)               # (k, nf), Shard(1)
        self.register_buffer("emb_pos", emb_pos)   # (ns, M), Shard(0)
        self.register_buffer("emb_src", emb_src)   # (ns, M), Shard(0)
        self.shifts = tuple(int(s) for s in shifts)
        self.nf, self.nc = int(nf), int(nc)
        self.axis = axis
        self.mesh = mesh

    @property
    def shape(self):
        return (self.nf, self.nc)

    @property
    def dtype(self):
        return self.w.dtype

    def forward(self, xc):
        mesh = self.mesh
        B = self.nf // mesh.size()
        xc_l = local_part(xc, mesh, self.nc)
        xc_ext = neighbour_blocks(mesh, xc_l)               # (3C,)
        vals = xc_ext[self.emb_src.to_local()[0].long()]    # local gather
        xe = xc_l.new_zeros(B + 1)
        xe[self.emb_pos.to_local()[0].long()] = vals
        xe = xe[:B]
        # the shifts read the embedded vector across shard edges: the
        # operator SpMV's halo exchange
        h = max(max((abs(s) for s in self.shifts), default=0), 1)
        lh, rh = exchange(mesh, xe[:h], xe[B - h:])
        xp = torch.cat([lh, xe, rh])
        w = self.w.to_local()
        y = xc_l.new_zeros(B)
        for k, s in enumerate(self.shifts):
            y = y + w[k] * xp[h + s:h + s + B]
        return sharded(y, mesh, self.nf)


class HaloBandedRestrict(nn.Module):
    """y_c = P^T x_f from the same banded data: the shifted sums of each
    shard (with x's halo), then each coarse shard extracts its entries
    from its own and its neighbours' fine blocks.  ``shard_out`` False
    gathers the coarse vector whole for a replicated coarse level."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, w, ext_src, shifts, nf: int, nc: int,
                 axis: str = "rows", mesh=None):
        super().__init__()
        self.register_buffer("w", w)               # (k, nf), Shard(1)
        self.register_buffer("ext_src", ext_src)   # (ns, C), Shard(0)
        self.shifts = tuple(int(s) for s in shifts)
        self.nf, self.nc = int(nf), int(nc)
        self.axis = axis
        self.mesh = mesh
        self.shard_out = True

    @property
    def shape(self):
        return (self.nc, self.nf)

    @property
    def dtype(self):
        return self.w.dtype

    def forward(self, xf):
        mesh = self.mesh
        B = self.nf // mesh.size()
        h = max(max((abs(s) for s in self.shifts), default=0), 1)
        xf_l = local_part(xf, mesh, self.nf)
        w = self.w.to_local()
        # ye[i] = sum_k w[k][i - s_k] xf[i - s_k]: each term needs
        # t = w * xf shifted into the slab, so t's edges are exchanged
        tcat = torch.stack([w[k] * xf_l for k in range(len(self.shifts))])
        lh, rh = exchange(mesh, tcat[:, :h], tcat[:, B - h:])
        ye = xf_l.new_zeros(B)
        for k, s in enumerate(self.shifts):
            tp = torch.cat([lh[k], tcat[k], rh[k]])
            ye = ye + tp[h - s:h - s + B]
        ye_ext = neighbour_blocks(mesh, ye)                # (3B,)
        y = ye_ext[self.ext_src.to_local()[0].long()]      # (C,)
        return emit(y, mesh, self.nc, self.shard_out)


def halo_banded_transfer(bp, mesh, axis: str = "rows"):
    """(HaloBandedProlong, HaloBandedRestrict) from a remainder-free
    ``BandedProlong``, or None when the plan would need non-neighbour
    exchange (C points not near-uniform) or the sizes do not split
    evenly."""
    ns = mesh.size()
    nf, nc = bp.n_fine, bp.n_coarse
    if bp.has_rem or nf % ns or nc % ns:
        return None
    B, C = nf // ns, nc // ns
    fpos = bp.fpos.detach().cpu().numpy().astype(np.int64)
    if np.any(np.diff(fpos) <= 0):
        return None                        # the plan needs sorted C pins
    # per fine shard: the embed plan
    jlo = np.searchsorted(fpos, np.arange(ns) * B, side="left")
    jhi = np.searchsorted(fpos, (np.arange(ns) + 1) * B, side="left")
    M = max(int((jhi - jlo).max()), 1)
    emb_pos = np.full((ns, M), B, dtype=np.int32)      # pad -> dropped
    emb_src = np.zeros((ns, M), dtype=np.int32)
    for s in range(ns):
        j = np.arange(jlo[s], jhi[s])
        src = j - (s - 1) * C
        if src.size and (src.min() < 0 or src.max() >= 3 * C):
            return None                    # needs non-neighbour coarse data
        emb_pos[s, :j.size] = (fpos[j] - s * B).astype(np.int32)
        emb_src[s, :j.size] = src.astype(np.int32)
    # per coarse shard: the extract plan
    ext_src = np.zeros((ns, C), dtype=np.int32)
    for t in range(ns):
        j = np.arange(t * C, (t + 1) * C)
        src = fpos[j] - (t - 1) * B
        if src.size and (src.min() < 0 or src.max() >= 3 * B):
            return None                    # needs non-neighbour fine data
        ext_src[t] = src.astype(np.int32)
    # full band weights (constant lanes materialised: the same bytes as
    # the operator's own bands)
    if bp.const_mode:
        w = bp.wc[:, None] * unpack_bits(bp.wm, nf, bp.wc.dtype)
    else:
        w = bp.w
    dev = mesh_device(mesh)
    w_d = split(w.detach().to(dev), mesh, dim=1)
    args = dict(shifts=tuple(bp.shifts), nf=nf, nc=nc, axis=axis, mesh=mesh)

    def rows(a):
        return split(torch.from_numpy(a).to(dev), mesh)

    pro = HaloBandedProlong(w_d, rows(emb_pos), rows(emb_src), **args)
    res = HaloBandedRestrict(w_d, rows(ext_src), **args)
    return pro, res
