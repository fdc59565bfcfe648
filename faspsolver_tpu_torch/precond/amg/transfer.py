"""Grid transfers as ``nn.Module``s (port of ``AggProlong``/
``AggRestrict``, ``BlockAggProlong``/``BlockAggRestrict``, ``CooProlong``/``CooRestrict``, ``BandedProlong``/
``BandedRestrict``, ``banded_transfer`` and ``csr_transfer`` of
``faspsolver_tpu/precond/amg/transfer.py``).

Reference: boolean aggregation transfer (form_tentative_p,
PreAMGAggregationCSR.inl:40; mxv_agg / rap_agg, BlaSpmvCSR.c:438,1276)
and sparse matrix-vector products with R = P^T (PreMGCycle.c:135-227,
BlaSpmvCSR.c:242, fasp_dcsr_trans).  A boolean P never materializes:
prolongation gathers ``x_c[agg]``, restriction segment-sums by ``agg``.
P and R share one set of arrays: the COO form gathers and segment-sums,
the banded form embeds the coarse vector at its C-points' fine
positions and applies P as statically shifted reads plus a small COO
remainder.  Every segment sum is an ``index_add_``, atomic on CUDA.
Plain PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import as_tensor, np_dtype
from ...formats import CSRMatrix
from ...ops.operators import (_COO_PAD_ALIGN, _buf, _round_up, pack_bits,
                              unpack_bits)

# banded_transfer's gates: the JAX package's values, kept for parity
# (ROADMAP §2b item 4 lists them for re-derivation on the H100)
_MAX_SHIFTS = 40          # most fine-space shifts kept as bands
_MAX_REM_FRAC = 0.2       # COO remainder holds at most this share of nnz
_MAX_BYTES_RATIO = 3.0    # bands cost at most this multiple of COO bytes


class _AggTransfer(nn.Module):
    """A boolean transfer: ``agg[i]`` is fine dof i's aggregate."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, agg, n_fine: int, n_coarse: int):
        super().__init__()
        self.register_buffer("agg", _buf(agg))       # int32
        self.n_fine = int(n_fine)
        self.n_coarse = int(n_coarse)


class AggProlong(_AggTransfer):
    """Boolean tentative prolongation: x_f = x_c[agg]."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine, self.n_coarse)

    def forward(self, xc: torch.Tensor) -> torch.Tensor:
        return xc.index_select(0, self.agg)

    @classmethod
    def from_agg(cls, agg: np.ndarray, n_coarse: int) -> "AggProlong":
        return cls(as_tensor(agg.astype(np.int32)), len(agg), int(n_coarse))


class AggRestrict(_AggTransfer):
    """Boolean restriction (the transpose of AggProlong): a segment sum
    by aggregate."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse, self.n_fine)

    def forward(self, rf: torch.Tensor) -> torch.Tensor:
        return rf.new_zeros(self.n_coarse).index_add_(0, self.agg, rf)


class _BlockAggTransfer(_AggTransfer):
    """A boolean block transfer: fine block i belongs to coarse block
    ``agg[i]`` (reference: form_boolean_p_bsr,
    PreAMGAggregationBSR.inl)."""

    def __init__(self, agg, n_fine: int, n_coarse: int, nb: int):
        super().__init__(agg, n_fine, n_coarse)
        self.nb = int(nb)


class BlockAggProlong(_BlockAggTransfer):
    """Blockwise boolean prolongation: fine block i takes coarse block
    agg[i]."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine * self.nb, self.n_coarse * self.nb)

    def forward(self, xc: torch.Tensor) -> torch.Tensor:
        return xc.reshape(self.n_coarse, self.nb).index_select(
            0, self.agg).reshape(-1)


class BlockAggRestrict(_BlockAggTransfer):
    """Blockwise boolean restriction: a segment sum of fine blocks by
    aggregate (``index_add_``: atomic, so not bit-reproducible, on
    CUDA)."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse * self.nb, self.n_fine * self.nb)

    def forward(self, rf: torch.Tensor) -> torch.Tensor:
        return rf.new_zeros(self.n_coarse, self.nb).index_add_(
            0, self.agg, rf.reshape(self.n_fine, self.nb)).reshape(-1)


class _CooTransfer(nn.Module):
    """P in COO form; pads point at row n_fine / column n_coarse."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, rows, cols, vals, n_fine: int, n_coarse: int):
        super().__init__()
        self.register_buffer("rows", _buf(rows))     # fine ids, int32
        self.register_buffer("cols", _buf(cols))     # coarse ids, int32
        self.register_buffer("vals", _buf(vals))
        self.n_fine = int(n_fine)
        self.n_coarse = int(n_coarse)


class CooProlong(_CooTransfer):
    """x_f = P x_c: gather by coarse column, segment-sum by fine row."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine, self.n_coarse)

    def forward(self, xc: torch.Tensor) -> torch.Tensor:
        xe = torch.cat([xc, xc.new_zeros(1)])         # pads read column nc
        prod = self.vals * xe.index_select(0, self.cols)
        y = xc.new_zeros(self.n_fine + 1).index_add_(0, self.rows, prod)
        return y[:self.n_fine]


class CooRestrict(_CooTransfer):
    """r_c = P^T r_f off P's arrays: gather by fine row, segment-sum by
    coarse column."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse, self.n_fine)

    def forward(self, xf: torch.Tensor) -> torch.Tensor:
        xe = torch.cat([xf, xf.new_zeros(1)])         # pads read row nf
        prod = self.vals * xe.index_select(0, self.rows)
        y = xf.new_zeros(self.n_coarse + 1).index_add_(0, self.cols, prod)
        return y[:self.n_coarse]


class _BandedTransfer(nn.Module):
    """P stored in fine index space: coarse dof j sits at fine position
    ``fpos[j]`` (its C point), so each entry P[i, j] is a fine-space shift
    ``fpos[j] - i``; the kept shifts are bands ``w`` (or, in const mode,
    scalars ``wc`` times packed row masks ``wm``) and the rest a COO
    remainder."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, fpos, w, rem_rows, rem_cols, rem_vals, shifts,
                 n_fine: int, n_coarse: int, has_rem: bool, wc=None,
                 wm=None, const_mode: bool = False):
        super().__init__()
        self.register_buffer("fpos", _buf(fpos))
        self.register_buffer("w", _buf(w))
        self.register_buffer("rem_rows", _buf(rem_rows))
        self.register_buffer("rem_cols", _buf(rem_cols))
        self.register_buffer("rem_vals", _buf(rem_vals))
        self.register_buffer("wc", None if wc is None else _buf(wc))
        self.register_buffer("wm", None if wm is None else _buf(wm))
        self.shifts = tuple(int(s) for s in shifts)
        self.n_fine = int(n_fine)
        self.n_coarse = int(n_coarse)
        self.has_rem = bool(has_rem)
        self.const_mode = bool(const_mode)

    def _bands(self, dtype) -> torch.Tensor:
        """(k, n_fine) weights; const mode unpacks every mask at once."""
        if self.const_mode:
            return self.wc[:, None] * unpack_bits(self.wm, self.n_fine, dtype)
        return self.w

    def _pad(self) -> int:
        return max(max((abs(s) for s in self.shifts), default=0), 1)


class BandedProlong(_BandedTransfer):
    """``y[i] = sum_k w[k][i] * xe[i + shift_k]`` over the embedded coarse
    vector ``xe[fpos] = xc``, plus the COO remainder."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_fine, self.n_coarse)

    def forward(self, xc: torch.Tensor) -> torch.Tensor:
        nf = self.n_fine
        pad = self._pad()
        xp = xc.new_zeros(nf + 2 * pad)
        xp[pad:pad + nf].index_put_((self.fpos,), xc)
        w = self._bands(xc.dtype)
        y = xc.new_zeros(nf)
        for k, s in enumerate(self.shifts):
            y = y + w[k] * xp[pad + s:pad + s + nf]
        if self.has_rem:
            xe = torch.cat([xc, xc.new_zeros(1)])
            prod = self.rem_vals * xe.index_select(0, self.rem_cols)
            y = y + xc.new_zeros(nf + 1).index_add_(
                0, self.rem_rows, prod)[:nf]
        return y


class BandedRestrict(_BandedTransfer):
    """R = P^T off the same arrays: ``ye = sum_k shift(w[k] * xf,
    +shift_k)``, then one extract ``yc = ye[fpos]``, plus the COO
    remainder."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_coarse, self.n_fine)

    def forward(self, xf: torch.Tensor) -> torch.Tensor:
        nf = self.n_fine
        pad = self._pad()
        w = self._bands(xf.dtype)
        ye = xf.new_zeros(nf)
        for k, s in enumerate(self.shifts):
            tp = F.pad(w[k] * xf, (pad, pad))
            ye = ye + tp[pad - s:pad - s + nf]
        yc = ye.index_select(0, self.fpos)
        if self.has_rem:
            xe = torch.cat([xf, xf.new_zeros(1)])
            prod = self.rem_vals * xe.index_select(0, self.rem_rows)
            yc = yc + xf.new_zeros(self.n_coarse + 1).index_add_(
                0, self.rem_cols, prod)[:self.n_coarse]
        return yc


def banded_transfer(P: CSRMatrix, fpos: np.ndarray, dtype=None):
    """(BandedProlong, BandedRestrict) from P and the fine positions of its
    coarse columns, or None when P does not band-compress (callers fall
    back to :func:`csr_transfer`).

    The most populated fine-space shifts (at most ``_MAX_SHIFTS``) become
    bands; the leftover entries ride a COO remainder capped at
    ``_MAX_REM_FRAC`` of nnz; bands that cost more than
    ``_MAX_BYTES_RATIO`` x the COO bytes are rejected."""
    npdt = np_dtype(dtype)
    nf, nc = P.shape
    nnz = P.nnz
    if nnz == 0 or nc == 0:
        return None
    fpos = np.asarray(fpos, dtype=np.int64)
    if fpos.shape[0] != nc:
        return None
    rows = np.repeat(np.arange(nf, dtype=np.int64), np.diff(P.indptr))
    cols = P.indices.astype(np.int64)
    d = fpos[cols] - rows
    # O(nnz) histogram over the shift range (-nf, nf)
    hist = np.bincount(d + nf, minlength=2 * nf + 1)
    pos_nz = np.nonzero(hist)[0]
    uniq = pos_nz - nf
    counts = hist[pos_nz]
    order = np.argsort(-counts, kind="stable")
    kept = order[:_MAX_SHIFTS]
    covered = int(counts[kept].sum())
    if nnz - covered > _MAX_REM_FRAC * nnz:
        return None
    # demote kept shifts that earn less than their streaming cost (each
    # band streams a full nf lane) into the remainder, budget permitting
    kept = list(kept)
    rem_budget = int(_MAX_REM_FRAC * nnz) - (nnz - covered)
    thin = max(nf // 256, 8)
    for idx in sorted(kept, key=lambda i: counts[i]):   # thinnest first
        c = int(counts[idx])
        if len(kept) > 1 and c <= thin and rem_budget >= c:
            kept.remove(idx)
            rem_budget -= c
    kept = np.array(kept, dtype=np.int64)
    if kept.size == 0:
        return None
    itemsize = npdt.itemsize
    coo_bytes = nnz * (itemsize + 8)
    # lanes sorted by shift value; direct shift -> lane lookup table
    kept_sorted = np.sort(uniq[kept])
    lane_arr = np.full(2 * nf + 1, -1, dtype=np.int32)
    lane_arr[kept_sorted + nf] = np.arange(len(kept_sorted),
                                           dtype=np.int32)
    lane = lane_arr[d + nf]
    sel = lane >= 0
    # constant lanes: grid-born interpolation weights are one value per
    # shift away from boundaries.  Exactly constant lanes encode as
    # scalar x bitmask in any dtype; in f32 near-constant lanes also
    # demote their non-modal entries (<= 5% of nnz) into the remainder.
    nlanes = len(kept_sorted)
    modes = np.zeros(nlanes, dtype=np.float64)
    is_f32 = npdt == np.float32
    demote = np.zeros(d.shape[0], dtype=bool)
    const_ok = nlanes > 0
    n_exc = 0
    # compare in the target dtype (f64 summation noise vanishes in f32)
    data_cmp = P.data.astype(npdt)
    for li in range(nlanes):
        idx = np.flatnonzero(sel & (lane == li))
        if idx.size == 0:
            continue
        v, c = np.unique(data_cmp[idx], return_counts=True)
        modes[li] = v[c.argmax()]
        exc = idx[data_cmp[idx] != modes[li]]
        if exc.size:
            if is_f32:
                demote[exc] = True
                n_exc += int(exc.size)
            else:
                const_ok = False
    if is_f32 and n_exc > 0.05 * nnz:
        const_ok = False
        demote[:] = False
    const_mode = bool(const_ok)
    # byte-ratio rejection with the effective storage: bitmask lanes cost
    # nf/8 bytes, full lanes nf*itemsize
    eff_band_bytes = (nlanes * ((nf + 31) // 32) * 4 if const_mode
                      else nlanes * nf * itemsize)
    if eff_band_bytes > _MAX_BYTES_RATIO * coo_bytes and nf > 4096:
        return None
    if is_f32 and const_mode:
        sel = sel & ~demote
    if const_mode:
        wm_np = np.zeros((nlanes, (nf + 31) // 32), dtype=np.int32)
        rowmask = np.zeros(nf, dtype=bool)
        for li in range(nlanes):
            rowmask[:] = False
            rowmask[rows[sel & (lane == li)]] = True
            wm_np[li] = pack_bits(rowmask)
        wc_np = modes.astype(npdt)
        w = np.zeros((nlanes, 1), dtype=npdt)   # unused in const mode
    else:
        wc_np = wm_np = None
        w = np.zeros((nlanes, nf), dtype=npdt)
        # (row, shift) is unique because fpos is injective
        w[lane[sel], rows[sel]] = P.data[sel]
    # COO remainder, shared between P and R
    n_rem = int((~sel).sum())
    has_rem = n_rem > 0
    pad_n = _round_up(max(n_rem, 1), _COO_PAD_ALIGN)
    rr = np.full(pad_n, nf, dtype=np.int32)
    rc = np.full(pad_n, nc, dtype=np.int32)
    rv = np.zeros(pad_n, dtype=npdt)
    if has_rem:
        rr[:n_rem] = rows[~sel]
        rc[:n_rem] = cols[~sel]
        rv[:n_rem] = P.data[~sel]
    arrays = [as_tensor(a) for a in (fpos.astype(np.int32), w, rr, rc, rv)]
    kw = dict(shifts=tuple(int(s) for s in kept_sorted), n_fine=nf,
              n_coarse=nc, has_rem=has_rem, const_mode=const_mode)
    if const_mode:
        kw["wc"] = as_tensor(wc_np)
        kw["wm"] = as_tensor(wm_np)
    return BandedProlong(*arrays, **kw), BandedRestrict(*arrays, **kw)


def csr_transfer(P: CSRMatrix, dtype=None):
    """General sparse prolongation + transpose restriction off one COO
    array set.  (The JAX package's ``share=False`` form, two ELL
    operators, has no caller and is not ported.)"""
    npdt = np_dtype(dtype)
    nf, nc = P.shape
    nnz = P.nnz
    pad = _round_up(max(nnz, 1), _COO_PAD_ALIGN)
    rows = np.full(pad, nf, dtype=np.int32)
    cols = np.full(pad, nc, dtype=np.int32)
    vals = np.zeros(pad, dtype=npdt)
    rows[:nnz] = np.repeat(np.arange(nf, dtype=np.int32), np.diff(P.indptr))
    cols[:nnz] = P.indices
    vals[:nnz] = P.data
    r, c, v = as_tensor(rows), as_tensor(cols), as_tensor(vals)
    return CooProlong(r, c, v, nf, nc), CooRestrict(r, c, v, nf, nc)
