"""Device operator for structured-grid banded block (STR) matrices (port
of ``faspsolver_tpu/ops/str_ops.py``).

Reference: dSTRmat (fasp.h:316-348) and fasp_blas_dstr_mxv
(BlaSpmvSTR.c).  Each band is a dense (ngrid, nc, nc) array, and the
SpMV is a sum of statically shifted batched block products: no gather.
Plain PyTorch; the JAX package computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import as_tensor, torch_dtype
from ..formats.str_grid import STRMatrix
from .operators import _buf, block_diag_apply


class StrOperator(nn.Module):
    """Banded block operator: y_g = diag_g x_g + sum_b band_b[g]
    x_{g+off_b}.  The bands are buffers (``diag``, ``band0``, ...); each
    band is one batched (nc, nc) x (nc,) product over a shifted slice
    (:func:`~.operators.block_diag_apply`, TF32 off) added into a slice
    of y.  The shifts are Python ints fixed at construction, so the apply
    reads nothing back to the host."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, diag, bands: Sequence, offsets: Sequence[int],
                 ng: int, nc: int):
        super().__init__()
        self.register_buffer("diag", _buf(diag))
        self._nb = len(bands)
        for k, b in enumerate(bands):
            self.register_buffer(f"band{k}", _buf(b))
        self.offsets = tuple(int(o) for o in offsets)
        self.ng = int(ng)
        self.nc = int(nc)

    @property
    def bands(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"band{k}") for k in range(self._nb))

    @property
    def shape(self) -> Tuple[int, int]:
        n = self.ng * self.nc
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ng = self.ng
        xb = x.reshape(ng, self.nc)
        y = block_diag_apply(self.diag, xb)
        for off, band in zip(self.offsets, self.bands):
            if off > 0:
                y[:ng - off] += block_diag_apply(band[:ng - off], xb[off:])
            else:
                k = -off
                y[k:] += block_diag_apply(band[k:], xb[:ng - k])
        return y.reshape(-1)

    def diag_inv(self) -> torch.Tensor:
        """(ng, nc, nc) inverses of the diagonal blocks, computed on the
        host in float64 as in the reference's setup
        (fasp_generate_diaginv_block)."""
        d = self.diag.detach().cpu().numpy().astype(np.float64)
        return as_tensor(np.linalg.inv(d), self.dtype).to(self.diag.device)

    @classmethod
    def from_str(cls, A: STRMatrix, dtype=None) -> "StrOperator":
        dtype = torch_dtype(dtype)
        return cls(as_tensor(A.diag, dtype),
                   [as_tensor(b, dtype) for b in A.offdiag],
                   A.offsets, A.ngrid, A.nc)
