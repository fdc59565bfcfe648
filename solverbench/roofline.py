"""Peaks of the devices the benchmark knows, and the least bytes a sparse
matrix-vector product has to move.

Peaks are the vendor's published dense rates (NVIDIA H100 SXM data
sheet, at the full 700 W power limit).  A device not in the table has no
roofline: a reader that needs one finds nothing and reports nothing."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12,
                              "fp64_flops_per_s": 34e12},
}


def peak(kind: str, key: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(key)


def spmv_min_bytes(nrows: int, ncols: int, itemsize: int) -> int:
    """The bytes any implementation of y = A x must move: x read once and
    y written once, at ``itemsize``.  The matrix's own values are not
    counted, since a constant band costs no bytes, so this is a lower
    bound whatever format holds the matrix."""
    return itemsize * (int(nrows) + int(ncols))


def share(min_seconds: float, seconds: float) -> float:
    """The least time over the measured time, in percent."""
    return 100.0 * min_seconds / seconds
