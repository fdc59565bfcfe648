"""Sparsity-pattern and grid visualization: 16-color BMP writers.

Reference: base/src/AuxGraphics.c — fasp_dcsr_plot / fasp_dcsr_subplot
(matrix "spy" plots) and fasp_grid2d_plot, all written through write_bmp16.
Observability tooling: dump what a matrix or a grid looks like without any
plotting dependency.
"""
from __future__ import annotations

import struct

import numpy as np

# classic 16-color VGA-ish palette (B, G, R, 0), matching the reference's
# 16-color BMP scheme (AuxGraphics.c write_bmp16)
_PALETTE = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
    (0, 0, 128), (128, 0, 128), (0, 128, 128), (192, 192, 192),
    (128, 128, 128), (255, 0, 0), (0, 255, 0), (255, 255, 0),
    (0, 0, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255),
]


def write_bmp16(path: str, image: np.ndarray) -> None:
    """Write a (h, w) array of palette indices (0..15) as a 4-bit BMP
    (reference: write_bmp16, AuxGraphics.c)."""
    img = np.asarray(image, dtype=np.uint8)
    h, w = img.shape
    row_bytes = ((w + 1) // 2 + 3) & ~3          # 4bpp rows padded to 4B
    data_size = row_bytes * h
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", 14 + 40 + 64 + data_size, 0, 0,
                            14 + 40 + 64))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 4, 0, data_size,
                            2835, 2835, 16, 16))
        for b, g, r in _PALETTE:
            f.write(struct.pack("<BBBB", b, g, r, 0))
        row = bytearray(row_bytes)
        for y in range(h - 1, -1, -1):           # bottom-up
            row[:] = b"\x00" * row_bytes
            line = img[y]
            for x in range(w):
                if x % 2 == 0:
                    row[x // 2] = (line[x] & 0xF) << 4
                else:
                    row[x // 2] |= line[x] & 0xF
            f.write(bytes(row))


def spy_plot(path: str, A, size: int = 200) -> None:
    """Sparsity-pattern BMP of a CSR matrix (reference: fasp_dcsr_plot,
    AuxGraphics.c): white background, blue nonzeros, red diagonal."""
    n, m = A.shape
    size = min(size, max(n, m))
    img = np.full((size, size), 15, dtype=np.uint8)       # white
    rows = np.repeat(np.arange(n), A.row_nnz())
    cols = np.asarray(A.indices)
    yi = (rows * size // max(n, 1)).astype(np.int64)
    xi = (cols * size // max(m, 1)).astype(np.int64)
    img[yi, xi] = 12                                      # blue
    d = rows == cols
    img[yi[d], xi[d]] = 9                                 # red diagonal
    write_bmp16(path, img)


def spy_subplot(path: str, A, row0: int, row1: int, col0: int, col1: int,
                size: int = 200) -> None:
    """Spy plot of a sub-block (reference: fasp_dcsr_subplot)."""
    sub = A.get_block(np.arange(row0, row1), np.arange(col0, col1))
    spy_plot(path, sub, size=size)


def grid2d_plot(path: str, values: np.ndarray, shape, levels: int = 14
                ) -> None:
    """Color-mapped 2D grid plot (reference: fasp_grid2d_plot): bin the
    field into the 16-color palette."""
    v = np.asarray(values, dtype=np.float64).reshape(shape)
    lo, hi = float(v.min()), float(v.max())
    scale = (levels - 1) / (hi - lo) if hi > lo else 0.0
    img = (1 + (v - lo) * scale).astype(np.uint8)
    write_bmp16(path, img)
