"""2-D stencil apply ``y = A x``: the CUDA kernel, its plain PyTorch
version, and the launch counter.

The kernel (``csrc/stencil2d.cu``) replaces both Pallas TPU kernels of
``faspsolver_tpu/ops/pallas_kernels.py`` — ``const_stencil_spmv_2d_pallas``
(scalar bands) and ``dia_spmv_2d_pallas`` (full bands) — and also takes the
factored bands of ``ops.operators.FactoredBand``, which is what the
structured hierarchy's large levels and its f64 fine operator carry.

Every band is described by one :class:`Band2d`:
``c(i, j) = w[row(i), j * cstride]`` with ``row(i)`` = 0 (broadcast), i
(full band) or ``rows[i]`` (factored).  :class:`StencilPlan` holds an
operator's bands and offsets; calling it on a CPU tensor runs
:func:`stencil2d_plain`, on a CUDA tensor launches the kernel (or raises).
There is no fallback from one to the other.

The kernel is tiled: persistent blocks walk ``TY x TX`` tiles of the
grid, staging each tile's ``(TY+2) x (TX+2)`` window of x in shared
memory.  All of that arithmetic lives here, in :class:`StencilTiling`:
the wrapper sizes the launch from it, the C entry checks the tile counts
it is handed against its own constants, and :func:`stencil2d_tiled_plain`
walks exactly those tiles in plain PyTorch, so the CPU tests hold the
tiling (coverage, halo zero-fill, the walk of a block) bit-equal to
:func:`stencil2d_plain` where no CUDA compiler exists.

The library is compiled with nvcc at the first CUDA launch into the
port's build directory; importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils.build import build_shared

MAX_BANDS = 9
ROW_BROADCAST, ROW_IDENTITY, ROW_INDEXED = 0, 1, 2

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "stencil2d.cu")

# The kernel's tile: a block of TX x NTY threads owns TY = R * NTY rows by
# TX columns, each thread R consecutive rows of one column.  The grid is
# capped at BLOCKS_PER_SM blocks per SM, and MIN_BLOCKS is the occupancy
# ptxas is asked to leave registers for, by item size.  These are handed
# to nvcc as -D flags (``_nvcc``) and the entry checks the tile counts it
# is given, so the kernel and this module cannot disagree.  They are the
# best of tools/stencil2d_tune.py's sweep on an NVIDIA H100 80GB HBM3
# (700 W) that spills nothing.  STAGES and RIDX_PITCH mirror constants of
# the kernel for the shared-memory size: window buffers per block, and
# staged row indices per tile row (>= MAX_BANDS, a multiple of 16 bytes).
TX, R, NTY, BLOCKS_PER_SM = 128, 8, 2, 4
MIN_BLOCKS = {4: 4, 8: 2}
STAGES, RIDX_PITCH = 2, 12

# published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and
# non-tensor-core FLOP/s by item size
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}

# kernel launches per dtype; incremented only where a launch is issued
launches = {torch.float32: 0, torch.float64: 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclass(frozen=True)
class Band2d:
    """Coefficients of one band: ``c(i, j) = w[row(i), j * cstride]``."""

    w: torch.Tensor                    # (rows, 1) or (rows, nx), contiguous
    rows: Optional[torch.Tensor]       # (ny,) int32 when rmode == ROW_INDEXED
    rmode: int
    cstride: int

    def coef(self) -> torch.Tensor:
        """The coefficient grid, broadcastable to (ny, nx)."""
        if self.rmode == ROW_INDEXED:
            return self.w.index_select(0, self.rows)
        if self.rmode == ROW_IDENTITY:
            return self.w
        return self.w[:1]


def full_band(b: torch.Tensor, dims: Tuple[int, int]) -> Optional[Band2d]:
    """Band2d of a raw band array of shape (1|ny, 1|nx), else None."""
    ny, nx = dims
    if b.dim() != 2 or b.shape[0] not in (1, ny) or b.shape[1] not in (1, nx):
        return None
    rmode = ROW_IDENTITY if (b.shape[0] == ny and ny > 1) else ROW_BROADCAST
    return Band2d(b, None, rmode, 1 if b.shape[1] > 1 else 0)


def kernel_covers(coords, dims) -> bool:
    """Offsets and grid the kernel takes: 2-D, at most 9 bands, each
    offset in {-1, 0, 1}^2, in any order."""
    return (len(dims) == 2 and 1 <= len(coords) <= MAX_BANDS
            and all(len(c) == 2 and abs(c[0]) <= 1 and abs(c[1]) <= 1
                    for c in coords))


def stencil2d_plain(x2d: torch.Tensor, bands: Sequence[Band2d],
                    coords) -> torch.Tensor:
    """Plain PyTorch version: shifted multiply-adds over the zero-padded
    grid, accumulated in band order (the order of the JAX operator)."""
    ny, nx = x2d.shape
    xp = F.pad(x2d, (1, 1, 1, 1))
    y = torch.zeros_like(x2d)
    for b, (dy, dx) in zip(bands, coords):
        y = y + b.coef() * xp[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
    return y


@dataclass(frozen=True)
class StencilTiling:
    """Launch geometry of the tiled kernel on an (ny, nx) grid.

    Tile ``t`` (row-major over ``tiles_y x tiles_x``) owns rows
    ``[i0, i1)`` and columns ``[j0, j1)``; its staged window is the
    ``(ty + 2) x (tx + 2)`` block of x that starts at ``(i0 - 1, j0 - 1)``,
    zero wherever it leaves the grid.  Block ``b`` of ``grid`` persistent
    blocks walks tiles ``b, b + grid, b + 2 grid, ...``."""

    ny: int
    nx: int
    ty: int
    tx: int
    grid: int
    smem_bytes: int

    @property
    def tiles_y(self) -> int:
        return -(-self.ny // self.ty)

    @property
    def tiles_x(self) -> int:
        return -(-self.nx // self.tx)

    @property
    def tiles(self) -> int:
        return self.tiles_y * self.tiles_x

    def tile(self, t: int) -> Tuple[int, int, int, int]:
        """(i0, i1, j0, j1) of tile ``t``, clipped to the grid."""
        ti, tj = divmod(t, self.tiles_x)
        i0, j0 = ti * self.ty, tj * self.tx
        return (i0, min(i0 + self.ty, self.ny), j0,
                min(j0 + self.tx, self.nx))

    def block_tiles(self, b: int) -> range:
        return range(b, self.tiles, self.grid)

    def window(self, x2d: torch.Tensor, t: int) -> torch.Tensor:
        """Tile ``t``'s staged window of ``x2d``: what the kernel's copy
        leaves in shared memory."""
        i0, _, j0, _ = self.tile(t)
        win = x2d.new_zeros((self.ty + 2, self.tx + 2))
        a0, a1 = max(i0 - 1, 0), min(i0 + self.ty + 1, self.ny)
        b0, b1 = max(j0 - 1, 0), min(j0 + self.tx + 1, self.nx)
        win[a0 - i0 + 1:a1 - i0 + 1, b0 - j0 + 1:b1 - j0 + 1] = \
            x2d[a0:a1, b0:b1]
        return win


def stencil_tiling(dims, itemsize: int, sm_count: int) -> StencilTiling:
    """The kernel's tiling of ``dims``: one wave of at most
    ``BLOCKS_PER_SM`` persistent blocks per SM, never more blocks than
    tiles.  Shared memory per block: STAGES windows of x plus, per stage,
    one row index per band and tile row (staged only where a coefficient
    varies along y)."""
    ny, nx = int(dims[0]), int(dims[1])
    if ny < 1 or nx < 1 or sm_count < 1:
        raise ValueError(f"grid {dims} on {sm_count} SMs")
    ty = R * NTY
    smem = STAGES * ((ty + 2) * (TX + 2) * itemsize + RIDX_PITCH * ty * 4)
    til = StencilTiling(ny, nx, ty, TX, 1, smem)
    grid = min(til.tiles, sm_count * BLOCKS_PER_SM)
    return StencilTiling(ny, nx, ty, TX, grid, smem)


def stencil2d_tiled_plain(x2d: torch.Tensor, bands: Sequence[Band2d],
                          coords, tiling: StencilTiling) -> torch.Tensor:
    """The kernel's walk in plain PyTorch: every block's tiles in turn,
    each computed from its staged window alone, bands accumulated in
    order.  Bit-equal to :func:`stencil2d_plain`; raises if the walk does
    not write every output exactly once."""
    ny, nx = x2d.shape
    if (ny, nx) != (tiling.ny, tiling.nx):
        raise ValueError(f"x is {ny}x{nx}, tiling is for "
                         f"{tiling.ny}x{tiling.nx}")
    y = torch.full_like(x2d, float("nan"))
    written = torch.zeros((ny, nx), dtype=torch.int32)
    coefs = [torch.broadcast_to(b.coef(), (ny, nx)) for b in bands]
    for blk in range(tiling.grid):
        for t in tiling.block_tiles(blk):
            i0, i1, j0, j1 = tiling.tile(t)
            win = tiling.window(x2d, t)
            acc = torch.zeros((i1 - i0, j1 - j0), dtype=x2d.dtype)
            for c, (dy, dx) in zip(coefs, coords):
                acc = acc + c[i0:i1, j0:j1] * win[
                    1 + dy:1 + dy + i1 - i0, 1 + dx:1 + dx + j1 - j0]
            y[i0:i1, j0:j1] = acc
            written[i0:i1, j0:j1] += 1
    if not bool((written == 1).all()):
        raise RuntimeError("tiling does not cover every output exactly once")
    return y


class StencilBound(NamedTuple):
    """Least time one apply could take on the card."""

    bytes: int          # x read once, y written once, coefficients once
    flops: int          # one multiply and one add per band and output
    us: float           # the larger of bytes / HBM rate and flops / peak
    by: str             # "bytes" or "operations"


def stencil_bound_us(dims, dtype: torch.dtype,
                     bands: Sequence[Band2d]) -> StencilBound:
    """Roofline bound of ``y = A x`` for these bands on one H100 SXM:
    every input byte read once (x, each band's coefficient array, the row
    index of a factored band), every output byte written once, against
    ``HBM_BYTES_PER_S``; 2 k flops per output against ``PEAK_FLOPS``."""
    n = int(dims[0]) * int(dims[1])
    item = dtype.itemsize
    nbytes = 2 * n * item
    for b in bands:
        nbytes += b.w.numel() * item
        if b.rmode == ROW_INDEXED:
            nbytes += b.rows.numel() * 4
    flops = 2 * len(bands) * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_flops = flops / PEAK_FLOPS[item] * 1e6
    return StencilBound(nbytes, flops, max(t_bytes, t_flops),
                        "bytes" if t_bytes >= t_flops else "operations")


_lib: Optional[ctypes.CDLL] = None


def _nvcc(sources, out):
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-Xptxas", "-v", f"-DFASP_TX={TX}", f"-DFASP_R={R}",
            f"-DFASP_NTY={NTY}",
            f"-DFASP_MIN_BLOCKS_F32={MIN_BLOCKS[4]}",
            f"-DFASP_MIN_BLOCKS_F64={MIN_BLOCKS[8]}", "-shared",
            "-Xcompiler", "-fPIC", "-o", out, *sources]


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_shared("stencil2d", [SOURCE], _nvcc))
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
        for name in ("fasp_stencil2d_f32", "fasp_stencil2d_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        lib.fasp_cuda_error_string.restype = ctypes.c_char_p
        lib.fasp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fasp_stencil2d_empty.restype = ctypes.c_int
        lib.fasp_stencil2d_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def launch_empty(grid: int, device) -> None:
    """One launch of an empty kernel with the stencil kernel's block size
    on ``grid`` blocks: what a launch alone costs on this card (a
    measurement aid, not counted in ``launches``)."""
    lib = library()
    err = lib.fasp_stencil2d_empty(
        int(grid), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("empty-kernel launch failed: "
                           + lib.fasp_cuda_error_string(err).decode())


class StencilPlan:
    """An operator's bands and offsets, ready to apply on either device.

    The launch arguments (device pointers, packed metadata, the tiling
    for the device's SM count) are built once, at the first CUDA call;
    the owning module drops its plan when its buffers move
    (``nn.Module._apply``)."""

    def __init__(self, bands: Sequence[Band2d], coords, dims):
        if not kernel_covers(coords, dims) or len(bands) != len(coords):
            raise ValueError(f"stencil kernel does not cover coords "
                             f"{coords} on grid {dims}")
        self.bands = tuple(bands)
        self.coords = tuple(tuple(int(v) for v in c) for c in coords)
        self.dims = (int(dims[0]), int(dims[1]))
        self._args = None

    def _launch_args(self, x: torch.Tensor):
        if self._args is not None:
            return self._args
        k = len(self.bands)
        meta = []
        for b, (dy, dx) in zip(self.bands, self.coords):
            if b.w.device != x.device or b.w.dtype != x.dtype:
                raise ValueError(f"band on {b.w.device}/{b.w.dtype}, "
                                 f"x on {x.device}/{x.dtype}")
            if not b.w.is_contiguous() or b.w.dim() != 2:
                raise ValueError("band coefficients must be a contiguous "
                                 "2-D array")
            need = (self.dims[0] if b.rmode == ROW_IDENTITY else 1,
                    self.dims[1] if b.cstride else 1)
            if b.w.shape[0] < need[0] or b.w.shape[1] < need[1]:
                raise ValueError(f"band of shape {tuple(b.w.shape)} does "
                                 f"not cover grid {self.dims}")
            if b.rmode == ROW_INDEXED and (
                    b.rows.device != x.device or b.rows.dtype != torch.int32
                    or not b.rows.is_contiguous()
                    or b.rows.numel() != self.dims[0]):
                raise ValueError("row index must be contiguous int32 (ny,) "
                                 "on the device of x")
            meta += [b.w.shape[1], b.cstride, b.rmode, dy, dx]
        # launch geometry after the bands: grid and tile counts
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        til = stencil_tiling(self.dims, x.dtype.itemsize, sms)
        meta += [til.grid, til.tiles_y, til.tiles_x]
        w = (ctypes.c_void_p * k)(*[b.w.data_ptr() for b in self.bands])
        rows = (ctypes.c_void_p * k)(*[
            b.rows.data_ptr() if b.rmode == ROW_INDEXED else 0
            for b in self.bands])
        meta_c = (ctypes.c_int * len(meta))(*meta)
        self._args = (x.device, x.dtype, w, rows, meta_c)
        return self._args

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ny, nx = self.dims
        if x.numel() != ny * nx:
            raise ValueError(f"x has {x.numel()} entries, grid is {ny}x{nx}")
        if x.device.type == "cpu":
            return stencil2d_plain(x.reshape(ny, nx), self.bands,
                                   self.coords).reshape(-1)
        if x.device.type != "cuda":
            raise ValueError(f"no stencil kernel for device {x.device}")
        if x.dtype not in launches or not x.is_contiguous():
            raise ValueError(f"stencil kernel takes contiguous f32/f64, "
                             f"got {x.dtype}")
        lib = library()
        dev, dt, w, rows, meta = self._launch_args(x)
        if dev != x.device or dt != x.dtype:
            raise ValueError(f"plan built for {dev}/{dt}, x on "
                             f"{x.device}/{x.dtype}")
        y = torch.empty_like(x)
        fn = (lib.fasp_stencil2d_f32 if x.dtype == torch.float32
              else lib.fasp_stencil2d_f64)
        err = fn(x.data_ptr(), y.data_ptr(), ny, nx, len(self.bands), w,
                 rows, meta, torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError("stencil2d launch failed: "
                               + lib.fasp_cuda_error_string(err).decode())
        launches[x.dtype] += 1
        return y
