"""The port's 2-D stencil apply against the JAX package's two Pallas
kernels (run in interpret mode on the CPU, as the JAX tests run them) and
against the JAX StencilNdOperator, in every coefficient form.

On the CPU the port's wrapper runs the kernel's plain PyTorch version, so
these tests hold that version — the reference the CUDA kernel is checked
against on the card — to the JAX package.  Error metric everywhere:
max|y_port - y_jax| / max|y_jax| (elementwise relative error is
meaningless where a stencil sum cancels to ~0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faspsolver_tpu.ops.operators import StencilNdOperator as JaxStencil
from faspsolver_tpu.ops.pallas_kernels import (StencilSpmv,
                                               const_stencil_apply_2d)
from faspsolver_tpu.precond.amg.band_algebra import BandMatrix as JaxBand
from faspsolver_tpu.testgen import poisson_2d
from faspsolver_tpu_torch.ops import stencil2d
from faspsolver_tpu_torch.ops.operators import (FactoredBand,
                                                StencilNdOperator)
from faspsolver_tpu_torch.precond.amg.band_algebra import BandMatrix

torch.set_num_threads(2)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _full_op(B):
    """Port StencilNdOperator with every band full (K2's form)."""
    items = sorted(B.bands.items())
    return StencilNdOperator([b for _, b in items], [c for c, _ in items],
                             B.dims)


def test_scalar_form_matches_k1_const_stencil_pallas():
    """K1 (const_stencil_spmv_2d_pallas, interpret mode) on the inputs of
    tests/test_operators.py: f32, atol 1e-5."""
    ny, nx = 96, 256
    rng = np.random.default_rng(3)
    x = rng.standard_normal(ny * nx).astype(np.float32)
    coords = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0), (1, 1))
    cvals = np.array([-0.25, -0.24, 1.01, -0.26, -0.23, 0.05], np.float32)
    y_k1 = np.asarray(const_stencil_apply_2d(
        jnp.asarray(cvals[:, None]), coords, (ny, nx), jnp.asarray(x),
        interpret=True))
    op = StencilNdOperator([c.reshape(1, 1) for c in cvals], coords,
                           (ny, nx))
    y = op(torch.from_numpy(x)).numpy()
    assert y.dtype == np.float32
    assert np.abs(y - y_k1).max() < 1e-5


@pytest.mark.parametrize("stencil", ["5pt", "9pt"])
def test_full_form_matches_k2_dia_spmv_pallas(stencil):
    """K2 (dia_spmv_2d_pallas via StencilSpmv, interpret mode) on the
    17x33 inputs of tests/test_structured.py: f64, rtol 1e-12."""
    from faspsolver_tpu.ops import dia_bands_from_csr
    A = poisson_2d(33, 17)
    B = BandMatrix.from_csr(A, (17, 33))
    if stencil == "9pt":
        B = B.pair_rap(0, 2).pair_rap(1, 2)
    offs, flat = B.flat_offsets() if stencil == "9pt" \
        else dia_bands_from_csr(A)
    k2 = StencilSpmv(offs, flat, B.dims, np.float64, tile=8,
                     interpret=True)
    x = np.random.default_rng(7).standard_normal(B.n)
    y_k2 = np.asarray(k2(jnp.asarray(x)))
    y = _full_op(B)(torch.from_numpy(x)).numpy()
    assert _rel(y, y_k2) < 1e-12


def _galerkin_levels():
    """A 5-point fine level and its 9-point SA Galerkin coarse level with
    ragged aggregates (191 -> 64, 127 -> 43)."""
    A = poisson_2d(191, 127)
    B = BandMatrix.from_csr(A, (127, 191))
    d = B.diagonal()
    Bc = B.smoothed_rap_all_axes(1.0 / d, 0.67, 3)
    assert Bc is not None and Bc.dims == (43, 64)
    return {"5pt": B, "9pt": Bc}


LEVELS = _galerkin_levels()


@pytest.mark.parametrize("form", ["factored", "full"])
@pytest.mark.parametrize("stencil", ["5pt", "9pt"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-6)])
def test_matches_jax_stencil_operator(form, stencil, dtype, tol):
    """The port's StencilNdOperator (built by the port's band algebra)
    against the JAX StencilNdOperator of the same band matrix; factored
    bands (the main path's form) and full bands."""
    B = LEVELS[stencil]
    jB = JaxBand(B.dims, dict(B.bands))
    gain = 4.0 if form == "factored" else 1e12
    port = B.to_stencil_operator(dtype, min_gain=gain)
    ref = jB.to_stencil_operator(dtype, min_gain=gain)
    n_fac = sum(isinstance(b, FactoredBand) for b in port.bands)
    assert n_fac == (len(port.bands) if form == "factored" else 0)
    x = np.random.default_rng(11).standard_normal(B.n).astype(dtype)
    y_ref = np.asarray(JaxStencil(
        tuple(jnp.asarray(b) if isinstance(b, np.ndarray) else
              type(b)(*(jnp.asarray(a) for a in (b.row_sel, b.core,
                                                   b.col_sel)))
              for b in ref.bands), ref.coords, ref.dims)(jnp.asarray(x)))
    y = port(torch.from_numpy(x)).numpy()
    assert y.dtype == dtype
    assert _rel(y, y_ref) < tol


def test_plain_version_takes_cpu_tensors_only():
    """The wrapper picks the plain version because the tensor lies on the
    CPU; on any other non-CUDA device it raises instead of falling back."""
    B = LEVELS["9pt"]
    op = B.to_stencil_operator(np.float64)
    before = dict(stencil2d.launches)
    op(torch.zeros(B.n, dtype=torch.float64))
    assert stencil2d.launches == before and stencil2d._lib is None
    with pytest.raises(ValueError, match="device"):
        op.plan()(torch.zeros(B.n, dtype=torch.float64, device="meta"))


def test_kernel_does_not_cover_3d_or_wide_offsets():
    """3-D stencils and offsets beyond {-1,0,1}^2 take the operator's
    explicit plain path (decided from structure), matching the JAX
    operator."""
    from faspsolver_tpu.testgen import poisson_3d
    A = poisson_3d(6, 5, 4)
    B = BandMatrix.from_csr(A, (4, 5, 6))
    op = B.to_stencil_operator(np.float64)
    assert not op._kernel
    wide = StencilNdOperator([np.ones((1, 1))], ((0, 2),), (3, 5))
    assert not wide._kernel
    x = np.random.default_rng(2).standard_normal(A.nrow)
    np.testing.assert_allclose(op(torch.from_numpy(x)).numpy(),
                               A.matvec(x), rtol=1e-12)
    xw = np.arange(15.0)
    yw = wide(torch.from_numpy(xw)).numpy().reshape(3, 5)
    np.testing.assert_array_equal(yw[:, :3], xw.reshape(3, 5)[:, 2:])
    np.testing.assert_array_equal(yw[:, 3:], 0.0)


# ---------------------------------------------------------------------------
# the tiled kernel's arithmetic, walked in plain PyTorch
# ---------------------------------------------------------------------------

COORDS = {5: ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)),
          7: ((-1, -1), (-1, 0), (0, -1), (0, 0), (0, 1), (1, 0), (1, 1)),
          9: tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))}


def _bands(form, dims, k, dtype, rng):
    """k Band2d of one form.  "factored" cycles through every layout a
    FactoredBand produces: indexed rows over (r, nx) and (r, 1), a
    (1, nx) row vector and a scalar."""
    ny, nx = dims

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    out = []
    for b in range(k):
        if form == "scalar":
            out.append(stencil2d.Band2d(t(1, 1), None,
                                        stencil2d.ROW_BROADCAST, 0))
        elif form == "full":
            out.append(stencil2d.full_band(t(ny, nx), dims))
        else:
            r = 3
            rows = torch.from_numpy(rng.integers(0, r, ny).astype(np.int32))
            out.append([
                stencil2d.Band2d(t(r, nx), rows, stencil2d.ROW_INDEXED, 1),
                stencil2d.Band2d(t(r, 1), rows, stencil2d.ROW_INDEXED, 0),
                stencil2d.Band2d(t(1, nx), None, stencil2d.ROW_BROADCAST, 1),
                stencil2d.Band2d(t(1, 1), None, stencil2d.ROW_BROADCAST, 0),
            ][b % 4])
    return out


# ragged and degenerate grids; 37x300 has TY, TX dividing neither extent
TILED_DIMS = [(1, 1), (1, 33), (17, 33), (8, 1023), (1023, 7), (37, 300)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("form", ["scalar", "factored", "full"])
@pytest.mark.parametrize("dims", TILED_DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_tiled_walk_is_bit_equal_to_plain(dims, form, dtype):
    """The kernel's tiles, staged windows (zero-filled halo) and block
    walk, in plain PyTorch, reproduce stencil2d_plain bit for bit, on one
    SM (blocks walk many tiles) and on 132 (one tile each or none)."""
    rng = np.random.default_rng(dims[0] * 1000 + dims[1])
    x = torch.from_numpy(rng.standard_normal(dims)).to(dtype)
    for k in (5, 9):
        bands = _bands(form, dims, k, dtype, rng)
        ref = stencil2d.stencil2d_plain(x, bands, COORDS[k])
        for sms in (1, 132):
            til = stencil2d.stencil_tiling(dims, dtype.itemsize, sms)
            got = stencil2d.stencil2d_tiled_plain(x, bands, COORDS[k], til)
            assert got.dtype == dtype and torch.equal(got, ref)


@pytest.mark.parametrize("dims", TILED_DIMS + [(1023, 1023), (341, 341),
                                               (8192, 8192)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_launch_geometry(dims, sms):
    """The grid never exceeds the SM-derived cap nor the tile count, the
    blocks' walks partition the tiles, the tiles partition the grid, and
    the window buffers fit a block's shared memory."""
    til = stencil2d.stencil_tiling(dims, 8, sms)
    assert 1 <= til.grid <= min(til.tiles, sms * stencil2d.BLOCKS_PER_SM)
    assert til.smem_bytes <= 227 * 1024
    walked = sorted(t for b in range(til.grid) for t in til.block_tiles(b))
    assert walked == list(range(til.tiles))
    rows = [til.tile(tj * til.tiles_x)[:2] for tj in range(til.tiles_y)]
    cols = [til.tile(t)[2:] for t in range(til.tiles_x)]
    for spans, extent, size in ((rows, dims[0], til.ty),
                                (cols, dims[1], til.tx)):
        assert spans[0][0] == 0 and spans[-1][1] == extent
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(0 < hi - lo <= size for lo, hi in spans)


def test_window_zero_fills_the_halo():
    """A corner tile's staged window: x inside the grid, zeros outside."""
    x = torch.arange(1.0, 1.0 + 20 * 130).reshape(20, 130)
    til = stencil2d.stencil_tiling((20, 130), 4, 132)
    assert (til.tiles_y, til.tiles_x) == (2, 2)
    win = til.window(x, 3)                     # rows 16.., columns 128..
    assert win.shape == (til.ty + 2, til.tx + 2)
    assert torch.equal(win[:5, :3], x[15:20, 127:130])
    assert float(win[5:].abs().sum()) == 0 and float(win[:, 3:].abs().sum()) == 0
    first = til.window(x, 0)
    assert float(first[0].abs().sum()) == 0 and float(first[:, 0].abs().sum()) == 0
    assert torch.equal(first[1:, 1:], x[:17, :129])


def _plan_bands(form, dims, k, dtype=torch.float32):
    return _bands(form, dims, k, dtype, np.random.default_rng(0))


# bytes and bound worked by hand: 2 n itemsize (+ k n itemsize for full
# bands) over 3.35 TB/s; factored and scalar coefficients are kilobytes
# (0.5% of the bytes at 1023^2, 4% at 341^2 with 9 bands; tolerance 5%)
BOUNDS = [
    ((1023, 1023), torch.float32, "factored", 5, 8.37e6, 2.50),
    ((1023, 1023), torch.float32, "factored", 7, 8.37e6, 2.50),
    ((341, 341), torch.float32, "factored", 9, 0.93e6, 0.28),
    ((1023, 1023), torch.float64, "factored", 5, 16.74e6, 5.00),
    ((1023, 1023), torch.float64, "factored", 7, 16.74e6, 5.00),
    ((1023, 1023), torch.float32, "full", 5, 29.30e6, 8.75),
    ((1023, 1023), torch.float64, "full", 5, 58.61e6, 17.5),
    ((4096, 4096), torch.float32, "scalar", 5, 134.2e6, 40.1),
]


@pytest.mark.parametrize("dims,dtype,form,k,nbytes,us", BOUNDS)
def test_stencil_bound(dims, dtype, form, k, nbytes, us):
    got = stencil2d.stencil_bound_us(dims, dtype,
                                     _plan_bands(form, dims, k, dtype))
    assert got.by == "bytes" and got.flops == 2 * k * dims[0] * dims[1]
    assert nbytes * 0.995 <= got.bytes <= nbytes * 1.05
    assert got.us == pytest.approx(got.bytes / 3.35e6, rel=1e-12)
    assert us * 0.995 <= got.us <= us * 1.05


def test_stencil_bound_of_the_large_grid():
    """8192^2 scalar 5-point f32: 536.9 MB, 160.3 us (no array is built:
    the bound reads shapes only)."""
    bands = _plan_bands("scalar", (1, 1), 5)
    got = stencil2d.stencil_bound_us((8192, 8192), torch.float32, bands)
    assert got.bytes == pytest.approx(536.9e6, rel=1e-3)
    assert got.us == pytest.approx(160.3, rel=1e-3)


def test_unsorted_offsets_go_through_the_kernel():
    """Bands in any order of offsets, repeated offsets too, are in the
    kernel's domain: the operator applies through its plan (the kernel on
    the card), and the tiled walk accumulates them in the order given."""
    assert stencil2d.kernel_covers(COORDS[7], (4, 5))
    assert stencil2d.kernel_covers(((0, 1), (0, 0)), (4, 5))
    assert stencil2d.kernel_covers(((0, 0), (0, 0)), (4, 5))
    rng = np.random.default_rng(5)
    bands = [rng.standard_normal((4, 5)) for _ in range(2)]
    op = StencilNdOperator(bands, ((0, 1), (0, 0)), (4, 5))
    assert op._kernel
    ref = StencilNdOperator(bands[::-1], ((0, 0), (0, 1)), (4, 5))
    x = torch.from_numpy(rng.standard_normal(20))
    np.testing.assert_allclose(op(x).numpy(), ref(x).numpy(), rtol=1e-14)
    dims = (37, 300)
    x2 = torch.from_numpy(rng.standard_normal(dims))
    for coords in (((0, 1), (0, 0), (-1, 0)),
                   ((0, 0), (1, 1), (0, 0), (-1, -1))):
        for form in ("scalar", "factored", "full"):
            b2 = _bands(form, dims, len(coords), torch.float64, rng)
            plan = stencil2d.StencilPlan(b2, coords, dims)
            want = stencil2d.stencil2d_plain(x2, b2, coords)
            til = stencil2d.stencil_tiling(dims, 8, 132)
            assert torch.equal(
                stencil2d.stencil2d_tiled_plain(x2, b2, coords, til), want)
            assert torch.equal(plan(x2.reshape(-1)), want.reshape(-1))
