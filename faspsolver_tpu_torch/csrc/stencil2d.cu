// stencil2d.cu — y = A x for a 2-D stencil operator on a (ny, nx) grid.
//
//   y[i,j] = sum_b c_b(i,j) * x[i + dy_b, j + dx_b],   x = 0 off the grid,
//
// with per-band offsets (dy, dx) in {-1, 0, 1}^2, at most 9 bands in any
// order (an offset may repeat), accumulated in the order given.
//
// Replaces the two Pallas TPU kernels of faspsolver_tpu/ops/pallas_kernels.py:
//   K1 const_stencil_spmv_2d_pallas (scalar coefficients in SMEM), and
//   K2 dia_spmv_2d_pallas           (full row-aligned (k, ny, nx) bands).
// One coefficient representation covers both and the factored bands the
// structured AMG hierarchy actually carries (ops/operators.py FactoredBand):
//
//   c_b(i,j) = w_b[row_b(i) * ldw_b + j * cstride_b]
//   row_b(i) = 0 (rmode 0, broadcast) | i (rmode 1, full band)
//            | rows_b[i] (rmode 2, factored: index of the 1 in row_sel's row i)
//
// scalar: w (1,1), rmode 0, cstride 0.   full: w (ny,nx), rmode 1, ldw nx.
// factored: w = core @ col_sel, (r, nx) or (r, 1); rmode 2 (or 0 if r == 1).
//
// What bounds it on an H100, by regime.  The work is 2 k flops per output
// against 2 (scalar, factored) or 2 + k (full) values moved, so it is bound
// by bytes everywhere.
//  * 1023^2 (the solver's fine level): x and y are 8 MB in f32, inside the
//    50 MB L2.  The transfer itself is 2.5 us at the HBM rate, about what a
//    launch costs, so the kernel is bound by the launch floor plus the
//    latency of one round of loads out of L2.  What matters is that every
//    SM has all its loads in flight at once and that the grid is one wave.
//  * 8192^2 (268 MB per vector, where the JAX package dispatches K1): HBM
//    streaming.  What matters is enough bytes in flight per SM (about
//    15 KB by Little's law at 3.35 TB/s) and no byte fetched twice from HBM.
//  * full bands: the coefficients are k/(2+k) of the bytes and are used
//    once each; they stream at either size.
//
// The design.
//  1. Tiles staged in shared memory.  A block of TX x NTY threads owns a
//     tile of TY = R * NTY rows by TX columns and stages the tile's
//     (TY+2) x (TX+2) window of x once, writing zeros where the window
//     leaves the grid, so the arithmetic has no bounds tests and each x
//     value is fetched from L2/HBM once per tile, not once per band.
//  2. Asynchronous copy, two stages.  The window is staged with cp.async
//     of one element (4 or 8 bytes), and while a block computes tile t from
//     one buffer the copy of its next tile fills the other.  Why not wider
//     or bulk copies: a row of the solver's grid is 1023 elements, so row
//     starts are not 16-byte aligned and neither 16-byte cp.async nor a
//     2-D TMA tensor map (row pitch must be a multiple of 16 bytes) nor a
//     1-D cp.async.bulk per row (16-byte aligned source) applies without
//     padding the solver's vectors; a tile spans whole rows only for
//     nx <= TX, where the whole problem is a launch-bound few KB.  One
//     warp instruction of element copies still moves a full 128-byte (f32)
//     line.  Two alternatives were built and measured slower on the card
//     (PERF.md): 16-byte copies into rows stored shifted by their own
//     misalignment (more instructions around fewer copies), and dealing
//     the window's elements evenly over the threads instead of rows to
//     warps (an integer division per element).
//  3. Register blocking along y.  Each thread computes R consecutive rows
//     of one column: R independent accumulators, so that the loads of one
//     row overlap the arithmetic of another.  Rows of a ragged last tile
//     that lie below the grid are computed too (their window rows are
//     staged zeros and their row indices 0) and only their store is
//     predicated off, so the row loop has no branch to wait at.
//     x is read from the staged window at each band's offset, K
//     shared-memory reads per output, and not carried in a 3 x 3 register
//     window: the offsets are run-time values in the caller's order, and a
//     register window must be indexed at compile time.  Both ways round
//     that were built and measured on an NVIDIA H100 80GB HBM3 (700 W;
//     PERF.md), and neither was kept.  (a) A second kernel for y-constant
//     coefficients that walks the nine window positions (band order only
//     for sorted offsets): on the scalar 5-point stencil 4.9 us against
//     this kernel's 4.7 at 1023^2 f32, 6.9 against 6.3 in f64, 233
//     against 234 at 8192^2, and 232 against 217 on a 1-band copy there.
//     (b) This kernel band-major, the thread's (R + 2) x 3 window in
//     registers and a 9-way uniform branch per band choosing the
//     position: 106-200 registers without spills, 7.2 us against 5.1 on
//     the 1023^2 factored f32 operator.
//  4. Coefficients hoisted.  The band count K and whether any coefficient
//     varies along y (PerRow) are template parameters, set by the entry
//     from the bands, and the row loop is straight-line code: a first
//     version that tested each band's kind there, at run time, ran at
//     12-14 us at 1023^2 because every load sat in its own branch and
//     waited for the one before it (and with PerRow a run-time flag ptxas
//     spilled in up to three f32 instantiations).
//     * PerRow = false (K1's scalars, (1, nx) row vectors): the K
//       coefficients of the thread's column are loaded before the wait on
//       the tile's copy, no row index is staged, and the row loop is a
//       shared-memory read and a multiply-add per band.
//     * PerRow = true (K2's full bands, factored bands): each band's kind
//       is resolved while the tile is staged, into one row index per band
//       and tile row: 0, i, or rows_b[i] (copied with the same cp.async
//       stages as x).  A tile all of whose rows have the same indices
//       (factored bands away from the grid's first and last rows) loads
//       its K coefficients once and runs the same row loop.  Any other
//       tile (full bands; boundary tiles) reads each row's K indices in
//       up to three 16-byte shared-memory loads and does, per band, the
//       same three steps whatever the kind: coefficient
//       w_b[idx * ldw + j * cstride] straight into a register (each is
//       used once, so shared memory would only add a trip), x, multiply-
//       add.
//  5. One wave of persistent blocks.  The wrapper sizes the grid from the
//     SM count (at most BLOCKS_PER_SM blocks per SM, a constant of the
//     wrapper measured on the card, never more than tiles; where an
//     instantiation's registers admit fewer resident blocks the rest
//     queue behind them);
//     block b walks tiles b, b + grid, ...  Neighbouring blocks
//     work on neighbouring tiles at the same time, so halo rows are shared
//     through L2.  The tile arithmetic is that of ops/stencil2d.py's
//     StencilTiling, which the CPU tests walk in plain PyTorch; the entry
//     checks the tile counts it is handed against the constants compiled
//     in here.
//
// The kernels allocate nothing and launch on the caller's stream; the
// C entry returns the first CUDA error (attribute or launch), so a
// refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_pipeline_primitives.h>
#include <cstddef>

#ifndef FASP_TX
#define FASP_TX 128
#endif
#ifndef FASP_R
#define FASP_R 8
#endif
#ifndef FASP_NTY
#define FASP_NTY 2
#endif
#ifndef FASP_MIN_BLOCKS_F32
#define FASP_MIN_BLOCKS_F32 4
#endif
#ifndef FASP_MIN_BLOCKS_F64
#define FASP_MIN_BLOCKS_F64 2
#endif

namespace {

constexpr int kMaxBands = 9;
constexpr int kTX = FASP_TX;
constexpr int kR = FASP_R;
constexpr int kNTY = FASP_NTY;
constexpr int kTY = kR * kNTY;
constexpr int kStages = 2;           // the tile loop double-buffers
constexpr int kThreads = kTX * kNTY;
constexpr int kWarps = kThreads / 32;
constexpr int kPitch = kTX + 2;       // window row, in elements
constexpr int kWinRows = kTY + 2;
constexpr int kWinElems = kWinRows * kPitch;
// Blocks per SM that ptxas is asked to leave room for (its register cap),
// by element size; measured on the card with the tile (tools/
// stencil2d_tune.py).  With no target stated ptxas spilled a few bytes of
// some f64 instantiations to gain occupancy.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? FASP_MIN_BLOCKS_F32
                                          : FASP_MIN_BLOCKS_F64;
constexpr int kRidxPitch = 12;        // row indices per tile row (>= 9)
constexpr int kRidxElems = kTY * kRidxPitch;

static_assert(kTX % 32 == 0 && kThreads <= 1024 && kTY <= kThreads,
              "block shape");
static_assert((kStages * kWinElems) % 4 == 0, "row indices 16-byte aligned");

// coefficient kind of a band
constexpr int kScalar = 0;    // w[0]
constexpr int kRowVec = 1;    // w[j]
constexpr int kFull = 2;      // w[i * ldw + j * cstride]
constexpr int kIndexed = 3;   // w[rows[i] * ldw + j * cstride]

// The bands, in the caller's order.
struct BandMeta {
    const void* w[kMaxBands];
    const int* rows[kMaxBands];
    int ldw[kMaxBands];
    int cstride[kMaxBands];
    int kind[kMaxBands];
    int off[kMaxBands];       // dy * kPitch + dx within the staged window
};

// Stage tile (i0, j0)'s window of x into xs, zeros off the grid.  Warps
// take window rows in turn and lanes consecutive columns, so every copy
// instruction covers one contiguous run of x.
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ x, int ny,
                                             int nx, int i0, int j0, T* xs) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int lr = warp; lr < kWinRows; lr += kWarps) {
        const int gi = i0 - 1 + lr;
        const bool row_in = gi >= 0 && gi < ny;
        const T* src = x + (size_t)(row_in ? gi : 0) * nx;
        T* dst = xs + lr * kPitch;
#pragma unroll
        for (int q = 0; q < (kPitch + 31) / 32; ++q) {
            const int lc = lane + 32 * q;
            const int gj = j0 - 1 + lc;
            if (lc < kPitch) {
                if (row_in && gj >= 0 && gj < nx)
                    __pipeline_memcpy_async(dst + lc, src + gj, sizeof(T));
                else
                    dst[lc] = T(0);
            }
        }
    }
}

// Stage the row index of every band for the TY rows of the tile at i0:
// ridx[l * kRidxPitch + b] is the row of w_b that grid row i0 + l reads.
template <int K>
__device__ __forceinline__ void stage_rows(int ny, int i0, int* ridx,
                                           const BandMeta& m) {
    if (threadIdx.x < kTY) {
        const int gi = i0 + threadIdx.x;
        int* dst = ridx + threadIdx.x * kRidxPitch;
#pragma unroll
        for (int b = 0; b < K; ++b) {
            if (m.kind[b] == kIndexed && gi < ny)
                __pipeline_memcpy_async(dst + b, m.rows[b] + gi, sizeof(int));
            else
                dst[b] = (m.kind[b] == kFull && gi < ny) ? gi : 0;
        }
    }
}

// PerRow says whether any coefficient varies along y; the entry sets it
// from the bands.  Without it (scalars and row vectors only) no row index
// is staged and the K coefficients of a column are loaded once per tile.
template <typename T, int K, bool PerRow>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
stencil2d(const T* __restrict__ x, T* __restrict__ y, int ny, int nx,
          int tiles_x, int tiles, BandMeta m) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* const xs_all = reinterpret_cast<T*>(smem_raw);
    int* const ridx_all = reinterpret_cast<int*>(xs_all + kStages * kWinElems);

    const int tx = threadIdx.x % kTX;         // column within the tile
    const int li = (threadIdx.x / kTX) * kR;  // first of this thread's rows
    const int stride = gridDim.x;
    int t = blockIdx.x;
    if (t >= tiles) return;

    int s = 0;
    {
        const int ti = t / tiles_x;
        stage_window<T>(x, ny, nx, ti * kTY, (t - ti * tiles_x) * kTX, xs_all);
        if (PerRow) stage_rows<K>(ny, ti * kTY, ridx_all, m);
        __pipeline_commit();
    }
    for (; t < tiles; t += stride) {
        const int tn = t + stride;
        if (tn < tiles) {
            const int ti = tn / tiles_x;
            stage_window<T>(x, ny, nx, ti * kTY, (tn - ti * tiles_x) * kTX,
                            xs_all + (s ^ 1) * kWinElems);
            if (PerRow)
                stage_rows<K>(ny, ti * kTY, ridx_all + (s ^ 1) * kRidxElems,
                              m);
        }
        __pipeline_commit();             // possibly an empty group

        const int ti = t / tiles_x;
        const int i0 = ti * kTY;
        const int j = (t - ti * tiles_x) * kTX + tx;
        const bool col_in = j < nx;
        const T* wp[K];                  // band b's coefficients of column j
#pragma unroll
        for (int b = 0; b < K; ++b)
            wp[b] = static_cast<const T*>(m.w[b])
                    + (col_in ? (size_t)j * m.cstride[b] : 0);
        T c[K];
        if (!PerRow) {
            // before the wait, so that the loads overlap the copy in flight
#pragma unroll
            for (int b = 0; b < K; ++b) c[b] = __ldg(wp[b]);
        }

        __pipeline_wait_prior(1);        // all but the newest group: tile t
        __syncthreads();

        // A tile all of whose rows read the same row of every w_b (for
        // factored bands, any tile away from the grid's first and last
        // rows) needs its coefficients once, not once per row.
        const int* ridx = ridx_all + s * kRidxElems;
        bool uniform_tile = true;
        if (PerRow) {
            bool same = true;
            if (threadIdx.x < kTY && i0 + threadIdx.x < ny) {
#pragma unroll
                for (int b = 0; b < K; ++b)
                    same &= ridx[threadIdx.x * kRidxPitch + b] == ridx[b];
            }
            uniform_tile = __syncthreads_and(same);
        }

        if (col_in) {
            // centre of this thread's first row in the staged window
            const T* sx = xs_all + s * kWinElems + (li + 1) * kPitch + tx + 1;
            if (uniform_tile) {
                if (PerRow) {
#pragma unroll
                    for (int b = 0; b < K; ++b)
                        c[b] = __ldg(wp[b] + (size_t)ridx[b] * m.ldw[b]);
                }
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                    const int i = i0 + li + r;
                    T acc = T(0);
#pragma unroll
                    for (int b = 0; b < K; ++b)      // band order
                        acc += c[b] * sx[r * kPitch + m.off[b]];
                    if (i < ny) y[(size_t)i * nx + j] = acc;
                }
            } else {
                const int4* rs = reinterpret_cast<const int4*>(
                    ridx + li * kRidxPitch);
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                    const int i = i0 + li + r;
                    const int4* q = rs + r * (kRidxPitch / 4);
                    const int4 v0 = q[0];
                    const int4 v1 = K > 4 ? q[1] : make_int4(0, 0, 0, 0);
                    const int4 v2 = K > 8 ? q[2] : make_int4(0, 0, 0, 0);
                    const int idx[kRidxPitch] = {v0.x, v0.y, v0.z, v0.w,
                                                 v1.x, v1.y, v1.z, v1.w,
                                                 v2.x, v2.y, v2.z, v2.w};
                    T acc = T(0);
#pragma unroll
                    for (int b = 0; b < K; ++b) {    // band order
                        const T cb = __ldg(wp[b] + (size_t)idx[b] * m.ldw[b]);
                        acc += cb * sx[r * kPitch + m.off[b]];
                    }
                    if (i < ny) y[(size_t)i * nx + j] = acc;
                }
            }
        }
        __syncthreads();                 // buffer s is free for tile t + 2
        s ^= 1;
    }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

template <typename T, int K, bool PerRow>
cudaError_t launch_k(const T* x, T* y, int ny, int nx, int tiles_x, int tiles,
                     int grid, const BandMeta& m, cudaStream_t st) {
    const size_t smem = kStages * (kWinElems * sizeof(T)
                                   + kRidxElems * sizeof(int));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            stencil2d<T, K, PerRow>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    stencil2d<T, K, PerRow><<<grid, kThreads, smem, st>>>(x, y, ny, nx,
                                                          tiles_x, tiles, m);
    return cudaGetLastError();
}

template <typename T>
int launch(const T* x, T* y, int ny, int nx, int k, const void* const* w,
           const int* const* rows, const int* meta, void* stream) {
    if (k < 1 || k > kMaxBands || ny < 1 || nx < 1)
        return (int)cudaErrorInvalidValue;
    BandMeta bm{};
    bool per_row = false;
    for (int b = 0; b < k; ++b) {
        const int ldw = meta[5 * b + 0], cstride = meta[5 * b + 1];
        const int rmode = meta[5 * b + 2];
        const int dy = meta[5 * b + 3], dx = meta[5 * b + 4];
        if (dy < -1 || dy > 1 || dx < -1 || dx > 1 || rmode < 0 || rmode > 2
            || cstride < 0 || cstride > 1 || ldw < 1
            || (rmode == 2 && rows[b] == nullptr))
            return (int)cudaErrorInvalidValue;
        bm.w[b] = w[b];
        bm.rows[b] = rows[b];
        bm.ldw[b] = ldw;
        bm.cstride[b] = cstride;
        bm.kind[b] = rmode == 1 ? kFull : rmode == 2 ? kIndexed
                     : cstride ? kRowVec : kScalar;
        bm.off[b] = dy * kPitch + dx;
        if (rmode != 0) per_row = true;
    }
    // launch geometry, sized by the wrapper (ops/stencil2d.py StencilTiling)
    const int grid = meta[5 * k + 0];
    const int tiles_y = meta[5 * k + 1], tiles_x = meta[5 * k + 2];
    if (tiles_y != (ny + kTY - 1) / kTY || tiles_x != (nx + kTX - 1) / kTX
        || grid < 1 || (long long)grid > (long long)tiles_y * tiles_x)
        return (int)cudaErrorInvalidValue;
    const int tiles = tiles_y * tiles_x;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (k) {
#define FASP_STENCIL_CASE(K)                                               \
    case K:                                                                \
        return (int)(per_row                                               \
            ? launch_k<T, K, true>(x, y, ny, nx, tiles_x, tiles, grid, bm, \
                                   st)                                     \
            : launch_k<T, K, false>(x, y, ny, nx, tiles_x, tiles, grid,    \
                                    bm, st));
        FASP_STENCIL_CASE(1) FASP_STENCIL_CASE(2) FASP_STENCIL_CASE(3)
        FASP_STENCIL_CASE(4) FASP_STENCIL_CASE(5) FASP_STENCIL_CASE(6)
        FASP_STENCIL_CASE(7) FASP_STENCIL_CASE(8) FASP_STENCIL_CASE(9)
#undef FASP_STENCIL_CASE
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// meta: 5 ints per band (ldw, cstride, rmode, dy, dx), then 3 for the
// launch (grid, tiles_y, tiles_x).  w / rows:
// k device pointers (rows[b] may be null unless rmode[b] == 2).  Returns a
// cudaError_t value, 0 on success.
int fasp_stencil2d_f32(const float* x, float* y, int ny, int nx, int k,
                       const void* const* w, const int* const* rows,
                       const int* meta, void* stream) {
    return launch<float>(x, y, ny, nx, k, w, rows, meta, stream);
}

int fasp_stencil2d_f64(const double* x, double* y, int ny, int nx, int k,
                       const void* const* w, const int* const* rows,
                       const int* meta, void* stream) {
    return launch<double>(x, y, ny, nx, k, w, rows, meta, stream);
}

// An empty kernel on `grid` blocks of the stencil kernel's size: what a
// launch alone costs.
int fasp_stencil2d_empty(int grid, void* stream) {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    empty_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
    return (int)cudaGetLastError();
}

const char* fasp_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
