// band_ops — fused stencil-band algebra for the structured AMG setup.
//
// The Python BandMatrix does these as k^2 NumPy slice expressions, each
// allocating temporaries and re-walking memory.  These C++ versions fuse
// each output band's accumulation into one pass and parallelize rows with
// OpenMP — the host-side analog of the reference's OpenMP'd RAP
// (fasp_blas_dcsr_rap, BlaSpmvCSR.c:999).
//
// Kernels are written once for 3-D (nz, ny, nx) row-major grids with
// (dz, dy, dx) coordinates; 2-D calls route through them with nz=1.
// A band's value at grid point p multiplies x[p + coord].

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// ---------------------------------------------------------------------------
// 3-D variants: coords are (dz, dy, dx); bands are (nz, ny, nx) row-major.
// ---------------------------------------------------------------------------

namespace {

struct Coord3 {
    int32_t z, y, x;
    bool operator<(const Coord3& o) const {
        if (z != o.z) return z < o.z;
        if (y != o.y) return y < o.y;
        return x < o.x;
    }
};

template <typename T>
int band_matmul_3d_impl(int nz, int ny, int nx,
                        int ka, const int32_t* ca, const T* A,
                        int kb, const int32_t* cb, const T* B,
                        int max_kc, int32_t* cc, T* C) {
    const int64_t n = (int64_t)nz * ny * nx;
    std::map<Coord3, int> out_idx;
    for (int i = 0; i < ka; ++i)
        for (int j = 0; j < kb; ++j) {
            Coord3 c{ca[3 * i] + cb[3 * j], ca[3 * i + 1] + cb[3 * j + 1],
                     ca[3 * i + 2] + cb[3 * j + 2]};
            if (!out_idx.count(c)) {
                int idx = (int)out_idx.size();
                if (idx >= max_kc) return -1;
                out_idx[c] = idx;
            }
        }
    const int kc = (int)out_idx.size();
    for (auto& kv : out_idx) {
        cc[3 * kv.second] = kv.first.z;
        cc[3 * kv.second + 1] = kv.first.y;
        cc[3 * kv.second + 2] = kv.first.x;
    }
    std::memset(C, 0, sizeof(T) * (size_t)kc * n);

    const int64_t sy = nx, sz = (int64_t)ny * nx;
    for (int i = 0; i < ka; ++i) {
        const int dz = ca[3 * i], dy = ca[3 * i + 1], dx = ca[3 * i + 2];
        const int z0 = dz >= 0 ? 0 : -dz, z1 = dz >= 0 ? nz - dz : nz;
        const int y0 = dy >= 0 ? 0 : -dy, y1 = dy >= 0 ? ny - dy : ny;
        const int x0 = dx >= 0 ? 0 : -dx, x1 = dx >= 0 ? nx - dx : nx;
        if (z1 <= z0 || y1 <= y0 || x1 <= x0) continue;
        const T* __restrict__ Ai = A + (int64_t)i * n;
        for (int j = 0; j < kb; ++j) {
            Coord3 c{dz + cb[3 * j], dy + cb[3 * j + 1], dx + cb[3 * j + 2]};
            T* __restrict__ Cc = C + (int64_t)out_idx[c] * n;
            const T* __restrict__ Bj = B + (int64_t)j * n;
            const int64_t shift = (int64_t)dz * sz + (int64_t)dy * sy + dx;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) collapse(2)
#endif
            for (int z = z0; z < z1; ++z)
                for (int y = y0; y < y1; ++y) {
                    const int64_t r = (int64_t)z * sz + (int64_t)y * sy;
                    const T* __restrict__ a = Ai + r;
                    const T* __restrict__ b = Bj + r + shift;
                    T* __restrict__ out = Cc + r;
#ifdef _OPENMP
#pragma omp simd
#endif
                    for (int x = x0; x < x1; ++x)
                        out[x] += a[x] * b[x];
                }
        }
    }
    return kc;
}

template <typename T>
int pair_rap_3d_impl(int nz, int ny, int nx, int k, const int32_t* cf,
                     const T* F, int ax, int s, int max_kc, int32_t* cc,
                     T* C) {
    const int dims_f[3] = {nz, ny, nx};
    int dims_c[3] = {nz, ny, nx};
    dims_c[ax] = (dims_f[ax] + s - 1) / s;
    const int64_t nc = (int64_t)dims_c[0] * dims_c[1] * dims_c[2];
    const int64_t n = (int64_t)nz * ny * nx;

    std::map<Coord3, int> out_idx;
    for (int i = 0; i < k; ++i) {
        const int comp = cf[3 * i + ax];
        for (int a = 0; a < s; ++a) {
            int bb = ((comp + a) % s + s) % s;
            int oc = (comp + a - bb) / s;
            Coord3 c{cf[3 * i], cf[3 * i + 1], cf[3 * i + 2]};
            (ax == 0 ? c.z : ax == 1 ? c.y : c.x) = oc;
            if (!out_idx.count(c)) {
                int idx = (int)out_idx.size();
                if (idx >= max_kc) return -1;
                out_idx[c] = idx;
            }
        }
    }
    const int kc = (int)out_idx.size();
    for (auto& kv : out_idx) {
        cc[3 * kv.second] = kv.first.z;
        cc[3 * kv.second + 1] = kv.first.y;
        cc[3 * kv.second + 2] = kv.first.x;
    }
    std::memset(C, 0, sizeof(T) * (size_t)kc * nc);

    const int64_t fy = nx, fz = (int64_t)ny * nx;
    const int64_t cy = dims_c[2], cz = (int64_t)dims_c[1] * dims_c[2];
    for (int i = 0; i < k; ++i) {
        const int comp = cf[3 * i + ax];
        const T* __restrict__ Fi = F + (int64_t)i * n;
        for (int a = 0; a < s; ++a) {
            int bb = ((comp + a) % s + s) % s;
            int oc = (comp + a - bb) / s;
            Coord3 c{cf[3 * i], cf[3 * i + 1], cf[3 * i + 2]};
            (ax == 0 ? c.z : ax == 1 ? c.y : c.x) = oc;
            T* __restrict__ Cc = C + (int64_t)out_idx[c] * nc;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) collapse(2)
#endif
            for (int Z = 0; Z < dims_c[0]; ++Z)
                for (int Y = 0; Y < dims_c[1]; ++Y) {
                    int z = ax == 0 ? s * Z + a : Z;
                    int y = ax == 1 ? s * Y + a : Y;
                    if (z >= nz || y >= ny) continue;
                    const T* __restrict__ src = Fi + (int64_t)z * fz
                                                + (int64_t)y * fy;
                    T* __restrict__ dst = Cc + (int64_t)Z * cz
                                          + (int64_t)Y * cy;
                    if (ax == 2) {
                        for (int X = 0; X < dims_c[2]; ++X) {
                            const int x = s * X + a;
                            if (x < nx) dst[X] += src[x];
                        }
                    } else {
#ifdef _OPENMP
#pragma omp simd
#endif
                        for (int x = 0; x < nx; ++x) dst[x] += src[x];
                    }
                }
        }
    }
    return kc;
}

}  // namespace

// ---------------------------------------------------------------------------
// Fused smoothed Galerkin coarsening:
//   Ac = P_tent^T (I - w A D^-1) A (I - w D^-1 A) P_tent
// with P_tent the boolean s-per-axis grouping aggregation (every axis with
// extent > 1), computed in ONE tiled pass so the 25..63-band fine-grid
// intermediate M = A - 2wB + w^2 C (B = A D^-1 A, C = B D^-1 A) never
// touches main memory.  w = 0 degenerates to the plain UA pair-RAP.
// This is the whole per-level body of the structured AMG setup
// (reference analog: fasp_blas_dcsr_rap, BlaSpmvCSR.c:999, fused with the
// boolean-P fast path rap_agg, :1276).
// ---------------------------------------------------------------------------

namespace {

template <typename T>
int smoothed_rap_3d_impl(int nz, int ny, int nx, int k, const int32_t* cA,
                         const T* A, const T* dinv, T omega, int s,
                         int max_kc, int32_t* cc, T* C) {
    const int64_t sy = nx, sz = (int64_t)ny * nx;
    const int dims[3] = {nz, ny, nx};
    const bool grp[3] = {nz > 1, ny > 1, nx > 1};
    const int sv[3] = {grp[0] ? s : 1, grp[1] ? s : 1, grp[2] ? s : 1};
    int cdims[3];
    for (int d = 0; d < 3; ++d)
        cdims[d] = grp[d] ? (dims[d] + s - 1) / s : dims[d];
    const int64_t ncy = cdims[2], ncz = (int64_t)cdims[1] * cdims[2];
    const int64_t ncoarse = (int64_t)cdims[0] * ncz;

    const bool smooth = omega != (T)0;

    // ---- symbolic: B coords (pair sums), M coords (A ∪ B ∪ triple) ----
    std::vector<Coord3> acoords(k);
    for (int i = 0; i < k; ++i)
        acoords[i] = Coord3{cA[3 * i], cA[3 * i + 1], cA[3 * i + 2]};
    std::map<Coord3, int> bidx;
    if (smooth)
        for (int i = 0; i < k; ++i)
            for (int j = 0; j < k; ++j) {
                Coord3 c{acoords[i].z + acoords[j].z,
                         acoords[i].y + acoords[j].y,
                         acoords[i].x + acoords[j].x};
                if (!bidx.count(c)) {
                    int idx = (int)bidx.size();
                    bidx[c] = idx;
                }
            }
    std::map<Coord3, int> midx;
    for (int i = 0; i < k; ++i)
        if (!midx.count(acoords[i])) {
            int idx = (int)midx.size();
            midx[acoords[i]] = idx;
        }
    if (smooth)
        for (auto& kv : bidx) {
            if (!midx.count(kv.first)) {
                int idx = (int)midx.size();
                midx[kv.first] = idx;
            }
            for (int j = 0; j < k; ++j) {
                Coord3 c{kv.first.z + acoords[j].z, kv.first.y + acoords[j].y,
                         kv.first.x + acoords[j].x};
                if (!midx.count(c)) {
                    int idx = (int)midx.size();
                    midx[c] = idx;
                }
            }
        }
    const int kb = (int)bidx.size();
    const int km = (int)midx.size();
    std::vector<Coord3> bco(kb), mco(km);
    for (auto& kv : bidx) bco[kv.second] = kv.first;
    for (auto& kv : midx) mco[kv.second] = kv.first;

    // coarse coords: every (m, phase) pair maps to floor((m+a)/s) per
    // grouped axis; build slot table [km][s][s][s] -> coarse band index
    std::map<Coord3, int> cidx;
    std::vector<int> slot((size_t)km * s * s * s, -1);
    auto fdiv = [](int a, int b) {
        return a >= 0 ? a / b : -(((-a) + b - 1) / b);
    };
    for (int m = 0; m < km; ++m)
        for (int az = 0; az < sv[0]; ++az)
            for (int ay = 0; ay < sv[1]; ++ay)
                for (int ax = 0; ax < sv[2]; ++ax) {
                    Coord3 oc{grp[0] ? fdiv(mco[m].z + az, s) : mco[m].z,
                              grp[1] ? fdiv(mco[m].y + ay, s) : mco[m].y,
                              grp[2] ? fdiv(mco[m].x + ax, s) : mco[m].x};
                    auto it = cidx.find(oc);
                    int idx;
                    if (it == cidx.end()) {
                        idx = (int)cidx.size();
                        if (idx >= max_kc) return -1;
                        cidx[oc] = idx;
                    } else {
                        idx = it->second;
                    }
                    slot[(((size_t)m * s + az) * s + ay) * s + ax] = idx;
                }
    const int kc = (int)cidx.size();
    for (auto& kv : cidx) {
        cc[3 * kv.second] = kv.first.z;
        cc[3 * kv.second + 1] = kv.first.y;
        cc[3 * kv.second + 2] = kv.first.x;
    }
    std::memset(C, 0, sizeof(T) * (size_t)kc * ncoarse);

    // halo of the B stencil in z/y (B rows needed at p + cb for stage C)
    int hbz = 0, hby = 0;
    for (auto& c : bco) {
        if (std::abs(c.z) > hbz) hbz = std::abs(c.z);
        if (std::abs(c.y) > hby) hby = std::abs(c.y);
    }
    // tile: sv[0] planes in z × sv[1] rows in y (one coarse (Z,Y) row set)
    const int tz = sv[0], ty = sv[1];
    const int bz = tz + 2 * hbz, by = ty + 2 * hby;   // B buffer extent
    const int ntz = (nz + tz - 1) / tz, nty = (ny + ty - 1) / ty;
    const int64_t ntiles = (int64_t)ntz * nty;

    const T w2 = omega * omega, w2n = -2 * omega;

#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<T> Bbuf(smooth ? (size_t)kb * bz * by * nx : 0);
        std::vector<T> Mrow((size_t)km * nx);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
        for (int64_t tile = 0; tile < ntiles; ++tile) {
            const int z0 = (int)(tile / nty) * tz;
            const int y0 = (int)(tile % nty) * ty;
            const int z1 = std::min(z0 + tz, nz), y1 = std::min(y0 + ty, ny);

            if (smooth) {
                // ---- stage B: B = (A D^-1) A on tile + halo rows ----
                std::fill(Bbuf.begin(), Bbuf.end(), (T)0);
                for (int z = std::max(0, z0 - hbz);
                     z < std::min(nz, z1 + hbz); ++z)
                    for (int y = std::max(0, y0 - hby);
                         y < std::min(ny, y1 + hby); ++y) {
                        const int64_t r = (int64_t)z * sz + (int64_t)y * sy;
                        for (int i = 0; i < k; ++i) {
                            const Coord3 c1 = acoords[i];
                            const int zq = z + c1.z, yq = y + c1.y;
                            if (zq < 0 || zq >= nz || yq < 0 || yq >= ny)
                                continue;
                            const int64_t shift =
                                (int64_t)c1.z * sz + (int64_t)c1.y * sy + c1.x;
                            const T* __restrict__ Ai = A + (int64_t)i * ((int64_t)nz * sz) + r;
                            const T* __restrict__ dv = dinv + r + shift;
                            const int x0c = std::max(0, -c1.x);
                            const int x1c = nx - std::max(0, c1.x);
                            for (int j = 0; j < k; ++j) {
                                Coord3 cb{c1.z + acoords[j].z,
                                          c1.y + acoords[j].y,
                                          c1.x + acoords[j].x};
                                const T* __restrict__ Aj =
                                    A + (int64_t)j * ((int64_t)nz * sz) + r + shift;
                                T* __restrict__ out =
                                    Bbuf.data() +
                                    ((size_t)bidx[cb] * bz + (z - (z0 - hbz))) *
                                        ((size_t)by * nx) +
                                    (size_t)(y - (y0 - hby)) * nx;
#ifdef _OPENMP
#pragma omp simd
#endif
                                for (int x = x0c; x < x1c; ++x)
                                    out[x] += Ai[x] * dv[x] * Aj[x];
                            }
                        }
                    }
            }

            // ---- stage M + accumulate into coarse ----
            for (int z = z0; z < z1; ++z) {
                const int az = grp[0] ? z % s : 0;
                const int Z = grp[0] ? z / s : z;
                for (int y = y0; y < y1; ++y) {
                    const int ay = grp[1] ? y % s : 0;
                    const int Y = grp[1] ? y / s : y;
                    const int64_t r = (int64_t)z * sz + (int64_t)y * sy;
                    std::fill(Mrow.begin(), Mrow.end(), (T)0);
                    // A term
                    for (int i = 0; i < k; ++i) {
                        const T* __restrict__ Ai =
                            A + (int64_t)i * ((int64_t)nz * sz) + r;
                        T* __restrict__ out =
                            Mrow.data() + (size_t)midx[acoords[i]] * nx;
#ifdef _OPENMP
#pragma omp simd
#endif
                        for (int x = 0; x < nx; ++x) out[x] += Ai[x];
                    }
                    if (smooth) {
                        // -2w B term
                        for (int bi = 0; bi < kb; ++bi) {
                            const T* __restrict__ Bi =
                                Bbuf.data() +
                                ((size_t)bi * bz + (z - (z0 - hbz))) *
                                    ((size_t)by * nx) +
                                (size_t)(y - (y0 - hby)) * nx;
                            T* __restrict__ out =
                                Mrow.data() + (size_t)midx[bco[bi]] * nx;
#ifdef _OPENMP
#pragma omp simd
#endif
                            for (int x = 0; x < nx; ++x)
                                out[x] += w2n * Bi[x];
                        }
                        // +w^2 C term: C[m][p] = sum B[cb][p] dinv[p+cb] A[c2][p+cb]
                        for (int bi = 0; bi < kb; ++bi) {
                            const Coord3 cb = bco[bi];
                            const int zq = z + cb.z, yq = y + cb.y;
                            if (zq < 0 || zq >= nz || yq < 0 || yq >= ny)
                                continue;
                            const int64_t shift =
                                (int64_t)cb.z * sz + (int64_t)cb.y * sy + cb.x;
                            const T* __restrict__ Bi =
                                Bbuf.data() +
                                ((size_t)bi * bz + (z - (z0 - hbz))) *
                                    ((size_t)by * nx) +
                                (size_t)(y - (y0 - hby)) * nx;
                            const T* __restrict__ dv = dinv + r + shift;
                            const int x0c = std::max(0, -cb.x);
                            const int x1c = nx - std::max(0, cb.x);
                            for (int j = 0; j < k; ++j) {
                                Coord3 m{cb.z + acoords[j].z,
                                         cb.y + acoords[j].y,
                                         cb.x + acoords[j].x};
                                const T* __restrict__ Aj =
                                    A + (int64_t)j * ((int64_t)nz * sz) + r + shift;
                                T* __restrict__ out =
                                    Mrow.data() + (size_t)midx[m] * nx;
#ifdef _OPENMP
#pragma omp simd
#endif
                                for (int x = x0c; x < x1c; ++x)
                                    out[x] += w2 * Bi[x] * dv[x] * Aj[x];
                            }
                        }
                    }
                    // scatter-accumulate into coarse bands: tiles own
                    // disjoint coarse (Z, Y) rows, so no races
                    for (int m = 0; m < km; ++m) {
                        const T* __restrict__ Mv = Mrow.data() + (size_t)m * nx;
                        const size_t base = (((size_t)m * s + az) * s + ay) * s;
                        for (int ax = 0; ax < sv[2]; ++ax) {
                            const int j = slot[base + ax];
                            T* __restrict__ out =
                                C + (int64_t)j * ncoarse + (int64_t)Z * ncz +
                                (int64_t)Y * ncy;
                            if (grp[2]) {
                                for (int x = ax; x < nx; x += s)
                                    out[x / s] += Mv[x];
                            } else {
#ifdef _OPENMP
#pragma omp simd
#endif
                                for (int x = 0; x < nx; ++x) out[x] += Mv[x];
                            }
                        }
                    }
                }
            }
        }
    }
    return kc;
}

}  // namespace

extern "C" {

int fasp_smoothed_rap_3d_f64(int nz, int ny, int nx, int k,
                             const int32_t* cA, const double* A,
                             const double* dinv, double omega, int s,
                             int max_kc, int32_t* cc, double* C) {
    return smoothed_rap_3d_impl<double>(nz, ny, nx, k, cA, A, dinv, omega, s,
                                        max_kc, cc, C);
}

int fasp_smoothed_rap_3d_f32(int nz, int ny, int nx, int k,
                             const int32_t* cA, const float* A,
                             const float* dinv, float omega, int s,
                             int max_kc, int32_t* cc, float* C) {
    return smoothed_rap_3d_impl<float>(nz, ny, nx, k, cA, A, dinv, omega, s,
                                       max_kc, cc, C);
}

}  // extern "C"

extern "C" {

int fasp_band_matmul_3d_f64(int nz, int ny, int nx, int ka,
                            const int32_t* ca, const double* A, int kb,
                            const int32_t* cb, const double* B, int max_kc,
                            int32_t* cc, double* C) {
    return band_matmul_3d_impl<double>(nz, ny, nx, ka, ca, A, kb, cb, B,
                                       max_kc, cc, C);
}

int fasp_band_matmul_3d_f32(int nz, int ny, int nx, int ka,
                            const int32_t* ca, const float* A, int kb,
                            const int32_t* cb, const float* B, int max_kc,
                            int32_t* cc, float* C) {
    return band_matmul_3d_impl<float>(nz, ny, nx, ka, ca, A, kb, cb, B,
                                      max_kc, cc, C);
}

int fasp_pair_rap_3d_f64(int nz, int ny, int nx, int k, const int32_t* cf,
                         const double* F, int ax, int s, int max_kc,
                         int32_t* cc, double* C) {
    return pair_rap_3d_impl<double>(nz, ny, nx, k, cf, F, ax, s, max_kc,
                                    cc, C);
}

int fasp_pair_rap_3d_f32(int nz, int ny, int nx, int k, const int32_t* cf,
                         const float* F, int ax, int s, int max_kc,
                         int32_t* cc, float* C) {
    return pair_rap_3d_impl<float>(nz, ny, nx, k, cf, F, ax, s, max_kc,
                                   cc, C);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// DIA extraction: CSR -> (offsets, row-aligned bands).  The setup's single
// largest host pass (nnz reads + k*n writes); two-phase with an offset
// presence bitmap, rows parallelized with OpenMP.  Python twin:
// ops/operators.py dia_bands_from_csr.
// ---------------------------------------------------------------------------

extern "C" {

// Phase 1: distinct diagonal offsets, ascending.  Returns k, or -k_true if
// k_true exceeds max_k (offsets_out then holds nothing useful).
int64_t fasp_dia_offsets(int64_t n, const int64_t* indptr,
                         const int64_t* indices, int64_t max_k,
                         int64_t* offsets_out) {
    // relaxed atomic flags: concurrent set of the same byte is formally a
    // data race on plain uint8_t (UB under TSan) even though idempotent —
    // relaxed stores carry no synchronization cost on x86/ARM
    std::vector<std::atomic<uint8_t>> present(2 * (size_t)n + 1);
    for (auto& p : present) p.store(0, std::memory_order_relaxed);
    std::atomic<uint8_t>* pres = present.data();
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
            int64_t off = indices[j] - i + n;   // in [0, 2n]
            if (!pres[off].load(std::memory_order_relaxed))
                pres[off].store(1, std::memory_order_relaxed);
        }
    }
    int64_t k = 0;
    for (int64_t o = 0; o <= 2 * n; ++o) {
        if (pres[o].load(std::memory_order_relaxed)) {
            if (k < max_k) offsets_out[k] = o - n;
            ++k;
        }
    }
    return (k <= max_k) ? k : -k;
}

// Phase 2: scatter values into row-aligned bands (k, n); bands must be
// zero-initialized.  Offsets ascending (binary search per entry, k small).
void fasp_dia_fill_f64(int64_t n, const int64_t* indptr,
                       const int64_t* indices, const double* data,
                       int64_t k, const int64_t* offsets, double* bands) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
            int64_t off = indices[j] - i;
            const int64_t* p =
                std::lower_bound(offsets, offsets + k, off);
            bands[(p - offsets) * n + i] = data[j];
        }
    }
}

void fasp_dia_fill_f32(int64_t n, const int64_t* indptr,
                       const int64_t* indices, const double* data,
                       int64_t k, const int64_t* offsets, float* bands) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {
            int64_t off = indices[j] - i;
            const int64_t* p =
                std::lower_bound(offsets, offsets + k, off);
            bands[(p - offsets) * n + i] = (float)data[j];
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused general-CSR Galerkin triple product C = R A P — the reference's
// hottest setup kernel (fasp_blas_dcsr_rap, BlaSpmvCSR.c:999): two-pass
// symbolic/numeric row merge, OpenMP over coarse rows with thread-local
// marker/accumulator arrays.  Column indices are emitted sorted so the
// Python CSRMatrix constructor skips its canonicalization lexsort.
// ---------------------------------------------------------------------------

extern "C" {

// Pass 1 (symbolic): per-coarse-row nnz counts into Cp[1..nc] (caller
// exclusive-scans).  Returns total nnz.
int64_t fasp_rap_symb(int64_t nc, const int64_t* Rp, const int64_t* Rj,
                      const int64_t* Ap, const int64_t* Aj,
                      const int64_t* Pp, const int64_t* Pj,
                      int64_t* Cp) {
    Cp[0] = 0;
#pragma omp parallel
    {
        std::vector<int64_t> marker(nc, -1);
#pragma omp for schedule(dynamic, 64)
        for (int64_t i = 0; i < nc; ++i) {
            int64_t cnt = 0;
            for (int64_t kr = Rp[i]; kr < Rp[i + 1]; ++kr) {
                const int64_t k = Rj[kr];
                for (int64_t ka = Ap[k]; ka < Ap[k + 1]; ++ka) {
                    const int64_t j = Aj[ka];
                    for (int64_t kp = Pp[j]; kp < Pp[j + 1]; ++kp) {
                        const int64_t c = Pj[kp];
                        if (marker[c] != i) {
                            marker[c] = i;
                            ++cnt;
                        }
                    }
                }
            }
            Cp[i + 1] = cnt;
        }
    }
    int64_t tot = 0;
    for (int64_t i = 0; i < nc; ++i) {
        tot += Cp[i + 1];
        Cp[i + 1] = tot;
    }
    return tot;
}

// Pass 2 (numeric): fill Cj/Cx given the row pointer from pass 1.
void fasp_rap_fill(int64_t nc, const int64_t* Rp, const int64_t* Rj,
                   const double* Rx, const int64_t* Ap, const int64_t* Aj,
                   const double* Ax, const int64_t* Pp, const int64_t* Pj,
                   const double* Px, const int64_t* Cp, int64_t* Cj,
                   double* Cx) {
#pragma omp parallel
    {
        std::vector<int64_t> marker(nc, -1);
        std::vector<double> w(nc, 0.0);
        std::vector<int64_t> cols;
        cols.reserve(256);
#pragma omp for schedule(dynamic, 64)
        for (int64_t i = 0; i < nc; ++i) {
            cols.clear();
            for (int64_t kr = Rp[i]; kr < Rp[i + 1]; ++kr) {
                const int64_t k = Rj[kr];
                const double r = Rx[kr];
                for (int64_t ka = Ap[k]; ka < Ap[k + 1]; ++ka) {
                    const int64_t j = Aj[ka];
                    const double ra = r * Ax[ka];
                    for (int64_t kp = Pp[j]; kp < Pp[j + 1]; ++kp) {
                        const int64_t c = Pj[kp];
                        const double v = ra * Px[kp];
                        if (marker[c] != i) {
                            marker[c] = i;
                            w[c] = v;
                            cols.push_back(c);
                        } else {
                            w[c] += v;
                        }
                    }
                }
            }
            std::sort(cols.begin(), cols.end());
            int64_t out = Cp[i];
            for (int64_t c : cols) {
                Cj[out] = c;
                Cx[out] = w[c];
                ++out;
            }
        }
    }
}

}  // extern "C"

// Single-pass fused RAP: each thread computes a contiguous coarse-row
// range into local buffers (symbolic+numeric fused, cancelled zeros
// dropped inline), then copies into the caller's arrays.  Returns nnz,
// or -1 when the caller's capacity is insufficient (caller retries with
// a larger cap).  ~2x the two-pass variant: the triple loop runs once.
extern "C" int64_t fasp_rap(int64_t nc,
                            const int64_t* Rp, const int64_t* Rj,
                            const double* Rx,
                            const int64_t* Ap, const int64_t* Aj,
                            const double* Ax,
                            const int64_t* Pp, const int64_t* Pj,
                            const double* Px,
                            int64_t cap, int64_t* Cp, int64_t* Cj,
                            double* Cx) {
    int nt = 1;
#ifdef _OPENMP
    nt = omp_get_max_threads();
#endif
    std::vector<std::vector<int64_t>> tcols((size_t)nt);
    std::vector<std::vector<double>> tvals((size_t)nt);
    std::vector<int64_t> lo((size_t)nt + 1);
    for (int t = 0; t <= nt; ++t) lo[t] = nc * (int64_t)t / nt;

#pragma omp parallel num_threads(nt)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        std::vector<int64_t> marker(nc, -1);
        std::vector<double> w(nc, 0.0);
        std::vector<int64_t> cols;
        cols.reserve(64);
        auto& oc = tcols[t];
        auto& ov = tvals[t];
        oc.reserve((size_t)(Rp[nc] / nt + 64));
        ov.reserve((size_t)(Rp[nc] / nt + 64));
        for (int64_t i = lo[t]; i < lo[t + 1]; ++i) {
            cols.clear();
            for (int64_t kr = Rp[i]; kr < Rp[i + 1]; ++kr) {
                const int64_t k = Rj[kr];
                const double r = Rx[kr];
                for (int64_t ka = Ap[k]; ka < Ap[k + 1]; ++ka) {
                    const int64_t j = Aj[ka];
                    const double ra = r * Ax[ka];
                    for (int64_t kp = Pp[j]; kp < Pp[j + 1]; ++kp) {
                        const int64_t c = Pj[kp];
                        if (marker[c] != i) {
                            marker[c] = i;
                            w[c] = ra * Px[kp];
                            cols.push_back(c);
                        } else {
                            w[c] += ra * Px[kp];
                        }
                    }
                }
            }
            std::sort(cols.begin(), cols.end());
            // row terminator: store count via Cp (filled after)
            int64_t cnt = 0;
            for (int64_t c : cols) {
                if (w[c] != 0.0) {
                    oc.push_back(c);
                    ov.push_back(w[c]);
                    ++cnt;
                }
            }
            Cp[i + 1] = cnt;       // per-row count (prefix-summed below)
        }
    }
    Cp[0] = 0;
    for (int64_t i = 0; i < nc; ++i) Cp[i + 1] += Cp[i];
    const int64_t nnz = Cp[nc];
    if (nnz > cap) return -1;
    // stitch: thread t's rows are contiguous, so its block lands at
    // Cp[lo[t]]
#pragma omp parallel num_threads(nt)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        std::memcpy(Cj + Cp[lo[t]], tcols[t].data(),
                    tcols[t].size() * sizeof(int64_t));
        std::memcpy(Cx + Cp[lo[t]], tvals[t].data(),
                    tvals[t].size() * sizeof(double));
    }
    return nnz;
}

// ---------------------------------------------------------------------------
// Adaptive-format support: offset histogram + band/remainder split.  These
// replace the NumPy middle of ops/operators.py best_operator — at 7M nnz
// the np.repeat + fancy scatter path costs ~1-2 s of the general AMG
// setup ("format" phase); here it is two parallel passes over nnz.
// ---------------------------------------------------------------------------

extern "C" {

// Histogram of diagonal offsets: hist must hold 2n+1 zeroed int64 slots
// (hist[off + n] = count of entries on diagonal `off`).
void fasp_dia_hist(int64_t n, const int64_t* indptr, const int64_t* indices,
                   int64_t* hist) {
#pragma omp parallel
    {
        std::vector<int64_t> local(2 * (size_t)n + 1, 0);
#pragma omp for schedule(static)
        for (int64_t i = 0; i < n; ++i)
            for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j)
                ++local[indices[j] - i + n];
#pragma omp critical
        {
            for (int64_t o = 0; o <= 2 * n; ++o)
                if (local[o]) hist[o] += local[o];
        }
    }
}

// Split a CSR matrix into row-aligned bands over `k` selected offsets
// (ascending) plus a COO remainder in CSR order.  bands must be zeroed
// (k, n); rem_* must hold at least ``cap`` entries.  Returns the
// remainder count, or -1 if it would exceed cap (nothing written).
#define DIA_SPLIT_BODY(T)                                                   \
    std::vector<int32_t> slot(2 * (size_t)n + 1, -1);                       \
    for (int64_t s = 0; s < k; ++s) slot[offsets[s] + n] = (int32_t)s;      \
    std::vector<int64_t> rowrem((size_t)n + 1, 0);                          \
    _Pragma("omp parallel for schedule(static)")                            \
    for (int64_t i = 0; i < n; ++i) {                                       \
        int64_t c = 0;                                                      \
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j)                 \
            if (slot[indices[j] - i + n] < 0) ++c;                          \
        rowrem[i + 1] = c;                                                  \
    }                                                                       \
    for (int64_t i = 0; i < n; ++i) rowrem[i + 1] += rowrem[i];             \
    if (rowrem[n] > cap) return -1;                                         \
    _Pragma("omp parallel for schedule(static)")                            \
    for (int64_t i = 0; i < n; ++i) {                                       \
        int64_t w = rowrem[i];                                              \
        for (int64_t j = indptr[i]; j < indptr[i + 1]; ++j) {               \
            const int32_t s = slot[indices[j] - i + n];                     \
            if (s >= 0) {                                                   \
                bands[(int64_t)s * n + i] = (T)data[j];                     \
            } else {                                                        \
                rem_rows[w] = (int32_t)i;                                   \
                rem_cols[w] = (int32_t)indices[j];                          \
                rem_vals[w] = (T)data[j];                                   \
                ++w;                                                        \
            }                                                               \
        }                                                                   \
    }                                                                       \
    return rowrem[n];

int64_t fasp_dia_split_f32(int64_t n, const int64_t* indptr,
                           const int64_t* indices, const double* data,
                           int64_t k, const int64_t* offsets, float* bands,
                           int32_t* rem_rows, int32_t* rem_cols,
                           float* rem_vals, int64_t cap) {
    DIA_SPLIT_BODY(float)
}

int64_t fasp_dia_split_f64(int64_t n, const int64_t* indptr,
                           const int64_t* indices, const double* data,
                           int64_t k, const int64_t* offsets, double* bands,
                           int32_t* rem_rows, int32_t* rem_cols,
                           double* rem_vals, int64_t cap) {
    DIA_SPLIT_BODY(double)
}

#undef DIA_SPLIT_BODY

}  // extern "C"
