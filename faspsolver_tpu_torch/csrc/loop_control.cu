// loop_control.cu — the control of the device-resident solve loops, and
// the CUDA graph calls that build them.
//
// The JAX package runs every solve loop as one jitted program: a
// lax.while_loop whose cond and rare branches (lax.cond) stay on the
// device, with the host reading nothing until the solve ends
// (faspsolver_tpu/krylov/pcg.py:58/:133/:173, bicgstab.py:35/:110/:142,
// minres.py:32/:95/:112, solvers/refine.py:219).  This file ports XLA's
// `while` / `cond` control around those bodies: it has no Pallas
// counterpart.
//
// A loop of the port (utils/graphs.py) is a CUDA graph whose WHILE
// conditional node holds the loop body (the captured vector work), and
// whose IF node holds the true-residual recompute.  The kernels here are
// the scalar bookkeeping of each JAX cond/body: from the reductions the
// body just computed they decide the safeguards (breakdown, zero
// solution, stagnation restart, claimed convergence and its recheck),
// update the scalar state, write every flag into the loop's state region
// in device memory (the vector work masks its restart and safe iterate
// with them), and set the conditional handles with
// cudaGraphSetConditional.  Called outside a graph (handle 0) they only
// update the region: the eager loop launches them and reads the region.
//
// One entry point per loop, each with phases:
//   PCG, BiCGstab, MINRES: 0 init (initial norms and the entry test,
//     JAX's `already`; sets the WHILE handle), 1 check (after the body's
//     first half; sets the IF handle of the recompute), 2 decide (after
//     the recompute, which may not have run; sets the WHILE handle);
//   refinement: 0 init, 1 round (after a round's f64 residual; sets the
//     WHILE handle and the next inner tolerance).
//   GMRES family: two nested WHILEs, the restart cycles around the Arnoldi
//     steps (faspsolver_tpu/krylov/gmres.py:175/:243): 0 init, 1 cycle,
//     2 arnoldi (the Hessenberg column's Givens rotations), 3 solve (the
//     window's back-substitution), 4 restart (see gmres_control).
//
// Rounding: the decisions must be those of the eager loop's scalar
// arithmetic in b's dtype (the JAX package's traced scalars), so every
// operation is an IEEE round-to-nearest intrinsic and the file is built
// with -fmad=false, without fast math (denormals kept: SMALLREAL2 is one
// in float).  utils/loops.py holds the plain PyTorch twin of each entry
// point; chip_smoke.py holds the two bit-equal.
//
// The graph calls at the end go through the driver API (see there).
//
// What bounds it: nothing but the launch.  One thread reads a few dozen
// scalars and writes as many; the time is the launch floor of a graph
// kernel node, a few microseconds, once or twice per iteration.
// GMRES's arnoldi phase does up to R rotations (R the restart window) and
// its solve phase R^2 / 2 dependent multiply-adds on one thread: at R = 60
// a few microseconds more, once per step and once per cycle.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

// Field layouts of a loop's state region (utils/loops.py reads these two
// enums from this file: keep each a single "enum Name { ... };").
enum LoopI { I_IT, I_MAXIT, I_STOP, I_SAFE, I_MAX_STAG, I_MAX_RESTART, I_STAG, I_MORE, I_STATUS, I_BREAKDOWN, I_ZERO_SOL, I_STAGNATED, I_CLAIM, I_NEED, I_CONV, I_RESTART, I_BETTER, I_CONT, I_NINIT, I_NBODY, I_NIF, I_J, I_CUR_RESTART, I_CYCLES, I_ADAPTIVE, I_COUNT };
enum LoopF { F_TOL, F_ABSTOL, F_MAXDIFF, F_ABSRES0, F_NORMR0, F_NORMU, F_NORMU_NEW, F_ABSRES, F_RELRES, F_BEST, F_INNER_TOL, F_INNER_FLOOR, F_R_NORM, F_R_NORM_OLD, F_STAG_BEST, F_SCALE, F_COUNT };

// constants of faspsolver_tpu_torch/constants.py and krylov/common.py,
// handed in as -D flags by utils/loops.py
#ifndef FASP_SMALLREAL
#error "build through faspsolver_tpu_torch/utils/loops.py (it passes the constants)"
#endif

namespace {

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Python's max(a, b) and min(a, b): the first argument unless the second
// is strictly greater (smaller) — what the eager loop's host checks did
template <typename T> __device__ __forceinline__ T pymax(T a, T b) { return b > a ? b : a; }
template <typename T> __device__ __forceinline__ T pymin(T a, T b) { return b < a ? b : a; }

__device__ __forceinline__ void set_cond(unsigned long long h, bool v) {
    if (h) cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(h), v ? 1u : 0u);
}

// initial norms (KryPcg.c:134-160) and the entry test
template <typename T>
__device__ void init_norms(T absres0, T xx, T* f, int* i, bool extra_done) {
    const T small = T(FASP_SMALLREAL);
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    f[F_MAXDIFF] = mul_rn(f[F_TOL], T(FASP_STAG_RATIO));
    f[F_NORMR0] = pymax(small, absres0);
    f[F_NORMU] = pymax(small, sqrt_rn(xx));
    f[F_ABSRES0] = absres0;
    f[F_ABSRES] = absres0;
    f[F_RELRES] = div_rn(absres0, mod ? f[F_NORMU] : f[F_NORMR0]);
    f[F_BEST] = absres0;
    i[I_IT] = 0;
    i[I_STAG] = 1;
    i[I_MORE] = 1;
    i[I_STATUS] = 0;
    i[I_NEED] = i[I_CONV] = i[I_RESTART] = i[I_BETTER] = 0;
    i[I_NINIT] += 1;
    const bool done = f[F_RELRES] < f[F_TOL] || absres0 < f[F_ABSTOL] || extra_done;
    i[I_CONT] = !done && 0 < i[I_MAXIT];
}

// What the check leaves for the eager loop to read when nothing is
// recomputed: decide() concludes the same then.
__device__ void provisional(int* i, bool done, int status) {
    i[I_STATUS] = status;
    i[I_CONT] = !done && i[I_IT] < i[I_MAXIT];
}

// The end of a PCG / BiCGstab iteration after the (possible) true
// residual `absres_true` (KryPcg.c:224-324): convergence, the failed
// stagnation and restart budgets, the restart, the status, the safe
// iterate.  BiCGstab has no zero-solution check (its flag stays 0), and
// (stagnated && conv) || (claim && conv) is conv.
template <typename T>
__device__ void krylov_decide(T absres_true, T* f, int* i) {
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    const bool need = i[I_NEED], stagnated = i[I_STAGNATED], claim = i[I_CLAIM];
    const bool breakdown = i[I_BREAKDOWN], zero_sol = i[I_ZERO_SOL];
    T absres = f[F_ABSRES], relres = f[F_RELRES];
    if (need) {
        absres = absres_true;
        relres = div_rn(absres, mod ? f[F_NORMU_NEW] : f[F_NORMR0]);
    }
    const bool conv = need && relres < f[F_TOL];
    const bool stag_fail = stagnated && !conv && i[I_STAG] >= i[I_MAX_STAG];
    const bool tol_fail = claim && !conv && i[I_MORE] >= i[I_MAX_RESTART];
    const bool restart = need && !conv && !stag_fail && !tol_fail;
    if (restart) {
        i[I_STAG] += stagnated;
        i[I_MORE] += claim;
    }
    const bool done = breakdown || zero_sol || stag_fail || tol_fail || conv;
    i[I_STATUS] = breakdown ? FASP_ERR_MISC : zero_sol ? FASP_ERR_SOLSTAG
                : stag_fail ? FASP_ERR_STAG : tol_fail ? FASP_ERR_TOLSMALL : 0;
    f[F_ABSRES] = absres;
    f[F_RELRES] = relres;
    f[F_ABSRES0] = absres;
    if (mod) f[F_NORMU] = f[F_NORMU_NEW];
    const bool better = i[I_SAFE] && absres < f[F_BEST];
    if (better) f[F_BEST] = absres;
    i[I_CONV] = conv;
    i[I_RESTART] = restart;
    i[I_BETTER] = better;
    i[I_CONT] = !done && i[I_IT] < i[I_MAXIT];
}

// PCG (faspsolver_tpu/krylov/pcg.py:84-170).
//   init   in = {absres0, x0.x0}
//   check  in = {p.Ap, alpha, absres, max|x|, x.x, p.p}
//   decide in = {true absres} (read only if the recompute ran)
template <typename T>
__global__ void pcg_control(int phase, const T* in, T* f, int* i, unsigned long long h) {
    const T small = T(FASP_SMALLREAL), small2 = T(FASP_SMALLREAL2), slow = T(0.9);
    if (phase == 0) {
        init_norms(in[0], in[1], f, i, false);
        set_cond(h, i[I_CONT]);
        return;
    }
    if (phase == 2) {
        krylov_decide(in[0], f, i);
        set_cond(h, i[I_CONT]);
        return;
    }
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    i[I_IT] += 1;
    i[I_NBODY] += 1;
    const T absres = in[2];
    const T relres = div_rn(absres, mod ? f[F_NORMU] : f[F_NORMR0]);
    const bool breakdown = fabs(in[0]) <= small2;
    const T factor = div_rn(absres, f[F_ABSRES0]);
    const bool zero_sol = factor > slow && in[3] <= small;
    const T normu_new = pymax(small, sqrt_rn(in[4]));
    const T reldiff = div_rn(mul_rn(fabs(in[1]), sqrt_rn(in[5])), normu_new);
    const bool stagnated = factor > slow && !zero_sol && i[I_STAG] <= i[I_MAX_STAG]
                           && reldiff < f[F_MAXDIFF];
    const bool claim = relres < f[F_TOL] && !stagnated && !zero_sol;
    const bool need = stagnated || claim;
    f[F_ABSRES] = absres;
    f[F_RELRES] = relres;
    f[F_NORMU_NEW] = normu_new;
    i[I_BREAKDOWN] = breakdown;
    i[I_ZERO_SOL] = zero_sol;
    i[I_STAGNATED] = stagnated;
    i[I_CLAIM] = claim;
    i[I_NEED] = need;
    i[I_NIF] += need;
    provisional(i, breakdown || zero_sol,
                breakdown ? FASP_ERR_MISC : zero_sol ? FASP_ERR_SOLSTAG : 0);
    set_cond(h, need);
}

// BiCGstab (faspsolver_tpu/krylov/bicgstab.py:56-141).
//   init   in = {absres0, x0.x0}
//   check  in = {rstar.v, t.t, absres, x.x, step.step}
//   decide in = {true absres}
template <typename T>
__global__ void bicgstab_control(int phase, const T* in, T* f, int* i, unsigned long long h) {
    const T small = T(FASP_SMALLREAL), small2 = T(FASP_SMALLREAL2), slow = T(0.9);
    if (phase == 0) {
        init_norms(in[0], in[1], f, i, false);
        set_cond(h, i[I_CONT]);
        return;
    }
    if (phase == 2) {
        krylov_decide(in[0], f, i);
        set_cond(h, i[I_CONT]);
        return;
    }
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    i[I_IT] += 1;
    i[I_NBODY] += 1;
    const T absres = in[2];
    const T relres = div_rn(absres, mod ? f[F_NORMU] : f[F_NORMR0]);
    const bool breakdown = fabs(in[0]) <= small2 || in[1] <= small2;
    const T factor = div_rn(absres, f[F_ABSRES0]);
    const T normu_new = pymax(small, sqrt_rn(in[3]));
    const bool stagnated = factor > slow && i[I_STAG] <= i[I_MAX_STAG]
                           && div_rn(sqrt_rn(in[4]), normu_new) < f[F_MAXDIFF];
    const bool claim = relres < f[F_TOL] && !stagnated;
    const bool need = stagnated || claim;
    f[F_ABSRES] = absres;
    f[F_RELRES] = relres;
    f[F_NORMU_NEW] = normu_new;
    i[I_BREAKDOWN] = breakdown;
    i[I_ZERO_SOL] = 0;
    i[I_STAGNATED] = stagnated;
    i[I_CLAIM] = claim;
    i[I_NEED] = need;
    i[I_NIF] += need;
    provisional(i, breakdown, breakdown ? FASP_ERR_MISC : 0);
    set_cond(h, need);
}

// MINRES (faspsolver_tpu/krylov/minres.py:56-111).
//   init   in = {absres0, x0.x0, beta0}
//   check  in = {eta, beta_new}
//   decide in = {true absres, x.x}
template <typename T>
__global__ void minres_control(int phase, const T* in, T* f, int* i, unsigned long long h) {
    const T small = T(FASP_SMALLREAL);
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    if (phase == 0) {
        init_norms(in[0], in[1], f, i, in[2] <= small);
        f[F_BEST] = f[F_RELRES];
        set_cond(h, i[I_CONT]);
        return;
    }
    if (phase == 1) {
        i[I_IT] += 1;
        i[I_NBODY] += 1;
        const T relres = div_rn(fabs(in[0]), f[F_NORMR0]);
        const bool claim = relres < f[F_TOL];
        const bool breakdown = in[1] <= small;
        f[F_RELRES] = relres;
        i[I_BREAKDOWN] = breakdown;
        i[I_CLAIM] = claim;
        i[I_NEED] = claim;
        i[I_NIF] += claim;
        provisional(i, breakdown, 0);
        set_cond(h, claim);
        return;
    }
    T relres = f[F_RELRES];
    if (i[I_NEED]) {
        f[F_NORMU_NEW] = pymax(small, sqrt_rn(in[1]));
        f[F_ABSRES] = in[0];
        relres = div_rn(in[0], mod ? f[F_NORMU_NEW] : f[F_NORMR0]);
    }
    const bool done = (i[I_CLAIM] && relres < f[F_TOL]) || i[I_BREAKDOWN];
    f[F_RELRES] = relres;
    const bool better = i[I_SAFE] && relres < f[F_BEST];
    if (better) f[F_BEST] = relres;
    i[I_BETTER] = better;
    i[I_STATUS] = 0;
    i[I_CONT] = !done && i[I_IT] < i[I_MAXIT];
    set_cond(h, i[I_CONT]);
}

// The inner tolerance of a round (solvers/refine.py): the remaining
// reduction times 0.3, between the floor and inner_tol, in f64, then
// rounded to the inner solve's type.
template <typename Tin>
__device__ void inner_tol(const double* f, double relres, Tin* inner_f) {
    const double need = pymin(pymax(div_rn(mul_rn(0.3, f[F_TOL]), pymax(relres, 1e-300)),
                                    f[F_INNER_FLOOR]),
                              f[F_INNER_TOL]);
    inner_f[F_TOL] = static_cast<Tin>(need);
}

// Refinement rounds (faspsolver_tpu/solvers/refine.py:219).
//   init   in unused: relres = 1, the entry test
//   round  in = {f64 relative residual after the round}
// i[I_IT] counts rounds, i[I_MAXIT] is max_rounds.
template <typename Tin>
__global__ void refine_control(int phase, const double* in, double* f, int* i,
                               Tin* inner_f, unsigned long long h) {
    double relres = 1.0;
    if (phase == 0) {
        i[I_IT] = 0;
        i[I_NINIT] += 1;
    } else {
        relres = in[0];
        i[I_IT] += 1;
        i[I_NBODY] += 1;
    }
    f[F_RELRES] = relres;
    i[I_CONT] = relres >= f[F_TOL] && i[I_IT] < i[I_MAXIT];
    inner_tol(f, relres, inner_f);
    set_cond(h, i[I_CONT]);
}

// The GMRES family (faspsolver_tpu/krylov/gmres.py:85-250): the scalar
// work of the restart cycles (the outer while_loop) and of each Arnoldi
// step (the inner one).  f / i are the outer loop's region, ia the inner
// loop's (its CONT and NBODY); `arr` holds the window's small arrays, R
// the window (restart, at most maxit), laid out as gmres_arrays says:
// H (R+1) x R row-major, then g (R+1), cs (R), sn (R) and y (R).
//   0 init     in = {absres0, x0.x0, |r0|}; sets the outer CONT
//   1 cycle    in unused: clears arr, g[0] = |r|, the scale of V[0]
//              (1/|r|, 0 at or under SMALLREAL), j = 0; the inner CONT
//   2 arnoldi  in = {h_0 .. h_R (0 past j), hn}: the j earlier rotations
//              on the column, the new one (den > SMALLREAL guard), column
//              j of H, g[j], g[j+1], cs[j], sn[j]; happy breakdown and
//              the least-squares residual's convergence; the inner CONT
//   3 solve    in unused: y from the j x j upper-triangular H y = g, row
//              j-1 first, each row's sum in increasing column; 0 past j
//   4 restart  in = {|r|, absres, x.x} of the true residual: relres, the
//              adaptive restart rule, stagnation against the best relres,
//              the safe iterate's flag; the outer CONT
// Phases 1 and 3 run on a block (the clear, the tile's load); the rest on
// its thread 0.  Phase 3 solves from a shared tile of H's first R rows, g
// and y: at R = 60 in f64 it takes 26.6 us where one thread reading H and
// g where they lie takes 90.0 us (tools/gmres_solve_tile.py, H100).
__host__ __device__ constexpr int gmres_arrays(int R) { return (R + 1) * R + (R + 1) + 3 * R; }

template <typename T>
__global__ void gmres_control(int phase, const T* in, T* f, int* i, int* ia, T* arr, int R,
                              unsigned long long h) {
    const T small = T(FASP_SMALLREAL);
    T* H = arr;
    T* g = H + (R + 1) * R;
    T* cs = g + R + 1;
    T* sn = cs + R;
    T* y = sn + R;
    if (phase == 1) {
        for (int k = threadIdx.x; k < gmres_arrays(R); k += blockDim.x) arr[k] = T(0);
        __syncthreads();
        if (threadIdx.x) return;
        const T r_norm = f[F_R_NORM];
        g[0] = r_norm;
        f[F_SCALE] = r_norm > small ? div_rn(T(1), r_norm) : T(0);
        i[I_J] = 0;
        ia[I_CONT] = 0 < i[I_CUR_RESTART] && i[I_IT] < i[I_MAXIT];
        set_cond(h, ia[I_CONT]);
        return;
    }
    if (phase == 3) {
        extern __shared__ __align__(16) unsigned char gmres_smem[];
        const int j = i[I_J];
        T* Hs = reinterpret_cast<T*>(gmres_smem);
        T* gs = Hs + R * R;
        T* ys = gs + R;
        for (int k = threadIdx.x; k < R * R; k += blockDim.x) Hs[k] = H[k];
        for (int k = threadIdx.x; k < R; k += blockDim.x) gs[k] = g[k];
        __syncthreads();
        for (int k = j + threadIdx.x; k < R; k += blockDim.x) y[k] = T(0);
        if (threadIdx.x) return;
        for (int k = j - 1; k >= 0; --k) {
            T acc = T(0);
            for (int m = k + 1; m < j; ++m) acc = add_rn(acc, mul_rn(Hs[k * R + m], ys[m]));
            ys[k] = div_rn(sub_rn(gs[k], acc), Hs[k * R + k]);
        }
        for (int k = 0; k < j; ++k) y[k] = ys[k];
        return;
    }
    if (threadIdx.x) return;
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    if (phase == 0) {
        init_norms(in[0], in[1], f, i, false);
        f[F_BEST] = f[F_RELRES];
        f[F_STAG_BEST] = f[F_RELRES];
        f[F_R_NORM] = in[2];
        f[F_R_NORM_OLD] = in[2];
        i[I_STAG] = 0;
        i[I_CYCLES] = 0;
        i[I_CUR_RESTART] = R;
        i[I_J] = 0;
        set_cond(h, i[I_CONT]);
        return;
    }
    if (phase == 2) {
        const int j = i[I_J];
        const T hn = in[R + 1];
        for (int k = 0; k <= R; ++k) H[k * R + j] = in[k];
        H[(j + 1) * R + j] = hn;
        for (int k = 0; k < j; ++k) {
            const T hk = H[k * R + j], hk1 = H[(k + 1) * R + j];
            H[k * R + j] = add_rn(mul_rn(cs[k], hk), mul_rn(sn[k], hk1));
            H[(k + 1) * R + j] = add_rn(mul_rn(-sn[k], hk), mul_rn(cs[k], hk1));
        }
        const T a = H[j * R + j], b = H[(j + 1) * R + j];
        const T den = sqrt_rn(add_rn(mul_rn(a, a), mul_rn(b, b)));
        const bool den_ok = den > small;
        const T c = den_ok ? div_rn(a, den) : T(1);
        const T s = den_ok ? div_rn(b, den) : T(0);
        H[j * R + j] = add_rn(mul_rn(c, a), mul_rn(s, b));
        H[(j + 1) * R + j] = T(0);
        const T gj = g[j];
        g[j] = mul_rn(c, gj);
        g[j + 1] = mul_rn(-s, gj);
        cs[j] = c;
        sn[j] = s;
        const bool happy = hn <= T(FASP_HAPPY);
        const bool conv = div_rn(fabs(g[j + 1]), f[F_NORMR0]) < f[F_TOL];
        i[I_J] = j + 1;
        ia[I_NBODY] += 1;
        ia[I_CONT] = j + 1 < i[I_CUR_RESTART] && i[I_IT] + j + 1 < i[I_MAXIT] && !happy && !conv;
        set_cond(h, ia[I_CONT]);
        return;
    }
    // phase 4
    const int j = i[I_J];
    i[I_IT] += j;
    const T r_norm = in[0], absres = in[1];
    const T normu = pymax(small, sqrt_rn(in[2]));
    const T relres = div_rn(absres, mod ? normu : f[F_NORMR0]);
    int cur = i[I_CUR_RESTART];
    if (i[I_ADAPTIVE]) {
        // the reference's rule (KryPvgmres.c:200-210)
        const T cr = div_rn(r_norm, pymax(f[F_R_NORM], small));
        const int shrunk = cur - FASP_RESTART_DEC > FASP_RESTART_MIN ? cur - FASP_RESTART_DEC : R;
        cur = cr > T(FASP_CR_MAX) || i[I_CYCLES] == 0 ? R : cr < T(FASP_CR_MIN) ? cur : shrunk;
    }
    const int stag = relres > mul_rn(T(FASP_STAG_FACTOR), f[F_STAG_BEST]) ? i[I_STAG] + 1 : 0;
    const bool stalled = stag >= FASP_MAX_STAG_CYCLES && relres > mul_rn(T(4), f[F_TOL]);
    const bool done = relres < f[F_TOL] || j == 0 || stalled;
    f[F_STAG_BEST] = pymin(f[F_STAG_BEST], relres);
    f[F_R_NORM_OLD] = f[F_R_NORM];
    f[F_R_NORM] = r_norm;
    f[F_ABSRES] = absres;
    f[F_RELRES] = relres;
    f[F_NORMU_NEW] = normu;
    const bool better = i[I_SAFE] && relres < f[F_BEST];
    if (better) f[F_BEST] = relres;
    i[I_BETTER] = better;
    i[I_CUR_RESTART] = cur;
    i[I_STAG] = stag;
    i[I_CYCLES] += 1;
    i[I_STATUS] = stalled ? FASP_ERR_STAG : 0;
    i[I_NBODY] += 1;
    i[I_CONT] = !done && i[I_IT] < i[I_MAXIT];
    set_cond(h, i[I_CONT]);
}

// The launch of GMRES's control; `R` is the window.  The cycle and solve
// phases take a block of 256 threads, the solve a shared tile of (R + 2) R
// values: above 48 KB the kernel's limit is raised to it first, and a tile
// past the card's opt-in limit (R > 168 in f64 on an H100) is refused.
template <typename T>
int gmres_entry(int phase, const T* in, T* f, int* i, int* ia, T* arr, int R,
                unsigned long long h, void* stream) {
    const int threads = phase == 1 || phase == 3 ? 256 : 1;
    const size_t smem = phase == 3 ? static_cast<size_t>(R + 2) * R * sizeof(T) : 0;
    if (smem > 48 * 1024) {
        int dev = 0, most = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess && smem > static_cast<size_t>(most)) e = cudaErrorInvalidValue;
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(gmres_control<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    gmres_control<T><<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        phase, in, f, i, ia, arr, R, h);
    return static_cast<int>(cudaGetLastError());
}

__global__ void empty_control() {}

// The driver API entry points the graph calls use, from the process's
// libcuda.  cuGraphAddNode is taken in its form without edge data.
struct Driver {
    CUresult (*graphCreate)(CUgraph*, unsigned int);
    CUresult (*graphDestroy)(CUgraph);
    CUresult (*handleCreate)(CUgraphConditionalHandle*, CUgraph, CUcontext, unsigned int,
                             unsigned int);
    CUresult (*addNode)(CUgraphNode*, CUgraph, const CUgraphNode*, size_t, CUgraphNodeParams*);
    CUresult (*addChild)(CUgraphNode*, CUgraph, const CUgraphNode*, size_t, CUgraph);
    CUresult (*getNodes)(CUgraph, CUgraphNode*, size_t*);
    CUresult (*nodeType)(CUgraphNode, CUgraphNodeType*);
    CUresult (*instantiate)(CUgraphExec*, CUgraph, CUDA_GRAPH_INSTANTIATE_PARAMS*);
    CUresult (*launch)(CUgraphExec, CUstream);
    CUresult (*execDestroy)(CUgraphExec);
    CUresult (*ctxGetCurrent)(CUcontext*);
    CUresult (*errorString)(CUresult, const char**);
    bool ok;
};

template <typename F>
bool find(void* lib, const char* name, F& fn) {
    fn = lib ? reinterpret_cast<F>(dlsym(lib, name)) : nullptr;
    return fn != nullptr;
}

Driver load_driver() {
    Driver d = {};
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    d.ok = find(lib, "cuGraphCreate", d.graphCreate)
        && find(lib, "cuGraphDestroy", d.graphDestroy)
        && find(lib, "cuGraphConditionalHandleCreate", d.handleCreate)
        && find(lib, "cuGraphAddNode", d.addNode)
        && find(lib, "cuGraphAddChildGraphNode", d.addChild)
        && find(lib, "cuGraphGetNodes", d.getNodes)
        && find(lib, "cuGraphNodeGetType", d.nodeType)
        && find(lib, "cuGraphInstantiateWithParams", d.instantiate)
        && find(lib, "cuGraphLaunch", d.launch)
        && find(lib, "cuGraphExecDestroy", d.execDestroy)
        && find(lib, "cuCtxGetCurrent", d.ctxGetCurrent)
        && find(lib, "cuGetErrorString", d.errorString);
    return d;
}

const Driver& driver() {
    static const Driver d = load_driver();
    return d;
}

}  // namespace

extern "C" {

// ---- the control kernels: one thread each, on `stream`; `h` is the
// conditional handle to set (0: none).  Each returns a cudaError_t value.

#define FASP_KRYLOV_ENTRY(name, kernel, T)                                          \
    int name(int phase, const T* in, T* f, int* i, unsigned long long h,            \
             void* stream) {                                                        \
        kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(phase, in, f, i, h); \
        return static_cast<int>(cudaGetLastError());                                \
    }

FASP_KRYLOV_ENTRY(fasp_loop_pcg_f32, pcg_control, float)
FASP_KRYLOV_ENTRY(fasp_loop_pcg_f64, pcg_control, double)
FASP_KRYLOV_ENTRY(fasp_loop_bicgstab_f32, bicgstab_control, float)
FASP_KRYLOV_ENTRY(fasp_loop_bicgstab_f64, bicgstab_control, double)
FASP_KRYLOV_ENTRY(fasp_loop_minres_f32, minres_control, float)
FASP_KRYLOV_ENTRY(fasp_loop_minres_f64, minres_control, double)

// the refinement's control; the suffix is the inner solve's type
int fasp_loop_refine_f32(int phase, const double* in, double* f, int* i, float* inner_f,
                         unsigned long long h, void* stream) {
    refine_control<float><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        phase, in, f, i, inner_f, h);
    return static_cast<int>(cudaGetLastError());
}

int fasp_loop_refine_f64(int phase, const double* in, double* f, int* i, double* inner_f,
                         unsigned long long h, void* stream) {
    refine_control<double><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        phase, in, f, i, inner_f, h);
    return static_cast<int>(cudaGetLastError());
}

// GMRES's control (gmres_entry); R is the window
int fasp_loop_gmres_f32(int phase, const float* in, float* f, int* i, int* ia, float* arr,
                        int R, unsigned long long h, void* stream) {
    return gmres_entry(phase, in, f, i, ia, arr, R, h, stream);
}

int fasp_loop_gmres_f64(int phase, const double* in, double* f, int* i, int* ia, double* arr,
                        int R, unsigned long long h, void* stream) {
    return gmres_entry(phase, in, f, i, ia, arr, R, h, stream);
}

// An empty one-thread kernel: the launch floor the control kernels sit on
// (a measurement aid, not counted).
int fasp_loop_empty(void* stream) {
    empty_control<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

// ---- building a resident loop's graph (utils/graphs.py), through the
// driver API: its entry points, looked up in the process's libcuda at
// first use (the library is not linked against it), keep one form
// whatever toolkit builds this file, where the runtime's
// cudaGraphAddNode changed its arguments between toolkits.  Graphs,
// nodes and executable graphs travel as opaque pointers; each call
// returns a CUresult (fasp_graph_error_string names it).

int fasp_graph_create(void** g) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    return d.graphCreate(reinterpret_cast<CUgraph*>(g), 0);
}

int fasp_graph_destroy(void* g) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    return d.graphDestroy(static_cast<CUgraph>(g));
}

// A conditional handle of graph g, reset to 0 at every launch (a kernel
// upstream of its node sets it), in the calling thread's context.
int fasp_graph_handle(void* g, unsigned long long* h) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    CUcontext ctx = nullptr;
    CUresult e = d.ctxGetCurrent(&ctx);
    if (e != CUDA_SUCCESS) return e;
    if (!ctx) return CUDA_ERROR_INVALID_CONTEXT;
    CUgraphConditionalHandle handle = 0;
    e = d.handleCreate(&handle, static_cast<CUgraph>(g), ctx, 0,
                       CU_GRAPH_COND_ASSIGN_DEFAULT);
    *h = static_cast<unsigned long long>(handle);
    return e;
}

// A conditional node over handle h (kind 0: IF, 1: WHILE) in g after
// `dep` (null: first), and its body graph, which g owns.
int fasp_graph_add_conditional(void* g, void* dep, unsigned long long h, int kind,
                               void** node, void** body) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    CUcontext ctx = nullptr;
    CUresult e = d.ctxGetCurrent(&ctx);
    if (e != CUDA_SUCCESS) return e;
    CUgraphNodeParams p = {};
    p.type = CU_GRAPH_NODE_TYPE_CONDITIONAL;
    p.conditional.handle = static_cast<CUgraphConditionalHandle>(h);
    p.conditional.type = kind ? CU_GRAPH_COND_TYPE_WHILE : CU_GRAPH_COND_TYPE_IF;
    p.conditional.size = 1;
    p.conditional.ctx = ctx;
    CUgraphNode dn = static_cast<CUgraphNode>(dep);
    e = d.addNode(reinterpret_cast<CUgraphNode*>(node), static_cast<CUgraph>(g),
                  dep ? &dn : nullptr, dep ? 1 : 0, &p);
    if (e == CUDA_SUCCESS) *body = static_cast<void*>(p.conditional.phGraph_out[0]);
    return e;
}

// A child-graph node in g after `dep` (null: first), embedding a copy
// of `child`.
int fasp_graph_add_child(void* g, void* dep, void* child, void** node) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    CUgraphNode dn = static_cast<CUgraphNode>(dep);
    return d.addChild(reinterpret_cast<CUgraphNode*>(node), static_cast<CUgraph>(g),
                      dep ? &dn : nullptr, dep ? 1 : 0, static_cast<CUgraph>(child));
}

// The number of nodes of `graph` and the kind (CUgraphNodeType) of the
// first one a conditional body refuses — host, event, external
// semaphore, memory allocation or free nodes — or -1.
int fasp_graph_node_kinds(void* graph, size_t* count, int* refused) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    *refused = -1;
    size_t n = 0;
    CUresult e = d.getNodes(static_cast<CUgraph>(graph), nullptr, &n);
    *count = n;
    if (e != CUDA_SUCCESS || n == 0) return e;
    CUgraphNode* nodes = new CUgraphNode[n];
    e = d.getNodes(static_cast<CUgraph>(graph), nodes, &n);
    for (size_t k = 0; e == CUDA_SUCCESS && k < n && *refused < 0; ++k) {
        CUgraphNodeType t;
        e = d.nodeType(nodes[k], &t);
        if (e == CUDA_SUCCESS && t != CU_GRAPH_NODE_TYPE_KERNEL
            && t != CU_GRAPH_NODE_TYPE_MEMCPY && t != CU_GRAPH_NODE_TYPE_MEMSET
            && t != CU_GRAPH_NODE_TYPE_GRAPH && t != CU_GRAPH_NODE_TYPE_EMPTY
            && t != CU_GRAPH_NODE_TYPE_CONDITIONAL)
            *refused = static_cast<int>(t);
    }
    delete[] nodes;
    return e;
}

// Instantiate g into *exec; on failure `result` is the CUgraphInstantiateResult
// and `node_kind` the CUgraphNodeType of the node at fault (-1: none).
int fasp_graph_instantiate(void** exec, void* g, int* result, int* node_kind) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    CUDA_GRAPH_INSTANTIATE_PARAMS p = {};
    CUresult e = d.instantiate(reinterpret_cast<CUgraphExec*>(exec),
                               static_cast<CUgraph>(g), &p);
    *result = static_cast<int>(p.result_out);
    *node_kind = -1;
    if (e != CUDA_SUCCESS && p.hErrNode_out) {
        CUgraphNodeType t;
        if (d.nodeType(p.hErrNode_out, &t) == CUDA_SUCCESS) *node_kind = static_cast<int>(t);
    }
    return e;
}

int fasp_graph_launch(void* exec, void* stream) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    return d.launch(static_cast<CUgraphExec>(exec), static_cast<CUstream>(stream));
}

int fasp_graph_exec_destroy(void* exec) {
    const Driver& d = driver();
    if (!d.ok) return CUDA_ERROR_NOT_FOUND;
    return d.execDestroy(static_cast<CUgraphExec>(exec));
}

const char* fasp_graph_error_string(int err) {
    const Driver& d = driver();
    const char* msg = nullptr;
    if (!d.ok) return "the CUDA driver's graph entry points were not found";
    if (d.errorString(static_cast<CUresult>(err), &msg) != CUDA_SUCCESS || !msg)
        return "unknown CUDA driver error";
    return msg;
}

const char* fasp_loop_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
