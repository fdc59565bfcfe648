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
//     window's back-substitution), 4 restart (see gmres_entry).
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
// What bounds it: the launch, and then the latency of what one thread
// executes.  An empty graph kernel node takes 0.8 us (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py phase 3); a control launch runs once per
// iteration on whichever SM is free, which may not hold the kernel's code
// yet, so the less code a launch runs the better (one kernel per phase
// beat one kernel over all phases: tools/loop_control_ab.py).  So each
// scalar phase is its own kernel (phase and entry point are template
// arguments: no code of the other phases), on one thread, issuing the
// loads of the fields and inputs it needs at its start (one round trip:
// loads_issued), and setting the conditional last.  GMRES's arnoldi phase chains up to R - 1 rotations
// (R the restart window) and its solve phase R dependent steps of a
// back-substitution: both run from shared memory and registers on one
// warp, unrolled for the window's 32-entry slots (a template argument),
// so what bounds them is that chain's latency (chip_smoke.py phase 3
// reads it from chain_probe).

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

// Keeps the loads above it above it: the compiler would otherwise sink
// each to its first use, after the divisions' slow-path branches, and the
// thread would wait for them one at a time.
__device__ __forceinline__ void loads_issued() { asm volatile("" ::: "memory"); }

// A region's fields in registers: `load` reads them (those a phase never
// reads are dropped by the compiler), the phase computes on the copy,
// `store` writes them back (those it did not change are dropped: the
// pointers are __restrict__).
template <typename T>
struct Fields {
    T f[F_COUNT];
    int i[I_COUNT];

    __device__ __forceinline__ void load(const T* __restrict__ fp, const int* __restrict__ ip) {
#pragma unroll
        for (int k = 0; k < F_COUNT; ++k) f[k] = fp[k];
#pragma unroll
        for (int k = 0; k < I_COUNT; ++k) i[k] = ip[k];
    }

    __device__ __forceinline__ void store(T* __restrict__ fp, int* __restrict__ ip) const {
#pragma unroll
        for (int k = 0; k < F_COUNT; ++k) fp[k] = f[k];
#pragma unroll
        for (int k = 0; k < I_COUNT; ++k) ip[k] = i[k];
    }
};

// initial norms (KryPcg.c:134-160) and the entry test
template <typename T>
__device__ __forceinline__ void init_norms(T absres0, T xx, T* f, int* i, bool extra_done) {
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
__device__ __forceinline__ void provisional(int* i, bool done, int status) {
    i[I_STATUS] = status;
    i[I_CONT] = !done && i[I_IT] < i[I_MAXIT];
}

// The end of a PCG / BiCGstab iteration after the (possible) true
// residual `absres_true` (KryPcg.c:224-324): convergence, the failed
// stagnation and restart budgets, the restart, the status, the safe
// iterate.  BiCGstab has no zero-solution check (its flag stays 0), and
// (stagnated && conv) || (claim && conv) is conv.
template <typename T>
__device__ __forceinline__ void krylov_decide(T absres_true, T* f, int* i) {
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
__device__ __forceinline__ bool pcg_phase(int phase, const T* x, T* f, int* i) {
    const T small = T(FASP_SMALLREAL), small2 = T(FASP_SMALLREAL2), slow = T(0.9);
    if (phase == 0) {
        init_norms(x[0], x[1], f, i, false);
        return i[I_CONT];
    }
    if (phase == 2) {
        krylov_decide(x[0], f, i);
        return i[I_CONT];
    }
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    i[I_IT] += 1;
    i[I_NBODY] += 1;
    const T absres = x[2];
    const T relres = div_rn(absres, mod ? f[F_NORMU] : f[F_NORMR0]);
    const bool breakdown = fabs(x[0]) <= small2;
    const T factor = div_rn(absres, f[F_ABSRES0]);
    const bool zero_sol = factor > slow && x[3] <= small;
    const T normu_new = pymax(small, sqrt_rn(x[4]));
    const T reldiff = div_rn(mul_rn(fabs(x[1]), sqrt_rn(x[5])), normu_new);
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
    return need;
}

// BiCGstab (faspsolver_tpu/krylov/bicgstab.py:56-141).
//   init   in = {absres0, x0.x0}
//   check  in = {rstar.v, t.t, absres, x.x, step.step}
//   decide in = {true absres}
template <typename T>
__device__ __forceinline__ bool bicgstab_phase(int phase, const T* x, T* f, int* i) {
    const T small = T(FASP_SMALLREAL), small2 = T(FASP_SMALLREAL2), slow = T(0.9);
    if (phase == 0) {
        init_norms(x[0], x[1], f, i, false);
        return i[I_CONT];
    }
    if (phase == 2) {
        krylov_decide(x[0], f, i);
        return i[I_CONT];
    }
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    i[I_IT] += 1;
    i[I_NBODY] += 1;
    const T absres = x[2];
    const T relres = div_rn(absres, mod ? f[F_NORMU] : f[F_NORMR0]);
    const bool breakdown = fabs(x[0]) <= small2 || x[1] <= small2;
    const T factor = div_rn(absres, f[F_ABSRES0]);
    const T normu_new = pymax(small, sqrt_rn(x[3]));
    const bool stagnated = factor > slow && i[I_STAG] <= i[I_MAX_STAG]
                           && div_rn(sqrt_rn(x[4]), normu_new) < f[F_MAXDIFF];
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
    return need;
}

// MINRES (faspsolver_tpu/krylov/minres.py:56-111).
//   init   in = {absres0, x0.x0, beta0}
//   check  in = {eta, beta_new}
//   decide in = {true absres, x.x}
template <typename T>
__device__ __forceinline__ bool minres_phase(int phase, const T* x, T* f, int* i) {
    const T small = T(FASP_SMALLREAL);
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    if (phase == 0) {
        init_norms(x[0], x[1], f, i, x[2] <= small);
        f[F_BEST] = f[F_RELRES];
        return i[I_CONT];
    }
    if (phase == 1) {
        i[I_IT] += 1;
        i[I_NBODY] += 1;
        const T relres = div_rn(fabs(x[0]), f[F_NORMR0]);
        const bool claim = relres < f[F_TOL];
        const bool breakdown = x[1] <= small;
        f[F_RELRES] = relres;
        i[I_BREAKDOWN] = breakdown;
        i[I_CLAIM] = claim;
        i[I_NEED] = claim;
        i[I_NIF] += claim;
        provisional(i, breakdown, 0);
        return claim;
    }
    T relres = f[F_RELRES];
    if (i[I_NEED]) {
        f[F_NORMU_NEW] = pymax(small, sqrt_rn(x[1]));
        f[F_ABSRES] = x[0];
        relres = div_rn(x[0], mod ? f[F_NORMU_NEW] : f[F_NORMR0]);
    }
    const bool done = (i[I_CLAIM] && relres < f[F_TOL]) || i[I_BREAKDOWN];
    f[F_RELRES] = relres;
    const bool better = i[I_SAFE] && relres < f[F_BEST];
    if (better) f[F_BEST] = relres;
    i[I_BETTER] = better;
    i[I_STATUS] = 0;
    i[I_CONT] = !done && i[I_IT] < i[I_MAXIT];
    return i[I_CONT];
}

// The inputs phase PHASE (0, 1, 2) of Krylov entry point KIND (0 PCG,
// 1 BiCGstab, 2 MINRES) reads.
template <int KIND, int PHASE>
__host__ __device__ constexpr int krylov_inputs() {
    return KIND == 2 ? (PHASE == 0 ? 3 : 2)
                     : PHASE == 0 ? 2 : PHASE == 2 ? 1 : KIND == 0 ? 6 : 5;
}

// One phase of a Krylov entry point, on one thread: its inputs and the
// region read first, the phase, the region stored, the handle set last
// (the IF handle at the check, else the WHILE one).
template <typename T, int KIND, int PHASE>
__global__ void krylov_control(const T* __restrict__ in, T* __restrict__ fp,
                               int* __restrict__ ip, unsigned long long h) {
    constexpr int N = krylov_inputs<KIND, PHASE>();
    T x[N];
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = in[k];
    Fields<T> r;
    r.load(fp, ip);
    loads_issued();
    const bool cond = KIND == 0 ? pcg_phase(PHASE, x, r.f, r.i)
                    : KIND == 1 ? bicgstab_phase(PHASE, x, r.f, r.i)
                                : minres_phase(PHASE, x, r.f, r.i);
    r.store(fp, ip);
    set_cond(h, cond);
}

// The inner tolerance of a round (solvers/refine.py): the remaining
// reduction times 0.3, between the floor and inner_tol, in f64, then
// rounded to the inner solve's type.
template <typename Tin>
__device__ __forceinline__ Tin inner_tol(const double* f, double relres) {
    const double need = pymin(pymax(div_rn(mul_rn(0.3, f[F_TOL]), pymax(relres, 1e-300)),
                                    f[F_INNER_FLOOR]),
                              f[F_INNER_TOL]);
    return static_cast<Tin>(need);
}

// Refinement rounds (faspsolver_tpu/solvers/refine.py:219), one kernel
// per phase.
//   init   in unused: relres = 1, the entry test
//   round  in = {f64 relative residual after the round}
// i[I_IT] counts rounds, i[I_MAXIT] is max_rounds.  `in` may be the
// region's own f at init (refine.py), where it is not read.
template <typename Tin, int PHASE>
__global__ void refine_control(const double* in, double* __restrict__ fp, int* __restrict__ ip,
                               Tin* __restrict__ inner_f, unsigned long long h) {
    const double relres = PHASE == 0 ? 1.0 : in[0];
    Fields<double> r;
    r.load(fp, ip);
    loads_issued();
    double* f = r.f;
    int* i = r.i;
    if (PHASE == 0) {
        i[I_IT] = 0;
        i[I_NINIT] += 1;
    } else {
        i[I_IT] += 1;
        i[I_NBODY] += 1;
    }
    f[F_RELRES] = relres;
    const bool cond = relres >= f[F_TOL] && i[I_IT] < i[I_MAXIT];
    i[I_CONT] = cond;
    const Tin tol = inner_tol<Tin>(f, relres);
    r.store(fp, ip);
    inner_f[F_TOL] = tol;
    set_cond(h, cond);
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
//   3 solve    in unused: y from the j x j upper-triangular H y = g by
//              columns (the reference BLAS dtrsm's order, without its
//              test for a zero: y[k] = g[k] / H[k,k], then g[m] -=
//              H[m,k] y[k] for every m < k, k from j-1 down); 0 past j
//   4 restart  in = {|r|, absres, x.x} of the true residual: relres, the
//              adaptive restart rule, stagnation against the best relres,
//              the safe iterate's flag; the outer CONT
// One kernel per kind of work (gmres_entry launches them): phases 0 and 4
// on one thread (gmres_scalar), the cycle's clear on a block
// (gmres_cycle), the arnoldi phase on a warp (gmres_arnoldi), the solve
// on a block that loads its tile and one warp that solves (gmres_solve);
// the last two for the window's number of 32-entry slots.
// The window is at most GMRES_MAX_WINDOW (the solve's registers) and its
// tile, H's R x R upper triangle, g and the steps' diagonal and
// superdiagonal entries, must fit the card's shared memory (R <= 237 in
// f64 on an H100).
__host__ __device__ constexpr int gmres_arrays(int R) { return (R + 1) * R + (R + 1) + 3 * R; }

constexpr int GMRES_SLOTS = 8;                       // g entries a lane keeps
constexpr int GMRES_MAX_WINDOW = 32 * GMRES_SLOTS;
constexpr int GMRES_BLOCK = 256;
constexpr int GMRES_BATCH = 16;                      // tile entries a thread loads at once

// phases 0 (init) and 4 (restart), one kernel each on one thread
template <typename T>
__device__ __forceinline__ bool gmres_scalar_phase(int phase, const T* x, T* f, int* i, int R) {
    const T small = T(FASP_SMALLREAL);
    const bool mod = i[I_STOP] == FASP_MOD_REL_RES;
    if (phase == 0) {
        init_norms(x[0], x[1], f, i, false);
        f[F_BEST] = f[F_RELRES];
        f[F_STAG_BEST] = f[F_RELRES];
        f[F_R_NORM] = x[2];
        f[F_R_NORM_OLD] = x[2];
        i[I_STAG] = 0;
        i[I_CYCLES] = 0;
        i[I_CUR_RESTART] = R;
        i[I_J] = 0;
        return i[I_CONT];
    }
    const int j = i[I_J];
    i[I_IT] += j;
    const T r_norm = x[0], absres = x[1];
    const T normu = pymax(small, sqrt_rn(x[2]));
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
    return i[I_CONT];
}

template <typename T, int PHASE>
__global__ void gmres_scalar(const T* __restrict__ in, T* __restrict__ fp, int* __restrict__ ip,
                             int R, unsigned long long h) {
    const T x[3] = {in[0], in[1], in[2]};
    Fields<T> r;
    r.load(fp, ip);
    loads_issued();
    const bool cond = gmres_scalar_phase(PHASE, x, r.f, r.i, R);
    r.store(fp, ip);
    set_cond(h, cond);
}

// phase 1 (cycle): the block clears the arrays, thread 0 the rest
template <typename T>
__global__ void gmres_cycle(T* __restrict__ fp, int* __restrict__ ip, int* __restrict__ ia,
                            T* __restrict__ arr, int R, unsigned long long h) {
    const T r_norm = fp[F_R_NORM];
    const int cur = ip[I_CUR_RESTART], it = ip[I_IT], maxit = ip[I_MAXIT];
    loads_issued();
    for (int k = threadIdx.x; k < gmres_arrays(R); k += blockDim.x) arr[k] = T(0);
    __syncthreads();
    if (threadIdx.x) return;
    const T small = T(FASP_SMALLREAL);
    arr[(R + 1) * R] = r_norm;                                     // g[0]
    fp[F_SCALE] = r_norm > small ? div_rn(T(1), r_norm) : T(0);
    ip[I_J] = 0;
    const bool cont = 0 < cur && it < maxit;
    ia[I_CONT] = cont;
    set_cond(h, cont);
}

// phase 2 (arnoldi), on one warp, S = ceil((R + 1) / 32) slots: lane l
// loads entries l, l + 32, ... of the column, g, cs and sn into
// registers, all before any is used (one round trip), and puts them in
// shared memory; the lanes write the column's entries past j + 1 back as
// they came, and lane 0 runs the rotation chain (the value carried from
// rotation k - 1 in a register; only -sn[k] * hk and the add are on the
// chain; its shared-memory loads have no store to wait behind) and the
// new rotation, storing each rotated entry straight to H.  Each element
// takes the same operations in the same order as the twin's ARNOLDI.
template <typename T, int S>
__global__ void gmres_arnoldi(const T* __restrict__ in, T* __restrict__ fp, int* __restrict__ ip,
                              int* __restrict__ ia, T* __restrict__ arr, int R,
                              unsigned long long h) {
    extern __shared__ __align__(16) unsigned char gmres_smem[];
    T* col = reinterpret_cast<T*>(gmres_smem);      // R + 1: the column of H
    T* gs = col + R + 1;                            // R + 1
    T* css = gs + R + 1;                            // R
    T* sns = css + R;                               // R
    T* H = arr;
    T* g = H + (R + 1) * R;
    T* cs = g + R + 1;
    T* sn = cs + R;
    const int lane = threadIdx.x;
    T vi[S], vg[S], vc[S], vs[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int k = 32 * s + lane;
        vi[s] = k <= R ? in[k] : T(0);
        vg[s] = k <= R ? g[k] : T(0);
        vc[s] = k < R ? cs[k] : T(0);
        vs[s] = k < R ? sn[k] : T(0);
    }
    const int j = ip[I_J];
    const T hn = in[R + 1];
    const T normr0 = fp[F_NORMR0], tol = fp[F_TOL];
    const int cur = ip[I_CUR_RESTART], it = ip[I_IT], maxit = ip[I_MAXIT];
    const int nbody = ia[I_NBODY];
    loads_issued();
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int k = 32 * s + lane;
        if (k <= R) {
            col[k] = vi[s];
            gs[k] = vg[s];
        }
        if (k < R) {
            css[k] = vc[s];
            sns[k] = vs[s];
        }
        if (k > j + 1 && k <= R) H[k * R + j] = vi[s];
    }
    __syncwarp();
    if (lane) return;
    const T small = T(FASP_SMALLREAL);
    T hk = col[0];
#pragma unroll 8
    for (int k = 0; k < j; ++k) {
        const T c = css[k], s = sns[k], hk1 = col[k + 1];
        H[k * R + j] = add_rn(mul_rn(c, hk), mul_rn(s, hk1));
        hk = add_rn(mul_rn(-s, hk), mul_rn(c, hk1));
    }
    const T a = hk, b = hn;
    const T den = sqrt_rn(add_rn(mul_rn(a, a), mul_rn(b, b)));
    const bool den_ok = den > small;
    const T c = den_ok ? div_rn(a, den) : T(1);
    const T s = den_ok ? div_rn(b, den) : T(0);
    H[j * R + j] = add_rn(mul_rn(c, a), mul_rn(s, b));
    H[(j + 1) * R + j] = T(0);
    const T gj = gs[j];
    const T gj1 = mul_rn(-s, gj);
    g[j] = mul_rn(c, gj);
    g[j + 1] = gj1;
    cs[j] = c;
    sn[j] = s;
    const bool happy = hn <= T(FASP_HAPPY);
    const bool conv = div_rn(fabs(gj1), normr0) < tol;
    ip[I_J] = j + 1;
    ia[I_NBODY] = nbody + 1;
    const bool cont = j + 1 < cur && it + j + 1 < maxit && !happy && !conv;
    ia[I_CONT] = cont;
    set_cond(h, cont);
}

// phase 3 (solve).  The block loads H's R x R upper triangle into shared
// memory, packed by columns (column k's rows 0..k at k (k + 1) / 2), and g
// after it: each thread reads GMRES_BATCH entries of H's first R rows
// (coalesced) before it stores any, so R <= 64 takes one round trip; y
// past j is zeroed.  Warp 0 lays out what each step reads by step: H[k,k]
// and H[k,k+1].
// Then warp 0 solves, lane l keeping g[32 s + l] in register gr[s], s <
// S = ceil(R / 32).
// Step k (from j - 1 down) finishes g[k] with its last term, g[k] -
// H[k,k+1] y[k+1], on every lane (the lanes hold g[k] less its earlier
// terms, broadcast by a shuffle during step k + 1), divides by H[k,k]
// (the owner lane keeps y[k] to store at the end), takes y[k+1] off the
// lane's g[m], m <= k, and broadcasts g[k-1] for the next step.  The
// chain per step is a multiply, a subtract and a division; the shuffle,
// the updates and the next step's reads run beside it.  Every g[m] takes
// its terms in the twin's order (y[j-1] first).
template <typename T, int S>
__global__ void gmres_solve(const int* __restrict__ ip, T* __restrict__ arr, int R) {
    constexpr unsigned FULL = 0xffffffffu;
    extern __shared__ __align__(16) unsigned char gmres_smem[];
    T* tri = reinterpret_cast<T*>(gmres_smem);
    T* gsh = tri + R * (R + 1) / 2;                 // g
    T* dsh = gsh + R;                               // H[k,k]
    T* ush = dsh + R;                               // H[k,k+1]
    const T* H = arr;
    const T* g = H + (R + 1) * R;
    T* y = arr + gmres_arrays(R) - R;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int j = ip[I_J];
    T gr[S];
    if (warp == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int m = 32 * s + lane;
            gr[s] = m < R ? g[m] : T(0);
            if (m < R) gsh[m] = gr[s];
        }
    }
    // entry q of H's first R rows is (m, k) = (q / R, q % R); the quotient
    // from a float product, exact here: (q + 1/2) / R is at least 1/(2 R)
    // from an integer, the product's error under 1e-5
    const int n = R * R;
    const float inv = 1.0f / static_cast<float>(R > 0 ? R : 1);
    for (int q0 = threadIdx.x; q0 < n; q0 += GMRES_BATCH * GMRES_BLOCK) {
        T v[GMRES_BATCH];
#pragma unroll
        for (int u = 0; u < GMRES_BATCH; ++u) {
            const int q = q0 + u * GMRES_BLOCK;
            v[u] = q < n ? H[q] : T(0);
        }
        loads_issued();
#pragma unroll
        for (int u = 0; u < GMRES_BATCH; ++u) {
            const int q = q0 + u * GMRES_BLOCK;
            const int m = static_cast<int>((static_cast<float>(q) + 0.5f) * inv), k = q - m * R;
            if (q < n && m <= k) tri[k * (k + 1) / 2 + m] = v[u];
        }
    }
    for (int k = j + threadIdx.x; k < R; k += GMRES_BLOCK) y[k] = T(0);
    __syncthreads();
    if (warp) return;
    // what each step reads of H, laid out by step before the chain starts
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int k = 32 * s + lane;
        if (k < j) {
            const T d = tri[k * (k + 1) / 2 + k];
            dsh[k] = d;
            ush[k] = k + 1 < j ? tri[(k + 1) * (k + 2) / 2 + k] : T(0);
        }
    }
    __syncwarp();
    // step j - 1's values; y stays in the owner lane's yr until the end
    const int top = j > 0 ? j - 1 : 0;
    T gp = gsh[top], dn = dsh[top], un = ush[top];
    T ynext = T(0), yr[S];
#pragma unroll
    for (int s = 0; s < S; ++s) yr[s] = T(0);
#pragma unroll
    for (int s = S - 1; s >= 0; --s) {
        if (32 * s >= j) continue;
#pragma unroll 1
        for (int l = min(31, j - 1 - 32 * s); l >= 0; --l) {
            // the step's values were read during the one before; the
            // next step's are read now, beside the chain
            const int k = 32 * s + l;
            const T d = dn, u = un;
            const int kn = k > 0 ? k - 1 : 0;
            dn = dsh[kn];
            un = ush[kn];
            const bool more = k + 1 < j;                 // y[k+1] exists
            const T* colk1 = tri + (more ? (k + 1) * (k + 2) / 2 : 0);
            const T gk = more ? sub_rn(gp, mul_rn(u, ynext)) : gp;
#pragma unroll
            for (int t = 0; t <= s; ++t) {
                const int m = 32 * t + lane;
                const bool take = more && m <= k;
                const T upd = sub_rn(gr[t], mul_rn(take ? colk1[m] : T(0), ynext));
                gr[t] = take ? upd : gr[t];
            }
            gp = __shfl_sync(FULL, l > 0 ? gr[s] : gr[s > 0 ? s - 1 : 0], (l + 31) & 31);
            const T yk = div_rn(gk, d);
            yr[s] = lane == l ? yk : yr[s];
            ynext = yk;
        }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
        if (32 * s + lane < j) y[32 * s + lane] = yr[s];
}

// The launches of the two phases unrolled for S slots (see gmres_entry).
template <typename T, int S>
int launch_arnoldi(const T* in, T* f, int* i, int* ia, T* arr, int R, unsigned long long h,
                   cudaStream_t st) {
    gmres_arnoldi<T, S><<<1, 32, (4 * R + 2) * sizeof(T), st>>>(in, f, i, ia, arr, R, h);
    return 0;
}

template <typename T, int S>
int launch_solve(const int* i, T* arr, int R, cudaStream_t st) {
    const size_t smem = (static_cast<size_t>(R) * (R + 1) / 2 + 3 * R) * sizeof(T);
    if (smem > 48 * 1024) {
        int dev = 0, most = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess && smem > static_cast<size_t>(most)) e = cudaErrorInvalidValue;
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(gmres_solve<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    gmres_solve<T, S><<<1, GMRES_BLOCK, smem, st>>>(i, arr, R);
    return 0;
}

// The launch of GMRES's control; `R` is the window.  The arnoldi and solve
// kernels are unrolled for the window's slots: ceil((R + 1) / 32) and
// ceil(R / 32).  The solve's tile, R (R + 1) / 2 + 3 R values, raises the
// kernel's shared-memory limit above 48 KB first; a window past
// GMRES_MAX_WINDOW or a tile past the card's opt-in limit is refused.
template <typename T>
int gmres_entry(int phase, const T* in, T* f, int* i, int* ia, T* arr, int R,
                unsigned long long h, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (R < 0 || R > GMRES_MAX_WINDOW) return static_cast<int>(cudaErrorInvalidValue);
    int e = 0;
    switch (phase) {
        case 0: gmres_scalar<T, 0><<<1, 1, 0, st>>>(in, f, i, R, h); break;
        case 1: gmres_cycle<T><<<1, GMRES_BLOCK, 0, st>>>(f, i, ia, arr, R, h); break;
        case 2:
            switch (R / 32 + 1) {
#define FASP_ARNOLDI(n) case n: e = launch_arnoldi<T, n>(in, f, i, ia, arr, R, h, st); break;
                FASP_ARNOLDI(1) FASP_ARNOLDI(2) FASP_ARNOLDI(3) FASP_ARNOLDI(4) FASP_ARNOLDI(5)
                FASP_ARNOLDI(6) FASP_ARNOLDI(7) FASP_ARNOLDI(8) FASP_ARNOLDI(9)
#undef FASP_ARNOLDI
                default: e = cudaErrorInvalidValue;
            }
            break;
        case 3:
            switch (R > 0 ? (R + 31) / 32 : 1) {
#define FASP_SOLVE(n) case n: e = launch_solve<T, n>(i, arr, R, st); break;
                FASP_SOLVE(1) FASP_SOLVE(2) FASP_SOLVE(3) FASP_SOLVE(4)
                FASP_SOLVE(5) FASP_SOLVE(6) FASP_SOLVE(7) FASP_SOLVE(8)
#undef FASP_SOLVE
                default: e = cudaErrorInvalidValue;
            }
            break;
        case 4: gmres_scalar<T, 4><<<1, 1, 0, st>>>(in, f, i, R, h); break;
        default: e = cudaErrorInvalidValue;
    }
    return e ? e : static_cast<int>(cudaGetLastError());
}

// A measurement aid (not counted): one warp runs `n` links of a dependent
// chain, each link what one step of a GMRES phase has on its critical
// path: kind 0 the arnoldi phase's rotation (a multiply and an add),
// kind 1 the solve's f64 step (a multiply, a subtract and a division).
// Timed against n = 0 it gives the card's latency per link.
__global__ void chain_probe(int kind, int n, double* v) {
    double x = v[0];
    const double c = v[1], s = v[2], d = v[3];
    if (kind == 0) {
        for (int k = 0; k < n; ++k) x = add_rn(mul_rn(-s, x), c);
    } else {
        for (int k = 0; k < n; ++k) x = div_rn(sub_rn(c, mul_rn(s, x)), d);
    }
    if (threadIdx.x == 0) v[4] = x;
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

// phase 0, 1 or 2 of Krylov entry point KIND on one thread
template <typename T, int KIND>
int krylov_entry(int phase, const T* in, T* f, int* i, unsigned long long h, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (phase == 0) krylov_control<T, KIND, 0><<<1, 1, 0, st>>>(in, f, i, h);
    else if (phase == 1) krylov_control<T, KIND, 1><<<1, 1, 0, st>>>(in, f, i, h);
    else if (phase == 2) krylov_control<T, KIND, 2><<<1, 1, 0, st>>>(in, f, i, h);
    else return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

// the refinement's phase 0 or 1; Tin is the inner solve's type
template <typename Tin>
int refine_entry(int phase, const double* in, double* f, int* i, Tin* inner_f,
                 unsigned long long h, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (phase == 0) refine_control<Tin, 0><<<1, 1, 0, st>>>(in, f, i, inner_f, h);
    else if (phase == 1) refine_control<Tin, 1><<<1, 1, 0, st>>>(in, f, i, inner_f, h);
    else return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ---- the control kernels, on `stream`; `h` is the conditional handle to
// set (0: none).  Each returns a cudaError_t value.

#define FASP_KRYLOV_ENTRY(name, KIND, T)                                            \
    int name(int phase, const T* in, T* f, int* i, unsigned long long h,            \
             void* stream) {                                                        \
        return krylov_entry<T, KIND>(phase, in, f, i, h, stream);                   \
    }

FASP_KRYLOV_ENTRY(fasp_loop_pcg_f32, 0, float)
FASP_KRYLOV_ENTRY(fasp_loop_pcg_f64, 0, double)
FASP_KRYLOV_ENTRY(fasp_loop_bicgstab_f32, 1, float)
FASP_KRYLOV_ENTRY(fasp_loop_bicgstab_f64, 1, double)
FASP_KRYLOV_ENTRY(fasp_loop_minres_f32, 2, float)
FASP_KRYLOV_ENTRY(fasp_loop_minres_f64, 2, double)

// the refinement's control; the suffix is the inner solve's type
int fasp_loop_refine_f32(int phase, const double* in, double* f, int* i, float* inner_f,
                         unsigned long long h, void* stream) {
    return refine_entry(phase, in, f, i, inner_f, h, stream);
}

int fasp_loop_refine_f64(int phase, const double* in, double* f, int* i, double* inner_f,
                         unsigned long long h, void* stream) {
    return refine_entry(phase, in, f, i, inner_f, h, stream);
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

// chain_probe on one warp (a measurement aid, not counted): v holds {x,
// c, s, d} and receives the chain's end in v[4]
int fasp_loop_chain_probe(int kind, int n, double* v, void* stream) {
    chain_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(kind, n, v);
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
