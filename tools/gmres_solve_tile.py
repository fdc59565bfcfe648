#!/usr/bin/env python3
"""Time the GMRES control's back-substitution (the ``SOLVE`` phase of
``gmres_control`` in ``faspsolver_tpu_torch/csrc/loop_control.cu``) with
and without a shared-memory tile, on one GPU.

    python3 tools/gmres_solve_tile.py

The loop is one thread's: row j - 1 first, each row's sum in increasing
column, y[k] = (g[k] - sum) / H[k, k].  Two standalone copies of it are
built here from one template: ``tile`` (a block of 256 threads loads H's
first R rows and g into shared memory, then thread 0 solves there) and
``global`` (one warp; thread 0 reads H and g where they lie, through L1).
For a full window (j = R) at R = 30 and 60, f32 and f64, each is held
bit-equal to the shipped kernel's y on the same arrays and timed with the
shipped kernel and ``torch.linalg.solve_triangular`` on the same R x R
triangle, each as a CUDA graph of 200 launches (CUDA events, best of 5).
Prints one JSON line; the shipped kernel keeps the faster of the two.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// arr as gmres_arrays lays it out: H (R+1) x R row-major, g (R+1), cs, sn, y
template <typename T, bool TILE>
__global__ void solve(T* arr, int R, int j) {
    extern __shared__ __align__(16) unsigned char smem[];
    const T* H = arr;
    const T* g = H + (R + 1) * R;
    T* y = arr + (R + 1) * (R + 1) + 2 * R;
    const T* Hs = H;
    const T* gs = g;
    T* ys = y;
    if (TILE) {
        T* s = reinterpret_cast<T*>(smem);
        for (int k = threadIdx.x; k < R * R; k += blockDim.x) s[k] = H[k];
        for (int k = threadIdx.x; k < R; k += blockDim.x) s[R * R + k] = g[k];
        Hs = s;
        gs = s + R * R;
        ys = s + R * R + R;
        __syncthreads();
    }
    for (int k = j + threadIdx.x; k < R; k += blockDim.x) y[k] = T(0);
    if (threadIdx.x) return;
    for (int k = j - 1; k >= 0; --k) {
        T acc = T(0);
        for (int m = k + 1; m < j; ++m) acc = add_rn(acc, mul_rn(Hs[k * R + m], ys[m]));
        ys[k] = div_rn(sub_rn(gs[k], acc), Hs[k * R + k]);
    }
    if (TILE)
        for (int k = 0; k < j; ++k) y[k] = ys[k];
}

template <typename T, bool TILE>
int launch(T* arr, int R, int j, void* stream) {
    const size_t smem = TILE ? static_cast<size_t>(R + 2) * R * sizeof(T) : 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(solve<T, TILE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    solve<T, TILE><<<1, TILE ? 256 : 32, smem, static_cast<cudaStream_t>(stream)>>>(arr, R, j);
    return static_cast<int>(cudaGetLastError());
}

extern "C" {
int solve_tile_f32(float* a, int R, int j, void* s) { return launch<float, true>(a, R, j, s); }
int solve_tile_f64(double* a, int R, int j, void* s) { return launch<double, true>(a, R, j, s); }
int solve_global_f32(float* a, int R, int j, void* s) { return launch<float, false>(a, R, j, s); }
int solve_global_f64(double* a, int R, int j, void* s) { return launch<double, false>(a, R, j, s); }
}
"""


def _library():
    from faspsolver_tpu_torch.utils import loops
    from faspsolver_tpu_torch.utils.build import BUILD_DIR, build_shared
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, "gmres_solve_tile.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    lib = ctypes.CDLL(build_shared("gmres_solve_tile", [src], loops._nvcc))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("tile", "global"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"solve_{name}_{dt}")
            fn.restype, fn.argtypes = i32, [p, i32, i32, p]
    return lib


def main() -> int:
    import torch
    from faspsolver_tpu_torch.utils import loops
    if not torch.cuda.is_available():
        print("gmres_solve_tile: no CUDA device available", file=sys.stderr)
        return 1
    smi = chip_smoke.card_info(torch)
    lib = _library()
    device = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows = []
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        for R in (30, 60):
            name = f"gmres window {R}"
            blk, reg, inner, arr, R = chip_smoke.gmres_case_state(
                torch, name, dt, device)
            seq = chip_smoke.GMRES_CASES[name][1]
            for phase, vals in seq[:R + 2]:      # init, cycle, R columns
                loops.gmres(phase, torch.tensor(vals or [0.0], dtype=dt,
                                                device=device),
                            reg, inner, arr, R)
            j = int(reg.i[loops.I.J])
            zero = torch.zeros(1, dtype=dt, device=device)
            loops.gmres(loops.SOLVE, zero, reg, inner, arr, R)
            want = arr.clone()
            row = {"dtype": tag, "R": R, "j": j}
            for variant in ("tile", "global"):
                fn = getattr(lib, f"solve_{variant}_{tag}")
                work = arr.clone()
                work[-R:] = 0
                loops.check(fn(work.data_ptr(), R, j, stream()), variant)
                torch.cuda.synchronize()
                chip_smoke.check(torch.equal(work, want),
                                 f"{variant} {tag} R = {R}: y bit-equal to "
                                 f"the shipped kernel's")
                row[f"{variant}_ms"] = chip_smoke.time_ms(
                    torch, lambda x, fn=fn, w=work: loops.check(
                        fn(w.data_ptr(), R, j, stream()), variant),
                    None, graph=True)
            row["shipped_ms"] = chip_smoke.time_ms(
                torch, lambda x: loops.gmres(loops.SOLVE, zero, reg, inner,
                                             arr, R), None, graph=True)
            H, g, *_ = loops.gmres_views(arr, R)
            Ht, gt = H[:R, :R].contiguous(), g[:R, None].contiguous()
            row["library_ms"] = chip_smoke.time_ms(
                torch, lambda x: torch.linalg.solve_triangular(
                    Ht, gt, upper=True), None, graph=True)
            rows.append(row)
            print(f"  solve {tag} R = {R}: tile {row['tile_ms'] * 1e3:.3f} "
                  f"us, global {row['global_ms'] * 1e3:.3f} us, shipped "
                  f"{row['shipped_ms'] * 1e3:.3f} us, solve_triangular "
                  f"{row['library_ms'] * 1e3:.3f} us; {smi}")
    print(json.dumps({"card": smi, "solve": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
