#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's headline solve once on one NVIDIA GPU.

    python3 chip_smoke.py              # the full check (one GPU)
    python3 chip_smoke.py --profile    # plus a torch.profiler pass over one solve

Phases (any failure exits non-zero; nothing is caught and carried on):

1. the card: nvidia-smi name and power limit, torch / CUDA / nvcc versions;
2. build the CUDA stencil kernel (nvcc, sm_90a) and the native setup
   library (g++) from the sources in this checkout;
3. the kernel against its plain PyTorch version on the card, for every
   coefficient form (scalar, factored, full) in f32 and f64, at the main
   paths' shapes (1023^2 5-point, 341^2 9-point, 1023^2 7-point P1-FE) and
   a ragged 17x33 grid;
4. the headline at full size: poisson_2d(1023) (1,046,529 dof), the
   structured SA-AMG setup in f32 with the f64 fine operator, moved to the
   card, then f64 refinement around f32 AMG-PCG (tol 1e-6, 4 rounds, 40
   inner iterations), verified on the host in f64; plus a small solve
   checked against scipy's direct solver;
5. per-apply times of kernel and plain version with CUDA events;
6. the general path at full size: the P1-FE Poisson matrix of
   unit_square_mesh(1024) (1,046,529 dof, 7,317,521 nonzeros) through
   classical RS-AMG (aggressive first level, standard interpolation,
   Chebyshev(3), 2+2 sweeps) in f32 with its f64 fine operator, f64
   refinement (tol 1e-6, inner 1e-4, 6 rounds, 40 inner iterations); its
   7-point fine operators held against the plain version and timed; plus a
   small solve checked against scipy's direct solver;
7. fe_auto: the same FE matrix through the structured setup of phase 4.

Each solve is run once to warm up, then timed with the kernel launch
counts set to 0 just before it and read just after; both dtypes must have
launched.  It prints a JSON line of the kernels, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.  It needs nothing but this
checkout and exits non-zero when no CUDA device is available.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

NX = 1023                 # the headline problem: 1023^2 = 1,046,529 dof
TOL = 1e-6
SEED = 20261016
# JAX package's runs of the same solves (BENCH_r05.json): the counts the
# port should reproduce (not times)
ANCHOR = {"rounds": 2, "inner_iters": 20, "relres": 1.36e-11}
GENERAL_ANCHOR = {"rounds": 2, "inner_iters": 17, "relres": 7.10e-7}
FE_AUTO_ANCHOR = {"inner_iters": 28, "relres": 4.16e-8}
HEADLINE_REFINE = dict(tol=TOL, max_rounds=4, maxit_inner=40)
GENERAL_REFINE = dict(tol=TOL, inner_tol=1e-4, inner_floor=1e-4,
                      max_rounds=6, maxit_inner=40)
REPLACES = {"k1": "faspsolver_tpu/ops/pallas_kernels.py:149",
            "k2": "faspsolver_tpu/ops/pallas_kernels.py:36"}


def check(ok, what):
    """A failed check ends the run (explicit, so it holds under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sh(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout + out.stderr).strip()


def card_info(torch):
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    from faspsolver_tpu_torch.ops.stencil2d import _nvcc
    nvcc = sh([_nvcc([], "")[0], "--version"]).splitlines()[-1]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"nvcc: {nvcc}  python {sys.version.split()[0]}")
    return smi


def build():
    from faspsolver_tpu_torch import native
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils.build import BUILD_LOG
    t0 = time.perf_counter()
    stencil2d.library()
    t1 = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"native setup library: {native.build_error}")
    t2 = time.perf_counter()
    print(f"build: stencil2d (nvcc) {t1 - t0:.2f} s, fasp_native (g++) "
          f"{t2 - t1:.2f} s")
    for line in BUILD_LOG["stencil2d"][2].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


# ---------------------------------------------------------------------------
# phase 3: kernel against plain
# ---------------------------------------------------------------------------

def coords_5pt():
    return ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))


def coords_9pt():
    return tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def coords_fe7():
    """The P1-FE stencil of unit_square_mesh: centre, axis neighbours and
    the (-1,-1)/(1,1) diagonal pair."""
    return ((-1, -1), (-1, 0), (0, -1), (0, 0), (0, 1), (1, 0), (1, 1))


def make_op(form, dims, coords, dtype, rng):
    """A StencilNdOperator whose bands are all of one coefficient form."""
    import numpy as np
    from faspsolver_tpu_torch.ops.operators import (FactoredBand,
                                                    StencilNdOperator,
                                                    factor_band_2d)
    ny, nx = dims
    np_dt = {"f32": np.float32, "f64": np.float64}[dtype]
    bands = []
    for _ in coords:
        if form == "scalar":
            bands.append(rng.standard_normal((1, 1)).astype(np_dt))
        elif form == "full":
            bands.append(rng.standard_normal((ny, nx)).astype(np_dt))
        else:
            # Galerkin-like: interior constant, distinct boundary rows and
            # columns — what factor_band_2d compresses on the hierarchy
            b = np.full((ny, nx), rng.standard_normal())
            b[0, :] = rng.standard_normal()
            b[-1, :] = rng.standard_normal()
            b[:, -1] *= 0.5
            fac = factor_band_2d(b.astype(np_dt))
            check(fac is not None, "test band must factor")
            bands.append(FactoredBand(*fac))
    return StencilNdOperator(bands, coords, dims)


def stencil_bound(op, x):
    """max_ij sum_b |c_b(i,j)| |x(i+dy, j+dx)| by the plain version on
    absolute values: the scale of the forward error bound."""
    from faspsolver_tpu_torch.ops.stencil2d import Band2d, stencil2d_plain
    plan = op.plan()
    absb = [Band2d(b.w.abs(), b.rows, b.rmode, b.cstride) for b in plan.bands]
    return float(stencil2d_plain(x.abs().reshape(plan.dims), absb,
                                 plan.coords).max())


def check_kernel(torch, device, shapes=((NX, NX), (341, 341))):
    """Kernel vs plain on the card.  Bound: both are sums of k products,
    each within gamma_k * sum|c||x| of the exact value (FMA contraction or
    not), so they differ by at most 2 k u * sum|c||x| (u = 2^-24 in f32,
    2^-53 in f64)."""
    import numpy as np
    from faspsolver_tpu_torch.ops.stencil2d import stencil2d_plain
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {"f32": 0.0, "f64": 0.0}
    cases = [(form, dims, coords, dt)
             for dt in ("f32", "f64")
             for form in ("scalar", "factored", "full")
             for dims, coords in ((shapes[0], coords_5pt()),
                                  (shapes[1], coords_9pt()),
                                  (shapes[0], coords_fe7()),
                                  ((17, 33), coords_9pt()))]
    for form, dims, coords, dt in cases:
        op = make_op(form, dims, coords, dt, rng).to(device)
        err = kernel_vs_plain(torch, op, gen, form)
        worst[dt] = max(worst[dt], err)
    return worst


def kernel_vs_plain(torch, op, gen, label):
    """One apply of ``op`` through the kernel against the plain version on
    the same x; the launch is made for the comparison, so the caller's
    count of the main paths' launches is read before it."""
    from faspsolver_tpu_torch.ops.stencil2d import stencil2d_plain
    dims, coords = op.dims, op.coords
    dt = {torch.float32: "f32", torch.float64: "f64"}[op.dtype]
    u = {"f32": 2.0 ** -24, "f64": 2.0 ** -53}[dt]
    x = torch.randn(op.n, generator=gen, device=gen.device, dtype=op.dtype)
    yk = op(x)
    plan = op.plan()
    yp = stencil2d_plain(x.reshape(dims), plan.bands,
                         plan.coords).reshape(-1)
    torch.cuda.synchronize()
    err = float((yk - yp).abs().max())
    scale = stencil_bound(op, x)
    bound = 2 * len(coords) * u
    ok = bool(torch.isfinite(yk).all()) and err <= bound * scale
    print(f"  {label:8s} {dt} {dims[0]}x{dims[1]} k={len(coords)}: "
          f"max|kernel-plain| {err:.3e} = {err / scale:.2e} of "
          f"sum|c||x| (bound {bound:.2e}) {'ok' if ok else 'FAIL'}")
    check(ok, f"kernel agrees with plain: {label} {dt} {dims} k={len(coords)}")
    return err


# ---------------------------------------------------------------------------
# phases 4, 6, 7: the main paths
# ---------------------------------------------------------------------------

def headline_param():
    from faspsolver_tpu_torch.constants import SmootherType
    from faspsolver_tpu_torch.utils.params import AMGParam
    return AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                    polynomial_degree=2, coarse_dof=800,
                    tentative_smooth=0.67)


def general_param():
    """bench.py's general stanza: aggressive (path-1) first-level
    coarsening with standard interpolation, Chebyshev(3), 2+2 sweeps."""
    from faspsolver_tpu_torch.constants import SmootherType
    from faspsolver_tpu_torch.utils.params import AMGParam
    return AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                    polynomial_degree=3, presmooth_iter=2,
                    postsmooth_iter=2, coarse_dof=800, aggressive_level=1)


def setup(torch, A, device):
    from faspsolver_tpu_torch.precond.amg import setup_structured
    hier = setup_structured(A, headline_param(), dtype=torch.float32,
                            smooth_p=True, keep_f64_fine=True, device=device)
    check(hier is not None and hier.fine64 is not None,
          "structured hierarchy with an f64 fine operator")
    return hier


def setup_general(torch, A, device, timings=None):
    from faspsolver_tpu_torch.precond.amg import setup_rs
    hier = setup_rs(A, general_param(), dtype=torch.float32,
                    keep_f64_fine=True, filter_smoother=True,
                    timings=timings, device=device)
    check(hier.fine64 is not None, "RS hierarchy with an f64 fine operator")
    return hier


def solve(torch, hier, b64, refine=HEADLINE_REFINE):
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.solvers import make_resident_refiner
    run = make_resident_refiner(hier.fine64, hier.levels[0].A,
                                AMGPrecond(hier), **refine)
    return run(b64)


def fe_problem():
    """P1-FE Poisson on unit_square_mesh(NX + 1), f = 1: bench.py's
    general and fe_auto problem."""
    import numpy as np
    from faspsolver_tpu_torch.testgen import assemble_poisson, unit_square_mesh
    t0 = time.perf_counter()
    A, b, _ = assemble_poisson(unit_square_mesh(NX + 1),
                               lambda p: np.ones(len(p)))
    print(f"  P1-FE matrix: {A.nrow} dof, {A.nnz} nonzeros, assembled in "
          f"{time.perf_counter() - t0:.2f} s")
    check((A.nrow, A.nnz) == (1_046_529, 7_317_521),
          "the stored-baseline FE problem")
    return A, b


def describe(op) -> str:
    name = type(op).__name__
    if name == "SumOperator":
        return "Sum(" + "+".join(describe(p) for p in op.parts) + ")"
    if name == "HybridDiaOperator":
        return (f"Hybrid({describe(op.dia)}+COO "
                f"{op.rem.vals.numel()})")
    if name == "StencilNdOperator":
        nfac = sum(type(b).__name__ == "FactoredBand" for b in op.bands)
        return f"Stencil(k={len(op.bands)}, factored {nfac})"
    return name


def print_hierarchy(hier):
    for i, l in enumerate(hier.levels):
        extra = ""
        if l.P is not None:
            extra = f", P {type(l.P).__name__}"
        if getattr(l, "Asm", None) is not None:
            extra += f", Asm {describe(l.Asm)}"
        print(f"  L{i} {l.A.shape[0]}: {describe(l.A)}{extra}")
    print(f"  coarse {type(hier.coarse).__name__}; fine64 "
          f"{describe(hier.fine64)}")


def drive(torch, device, A, b, hier, refine, anchor, profile=False):
    """Warm-up solve, then the timed solve with the launch counts set to 0
    just before it and read just after; verified on the host in f64."""
    import numpy as np
    from faspsolver_tpu_torch.ops import stencil2d

    # first solve: loads the kernel library, creates the cuBLAS handle of
    # the coarse matmul — untimed warm-up
    solve(torch, hier, torch.as_tensor(b, device=device), refine)
    sync(torch, device)

    stencil2d.reset_launches()
    t0 = time.perf_counter()
    b64 = torch.as_tensor(b, device=device)
    out = solve(torch, hier, b64, refine)
    x = out.x.cpu().numpy()
    solve_s = time.perf_counter() - t0
    counts = {str(k).replace("torch.", ""): v
              for k, v in stencil2d.launches.items()}

    check(x.shape == (A.nrow,) and bool(np.isfinite(x).all()),
          "finite x of the expected shape")
    relres = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
    print(f"  solve (b in, x on host) {solve_s:.3f} s; rounds {out.rounds} "
          f"(JAX anchor {anchor.get('rounds', '-')}), inner iterations "
          f"{out.iters} (anchor {anchor['inner_iters']}), verified f64 "
          f"relres {relres:.3e} (anchor {anchor['relres']:.2e}), device "
          f"relres {out.relres:.3e}, host syncs {out.syncs}")
    print(f"  stencil-kernel launches during the solve: {counts}")
    if torch.device(device).type == "cuda":
        check(counts["float32"] > 0 and counts["float64"] > 0,
              f"the solve launched the kernel in f32 and f64: {counts}")
    check(relres < TOL, f"verified relres {relres} < {TOL}")
    if profile:
        profile_solve(torch, hier, b64, refine)
    return counts, {"solve_s": solve_s, "rounds": out.rounds,
                    "inner_iters": out.iters, "relres": relres}


def main_path(torch, device, profile=False, nx=NX):
    from faspsolver_tpu_torch.testgen import poisson_2d
    import numpy as np

    t0 = time.perf_counter()
    A = poisson_2d(nx)
    gen_s = time.perf_counter() - t0
    sync(torch, device)
    t0 = time.perf_counter()
    hier = setup(torch, A, device)
    sync(torch, device)
    setup_s = time.perf_counter() - t0
    levels = ", ".join(f"{type(l.A).__name__}({l.A.shape[0]})"
                       for l in hier.levels)
    print(f"  hierarchy: {levels}; fine64 {type(hier.fine64).__name__}")
    print(f"  poisson_2d({nx}) generated in {gen_s:.2f} s; setup (host + "
          f".to(cuda)) {setup_s:.3f} s")
    counts, res = drive(torch, device, A, A.matvec(np.ones(A.nrow)), hier,
                        HEADLINE_REFINE, ANCHOR, profile)
    return hier, counts, {"setup_s": setup_s, **res}


def general_path(torch, device, A, b, profile=False):
    """Phase 6: classical RS-AMG on the FE matrix."""
    timings = {}
    sync(torch, device)
    t0 = time.perf_counter()
    hier = setup_general(torch, A, device, timings)
    sync(torch, device)
    setup_s = time.perf_counter() - t0
    print_hierarchy(hier)
    print(f"  setup (host + .to(cuda)) {setup_s:.3f} s; per phase "
          + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in timings.items()))
    fine = hier.levels[0].A
    check(type(fine).__name__ == "StencilNdOperator" and fine._kernel
          and type(hier.fine64).__name__ == "StencilNdOperator"
          and hier.fine64._kernel,
          "the RS fine level and its f64 operator apply through the kernel")
    counts, res = drive(torch, device, A, b, hier, GENERAL_REFINE,
                        GENERAL_ANCHOR, profile)
    check(abs(res["inner_iters"] - GENERAL_ANCHOR["inner_iters"]) <= 3
          and res["rounds"] <= 3,
          f"general path within 3 inner iterations of "
          f"{GENERAL_ANCHOR['inner_iters']} and <= 3 rounds: {res}")
    return hier, counts, {"setup_s": setup_s, **res,
                          "setup_phases_s": timings}


def fe_auto_path(torch, device, A, b):
    """Phase 7: the FE matrix through the structured setup."""
    sync(torch, device)
    t0 = time.perf_counter()
    hier = setup(torch, A, device)
    sync(torch, device)
    setup_s = time.perf_counter() - t0
    print_hierarchy(hier)
    print(f"  setup (host + .to(cuda)) {setup_s:.3f} s")
    counts, res = drive(torch, device, A, b, hier, HEADLINE_REFINE,
                        FE_AUTO_ANCHOR)
    check(abs(res["inner_iters"] - FE_AUTO_ANCHOR["inner_iters"]) <= 3,
          f"fe_auto within 3 inner iterations of "
          f"{FE_AUTO_ANCHOR['inner_iters']}: {res}")
    return counts, {"setup_s": setup_s, **res}


def small_reference_check(torch, device, setup_fn=None, refine=HEADLINE_REFINE,
                          A=None, label="poisson_2d(63)"):
    """A small solve against scipy's direct solve."""
    import numpy as np
    import scipy.sparse.linalg as spla
    from faspsolver_tpu_torch.testgen import poisson_2d
    A = poisson_2d(63) if A is None else A
    b = np.random.default_rng(SEED).standard_normal(A.nrow)
    hier = (setup_fn or setup)(torch, A, device)
    out = solve(torch, hier, torch.as_tensor(b, device=device), refine)
    x = out.x.cpu().numpy()
    xref = spla.spsolve(A.to_scipy().tocsc(), b)
    err = float(np.linalg.norm(x - xref) / np.linalg.norm(xref))
    print(f"  small check {label}: |x - x_direct|/|x_direct| "
          f"{err:.2e} (bound 1e-4: tol 1e-6 times cond ~2e3)")
    check(bool(np.isfinite(x).all()) and err < 1e-4,
          f"small solve agrees with the direct solve: {err}")


def profile_solve(torch, hier, b64, refine=HEADLINE_REFINE):
    """Device busy share of one solve: kernel time (device rows only, so
    no CPU-op row counts its kernels twice) over the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(torch, hier, b64, refine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    dev = sum(r.self_device_time_total for r in rows
              if getattr(r, "device_type", None) == DeviceType.CUDA)
    print(f"  profile: wall {wall * 1e3:.1f} ms (profiled), device kernel "
          f"time {dev / 1e3:.1f} ms, device busy share "
          f"{(dev / 1e6) / wall:.3f}" if dev else
          "  profile: no device time recorded (not measured)")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15))


# ---------------------------------------------------------------------------
# phase 5: per-apply times
# ---------------------------------------------------------------------------

def time_ms(torch, fn, x, reps=200, tries=5, graph=False):
    """Best-of-``tries`` mean ms per call over ``reps`` back-to-back calls,
    CUDA events.  Eager (graph=False) that is the rate the host can
    enqueue, which bounds short kernels; with graph=True the ``reps``
    calls are captured once in a CUDA graph and replayed, which times
    the device work alone."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn(x)
    def run():
        for _ in range(reps):
            fn(x)

    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    best = float("inf")
    for _ in range(tries):
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def apply_times(torch, ops, smi):
    """Per-apply times of each (label, operator) through the kernel and
    through the plain version, in turns: plain, kernel, kernel, plain."""
    from faspsolver_tpu_torch.ops import stencil2d
    rows = {}
    for label, op in ops:
        plan = op.plan()
        x = torch.ones(op.n, dtype=op.dtype, device="cuda")

        def plain(v, plan=plan):
            return stencil2d.stencil2d_plain(v.view(plan.dims), plan.bands,
                                             plan.coords)

        ts = {}
        for graph in (True, False):
            p1 = time_ms(torch, plain, x, graph=graph)
            k1 = time_ms(torch, plan, x, graph=graph)
            k2 = time_ms(torch, plan, x, graph=graph)
            p2 = time_ms(torch, plain, x, graph=graph)
            ts[graph] = (min(k1, k2), min(p1, p2))
        rows[label] = ts[True]
        (kg, pg), (ke, pe) = ts[True], ts[False]
        print(f"  {label}: device time (graph replay) kernel "
              f"{kg * 1e3:.2f} us, plain {pg * 1e3:.2f} us; eager "
              f"(host enqueue included) kernel {ke * 1e3:.2f} us, plain "
              f"{pe * 1e3:.2f} us per apply (best of 5 x 200, CUDA events; "
              f"{smi})")
    return rows


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    profile = "--profile" in argv

    print("== 1. card")
    smi = card_info(torch)
    print("== 2. build")
    build()
    print("== 3. kernel against plain version")
    worst = check_kernel(torch, device)
    counts, res = {}, {}
    print("== 4. main path: headline")
    hier, counts["headline"], res["headline"] = main_path(torch, device,
                                                          profile)
    small_reference_check(torch, device)
    print("== 5. per-apply times")
    times = apply_times(torch, (
        ("1023^2 f32 factored 5-pt", hier.levels[0].A),
        ("341^2 f32 factored 9-pt", hier.levels[1].A),
        ("1023^2 f64 factored 5-pt", hier.fine64)), smi)
    del hier
    print("== 6. main path: general (classical RS-AMG, P1-FE)")
    A, b = fe_problem()
    hier, counts["general"], res["general"] = general_path(
        torch, device, A, b, profile)
    from faspsolver_tpu_torch.testgen import assemble_poisson, unit_square_mesh
    import numpy as np
    small, _, _ = assemble_poisson(unit_square_mesh(64),
                                   lambda p: np.ones(len(p)))
    small_reference_check(torch, device, setup_general, GENERAL_REFINE,
                          A=small, label="unit_square_mesh(64) RS-AMG")
    gen = torch.Generator(device=device).manual_seed(SEED)
    fe7 = (("1023^2 f32 factored 7-pt FE", hier.levels[0].A),
           ("1023^2 f64 factored 7-pt FE", hier.fine64))
    for (label, op), dt in zip(fe7, ("f32", "f64")):
        worst[dt] = max(worst[dt], kernel_vs_plain(torch, op, gen, "FE"))
    times.update(apply_times(torch, fe7, smi))
    del hier
    print("== 7. main path: fe_auto (structured SA-AMG, P1-FE)")
    counts["fe_auto"], res["fe_auto"] = fe_auto_path(torch, device, A, b)

    src = "faspsolver_tpu_torch/csrc/stencil2d.cu"
    kernels = []
    for dt, tname, cname, repl, also in (
            ("f32", "float", "float32", "k1", "k2"),
            ("f64", "double", "float64", "k2", "k1")):
        k5, p5 = times[f"1023^2 {dt} factored 5-pt"]
        k7, p7 = times[f"1023^2 {dt} factored 7-pt FE"]
        by_path = {path: c[cname] for path, c in counts.items()}
        kernels.append({
            "name": f"stencil2d<{tname}>", "route": "cuda", "source": src,
            "replaces": REPLACES[repl], "also_replaces": REPLACES[also],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst[dt], "ms": k5, "plain_ms": p5,
            "ms_fe7": k7, "plain_ms_fe7": p7})
    print(json.dumps({"kernels": kernels, "main_paths": res}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
