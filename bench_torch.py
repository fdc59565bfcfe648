"""Headline benchmark of the PyTorch/CUDA port: AMG-PCG time to 1e-6 on
the 1,046,529-dof 2-D Poisson problem, with ``bench.py``'s stanzas.

    python bench_torch.py               # the CUDA device (raises without one)
    python bench_torch.py --device cpu  # on the CPU, at full size (minutes)

The port of ``bench.py`` (which stays the JAX package's benchmark), stanza
by stanza and in its order, through ``faspsolver_tpu_torch`` alone: it
never imports ``jax`` nor ``faspsolver_tpu``.

Reference baseline (BASELINE.md): CG + classical RS-AMG V-cycle on the same
size problem, gcc -O2, 4 OpenMP threads: setup 1.4029 s + solve 1.5566 s =
2.9973 s total (test/out/poisson-O2-th4.out).  vs_baseline is
reference_total / ours_total (> 1 means faster than the reference).

Configuration: the structured SA-AMG hierarchy in f32 with its exact f64
fine operator (``setup_structured(..., keep_f64_fine=True)``), and the
resident refiner (``solvers.refine.make_resident_refiner``): f64 true
residuals on the device around an f32 AMG-PCG inner solve, refined
against the exact f64 b.  On the card every 2-D stencil apply launches
the hand-written kernel (``csrc/stencil2d.cu``), and PCG, the AMG cycle
and the refiner's f64 stages replay CUDA graphs (``utils/graphs.py``).

Timed regions match the reference's: setup starts from the host CSR
matrix (the move to the device included; a device synchronize ends it),
the solve runs from the f64 b on the host to the f64 x on the host.  The
first solve, run on a warm-up b, captures the CUDA graphs (the
counterpart of bench.py's AOT compile) and is reported apart as
``cold_solve_s``; the timed solve replays them.  Bring-up (CUDA context,
a 32 MB copy each way, the native library's g++ build and the stencil
kernel's nvcc build) is untimed, as process start-up is.  The solution is
verified on the host in f64, untimed.

SpMV metric: chains of k applies of the fine f32 operator, normalised by
``v * rsqrt(v.v)`` once per rep, at k = 1 and k = 8; the marginal time
(t[8] - t[1]) / 7 removes the chain's fixed per-rep cost.  On the card
each chain of ``reps`` reps is one CUDA graph, timed by CUDA events, best
of ``tries``.  The stream probe is a 1-band operator through the same
chain; the HBM probes repeat both at 8192^2 (268 MB per vector, beyond
an H100's 50 MB L2).

Prints lines of readings (each chain's raw best and spread), then ONE
JSON line, last: ``metric``, ``value`` (setup_s + solve_s), ``unit``,
``vs_baseline`` and ``detail``, with bench.py's keys (``general_packed_mb``
is ``general_device_mb`` here, and bench.py's ``fe_auto_warn`` pin is
not ported) plus the port's counters: ``cold_solve_s``, ``host_syncs``
(1 for a resident solve: the one read at its end), ``graph_captures``,
``graph_replays`` (program launches: 1 for a resident solve),
``graph_nodes_replayed``, ``stencil_launches`` (per dtype) and
``loop_control_launches`` (the loop-control kernel's, counted on the
device) for the headline and, prefixed, for the general and fe_auto
solves; for the SPE01 stanza's timed run ``spe01_inner_solves`` (its
refinement rounds' vFGMRES solves), ``spe01_host_syncs`` (the
refinement's: one per round plus the inner solves'; 2 per round when
each inner solve is resident) and ``spe01_graph_replays`` (program
launches: one per resident inner solve); ``chain_launches_per_rep``;
``device_name``, ``power_limit_w``.
"""
from __future__ import annotations

import argparse
import json
import os
import platform as _platform
import shutil
import subprocess
import time

import numpy as np
import torch

NX = 1023                      # 1023^2 = 1,046,529 dof
NH = 8192                      # HBM probes: 8192^2 = 67,108,864 dof
REPS = 100                     # reps per chain, 1M-dof probes
HBM_REPS = 10                  # reps per chain, HBM probes
TRIES = 3
REF_TOTAL_S = 2.9973           # reference -O2 4-thread setup + solve
TOL = 1e-6
HEADLINE_REFINE = dict(tol=TOL, max_rounds=4, maxit_inner=40)
GENERAL_REFINE = dict(tol=TOL, inner_tol=1e-4, inner_floor=1e-4,
                      max_rounds=6, maxit_inner=40)


def _marginal_us(timed_chain, k_lo: int = 1, k_hi: int = 8,
                 reps: int = 100, tries: int = 3) -> tuple:
    """Best-of-N marginal per-op time via two chain lengths (us).
    Returns (marginal_us, fixed_overhead_us)."""
    t_lo = min(timed_chain(k_lo, reps) for _ in range(tries)) / reps
    t_hi = min(timed_chain(k_hi, reps) for _ in range(tries)) / reps
    marg = (t_hi - t_lo) / (k_hi - k_lo)
    fixed = t_lo - marg * k_lo
    return marg * 1e6, max(fixed, 0.0) * 1e6


def resolve_device(device) -> torch.device:
    """``device``, else the CUDA device; where there is none it raises
    instead of running on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch: no CUDA device is available; "
                               "run with --device cpu (main(device=\"cpu\")) "
                               "for the CPU")
        device = "cuda"
    return torch.device(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> tuple:
    """(device name, power limit in W or None), from nvidia-smi where it
    answers, else torch; and nvidia-smi's line."""
    if device.type != "cuda":
        return _platform.processor() or "cpu", None, "cpu"
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        line = out.splitlines()[device.index or 0] if out else ""
        name, _, limit = line.partition(",")
        try:
            return name.strip(), float(limit.split()[0]), line
        except (ValueError, IndexError):
            pass
    name = torch.cuda.get_device_name(device)
    return name, None, name


def bring_up(device) -> None:
    """Untimed, as process start-up: the CUDA context, one 32 MB copy each
    way, the native setup library (g++) and a first stencil launch (the
    kernel's nvcc build)."""
    from faspsolver_tpu_torch import native
    from faspsolver_tpu_torch.ops.operators import StencilNdOperator
    host = torch.ones(8 << 20, dtype=torch.float32)
    dev = host.to(device)
    (dev * 1.5).cpu()
    del host, dev
    native.available()
    op = StencilNdOperator([np.full((1, 1), 0.9995, dtype=np.float32)],
                           ((0, 1),), (8, 8)).to(device)
    op(torch.ones(64, dtype=torch.float32, device=device))
    _sync(device)


def headline_param():
    from faspsolver_tpu_torch.constants import SmootherType
    from faspsolver_tpu_torch.utils.params import AMGParam
    return AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                    polynomial_degree=2, coarse_dof=800,
                    tentative_smooth=0.67)


def general_param():
    """The general stanza's RS-AMG: aggressive (path-1) first-level
    coarsening with standard interpolation, Chebyshev(3), 2+2 sweeps."""
    from faspsolver_tpu_torch.constants import SmootherType
    from faspsolver_tpu_torch.utils.params import AMGParam
    return AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                    polynomial_degree=3, presmooth_iter=2,
                    postsmooth_iter=2, coarse_dof=800, aggressive_level=1)


def structured(A, device):
    """The headline's setup, timed from the host CSR to the hierarchy on
    the device: (hierarchy, seconds)."""
    from faspsolver_tpu_torch.precond.amg import setup_structured
    _sync(device)
    t0 = time.perf_counter()
    hier = setup_structured(A, headline_param(), dtype=torch.float32,
                            smooth_p=True, keep_f64_fine=True,
                            device=device)
    if hier is None or hier.fine64 is None:
        raise RuntimeError("the problem must take the structured path with "
                           "its f64 fine operator")
    _sync(device)
    return hier, time.perf_counter() - t0


def classical(A, device, timings):
    """The general stanza's RS-AMG setup, timed from the host CSR to the
    hierarchy on the device: (hierarchy, seconds); ``timings`` gets the
    seconds per setup phase and the final synchronize's as upload_s."""
    from faspsolver_tpu_torch.precond.amg import setup_rs
    _sync(device)
    t0 = time.perf_counter()
    hier = setup_rs(A, general_param(), dtype=torch.float32,
                    keep_f64_fine=True, timings=timings,
                    filter_smoother=True, device=device)
    t_up = time.perf_counter()
    _sync(device)
    timings["upload_s"] = time.perf_counter() - t_up
    return hier, time.perf_counter() - t0


def refiner(hier, **kw):
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.solvers import make_resident_refiner
    return make_resident_refiner(hier.fine64, hier.levels[0].A,
                                 AMGPrecond(hier), **kw)


def timed_solve(device, run, b) -> tuple:
    """``run`` on ``b`` (host f64, or a device tensor) timed from the
    upload to x on the host, with the kernel launch counts and the graph
    counters set to 0 just before it and read just after:
    (outcome, x, seconds, counters)."""
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils import graphs, loops
    _sync(device)
    stencil2d.reset_launches()
    loops.reset_launches()
    graphs.reset_stats()
    t0 = time.perf_counter()
    out = run(torch.as_tensor(b, dtype=torch.float64, device=device))
    x = out.x.cpu().numpy()
    s = time.perf_counter() - t0
    counters = {
        "host_syncs": out.syncs, "graph_captures": graphs.stats["captures"],
        "graph_replays": graphs.stats["replays"],
        "graph_nodes_replayed": graphs.stats["nodes_replayed"],
        "stencil_launches": {str(k).replace("torch.", ""): v
                             for k, v in stencil2d.launches.items()},
        "loop_control_launches": sum(loops.launches.values())}
    return out, x, s, counters


def warm_and_time(device, run, A, b, prefix):
    """The cold solve on a warm-up b (ones: the graphs' capture), then
    the timed solve on ``b``, verified on the host in f64 (untimed)."""
    _, _, cold_s, _ = timed_solve(
        device, run, torch.ones(A.nrow, dtype=torch.float64, device=device))
    out, x, s, counters = timed_solve(device, run, b)
    verified = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
    print(f"{prefix}: cold solve {cold_s:.4f} s, timed solve {s:.4f} s, "
          f"rounds {out.rounds}, inner iterations {out.iters}, verified "
          f"relres {verified:.3e}, {counters}")
    return out, x, s, verified, {"cold_solve_s": round(cold_s, 4),
                                 **counters}


class Chains:
    """bench.py's marginal-time chains: ``timed(label, op, v0)`` returns
    ``timed_chain(k, reps) -> seconds`` for ``_marginal_us``.  On the card
    each (k, reps) chain is one CUDA graph (``graphs.Program``), captured
    before timing and replayed between CUDA events; its stencil launches
    per rep must be k.  On the CPU it runs eagerly under the host clock.
    ``launches`` keeps launches per rep by label and k; ``samples`` every
    try's seconds."""

    def __init__(self, device):
        self.device = device
        self.launches, self.samples = {}, {}

    @staticmethod
    def _body(op, v, k, reps):
        for _ in range(reps):
            w = v
            for _ in range(k):
                w = op(w)
            v.copy_(w * torch.rsqrt(torch.linalg.vecdot(w, w)))

    def timed(self, label, op, v0):
        from faspsolver_tpu_torch.utils.graphs import Program
        v = v0.clone()
        progs = {}
        self.launches[label] = {}

        def timed_chain(k, reps):
            self.samples.setdefault((label, k), [])
            if self.device.type != "cuda":
                t0 = time.perf_counter()
                self._body(op, v, k, reps)
                s = time.perf_counter() - t0
            else:
                if (k, reps) not in progs:
                    prog = Program(lambda: self._body(op, v, k, reps),
                                   self.device, keep=[v])
                    per_rep = prog.launches[v.dtype] / reps
                    if per_rep != k:
                        raise RuntimeError(f"{label}: {per_rep} stencil "
                                           f"launches per rep, not {k}")
                    self.launches[label][str(k)] = int(per_rep)
                    progs[(k, reps)] = prog
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                progs[(k, reps)].replay()
                end.record()
                end.synchronize()
                s = start.elapsed_time(end) / 1e3
            self.samples[(label, k)].append(s)
            return s

        self._body(op, v, 1, 2)         # warm both shapes
        self._body(op, v, 8, 2)
        return timed_chain

    def report(self, reps):
        for (label, k), ts in self.samples.items():
            print(f"chain {label} k={k}: best {min(ts) / reps * 1e6:.3f} us "
                  f"per rep, spread {min(ts) / reps * 1e6:.3f}-"
                  f"{max(ts) / reps * 1e6:.3f} over {len(ts)} tries of "
                  f"{reps} reps")


def main(device=None, *, nx: int = NX, nh: int = NH, reps: int = REPS,
         tries: int = TRIES) -> dict:
    """Run every stanza and print the JSON line; return its object.
    ``nx``, ``nh``, ``reps`` and ``tries`` shrink the run for a quick
    check on the CPU."""
    device = resolve_device(device)
    from faspsolver_tpu_torch.ops.operators import StencilNdOperator
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils.profiling import tree_nbytes

    # ---- device bring-up (untimed, as process start-up) ----
    bring_up(device)
    device_name, power_w, smi = card(device)
    print(f"card: {smi}")

    t0 = time.perf_counter()
    A = poisson_2d(nx)
    gen_s = time.perf_counter() - t0

    # ---- AMG setup from the host CSR: the cold (first) run is the
    # headline's, the warm (second) run is recorded beside it ----
    setup_runs = []
    for _ in range(2):
        hier, s = structured(A, device)
        setup_runs.append(s)
    setup_s = setup_runs[0]
    b = A.matvec(np.ones(A.nrow))

    # ---- the resident refiner: a warm-up solve captures the graphs,
    # then the timed solve, b (host f64) -> x (host f64) ----
    run = refiner(hier, **HEADLINE_REFINE)
    out, _, solve_s, relres_verified, head = warm_and_time(device, run, A, b,
                                                           "headline")
    total_s = setup_s + solve_s

    # ---- SpMV / stream throughput: marginal-time methodology ----
    chains = Chains(device)
    op = hier.levels[0].A                       # fine stencil op (f32)
    bdev32 = torch.as_tensor(b, dtype=torch.float32, device=device)
    spmv_us, chain_fixed_us = _marginal_us(
        chains.timed("spmv", op, bdev32), reps=reps, tries=tries)
    one_band = StencilNdOperator(
        [np.full((1, 1), 0.9995, dtype=np.float32)], ((0, 1),),
        (nx, nx)).to(device)
    stream_us, _ = _marginal_us(chains.timed("stream", one_band, bdev32),
                                reps=reps, tries=tries)
    chains.report(reps)
    del bdev32, one_band, op, run, hier
    if device.type == "cuda":
        torch.cuda.empty_cache()

    bytes_per = np.dtype(np.float32).itemsize
    n = A.nrow
    spmv_gbs = 2 * n * bytes_per / (spmv_us / 1e6) / 1e9
    stream_gbs = 2 * n * bytes_per / (stream_us / 1e6) / 1e9
    nnz_per_s = A.nnz / (spmv_us / 1e6)

    # ---- HBM probes at nh^2: every element round-trips HBM ----
    hbm = {}
    try:
        nhh = nh * nh
        hbm_reps = min(HBM_REPS, reps)
        hbm_chains = Chains(device)
        vbig = torch.ones(nhh, dtype=torch.float32, device=device)
        one_hbm = StencilNdOperator(
            [np.full((1, 1), 0.9995, dtype=np.float32)], ((0, 1),),
            (nh, nh)).to(device)
        coefs5 = (-0.2499, -0.2499, 0.99999, -0.2499, -0.2499)
        coords5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
        five_hbm = StencilNdOperator(
            [np.full((1, 1), c, dtype=np.float32) for c in coefs5],
            coords5, (nh, nh)).to(device)
        stream_hbm_us, _ = _marginal_us(
            hbm_chains.timed("stream_hbm", one_hbm, vbig), reps=hbm_reps,
            tries=tries)
        spmv_hbm_us, _ = _marginal_us(
            hbm_chains.timed("spmv_hbm", five_hbm, vbig), reps=hbm_reps,
            tries=tries)
        hbm_chains.report(hbm_reps)
        chains.launches.update(hbm_chains.launches)
        del vbig, one_hbm, five_hbm, hbm_chains
        stream_hbm_gbs = 2 * nhh * bytes_per / (stream_hbm_us / 1e6) / 1e9
        spmv_hbm_gbs = 2 * nhh * bytes_per / (spmv_hbm_us / 1e6) / 1e9
        hbm = {
            "stream_hbm_gbs": round(stream_hbm_gbs, 2),
            "spmv_hbm_gbs": round(spmv_hbm_gbs, 2),
            "spmv_vs_hbm_sol": round(spmv_hbm_gbs / stream_hbm_gbs, 3),
            "hbm_probe_dof": nhh,
        }
    except Exception as e:  # noqa: BLE001 -- detail metric, never fatal
        hbm = {"hbm_probe_error": str(e)[:120]}
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- General path: the reference's stored-baseline problem, the
    # P1-FE Poisson matrix, through classical RS-AMG ----
    general = {}
    try:
        from faspsolver_tpu_torch.testgen import (assemble_poisson,
                                                  unit_square_mesh)

        t0 = time.perf_counter()
        mesh = unit_square_mesh(nx + 1)
        Afe, bfe, _ = assemble_poisson(mesh, lambda p: np.ones(len(p)))
        fe_gen_s = time.perf_counter() - t0

        g_tim = {}             # per-phase setup attribution
        hfe, g_setup_s = classical(Afe, device, g_tim)

        g_run = refiner(hfe, **GENERAL_REFINE)
        g_out, _, g_solve_s, g_verified, g_cnt = warm_and_time(
            device, g_run, Afe, bfe, "general")
        general = {
            "general_setup_s": round(g_setup_s, 4),
            "general_solve_s": round(g_solve_s, 4),
            "general_total_s": round(g_setup_s + g_solve_s, 4),
            "general_vs_baseline": round(
                REF_TOTAL_S / (g_setup_s + g_solve_s), 3),
            "general_rounds": int(g_out.rounds),
            "general_inner_iters": int(g_out.iters),
            "general_relres_verified": g_verified,
            "general_converged": bool(g_verified < TOL),
            "general_nnz": Afe.nnz,
            "general_device_mb": round(tree_nbytes(hfe) / 1e6, 1),
            "general_gen_s": round(fe_gen_s, 2),
            **{f"general_{k}": (round(v, 3) if isinstance(v, float)
                                else v) for k, v in g_tim.items()},
            **{f"general_{k}": v for k, v in g_cnt.items()},
        }
        del g_run, hfe
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # ---- fe_auto: the same FE matrix through the headline's
        # structured setup, by the headline's protocol ----
        hauto, a_setup_s = structured(Afe, device)
        a_run = refiner(hauto, **HEADLINE_REFINE)
        a_out, _, a_solve_s, a_verified, a_cnt = warm_and_time(
            device, a_run, Afe, bfe, "fe_auto")
        general.update({
            "fe_auto_setup_s": round(a_setup_s, 4),
            "fe_auto_solve_s": round(a_solve_s, 4),
            "fe_auto_total_s": round(a_setup_s + a_solve_s, 4),
            "fe_auto_vs_baseline": round(
                REF_TOTAL_S / (a_setup_s + a_solve_s), 3),
            "fe_auto_inner_iters": int(a_out.iters),
            "fe_auto_relres_verified": a_verified,
            "fe_auto_converged": bool(a_verified < TOL),
            **{f"fe_auto_{k}": v for k, v in a_cnt.items()},
        })
        del a_run, hauto
    except Exception as e:  # noqa: BLE001 -- detail metric, never fatal
        general = {**general, "general_error": str(e)[:160]}
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- SPE01 (BSR nb=3): f32 UA-AMG-vFGMRES inside f64 host
    # refinement, on the files in FASP_REFDATA (else reference/data) ----
    spe01 = {}
    try:
        from faspsolver_tpu_torch.constants import AggregationType, AMGType
        from faspsolver_tpu_torch.io import read_bsr, read_vec
        from faspsolver_tpu_torch.krylov import vfgmres
        from faspsolver_tpu_torch.ops import device_operator
        from faspsolver_tpu_torch.precond import AMGPrecond
        from faspsolver_tpu_torch.precond.amg import setup_ua_bsr
        from faspsolver_tpu_torch.solvers import solve_refined
        from faspsolver_tpu_torch.utils.params import AMGParam

        data = os.environ.get("FASP_REFDATA", os.path.join("reference",
                                                           "data"))
        Aspe = read_bsr(os.path.join(data, "bsrmat_SPE01.dat"))
        bspe = read_vec(os.path.join(data, "rhs_SPE01.dat"))
        pspe = AMGParam(AMG_type=int(AMGType.UA), coarse_dof=30,
                        aggregation_type=int(AggregationType.VMB),
                        strong_coupled=0.08)

        from faspsolver_tpu_torch.utils import graphs
        solves = [0]

        def spe_run():
            h = setup_ua_bsr(Aspe, pspe, dtype=torch.float32, device=device)
            op32 = device_operator(Aspe, dtype=torch.float32).to(device)
            Ms = AMGPrecond(h)

            def inner(r, tl):
                solves[0] += 1
                return vfgmres(op32, r, M=Ms, tol=tl, maxit=100,
                               restart=30)
            return solve_refined(Aspe, bspe, inner, tol=1e-6,
                                 max_rounds=4, dtype=torch.float32,
                                 device=device)

        spe_run()                      # warm-up (excluded)
        solves[0] = 0
        replays = graphs.stats["replays"]
        t0 = time.perf_counter()
        res_spe = spe_run()
        spe01 = {
            "spe01_total_s": round(time.perf_counter() - t0, 4),
            "spe01_inner_iters": res_spe.inner_iters,
            "spe01_relres": res_spe.relres,
            "spe01_converged": bool(res_spe.converged),
            "spe01_inner_solves": solves[0],
            "spe01_host_syncs": res_spe.syncs,
            "spe01_graph_replays": graphs.stats["replays"] - replays,
        }
    except Exception as e:  # noqa: BLE001 -- detail metric, never fatal
        spe01 = {"spe01_error": str(e)[:120]}

    result = {
        "metric": "amg_pcg_total_time_1M_poisson",
        "value": round(total_s, 4),
        "unit": "s",
        "vs_baseline": round(REF_TOTAL_S / total_s, 3),
        "detail": {
            "setup_s": round(setup_s, 4),
            "setup_warm_s": round(setup_runs[1], 4),
            "solve_s": round(solve_s, 4),
            "refine_rounds": int(out.rounds),
            "inner_iters": int(out.iters),
            "relres": out.relres,
            "relres_verified_f64": relres_verified,
            "converged": bool(relres_verified < TOL),
            **head,
            "spmv_us": round(spmv_us, 1),
            "stream_us": round(stream_us, 1),
            "chain_fixed_overhead_us": round(chain_fixed_us, 1),
            "spmv_gbs": round(spmv_gbs, 2),
            # 1M-dof probes: an 8 MB working set stays in an H100's
            # 50 MB L2; the HBM-bound ceiling is stream_hbm_gbs below
            "stream_onchip_gbs": round(stream_gbs, 2),
            "spmv_vs_stream": round(stream_us / spmv_us, 3)
            if spmv_us > 0 else None,
            **hbm,
            "chain_launches_per_rep": (chains.launches
                                       if device.type == "cuda" else None),
            "spmv_nnz_per_s": round(nnz_per_s / 1e9, 3),
            "n": A.nrow, "nnz": A.nnz,
            "platform": device.type,
            "device_name": device_name,
            "power_limit_w": power_w,
            "dtype": "float32",
            "gen_s": round(gen_s, 3),
            **general,
            **spe01,
        },
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where to run (default: the CUDA device)")
    main(ap.parse_args().device)
