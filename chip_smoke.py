#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's headline solve once on one NVIDIA GPU.

    python3 chip_smoke.py              # the full check (one GPU)
    python3 chip_smoke.py --profile    # plus a torch.profiler pass over one solve
    python3 chip_smoke.py --kernel-only  # phases 1-3, then stop
    python3 chip_smoke.py --block-only   # phases 1-3 and 9, then stop
    python3 chip_smoke.py --surface-only # phases 1-3 and 10, then stop
    python3 chip_smoke.py --harness-only # phases 1-3 and 11, then stop
    python3 chip_smoke.py --regression-only  # phases 1-3 and 12, then stop
    python3 chip_smoke.py --parallel-only    # phases 1-3 and 13, then stop
    python3 chip_smoke.py --tutorials-only   # phases 1-3 and 14, then stop
    python3 chip_smoke.py --bench-only       # phases 1-3 and 15, then stop

Phases (any failure exits non-zero; nothing is caught and carried on):

1. the card: nvidia-smi name and power limit, torch / CUDA / nvcc versions;
2. build the CUDA stencil kernel and the loop-control kernel (nvcc,
   sm_90a) and the native setup library (g++, from
   faspsolver_tpu_torch/csrc/, whose paths it prints) from the sources in
   this checkout, the three compilers started together;
3. the stencil kernel against its plain PyTorch version on the card, for
   every coefficient form (scalar, factored, full) in f32 and f64, at the
   main paths' shapes (1023^2 5-point, 341^2 9-point, 1023^2 7-point
   P1-FE) and a ragged 17x33 grid; then every entry point of the
   loop-control kernel (PCG, BiCGstab, MINRES, refinement) over the
   edge-case table LOOP_CASES in f32 and f64, its state block after each
   step bit-equal to its plain twin's, and its launch time beside an
   empty one-thread kernel's; then its GMRES entry point over
   GMRES_CASES the same way (block and window arrays bit-equal), the
   latency per link of the two dependent chains, and the times of one Arnoldi step's rotations at
   j = R - 1 and one window's back-substitution at j = R, for R = 30 and
   60 in f64, each beside the launch floor plus its chain; then its
   multigrid entry point (``mg``) over MG_CASES (both forms of the test,
   NaN included) the same way, and one check launch's time in f32 and
   f64 beside the empty kernel; then GCG / GCR's entry point (``gcr``)
   over GCR_CASES the same way (NaN fields compared as NaN), and one step
   launch's time in f32 and f64 beside the empty kernel;
4. the headline at full size: poisson_2d(1023) (1,046,529 dof), the
   structured SA-AMG setup in f32 with the f64 fine operator, moved to the
   card, then f64 refinement around f32 AMG-PCG (tol 1e-6, 4 rounds, 40
   inner iterations), verified on the host in f64; plus a small solve
   checked against scipy's direct solver;
5. per-apply times of kernel and plain version with CUDA events, each
   beside its roofline bound, an empty kernel on the same grid (what a
   launch costs), ``A_csr @ x`` (the operator's matrix as a
   ``torch.sparse_csr_tensor``: cuSPARSE's SpMV) and, for the scalar
   form, ``F.conv2d`` (library calls that compute the same function;
   timed here, used nowhere in the port): the main paths' operators, the
   scalar and full forms at 1023^2,
   and the scalar 5-point stencil and a 1-band stream probe at 4096^2 and
   8192^2 (beyond the L2);
6. the general path at full size: the P1-FE Poisson matrix of
   unit_square_mesh(1024) (1,046,529 dof, 7,317,521 nonzeros) through
   classical RS-AMG (aggressive first level, standard interpolation,
   Chebyshev(3), 2+2 sweeps) in f32 with its f64 fine operator, f64
   refinement (tol 1e-6, inner 1e-4, 6 rounds, 40 inner iterations); its
   7-point fine operators held against the plain version and timed; plus a
   small solve checked against scipy's direct solver;
7. fe_auto: the same FE matrix through the structured setup of phase 4;
8. drivers, the user entry point: ``ini/input.dat`` (CG + classical
   RS-AMG with C/F-ordered Gauss-Seidel), ``sa.dat``, ``ua.dat`` and
   ``bamg.dat`` through the port's CLI (``__main__.main``) on
   poisson_2d(1023) in float64, each held to the JAX CLI's iteration
   count and verified relres < 1e-6, then timed again as setup and solve;
   ``input.dat`` once more through the CLI with no device argument, which
   must run on the card; then one float64 solve per new Krylov method, cycle, smoother and
   setup on poisson_fe_manufactured(64), each held to its JAX anchor
   (the Krylov rows resident: one launch, one read, and their eager
   loop's result), and one resident GCG descent step timed at each
   window GCG / GCR take (GCG_STEP_WINDOWS);
9. block and factorization preconditioners, every solve through the
   port's drivers or CLI with no device argument, in float64 unless it
   refines: (a) block_poisson_3d(64, nb=3) (786,432 dof, BSR) under
   vFGMRES + UA-BSR AMG with ini/bsr.dat's parameters, bench.py's
   reservoir stanza (f32 UA-BSR, and SA-BSR, inside solve_refined),
   near-kernel AMG, true block ILU(0) and block Jacobi, every Krylov
   loop of each row resident (one launch, one read) and its first solve
   rerun warm and as the eager loop from the same state, timed, with
   the same count and x (bit-equal, or within X_DIFF_LIMITS where the
   UA-BSR restriction adds with atomics); (b) ILUk(0) and
   ILUt under CG through the CLI on poisson_2d(1023), each apply timed as
   the eager loop over its levels and as the replay of its CUDA graph;
   (c) forward (GMRES) and symmetric (CG) Schwarz through the CLI on
   poisson_2d(1023), each Krylov loop resident (one launch, one read)
   and its solve rerun warm and as the eager loop, x bit-equal; (d) the
   ILU / Schwarz level smoothers, energy-min
   interpolation, CR coarsening, ILU-M, ILUtp and Schwarz on
   poisson_fe_manufactured(64).  Each is held to its JAX count and its
   tolerance, and one BsrEll SpMV, block Gauss-Seidel sweep, block ILU,
   scalar ILU and Schwarz apply on the card is held against the same
   module on the CPU;
10. the rest of the solver surface, every solve through the port's
   drivers (or its GMG, Krylov, eigen and C API entry points) with no
   device argument, in float64: (a) block_poisson_3d(64, nb=3) in band
   form (STR, 786,432 dof): its operator against the BSR one, CG + block
   diagonal, vFGMRES + banded block ILU(0) / ILU(1), block Gauss-Seidel
   and Schwarz; (b) the same matrix field by field as a 3 x 3 BLC under
   the block preconditioner in its four modes, and poisson_3d(96) in 12
   z-slabs (884,736 dof) under the sweeping preconditioner; in (a) and
   (b) every Krylov loop resident (one launch, one read), each row's
   solve rerun warm and as the eager loop: the same count, x bit-equal
   (within X_DIFF_LIMITS over BLC's UA-AMG blocks); (c) matrix-
   free geometric multigrid at n = 1024 (2-D) and 128 (3-D), held to the
   O(h^2) error too, each row cold, warm and as the eager loop; (d) a
   MatFreeOperator over the f64 1023^2 stencil operator (it must launch
   the f64 kernel) and over the ELL operator through the six matfree
   Krylov methods, each loop resident (the wrapped operators declare
   themselves capturable) and rerun warm and as the eager loop, maxeig
   on the host and on the card, and the four C
   API functions.  Each count is held to its JAX count, and one apply of
   each new operator and preconditioner on the card against the CPU;
11. the benchmark harness, checkpoint and profiling, every call through
   the port's entry points with no device argument: (a) the six
   generated rows (29,791 to 1,046,529 dof; the largest 3-D row at 63^3,
   HARNESS_3D) as run_generated("amg") scores them in float64 (lMVU, a warm and a timed call of the whole
   solver), x verified on the host, (b) the same in the f32 refined mode,
   (c) main(["--corpus"]) over the first ten corpus rows at 255^2 (all
   20 with --harness-only), each count held to the JAX package's CPU
   count or flagged as a reference anomaly;
   (d) the headline hierarchy and input.dat's RS hierarchy saved and
   loaded back onto the card bit-equal, solving as the originals do;
   (e) the 1023^2 row's f64 solve, its setup and solve halves each
   annotated, inside profiling.trace, the device
   busy share read from the trace file, and the memory report of the
   headline hierarchy beside the allocator's growth; (f) the f32 refined
   mode on jump_2d(32, 1e6) and jump_2d(24, 3e6), where the JAX package
   takes its diagonal-scaled rescue and its f64 escalation: each held to
   convergence and its verified relres, its banner, count and stages
   printed beside JAX's (held to them too once FALLBACK_FAULT is
   repaired);
12. the regression runner (``faspsolver_tpu_torch/regression``), its
   config functions called with no device argument, float64: core_configs
   on the generated 100- and 3,969-dof problems, bsr_configs on
   block_poisson_3d(12, nb=3), matfree_configs on the 3,969-dof problem
   and mm_configs on the two structural stand-ins (4,880 and 5,489 dof),
   every row held to the JAX runner's CPU row (verdict, count within its
   allowance), the tally printed;
13. the distribution layer (``faspsolver_tpu_torch/parallel``) on one
   rank of the card over NCCL, at full width: (a) Jacobi-PCG over
   dist_operator(poisson_2d(1023)); (b) AMG-PCG over dist_dia_operator
   with the headline's structured hierarchy in f64 placed by
   shard_hierarchy; (c) the same through halo_shard_hierarchy, (c) = (b);
   (d) the RS halo hierarchy of poisson_2d(1023); (e) vFGMRES over
   shard_block_rows(block_poisson_3d(64, nb=3)) (786,432 dof) with a
   replicated UA-BSR hierarchy; (f) the communication record of one
   whole cycle of (c) and (d); (g) dryrun_multichip(world size); each
   count held to the JAX package's one-device count, x verified on the
   host in f64, (b) and (c) must launch the f64 kernel; every Krylov
   loop of (a)-(e) and (g) resident over its DTensor vectors (one
   launch, one read), each of (a)-(e) rerun warm and as the eager loop
   from the same state, timed, with the same count and x (bit-equal, or
   within X_DIFF_LIMIT where (d)'s coarse transfers and (e)'s UA-BSR
   restriction add with atomics), and what a two-iteration eager run of
   its pieces communicates (the pieces the graph captured); then (c)
   once more as the eager loop under the profiler for the device's busy
   share; then the teardown with the phase's modules alive: the programs
   kept for them released (``graphs.release`` over the mesh's groups),
   then the group taken down, counted and timed under a 120 s watchdog.
   One card means world size 1 (NCCL takes one rank per card); the
   multi-rank exchange is held on four gloo CPU ranks by
   tests/test_torch_parallel.py, where it runs eagerly, and on one NCCL
   rank per card by tests/test_torch_gpu.py's across_ranks tests.
14. the tutorials (``tutorials_torch/``, the port of ``tutorials/``),
   each script's ``main`` with no device argument: the P1-FE matrix of
   phase 6 and its right-hand side written as csrmat_FE.dat / rhs_FE.dat
   and block_poisson_3d(64, nb=3) (786,432 dof) as bsrmat_SPE01.dat /
   rhs_SPE01.dat by the port's writers into a temporary directory, then
   poisson_pcg (RS-AMG + CG), poisson_amg (AMG alone), poisson_its (CG,
   CG + diag, CG + ILU, CG + AMG, GMRES + AMG), poisson_gmg, spe01_its
   (vFGMRES + UA-BSR AMG) on those files and fast_path at 1023^2 (the
   headline setup and the refined solve, cold and warm); every printed
   row held to the JAX script's CPU row on the same files, with each
   row's setup and solve seconds and its stencil launches;
15. the headline benchmark: ``python bench_torch.py`` (the port of
   bench.py) as a subprocess on the card, at full width (the 1023^2
   headline, the 1,046,529-dof P1-FE matrix through the general and
   fe_auto stanzas, the probes at 1023^2 and 8192^2), its SPE01 stanza
   on phase 14's block_poisson_3d(64, nb=3) pair through FASP_REFDATA
   (written here when phase 14 did not run); the subprocess's readings
   and every key of its JSON line printed, each held to
   :func:`bench_misses` (no ``*_error`` key, every stanza converged,
   the counts at their anchors, graphs replayed and none captured in a
   timed region, both kernel dtypes launched by the headline, k stencil
   launches per rep in every marginal-time chain).

On the card the refinement, its inner PCG, and the PCG, BiCGstab, MINRES
and GMRES-family solves over capturable operators are resident: the
whole loop is one CUDA graph captured at the first solve, with
conditional WHILE and IF nodes set by the loop-control kernel
(``faspsolver_tpu_torch/utils/graphs.py``; GMRES: a WHILE over restart
cycles around a WHILE over Arnoldi steps), launched once per solve and
read once at its end.  Phases 8, 9, 11, 12 and 14 record every
GMRES-family solve (:func:`gmres_solves`): each resident one must be one
program launch and one host read, one must have run, and the phase's
first is held to its own eager loop.  So do the multigrid solve loops
(AMG as a solver and FAMG, GMG's V-cycles and GMG-CG, resident on the
card as one graph each) in phases 10, 12 and 14 (:func:`mg_solves`): the
first resident solve of each kind also runs warm and as the eager loop,
and ``capi.dcsr_amg`` must have run its loop resident.  Phases 4, 6 and 7 run each solve twice: cold (the
capture included) and warm, the timed one, each with the kernel launch
counts and the graph counters set to 0 just before it and read just
after: its seconds, program launches and nodes, captures, capture
seconds and graph MB, the memory reserved before and after, host syncs
and launches; both dtypes and the loop-control kernel must have
launched, and every solve must be one program launch and one host read.
Phases 9a, 9c, 10a, 10b and 10d record every loop program of each row
(:func:`loop_solves`): each must be resident, one launch and one read,
and its first solve is rerun warm and as the eager loop, each printed
with its seconds, host reads, program
launches, nodes, captures, capture seconds and graph MB.
Phase 4 runs the headline once more as the eager loop
(``graphs.eager()``) and holds its x bit-equal to the resident solve's,
with equal counts and launches, and the eager loop's reads (one per
round, inner start, inner iteration and recompute) against the resident
solve's one; phase 8 times each ini file's Krylov solve cold and warm
the same way (input.dat's CG + AMG: one launch and one read each) and
holds the small grid's BiCGstab and MINRES solves to one read and
bit-equal to their own eager loops.  Phase 8 counts the launches of each CLI run
(setup and solve) and of each timed solve; input.dat's must include the
f64 kernel; phases 9 and 10 count the launches of each solve, and the
ILU and Schwarz solves of phase 9 and the MatFree solve of phase 10 must
have launched the f64 kernel; phase 11 counts those of each harness row
and of the corpus run; phases 12 and 13 those of each config set and
each solve, phase 14 those of each tutorial and each of its driver calls;
fast_path must have launched the f32 kernel, CG + ILU the f64 one; phase
15 reads the launches of bench_torch.py's three timed solves from its
JSON line.  The loop-control kernel's GMRES entry point is counted apart
("gmres") from its other entry points ("loop_control", the multigrid
loops' ``mg`` among them) and has its own row in the kernels' JSON
line.  Each phase's banner gives the seconds
since the start and those of the phase before.  It prints a JSON line of
the kernels, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  It needs nothing but this
checkout and exits non-zero when no CUDA device is available.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

# the main paths' settings: bench_torch.py's (the port of bench.py)
from bench_torch import (GENERAL_REFINE, HEADLINE_REFINE, general_param,
                         headline_param)

NX = 1023                 # the headline problem: 1023^2 = 1,046,529 dof
TOL = 1e-6
SEED = 20261016
# JAX package's runs of the same solves (BENCH_r05.json): the counts the
# port should reproduce (not times)
ANCHOR = {"rounds": 2, "inner_iters": 20, "relres": 1.36e-11}
GENERAL_ANCHOR = {"rounds": 2, "inner_iters": 17, "relres": 7.10e-7}
FE_AUTO_ANCHOR = {"inner_iters": 28, "relres": 4.16e-8}
# phase 15: bench_torch.py's SPE01 stanza on bsr_problem() written by the
# port's writers, JAX CPU (f32 inner solves):
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py bench-spe01 64
BENCH_SPE01_ANCHOR = 112
BENCH_TIMEOUT = 900
REPLACES = {"k1": "faspsolver_tpu/ops/pallas_kernels.py:149",
            "k2": "faspsolver_tpu/ops/pallas_kernels.py:36",
            # no Pallas kernel: XLA's while / cond around the loop bodies
            "loop": "faspsolver_tpu/krylov/pcg.py:173",
            "gmres": "faspsolver_tpu/krylov/gmres.py:243",
            "gcr": "faspsolver_tpu/krylov/gcg_gcr.py:124"}

# phase 8, the user entry point: the JAX CLI's iteration counts on the
# same runs (python -m faspsolver_tpu -ini ini/<f>.dat -problem poisson2d
# -size 1023, CPU, float64), and the allowed distance from each: 1 for
# CG over RS / SA, 5% (at least 2) where AggRestrict's atomic sums reorder
# the f64 arithmetic (UA) or GMRES restarts compound it
INI_ANCHORS = {"input": (6, 1), "sa": (9, 1), "ua": (33, 2), "bamg": (68, 3)}

# phase 8, one solve per new module on poisson_fe_manufactured(64) (3,969
# dof, the generated FE-3969 problem) in float64, after
# regression/runner.py:core_configs without ILU, BSR and energy-min:
# (name, driver, ITSParam fields, AMGParam fields, JAX iterations,
# allowed distance).  The JAX counts are the JAX package's drivers on the
# CPU in float64, printed by
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py
# and tests/test_torch_drivers.py holds the port's CPU counts to them.
# The distance is 1, 2 for the GMRES family, and 3 for BiCGstab with the
# diagonal preconditioner, whose count on this problem moves with
# nothing but the summation order of its dot products: 69 to 71 for four
# orders on the CPU, 72 on the H100 (cuBLAS order, the same on repeat).
_CG, _BICG, _MINRES, _GMRES, _VGMRES, _VFGMRES, _GCG, _GCR = range(1, 9)
_GS, _SGS, _SOR, _SSOR, _L1 = 2, 3, 5, 6, 10
_DIAG_ITS = dict(tol=1e-10, maxit=2000, restart=60)
_AMG_ITS = dict(tol=1e-10, maxit=200, restart=30)
_KRYLOV = (("BiCGstab", _BICG, 69, 5), ("MinRes", _MINRES, 99, 8),
           ("GMRES", _GMRES, 132, 8), ("vGMRES", _VGMRES, 132, 8),
           ("vFGMRES", _VFGMRES, 132, 8), ("GCR", _GCR, 132, 8),
           ("GCG", _GCG, 99, 8))
_GMRES_FAMILY = (_GMRES, _VGMRES, _VFGMRES)
# the small-grid solves whose loop is resident on the card
RESIDENT_SMALL_GRID = tuple(f"{name} + {pre}" for pre in ("diag", "AMG")
                            for name in ("BiCGstab", "MinRes", "GMRES",
                                         "vGMRES", "vFGMRES", "GCR", "GCG"))
SMALL_GRID = [
    *[(f"{name} + diag", "krylov_diag", dict(itsolver_type=t, **_DIAG_ITS),
       None, n_diag, 3 if t == _BICG else 2 if t in _GMRES_FAMILY else 1)
      for name, t, n_diag, _ in _KRYLOV],
    *[(f"{name} + AMG", "krylov_amg", dict(itsolver_type=t, **_AMG_ITS),
       dict(smoother=_GS), n_amg, 2 if t in _GMRES_FAMILY else 1)
      for name, t, _, n_amg in _KRYLOV],
    ("AMG W-cycle GS", "solve_amg", None,
     dict(cycle_type=2, maxit=20, tol=1e-10), 5, 1),
    ("AMG AMLI(3) GS", "solve_amg", None,
     dict(cycle_type=3, amli_degree=3, maxit=20, tol=1e-10), 7, 1),
    ("AMG NL-AMLI GS", "solve_amg", None,
     dict(cycle_type=4, maxit=20, tol=1e-10), 5, 1),
    ("FAMG V GS", "solve_famg", None, dict(maxit=20, tol=1e-10), 8, 1),
    ("AMG V SGS", "solve_amg", None,
     dict(smoother=_SGS, maxit=20, tol=1e-10), 13, 1),
    ("AMG V SOR 1.1", "solve_amg", None,
     dict(smoother=_SOR, relaxation=1.1, maxit=60, tol=1e-10), 12, 1),
    ("AMG V SSOR 1.1", "solve_amg", None,
     dict(smoother=_SSOR, relaxation=1.1, maxit=60, tol=1e-10), 15, 1),
    ("AMG V L1-diag", "solve_amg", None,
     dict(smoother=_L1, maxit=100, tol=1e-10), 22, 1),
    ("CG + SA-AMG VMB", "krylov_amg", dict(itsolver_type=_CG, **_AMG_ITS),
     dict(AMG_type=2, aggregation_type=2, smoother=_GS), 14, 1),
    ("CG + UA-AMG PAIRWISE", "krylov_amg",
     dict(itsolver_type=_CG, **_AMG_ITS),
     dict(AMG_type=3, aggregation_type=1, smoother=_GS), 23, 1),
]


# phase 9a, the block (BSR) reservoir path: block_poisson_3d(BSR_NX,
# nb=3), b = A x for a seeded x, in float64 unless the entry refines.
# (name, driver, fields, JAX count, allowed distance).  "ini" reads its
# ITSParam / AMGParam from ini/bsr.dat (vFGMRES(30), tol 1e-9, UA, GS,
# 2 + 2 sweeps); "refined" is bench.py's reservoir stanza (f32 hierarchy,
# vFGMRES(30) with maxit 100 inside solve_refined, tol 1e-6, 4 rounds) and
# counts inner iterations; "nk" passes the component-wise constant basis.
# block Jacobi runs under CG: the matrix is symmetric positive definite,
# and a restarted method behind so weak a preconditioner was not tried at
# this size.  The JAX counts come from
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py bsr <nx>
# run at the full size (161 s on the CPU).  Allowed distances, here and
# below: 1 (2 for the GMRES family) for counts under 40 with deterministic
# sums; max(2, 5%) where ``index_add_`` (atomic on the card), GMRES
# restarts, float32 or the order of the dot products of a long CG run
# reorder the sums.
BSR_NX = 64
BSR_TOL = 1e-9
_BSR_ITS = dict(itsolver_type=_VFGMRES, tol=BSR_TOL, maxit=500, restart=30)
_STANZA = dict(AMG_type=3, coarse_dof=30, aggregation_type=2,
               strong_coupled=0.08)
BSR_GRID = [
    ("vFGMRES + UA-BSR (ini/bsr.dat)", "krylov_amg", "ini", 17, 2),
    ("refined f32 vFGMRES + UA-BSR (bench stanza)", "refined",
     dict(amg=_STANZA), 112, 6),
    ("refined f32 vFGMRES + SA-BSR", "refined",
     dict(amg=dict(_STANZA, AMG_type=2)), 14, 2),
    ("vFGMRES + near-kernel UA-BSR", "krylov_nk_amg",
     dict(its=_BSR_ITS, nk=True,
          amg=dict(AMG_type=3, aggregation_type=2, coarse_dof=30)),
     31, 2),
    ("vFGMRES + block ILU(0)", "krylov_ilu",
     dict(its=_BSR_ITS, ilu=dict(ILU_lfil=0)), 71, 4),
    ("CG + block Jacobi", "krylov_diag",
     dict(its=dict(itsolver_type=_CG, tol=BSR_TOL, maxit=2000)), 213, 11),
]
REFINED = dict(tol=1e-6, max_rounds=4)
REFINED_INNER = dict(maxit=100, restart=30)

# phases 9b and 9c through the CLI on copies of ini/input.dat (CG, tol
# 1e-6) with these lines replaced; the JAX CLI's counts from
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py cli 4 1023 \
#         itsolver_maxit=2000 [ILU_type=2 ...]
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py cli 5 1023 \
#         itsolver_maxit=2000 SWZ_type=3      (solver_type=4 SWZ_type=1)
# input.dat's 500 iterations do not reach 1e-6 with ILU(0) at 1023^2 (the
# count is above 500), hence itsolver_maxit.  Forward Schwarz is not
# symmetric, and CG with it stalls in both packages, so the forward
# sweep runs under GMRES (solver_type 4) and the symmetric one under CG.
# Schwarz runs at 1023^2 too: its host setup (Python over 522,753 blocks,
# their submatrices gathered by array operations) stays under 60 s there.
SWZ_NX = 1023
ILU_RUNS = {"ILUk(0)": dict(itsolver_maxit=2000),
            "ILUt": dict(itsolver_maxit=2000, ILU_type=2)}
ILU_ANCHORS = {"ILUk(0)": (540, 27), "ILUt": (127, 7)}
SWZ_RUNS = {"GMRES + forward Schwarz": dict(itsolver_maxit=2000,
                                            solver_type=4, SWZ_type=1),
            "CG + symmetric Schwarz": dict(itsolver_maxit=2000, SWZ_type=3)}
SWZ_ANCHORS = {"GMRES + forward Schwarz": (1122, 56),
               "CG + symmetric Schwarz": (205, 10)}

# phase 9d, the level smoothers and what phase 8 left out, on the small
# grid of phase 8 (poisson_fe_manufactured(64), float64): (name, driver,
# fields, JAX count, allowed distance); the JAX counts from
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py leftover
_ILU_ITS = dict(tol=1e-10, maxit=2000, restart=60)
LEFTOVER_GRID = [
    ("CG + RS-AMG, ILU level smoother", "krylov_amg",
     dict(its=dict(itsolver_type=_CG, **_AMG_ITS), amg=dict(ILU_levels=1)),
     8, 1),
    ("CG + RS-AMG, Schwarz level smoother", "krylov_amg",
     dict(its=dict(itsolver_type=_CG, **_AMG_ITS), amg=dict(SWZ_levels=1)),
     6, 1),
    ("CG + RS-AMG, energy-min interpolation", "krylov_amg",
     dict(its=dict(itsolver_type=_CG, **_AMG_ITS),
          amg=dict(interpolation_type=3, smoother=_GS)), 11, 1),
    ("CG + CR-AMG", "krylov_amg",
     dict(its=dict(itsolver_type=_CG, **_AMG_ITS),
          amg=dict(coarsening_type=3, smoother=_GS)), 86, 5),
    ("CG + ILUk(0), 3,969 dof", "krylov_ilu",
     dict(its=dict(itsolver_type=_CG, **_ILU_ITS), ilu=dict(ILU_lfil=0)),
     56, 3),
    ("CG + ILUk(1)", "krylov_ilu",
     dict(its=dict(itsolver_type=_CG, **_ILU_ITS), ilu=dict(ILU_lfil=1)),
     42, 3),
    ("GMRES + ILUt", "krylov_ilu",
     dict(its=dict(itsolver_type=_GMRES, **_ILU_ITS), ilu=dict(ILU_type=2)),
     16, 2),
    ("GMRES + ILUtp", "krylov_ilu",
     dict(its=dict(itsolver_type=_GMRES, **_ILU_ITS), ilu=dict(ILU_type=3)),
     16, 2),
    ("CG + ILU-M", "krylov_ilu_m",
     dict(its=dict(itsolver_type=_CG, **_ILU_ITS), ilu=dict(ILU_lfil=0)),
     56, 3),
    ("CG + symmetric Schwarz, 3,969 dof", "krylov_swz",
     dict(its=dict(itsolver_type=_CG, **_ILU_ITS), swz=dict(SWZ_type=3)),
     26, 2),
    ("GMRES + forward Schwarz, 3,969 dof", "krylov_swz",
     dict(its=dict(itsolver_type=_GMRES, **_ILU_ITS), swz=dict(SWZ_type=1)),
     35, 2),
]


# phase 10, the rest of the solver surface through the drivers with no
# device argument, float64; (name, driver, fields, JAX count, allowed
# distance), fields as in BSR_GRID plus "kw", the driver's own keyword
# arguments.  The JAX counts come from
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py str 64
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py blc 64
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py sweep 96 12
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py gmg 1024 128
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py surface 1023
# (10a) block_poisson_3d(64, nb=3) in band form (STR, str_problem), under
# ini/bsr.dat's ITSParam (_BSR_ITS: vFGMRES(30), tol 1e-9, maxit 500)
# but for CG + block Jacobi, which runs as in phase 9a.  The JAX STR ILU
# schedules its solves on the 1-D index (262,144 levels per factor at
# 64^3, beyond what JAX can trace), so its anchors apply the JAX
# package's factor with the JAX BlockTriangularSolver over grid
# wavefronts that the anchor script builds itself (the same arithmetic:
# it drops only the steps that wrap, whose blocks it checks are zero).
STR_NX = 64
STR_GRID = [
    ("CG + STR block diag", "krylov_diag",
     dict(its=dict(itsolver_type=_CG, tol=BSR_TOL, maxit=2000)), 213, 11),
    ("vFGMRES + STR ILU(0)", "krylov_ilu",
     dict(its=_BSR_ITS, ilu=dict(ILU_lfil=0)), 71, 4),
    ("vFGMRES + STR ILU(1)", "krylov_ilu",
     dict(its=_BSR_ITS, ilu=dict(ILU_lfil=1)), 52, 3),
    ("vFGMRES + STR block GS", "krylov_blockgs",
     dict(its=_BSR_ITS, kw=dict(smoother="blockgs")), 87, 5),
    ("vFGMRES + STR Schwarz", "krylov_blockgs",
     dict(its=_BSR_ITS, kw=dict(smoother="schwarz")), 31, 2),
]
# (10b) the same matrix field by field, a 3 x 3 BLC of 262,144-row blocks
# (blc_problem), UA-AMG on the diagonal blocks; then poisson_3d(96) cut
# into 12 z-slabs of 8 planes, a block-tridiagonal 12 x 12 BLC of
# 73,728-row blocks (sweep_problem), under the layered sweeping
# preconditioner
BLC_NX = 64
BLC_GRID = [(f"vFGMRES + BLC {mode}", "krylov_block",
             dict(its=_BSR_ITS, kw=dict(mode=mode)), anchor, bound)
            for mode, anchor, bound in (("diag", 28, 2), ("lower", 26, 2),
                                        ("upper", 26, 2), ("sgs", 25, 2))]
SWEEP_N, SWEEP_SLABS = 96, 12
SWEEP_GRID = [("vFGMRES + sweeping, 12 slabs", "krylov_sweeping",
               dict(its=_BSR_ITS), 43, 3)]
# the sum of 10b's rows that adds with atomics on the card
UA_ATOMIC = ("UA-AMG's restriction (AggRestrict) adds with index_add_, "
             "atomic on the card")
# (10c) matrix-free geometric multigrid: -Δu = f with f = dπ² Π sin(π x_i)
# on the unit square (n = 1024: 1,046,529 interior unknowns) and cube
# (n = 128: 2,048,383), default tol 1e-8: (name, function, dimension,
# keyword arguments, JAX count, allowed distance)
GMG_N2, GMG_N3 = 1024, 128
GMG_GRID = [
    ("GMG V-cycles 2-D", "poisson_gmg_2d", 2, {}, 7, 1),
    ("GMG V-cycles 2-D, full-MG start", "poisson_gmg_2d", 2,
     dict(full_first=True), 2, 1),
    ("GMG-CG 2-D", "poisson_gmgcg_2d", 2, {}, 3, 1),
    ("GMG V-cycles 3-D", "poisson_gmg_3d", 3, {}, 9, 1),
    ("GMG-CG 3-D", "poisson_gmgcg_3d", 3, {}, 6, 1),
    ("GMG 1-D (direct)", "poisson_gmg_1d", 1, {}, 1, 0),
]
# (10d) regression/runner.py:matfree_configs: an ELL operator behind a
# MatFreeOperator, Jacobi, maxit 4000, on phase 8's small grid, at tol
# 1e-10: the runner's 1e-13 is this grid's rounding floor, where the order
# of the sums decides the counts (BiCGstab took 88 on the card against the
# JAX package's 82 there): (name, Krylov function, restart, JAX count,
# allowed distance)
MATFREE_GRID = [("matfree CG", "pcg", None, 100, 5),
                ("matfree BiCGstab", "bicgstab", None, 69, 4),
                ("matfree MinRes", "minres", None, 99, 5),
                ("matfree GMRES", "gmres", 60, 132, 7),
                ("matfree vFGMRES", "vfgmres", 60, 132, 7),
                ("matfree GCG", "gcg", None, 99, 5)]
MATFREE_ITS = dict(tol=1e-10, maxit=4000)
# the f64 1023^2 stencil operator behind a MatFreeOperator, CG + Jacobi
MATFREE_STENCIL = dict(tol=1e-6, maxit=5000)
MATFREE_STENCIL_ANCHOR = (297, 15)
# the C API at 1023^2 (CSR, b = A x for a seeded x) and on phase 9a's
# matrix (BSR): (function, keyword arguments, JAX count, allowed distance)
CAPI_GRID = [("dcsr_krylov_amg", dict(tol=1e-6, maxit=500), 4, 1),
             ("dcsr_amg", dict(tol=1e-6, maxit=100), 5, 1),
             ("dcsr_krylov_ilu", dict(tol=1e-6, maxit=2000), 90, 5),
             ("dbsr_krylov_amg", dict(tol=1e-9, maxit=500), 23, 2)]
MAXEIG_ANCHOR = 8303774.513804946

# phase 11, the benchmark harness: the JAX package's own harness
# functions on the CPU, one solve per row (iterations, "rescue" /
# "escalate" where the f32 ladder needed its fallbacks), printed by
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py harness gen f64
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py harness gen f32
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py harness corpus f64
# Each count is held within max(2, 5%) (f64 sums in another order under
# vGMRES restarts; the f32 mode's rounding); a row that
# reference_anomalies() flags is printed as such and held only to
# convergence and its verified relres.  None of these anchors is flagged.
# The generated rows' 3-D sizes: the harness's largest, 101^3 (1,030,301
# dof), took 24-28 s a timed call on the H100 beside its warm call, so
# the run keeps to its time budget with 63^3 (250,047 dof) in its place
HARNESS_3D = (31, 47, 63)
HARNESS_GEN_F64 = {
    "fdm2d-255x255": (6, ""), "fdm2d-511x511": (6, ""),
    "fdm2d-1023x1023": (6, ""), "fdm3d-31^3": (6, ""), "fdm3d-47^3": (6, ""),
    "fdm3d-63^3": (6, "")}
HARNESS_GEN_F32 = {
    "fdm2d-255x255": (8, ""), "fdm2d-511x511": (8, ""),
    "fdm2d-1023x1023": (9, ""), "fdm3d-31^3": (8, ""), "fdm3d-47^3": (8, ""),
    "fdm3d-63^3": (8, "")}
HARNESS_CORPUS_F64 = {
    "poisson2d": (6, ""), "poisson3d": (6, ""), "aniso-x-1e1": (5, ""),
    "aniso-x-1e2": (5, ""), "aniso-x-1e3": (4, ""), "aniso-y-1e1": (5, ""),
    "aniso-y-1e2": (5, ""), "aniso-y-1e3": (4, ""), "aniso3d-weak": (5, ""),
    "aniso3d-mixed": (4, ""), "jump-1e2": (7, ""), "jump-1e4": (7, ""),
    "jump-1e6": (7, ""), "jump-inv-1e4": (6, ""), "convdiff-mild": (6, ""),
    "convdiff-strong": (8, ""), "convdiff-grid": (11, ""),
    "stretched-1e1": (7, ""), "stretched-1e2": (7, ""),
    "stretched-1e3": (7, "")}
HARNESS_TOL = 1e-8        # the harness solvers' own tolerance

# phase 11f: the f32 refined mode's two fallbacks, on jump_2d(n, contrast)
# with b = A 1 (tests/test_torch_harness.py runs them on the CPU): the
# diagonal-scaled rescue at 32^2 and 1e6, the f64 escalation at 24^2 and
# 3e6, each named by the banner the harness prints.  Case -> (n,
# contrast, banner); the JAX package's total inner iterations and its
# stages (rounds, inner iterations and relres of each refinement) are
# printed by
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py fallbacks
FALLBACK_CASES = {
    "rescue": (32, 1e6, "diagscaled-inner f32 retry converged"),
    "escalation": (24, 3e6, "-> f64 escalation")}
FALLBACK_ANCHORS = {"rescue": (840, [(4, 456), (7, 384)]),
                    "escalation": (829, [(2, 391), (8, 435), (1, 3)])}
# An open fault (ROADMAP.md section 3): on the card the rescue case takes
# the f64 escalation, and the counts leave their allowance.  While it
# stands the rows hold convergence and the verified relres, and print the
# banner and the count beside JAX's; once it is repaired (None) they hold
# both too.
FALLBACK_FAULT = ("the f32 ladder's branch at its rounding floor differs "
                  "from JAX's on the card")

# phase 12, the regression runner (faspsolver_tpu_torch/regression): the
# reference's conformance sizes, generated (the reference data is not in
# the repository).  Each set names its config function and its problems
# (regression_problems); every row is held to the JAX runner's CPU row
# on the same problem, printed by
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py regression <set>
# as (iterations, verdict, extra).  No row repeats phase 8's SMALL_GRID
# or 10d's MATFREE_GRID: those solve poisson_fe_manufactured(64)'s own
# right-hand side at other tolerances, these b = A sol for a seeded sol.
REGRESSION_SETS = {"core": ("core_configs", ("fd", "fe")),
                   "bsr": ("bsr_configs", ("bsr",)),
                   "matfree": ("matfree_configs", ("fe",)),
                   "mm": ("mm_configs", ("plate", "shell"))}
REGRESSION_SEED = 20260921
# (iterations, verdict, extra) of every row, by problem and config
REGRESSION_ANCHORS = {
    'gen-fd-poisson-100': {
        'AMG V direct-interp GS': (1, True, ''),
        'AMG V standard-interp GS': (1, True, ''),
        'FAMG V direct GS': (1, True, ''),
        'AMG W-cycle GS': (1, True, ''),
        'AMG AMLI GS': (1, True, ''),
        'AMG NL-AMLI GS': (1, True, ''),
        'AMG V SGS': (1, True, ''),
        'AMG V L1-diag': (1, True, ''),
        'AMG V energymin-interp GS': (1, True, ''),
        'AMG V SOR': (1, True, ''),
        'AMG V SSOR': (1, True, ''),
        'SA-AMG V GS': (1, True, ''),
        'UA-AMG V GS': (1, True, ''),
        'CG': (41, True, ''),
        'CG + diag': (41, True, ''),
        'BiCGstab + diag': (30, True, ''),
        'MinRes + diag': (41, True, ''),
        'GMRES + diag': (41, True, ''),
        'vGMRES + diag': (41, True, ''),
        'vFGMRES + diag': (41, True, ''),
        'GCR + diag': (41, True, ''),
        'GCG + diag': (41, True, ''),
        'CG + AMG(direct)': (1, True, ''),
        'CG + AMG(standard)': (1, True, ''),
        'CG + SA-AMG': (1, True, ''),
        'CG + UA-AMG': (1, True, ''),
        'BiCGstab + AMG': (1, True, ''),
        'MinRes + AMG': (1, True, ''),
        'GMRES + AMG': (1, True, ''),
        'vGMRES + AMG': (1, True, ''),
        'vFGMRES + AMG': (1, True, ''),
        'CG (BSR)': (41, True, ''),
        'BiCGstab (BSR)': (30, True, ''),
        'GMRES (BSR)': (41, True, ''),
        'vGMRES (BSR)': (41, True, ''),
        'vFGMRES (BSR)': (41, True, ''),
        'GCG + AMG': (1, True, ''),
        'GCR + AMG': (1, True, ''),
        'CG + ILU(0)': (18, True, ''),
        'CG + ILU(1)': (13, True, ''),
        'CG + ILUt': (3, True, ''),
        'CG + ILUtp': (3, True, ''),
        'GMRES + ILUt': (6, True, ''),
        'CG stop2': (41, True, ''),
        'CG stop3': (46, True, ''),
        'SafeCG + diag': (40, True, ''),
        'SafeBiCGstab + diag': (29, True, ''),
        'SafeMinRes + diag': (41, True, ''),
        'SafeGMRES + diag': (41, True, ''),
        'SafeVGMRES + diag': (41, True, ''),
    },
    'gen-fe-poisson-3969': {
        'AMG V direct-interp GS': (9, True, ''),
        'AMG V standard-interp GS': (9, True, ''),
        'FAMG V direct GS': (9, True, ''),
        'AMG W-cycle GS': (5, True, ''),
        'AMG AMLI GS': (5, True, ''),
        'AMG NL-AMLI GS': (4, True, ''),
        'AMG V SGS': (11, True, ''),
        'AMG V L1-diag': (20, True, ''),
        'AMG V energymin-interp GS': (20, True, ''),
        'AMG V SOR': (9, True, ''),
        'AMG V SSOR': (13, True, ''),
        'SA-AMG V GS': (20, True, ''),
        'UA-AMG V GS': (53, True, ''),
        'CG': (242, True, ''),
        'CG + diag': (242, True, ''),
        'BiCGstab + diag': (176, True, ''),
        'MinRes + diag': (240, True, ''),
        'GMRES + diag': (467, True, ''),
        'vGMRES + diag': (467, True, ''),
        'vFGMRES + diag': (467, True, ''),
        'GCR + diag': (467, True, ''),
        'GCG + diag': (240, True, ''),
        'CG + AMG(direct)': (8, True, ''),
        'CG + AMG(standard)': (8, True, ''),
        'CG + SA-AMG': (14, True, ''),
        'CG + UA-AMG': (23, True, ''),
        'BiCGstab + AMG': (5, True, ''),
        'MinRes + AMG': (8, True, ''),
        'GMRES + AMG': (8, True, ''),
        'vGMRES + AMG': (8, True, ''),
        'vFGMRES + AMG': (8, True, ''),
        'CG (BSR)': (242, True, ''),
        'BiCGstab (BSR)': (176, True, ''),
        'GMRES (BSR)': (467, True, ''),
        'vGMRES (BSR)': (467, True, ''),
        'vFGMRES (BSR)': (467, True, ''),
        'GCG + AMG': (8, True, ''),
        'GCR + AMG': (8, True, ''),
        'CG + ILU(0)': (77, True, ''),
        'CG + ILU(1)': (49, True, ''),
        'CG + ILUt': (6, True, ''),
        'CG + ILUtp': (6, True, ''),
        'GMRES + ILUt': (16, True, ''),
        'CG stop2': (242, True, ''),
        'CG stop3': (248, True, ''),
        'SafeCG + diag': (230, True, ''),
        'SafeBiCGstab + diag': (170, True, ''),
        'SafeMinRes + diag': (240, True, ''),
        'SafeGMRES + diag': (467, True, ''),
        'SafeVGMRES + diag': (467, True, ''),
        'matfree CG': (242, True, ''),
        'matfree BiCGstab': (176, True, ''),
        'matfree MinRes': (240, True, ''),
        'matfree GMRES': (467, True, ''),
        'matfree vFGMRES': (467, True, ''),
        'matfree GCG': (240, True, ''),
    },
    'blockpoisson-bsr3': {
        'vFGMRES + UA-AMG': (25, True, 'nlvl=4'),
        'vFGMRES + SA-AMG': (15, True, 'nlvl=2'),
        'vFGMRES + nk-AMG': (25, True, 'nlvl=4'),
        'vFGMRES + AMG-nk': (25, True, 'nlvl=4'),
    },
    'bcsstk16-syn': {
        'CG': (100, False, ''),
        'BiCGstab': (100, False, 'rescued: diagscaled'),
        'MinRes': (100, False, 'rescued: diagscaled'),
        'GMRES': (100, False, 'rescued: diagscaled'),
        'vGMRES': (100, False, 'rescued: diagscaled'),
        'vFGMRES': (100, False, 'rescued: diagscaled'),
        'GCG': (100, False, 'rescued: diagscaled'),
        'GCR': (100, False, 'rescued: diagscaled'),
        'CG + diag': (100, False, 'rescued: diagscaled'),
        'BiCGstab + diag': (100, False, ''),
        'MinRes + diag': (100, False, 'rescued: diagscaled'),
        'GMRES + diag': (100, False, ''),
        'vGMRES + diag': (100, False, ''),
        'vFGMRES + diag': (100, False, ''),
        'GCG + diag': (100, False, ''),
        'GCR + diag': (100, False, ''),
        'CG + ILUk': (63, True, ''),
        'BiCGstab + ILUk': (47, True, ''),
        'MinRes + ILUk': (62, True, ''),
        'GMRES + ILUk': (100, True, ''),
        'vGMRES + ILUk': (100, True, ''),
        'vFGMRES + ILUk': (100, True, ''),
        'GCG + ILUk': (88, True, ''),
        'GCR + ILUk': (100, True, ''),
        'CG + ILUt': (51, True, ''),
        'BiCGstab + ILUt': (17, True, ''),
        'MinRes + ILUt': (47, True, ''),
        'GMRES + ILUt': (25, True, ''),
        'vGMRES + ILUt': (25, True, ''),
        'vFGMRES + ILUt': (25, True, ''),
        'GCG + ILUt': (25, True, ''),
        'GCR + ILUt': (25, True, ''),
        'CG + ILUtp': (51, True, ''),
        'BiCGstab + ILUtp': (17, True, ''),
        'MinRes + ILUtp': (47, True, ''),
        'GMRES + ILUtp': (25, True, ''),
        'vGMRES + ILUtp': (25, True, ''),
        'vFGMRES + ILUtp': (25, True, ''),
        'GCG + ILUtp': (25, True, ''),
        'GCR + ILUtp': (25, True, ''),
        'CG + AMG': (51, True, ''),
        'BiCGstab + AMG': (39, True, ''),
        'MinRes + AMG': (51, True, ''),
        'GMRES + AMG': (100, True, ''),
        'vGMRES + AMG': (100, True, ''),
        'vFGMRES + AMG': (100, True, ''),
        'GCG + AMG': (73, True, ''),
        'GCR + AMG': (100, True, ''),
        'AMG solver': (20, False, ''),
    },
    's2rmq4m1-syn': {
        'CG': (100, False, 'rescued: diagscaled'),
        'BiCGstab': (100, False, 'rescued: diagscaled'),
        'MinRes': (100, False, 'rescued: diagscaled'),
        'GMRES': (100, False, 'rescued: diagscaled'),
        'vGMRES': (100, False, 'rescued: diagscaled'),
        'vFGMRES': (100, False, 'rescued: diagscaled'),
        'GCG': (100, False, 'rescued: diagscaled'),
        'GCR': (100, False, 'rescued: diagscaled'),
        'CG + diag': (100, False, 'rescued: diagscaled'),
        'BiCGstab + diag': (100, False, ''),
        'MinRes + diag': (100, False, 'rescued: diagscaled'),
        'GMRES + diag': (100, False, ''),
        'vGMRES + diag': (100, False, ''),
        'vFGMRES + diag': (100, False, ''),
        'GCG + diag': (100, False, ''),
        'GCR + diag': (100, False, ''),
        'CG + ILUk': (29, True, ''),
        'BiCGstab + ILUk': (16, True, ''),
        'MinRes + ILUk': (29, True, ''),
        'GMRES + ILUk': (31, True, ''),
        'vGMRES + ILUk': (31, True, ''),
        'vFGMRES + ILUk': (31, True, ''),
        'GCG + ILUk': (50, True, ''),
        'GCR + ILUk': (31, True, ''),
        'CG + ILUt': (20, True, ''),
        'BiCGstab + ILUt': (7, True, ''),
        'MinRes + ILUt': (100, True, ''),
        'GMRES + ILUt': (13, True, ''),
        'vGMRES + ILUt': (13, True, ''),
        'vFGMRES + ILUt': (13, True, ''),
        'GCG + ILUt': (13, True, ''),
        'GCR + ILUt': (13, True, ''),
        'CG + ILUtp': (20, True, ''),
        'BiCGstab + ILUtp': (7, True, ''),
        'MinRes + ILUtp': (100, True, ''),
        'GMRES + ILUtp': (13, True, ''),
        'vGMRES + ILUtp': (13, True, ''),
        'vFGMRES + ILUtp': (13, True, ''),
        'GCG + ILUtp': (13, True, ''),
        'GCR + ILUtp': (13, True, ''),
        'CG + AMG': (36, True, ''),
        'BiCGstab + AMG': (22, True, ''),
        'MinRes + AMG': (36, True, ''),
        'GMRES + AMG': (38, True, ''),
        'vGMRES + AMG': (38, True, ''),
        'vFGMRES + AMG': (38, True, ''),
        'GCG + AMG': (33, True, ''),
        'GCR + AMG': (38, True, ''),
        'AMG solver': (20, False, ''),
    },
}


def regression_problems(keys):
    """The generated regression problems (name, A, b, sol), sol from a
    seeded generator and b = A sol (the reference's manufactured
    solutions, regression.c:118-126): "fd" poisson_2d(10) (100 dof, the
    FD row's size), "fe" the matrix of poisson_fe_manufactured(64) (3,969
    dof, the FE row's), "plate" / "shell" the structural stand-ins of the
    MatrixMarket set, "bsr" block_poisson_3d(12, nb=3).  The names trip
    none of the runner's filters; the last three keep the JAX loaders'
    own names."""
    import numpy as np
    from faspsolver_tpu_torch.testgen import (block_poisson_3d, poisson_2d,
                                              poisson_fe_manufactured)
    from faspsolver_tpu_torch.testgen.structural import (plate_stress_syn,
                                                         shell_stress_syn)
    make = {"fd": ("gen-fd-poisson-100", lambda: poisson_2d(10)),
            "fe": ("gen-fe-poisson-3969",
                   lambda: poisson_fe_manufactured(64)[0]),
            "plate": ("bcsstk16-syn", plate_stress_syn),
            "shell": ("s2rmq4m1-syn", shell_stress_syn),
            "bsr": ("blockpoisson-bsr3",
                    lambda: block_poisson_3d(12, nb=3))}
    out = []
    for key in keys:
        name, fn = make[key]
        A = fn()
        sol = np.random.default_rng(
            REGRESSION_SEED + list(make).index(key)).standard_normal(A.nrow)
        out.append((name, A, A.matvec(sol), sol))
    return out


# phase 13, the distribution layer at full width on world size 1 (one
# card: NCCL takes one rank per card), NCCL: (a) Jacobi-PCG over
# dist_operator(poisson_2d(1023)); (b) AMG-PCG over dist_dia_operator
# with the headline's structured hierarchy (phase 4's parameters, f64)
# placed by shard_hierarchy; (c) the same through halo_shard_hierarchy,
# PCG on its fine halo operator, (c) = (b); (d) the RS hierarchy of
# __graft_entry__'s dryrun (Chebyshev(2), coarse_dof 60) through
# halo_shard_hierarchy; (e) vFGMRES(30) over shard_block_rows of
# block_poisson_3d(64, nb=3) with a replicated UA-BSR hierarchy; b = A 1
# throughout.  (tol, maxit, JAX count on one device, allowed distance);
# the JAX counts from
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py parallel 1023
PAR_NX, PAR_BSR_NX = 1023, 64
PARALLEL_RUNS = {
    "a": dict(tol=1e-6, maxit=10000),
    "b": dict(tol=1e-8, maxit=200),
    "d": dict(tol=1e-8, maxit=200),
    "e": dict(tol=1e-8, maxit=200, restart=30),
}
# rows whose JAX count the JAX package does not reproduce itself: its
# jitted solver and the same arithmetic as an eager JAX loop part by more
# than the allowance (printed by
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py gcg-floor
# as (jitted, eager)), so at the runner's tol 1e-15 the count is set by
# rounding.  Such a row is held to its verdict and printed with both
# counts; its count is not held.
REGRESSION_FLOOR = {
    ("bcsstk16-syn", "GCG + ILUk"): "JAX 88 jitted, 100 as an eager loop",
    ("bcsstk16-syn", "GCG + AMG"): "JAX 73 jitted, 100 as an eager loop",
    ("s2rmq4m1-syn", "GCG + ILUk"): "JAX 50 jitted, 100 as an eager loop",
}
PARALLEL_ANCHORS = {"a": (1507, 75), "b": (13, 1), "d": (7, 1), "e": (24, 2)}

# phase 14, the tutorials (tutorials_torch/, the port of tutorials/): each
# script's main, with no device argument, on the files
# write_tutorial_data writes (the FE pair: fe_problem(), 1,046,529 dof;
# the SPE01 pair: bsr_problem(), 786,432 dof in 3 x 3 blocks) and
# fast_path at NX.  TUTORIALS: (port module, JAX script); TUTORIAL_ROWS:
# each printed row's (tol, maxit) as its script passes them.  Each row is
# held to the JAX script's CPU row on the same files, printed by
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py tutorials <dir>
# (poisson_its 164 s on the CPU, the other five 112 s together), with
# its count within max(2, 5%) (RS and UA setups sum with index_add_,
# atomic on the card; the long CG runs and GMRES restarts reorder f64
# sums; fast_path's inner solve is f32), its relres under its tol, or,
# for a row that stops at its maxit, within TUTORIAL_MAXIT_RELRES times
# the anchor's either way; GMG's error against the exact solution within
# 1e-3 of the anchor's, relative.
TUTORIALS = (("poisson_pcg", "poisson_pcg"), ("poisson_amg", "poisson_amg"),
             ("poisson_its", "poisson_its"), ("poisson_gmg", "poisson_gmg"),
             ("spe01_its", "spe01_its"), ("fast_path", "tpu_fast_path"))
TUTORIAL_ROWS = {
    "AMG-PCG": (1e-10, 200), "AMG": (1e-9, 100), "CG": (1e-8, 2000),
    "CG+diag": (1e-8, 2000), "CG+ILU": (1e-8, 500), "CG+AMG": (1e-8, 100),
    "GMRES+AMG": (1e-8, 100), "GMG": (1e-9, 50),
    "SPE01 vFGMRES+AMG": (1e-9, 500), "refined solve": (1e-8, None)}
TUTORIAL_MAXIT_RELRES = 2.0
TUTORIAL_ANCHORS = {
    "AMG-PCG": {"iters": 10, "relres": 3.484e-11},
    "AMG": {"iters": 13, "relres": 4.405e-10},
    "CG": {"iters": 1874, "relres": 7.887e-09},
    "CG+diag": {"iters": 1874, "relres": 7.887e-09},
    "CG+ILU": {"iters": 500, "relres": 1.678e-05},
    "CG+AMG": {"iters": 8, "relres": 5.82e-09},
    "GMRES+AMG": {"iters": 8, "relres": 2.53e-09},
    "GMG": {"iters": 8, "relres": 1.049e-10, "err": 5.02e-05},
    "SPE01 vFGMRES+AMG": {"iters": 23, "relres": 5.193e-10},
    "refined solve": {"iters": 19, "relres": 2.941e-11, "rounds": 2}}


def regression_misses(results, configs, problems, hold_extra=True):
    """The rows of a run_matrix result that leave their JAX anchor (a
    verdict of their own, an ``extra`` of their own when ``hold_extra``,
    a count beyond the allowance unless REGRESSION_FLOOR names the row),
    and the anchored rows of these configs and problems the result
    lacks."""
    bad = []
    for r in results:
        it, ok, extra = REGRESSION_ANCHORS[r.problem][r.name]
        floor = (r.problem, r.name) in REGRESSION_FLOOR
        if (r.ok != ok or (hold_extra and r.extra != extra)
                or (not floor and abs(r.iters - it)
                    > regression_allowance(r.name, it))):
            bad.append(f"{r.problem} / {r.name}: {r.iters} its, "
                       f"{'PASS' if r.ok else 'ATTENTION'} {r.extra!r} "
                       f"(JAX {it}, {'PASS' if ok else 'ATTENTION'} "
                       f"{extra!r})")
    names = {c[0] for c in configs}
    want = {(p[0], c) for p in problems
            for c in REGRESSION_ANCHORS[p[0]] if c in names}
    bad += [f"{p} / {c}: not run" for p, c in sorted(
        want - {(r.problem, r.name) for r in results})]
    return bad


def regression_allowance(config: str, anchor: int) -> int:
    """PERF.md section 2's allowance for a regression row's count: 1
    under 40 iterations (2 for the GMRES family, 3 for BiCGstab + diag),
    else max(2, 5%)."""
    if anchor >= 40:
        return max(2, round(0.05 * anchor))
    if config.startswith("BiCGstab + diag"):
        return 3
    if "GMRES" in config:
        return 2
    return 1


def family(name):
    """A harness row's problem family: its name up to the first "-"."""
    return name.split("-")[0]


def reference_anomalies(table):
    """{row: why} for the rows of a harness anchor table ({row: (JAX
    iterations, "" | "rescue" | "escalate")}) whose JAX run the f32
    ladder rescued or escalated, or that took more than 10 x the median
    count of their family: flagged, never matched silently."""
    import statistics
    median = {}
    for name, (iters, _) in table.items():
        median.setdefault(family(name), []).append(iters)
    median = {f: statistics.median(v) for f, v in median.items()}
    out = {}
    for name, (iters, flag) in table.items():
        if flag:
            out[name] = f"the JAX f32 ladder had to {flag}"
        elif iters > 10 * median[family(name)]:
            out[name] = (f"{iters} iterations, over 10 x the median "
                         f"{median[family(name)]:g} of {family(name)}-*")
    return out


def check(ok, what):
    """A failed check ends the run (explicit, so it holds under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def component_basis(nrow, nb):
    """The component-wise constant near-kernel basis, (nrow, nb)."""
    import numpy as np
    B = np.zeros((nrow, nb))
    for t in range(nb):
        B[t::nb, t] = 1.0
    return B


def bsr_problem(nx=None):
    """block_poisson_3d(nx, nb=3) (nx defaults to BSR_NX) and b = A x for
    a seeded x."""
    import numpy as np
    from faspsolver_tpu_torch.testgen import block_poisson_3d
    A = block_poisson_3d(nx or BSR_NX, nb=3)
    return A, A.matvec(np.random.default_rng(SEED).standard_normal(A.nrow))


def str_problem(nx=None):
    """block_poisson_3d(nx, nb=3) in band form (nx defaults to STR_NX):
    the STRMatrix with offsets +-1, +-nx, +-nx^2 whose bands are the BSR
    matrix's own blocks (zero where a band leaves the grid), so the two
    are one matrix; returns (STR, BSR, b) with b that of
    :func:`bsr_problem`."""
    import numpy as np
    from faspsolver_tpu_torch.formats import STRMatrix
    nx = nx or STR_NX
    A, b = bsr_problem(nx)
    ng = A.nrow_block
    rows = np.repeat(np.arange(ng), np.diff(A.indptr))
    dist = A.indices - rows
    offsets = (1, -1, nx, -nx, nx * nx, -nx * nx)

    def band(o):
        out = np.zeros((ng, A.nb, A.nb))
        hit = dist == o
        out[rows[hit]] = A.data[hit]
        return out

    check(np.isin(dist, (0,) + offsets).all(), "every block lies in a band")
    return (STRMatrix(nx, nx, nx, A.nb, band(0), offsets,
                      [band(o) for o in offsets]), A, b)


def blc_problem(nx=None):
    """The same matrix field by field (nx defaults to BLC_NX): the 3 x 3
    BLCMatrix whose block (p, q) is blk[p, q] poisson_3d(nx), blk = I +
    0.1 (J - I), and b of :func:`bsr_problem` in that order."""
    import numpy as np
    from faspsolver_tpu_torch.formats import BLCMatrix, CSRMatrix
    from faspsolver_tpu_torch.testgen import poisson_3d
    nx = nx or BLC_NX
    P = poisson_3d(nx)
    blk = np.eye(3) + 0.1 * (np.ones((3, 3)) - np.eye(3))
    A = BLCMatrix([[CSRMatrix(P.indptr, P.indices, P.data * blk[p, q],
                              P.shape) for q in range(3)] for p in range(3)])
    _, b = bsr_problem(nx)
    return A, b.reshape(-1, 3).T.reshape(-1)


def sweep_problem(n=None, slabs=None):
    """poisson_3d(n) cut into ``slabs`` z-slabs (defaults SWEEP_N,
    SWEEP_SLABS): in its z-major order a block-tridiagonal BLCMatrix;
    b = A x for a seeded x."""
    import numpy as np
    from faspsolver_tpu_torch.formats import BLCMatrix, CSRMatrix
    from faspsolver_tpu_torch.testgen import poisson_3d
    n, slabs = n or SWEEP_N, slabs or SWEEP_SLABS
    P = poisson_3d(n)
    m = P.to_scipy()
    size = n * n * (n // slabs)
    check(size * slabs == P.nrow, "the slabs tile the grid")
    A = BLCMatrix([[CSRMatrix.from_scipy(
        m[i * size:(i + 1) * size, j * size:(j + 1) * size])
        if abs(i - j) <= 1 else None for j in range(slabs)]
        for i in range(slabs)])
    return A, P.matvec(np.random.default_rng(SEED).standard_normal(P.nrow))


def gmg_problem(n, dim):
    """(f, u) on the (n+1)^dim grid with the boundary: u = prod
    sin(pi x_i), f = dim pi^2 u (so -Δu = f exactly)."""
    import numpy as np
    xs = np.arange(n + 1) / n
    grids = np.meshgrid(*([xs] * dim), indexing="ij")
    u = np.prod([np.sin(np.pi * g) for g in grids], axis=0)
    return dim * np.pi ** 2 * u, u


def write_tutorial_data(dirname, small=False):
    """The tutorials' input files in ``dirname``, written by the port's
    writers: csrmat_FE.dat / rhs_FE.dat (fe_problem(); small:
    poisson_fe_manufactured(64), 3,969 dof, the size of the reference's
    FE pair) and bsrmat_SPE01.dat / rhs_SPE01.dat (bsr_problem(); small:
    bsr_problem(8)).  Returns the seconds the writing took."""
    import os
    from faspsolver_tpu_torch.io import write_csr, write_vec
    from faspsolver_tpu_torch.testgen import poisson_fe_manufactured
    A, b = (poisson_fe_manufactured(64)[:2] if small else fe_problem())
    t0 = time.perf_counter()
    write_csr(os.path.join(dirname, "csrmat_FE.dat"), A)
    write_vec(os.path.join(dirname, "rhs_FE.dat"), b)
    return time.perf_counter() - t0 + write_spe01_data(
        dirname, 8 if small else None)


def write_spe01_data(dirname, nx=None):
    """bsr_problem(nx) as bsrmat_SPE01.dat / rhs_SPE01.dat in ``dirname``,
    by the port's writers: the stand-in for the reference's SPE01 pair,
    which is not in the repository.  Returns the seconds the writing
    took."""
    import os
    from faspsolver_tpu_torch.io import write_bsr, write_vec
    B, bb = bsr_problem(nx)
    t0 = time.perf_counter()
    write_bsr(os.path.join(dirname, "bsrmat_SPE01.dat"), B)
    write_vec(os.path.join(dirname, "rhs_SPE01.dat"), bb)
    return time.perf_counter() - t0


def tutorial_lines(text):
    """{label: {"iters", "relres"[, "rounds"][, "err"]}} of the result
    lines a tutorial printed (the JAX scripts' format, which the port's
    keep); fast_path's inner iterations are its "iters"."""
    import re
    line = re.compile(
        r"^(?P<label>[^:]+?)\s*: (?:iters=\s*(?P<iters>\d+) "
        r"|(?P<n>\d+) (?:iterations|cycles), "
        r"|rounds=(?P<rounds>\d+) inner=(?P<inner>\d+) )"
        r"relres[= ](?P<relres>[-+.e0-9]+)"
        r"(?:, max err vs exact (?P<err>[-+.e0-9]+))?$")
    out = {}
    for ln in text.splitlines():
        m = line.match(ln.strip())
        if not m:
            continue
        row = {"iters": int(m["iters"] or m["n"] or m["inner"]),
               "relres": float(m["relres"])}
        if m["rounds"]:
            row["rounds"] = int(m["rounds"])
        if m["err"]:
            row["err"] = float(m["err"])
        out[m["label"]] = row
    return out


def tutorial_misses(got, anchors):
    """The printed rows that leave their JAX anchor (phase 14's rule,
    above TUTORIALS), and the anchored rows that were not printed."""
    bad = [f"{label}: not printed" for label in anchors if label not in got]
    for label, row in got.items():
        ref = anchors.get(label)
        if ref is None:
            bad.append(f"{label}: no anchor")
            continue
        tol, maxit = TUTORIAL_ROWS[label]
        allow = max(2, round(0.05 * ref["iters"]))
        ok = abs(row["iters"] - ref["iters"]) <= allow
        if maxit is not None and ref["iters"] >= maxit:
            ok &= (row["relres"] < tol or abs(math.log(
                row["relres"] / ref["relres"]))
                <= math.log(TUTORIAL_MAXIT_RELRES))
        else:
            ok &= row["relres"] < tol
        if "rounds" in ref:
            ok &= abs(row["rounds"] - ref["rounds"]) <= 1
        if "err" in ref:
            ok &= abs(row["err"] - ref["err"]) <= 1e-3 * ref["err"]
        if not ok:
            bad.append(f"{label}: {row} (JAX {ref}, {allow} iterations "
                       f"allowed)")
    return bad


def ini_with(ini, overrides, tmpdir=None):
    """A copy of ``ini`` in a new temporary directory with the given
    ``key = value`` lines replaced (appended where the file has none):
    the CLI has no flag for ILU_type or SWZ_type."""
    import os
    import tempfile
    if not overrides:
        return ini
    with open(ini) as f:
        lines = f.read().splitlines()
    for key, value in overrides.items():
        hit = [i for i, ln in enumerate(lines)
               if ln.split("=")[0].strip() == key]
        for i in hit:
            lines[i] = f"{key} = {value}"
        if not hit:
            lines.append(f"{key} = {value}")
    path = os.path.join(tempfile.mkdtemp(dir=tmpdir), os.path.basename(ini))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def launch_counts():
    """The stencil wrapper's launch counts since they were last set to 0,
    by element type, the loop-control kernel's GMRES entry point's
    ("gmres") and its other entry points' ("loop_control"), and of those
    the multigrid loops' entry point's ("mg", counted in "loop_control"
    too), and GCG / GCR's ("gcr", not in "loop_control")."""
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils import loops
    out = {str(k).replace("torch.", ""): v
           for k, v in stencil2d.launches.items()}
    out["gmres"] = loops.launches["gmres"]
    out["gcr"] = loops.launches["gcr"]
    out["loop_control"] = (sum(loops.launches.values()) - out["gmres"]
                           - out["gcr"])
    out["mg"] = loops.launches["mg"]
    return out


def reset_counts():
    """Both kernels' launch counts set to 0."""
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils import loops
    stencil2d.reset_launches()
    loops.reset_launches()


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
    """The two CUDA kernels (nvcc) and the native setup library (g++),
    built from the sources in this checkout, the three compilers started
    together."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from faspsolver_tpu_torch import native
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils import loops
    from faspsolver_tpu_torch.utils.build import BUILD_LOG
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(f) for f in (stencil2d.library, loops.library,
                                         native.available)]
        stencil_lib, loop_lib, native_ok = (j.result() for j in jobs)
    if not native_ok:
        raise RuntimeError(f"native setup library: {native.build_error}")
    print(f"build: stencil2d (nvcc) {BUILD_LOG['stencil2d'][1]:.2f} s, "
          f"loop_control (nvcc) {BUILD_LOG['loop_control'][1]:.2f} s, "
          f"fasp_native (g++) {BUILD_LOG['fasp_native'][1]:.2f} s, "
          f"{time.perf_counter() - t0:.2f} s in all")
    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(native.__file__))), "csrc")
    print("fasp_native built from "
          + ", ".join(os.path.relpath(p) for p in native._SOURCES))
    check(all(os.path.dirname(os.path.abspath(p)) == csrc
              for p in native._SOURCES),
          "the native library is built from faspsolver_tpu_torch/csrc/")
    print_ptxas(BUILD_LOG["stencil2d"][2])


def print_ptxas(log, fail_on_spill=True):
    """Registers, shared memory and spills of every kernel as ptxas -v
    reports them; a spill is a fault.  ``log`` is empty when the library
    was found already built."""
    import re
    if not log:
        print("  library already built here: no compiler output")
        return
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            print("  ptxas:", demangle(m.group(1)))
        elif "registers" in line or "spill" in line:
            print("  ptxas:  ", line.replace("ptxas info    :", "").strip())
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", log)]
    if fail_on_spill:
        check(spills and not any(spills),
              f"ptxas reports no spills: {spills}")


def demangle(name):
    """A readable name for a mangled kernel entry (no c++filt needed)."""
    import re
    m = re.search(r"stencil2dI([fd])Li(\d)ELb([01])EE", name)
    if not m:
        return "empty_kernel" if "empty_kernel" in name else name
    ty = {"f": "float", "d": "double"}[m.group(1)]
    per_row = {"0": "false", "1": "true"}[m.group(3)]
    return f"stencil2d<{ty}, {m.group(2)}, {per_row}>"


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


# phase 3, second part: the loop-control kernel (csrc/loop_control.cu)
# against its plain twin, bit for bit.  A case is (entry point, region
# parameters, steps), a step (phase, inputs): PCG's check takes p.Ap,
# alpha, |r|, max|x|, x.x, p.p; BiCGstab's rstar.v, t.t, |r|, x.x,
# step.step; MINRES's eta and the next Lanczos norm; every decide the
# true residual's norm (MINRES: and x.x); the refinement's round its
# f64 relres.  Krylov parameters default to LOOP_KRYLOV.  Together the
# cases take every branch: convergence, a false claim restarted and one
# out of budget, breakdowns, the zero solution, stagnation restarts and
# their budget, MOD_REL_RES and REL_PRECRES, the safe iterate, maxit, an
# entry test that is already done, and the inner tolerance's clamps.
LOOP_KRYLOV = dict(tol=1e-6, abstol=1e-18, maxit=50, stop_type=1,
                   safe=False, max_stag=20, max_restart=20)
LOOP_REFINE = dict(tol=1e-6, inner_tol=1e-5, inner_floor=5e-6,
                   max_rounds=4)
_PCG_SLOW = [1.5, 0.4, 5e-7, 0.2, 0.05, 0.2]
LOOP_CASES = {
    "pcg converges": ("pcg", {}, [
        (0, [1.0, 0.0]), (1, [2.0, 0.5, 0.3, 0.1, 0.04, 1.0]), (2, [0.0]),
        (1, _PCG_SLOW), (2, [5e-7])]),
    "pcg false claim restarts": ("pcg", {}, [
        (0, [1.0, 0.0]), (1, _PCG_SLOW), (2, [2e-6]),
        (1, [1.5, 0.4, 6e-7, 0.2, 0.05, 0.2]), (2, [3e-7])]),
    "pcg false claim out of budget": ("pcg", {"max_restart": 1}, [
        (0, [1.0, 0.0]), (1, _PCG_SLOW), (2, [2e-6])]),
    "pcg breakdown": ("pcg", {}, [
        (0, [1.0, 0.0]), (1, [1e-41, 0.0, 0.99, 0.0, 0.0, 1.0]),
        (2, [0.0])]),
    "pcg zero solution": ("pcg", {}, [
        (0, [1.0, 0.0]), (1, [2.0, 0.5, 0.95, 1e-21, 1e-42, 1.0]),
        (2, [0.0])]),
    "pcg stagnation restart, then its budget": ("pcg", {"max_stag": 2}, [
        (0, [1.0, 4e14]), (1, [2.0, 1e-9, 0.95, 2e7, 4e14, 1.0]),
        (2, [0.95]), (1, [2.0, 1e-9, 0.94, 2e7, 4e14, 1.0]), (2, [0.94])]),
    "pcg MOD_REL_RES": ("pcg", {"stop_type": 3}, [
        (0, [1.0, 4.0]), (1, [2.0, 0.5, 0.3, 0.1, 9.0, 1.0]), (2, [0.0]),
        (1, [1.5, 0.4, 2e-6, 0.2, 16.0, 0.2]), (2, [1.5e-6])]),
    "pcg REL_PRECRES": ("pcg", {"stop_type": 2}, [
        (0, [2.0, 1.0]), (1, [2.0, 0.5, 0.6, 0.1, 0.04, 1.0]), (2, [0.0]),
        (1, _PCG_SLOW), (2, [1e-6])]),
    "pcg safe iterate": ("pcg", {"safe": True}, [
        (0, [1.0, 0.0]), (1, [2.0, 0.5, 0.5, 0.1, 0.04, 1.0]), (2, [0.0]),
        (1, [2.0, 0.5, 0.45, 0.1, 0.04, 1.0]), (2, [0.0]),
        (1, [2.0, 0.5, 0.8, 0.1, 0.04, 1.0]), (2, [0.0])]),
    "pcg maxit": ("pcg", {"maxit": 1}, [
        (0, [1.0, 0.0]), (1, [2.0, 0.5, 0.3, 0.1, 0.04, 1.0]), (2, [0.0])]),
    "pcg done at entry": ("pcg", {}, [(0, [1e-19, 1.0])]),
    "bicgstab converges": ("bicgstab", {}, [
        (0, [1.0, 0.0]), (1, [1.0, 2.0, 0.3, 0.04, 0.01]), (2, [0.0]),
        (1, [1.0, 2.0, 5e-7, 0.05, 0.01]), (2, [5e-7])]),
    "bicgstab breakdown of t.t": ("bicgstab", {}, [
        (0, [1.0, 0.0]), (1, [1.0, 1e-41, 0.99, 0.04, 0.01]), (2, [0.0])]),
    "bicgstab breakdown of rstar.v": ("bicgstab", {}, [
        (0, [1.0, 0.0]), (1, [-1e-41, 2.0, 0.99, 0.04, 0.01]),
        (2, [0.0])]),
    "bicgstab stagnation restart": ("bicgstab", {}, [
        (0, [1.0, 4e14]), (1, [1.0, 2.0, 0.95, 4e14, 1e-18]), (2, [0.95]),
        (1, [1.0, 2.0, 0.5, 4e14, 1.0]), (2, [0.0])]),
    "bicgstab false claim out of budget": ("bicgstab", {"max_restart": 1}, [
        (0, [1.0, 0.0]), (1, [1.0, 2.0, 5e-7, 0.05, 0.01]), (2, [2e-6])]),
    "bicgstab MOD_REL_RES, safe": ("bicgstab", {"stop_type": 3,
                                                "safe": True}, [
        (0, [1.0, 4.0]), (1, [1.0, 2.0, 0.3, 9.0, 0.01]), (2, [0.0]),
        (1, [1.0, 2.0, 0.6, 9.0, 0.01]), (2, [0.0]),
        (1, [1.0, 2.0, 2e-6, 16.0, 0.01]), (2, [1.5e-6])]),
    "minres converges": ("minres", {}, [
        (0, [1.0, 0.0, 1.0]), (1, [0.3, 0.5]), (2, [0.0, 0.0]),
        (1, [5e-7, 0.5]), (2, [6e-7, 1.0])]),
    "minres false claim continues": ("minres", {}, [
        (0, [1.0, 0.0, 1.0]), (1, [5e-7, 0.5]), (2, [2e-6, 1.0]),
        (1, [4e-7, 0.5]), (2, [5e-7, 1.0])]),
    "minres Lanczos breakdown": ("minres", {}, [
        (0, [1.0, 0.0, 1.0]), (1, [0.3, 1e-21]), (2, [0.0, 0.0])]),
    "minres done at entry": ("minres", {}, [(0, [1.0, 0.0, 1e-21])]),
    "minres MOD_REL_RES, safe": ("minres", {"stop_type": 3, "safe": True}, [
        (0, [1.0, 4.0, 1.0]), (1, [0.3, 0.5]), (2, [0.0, 0.0]),
        (1, [0.4, 0.5]), (2, [0.0, 0.0]), (1, [5e-7, 0.5]),
        (2, [2e-6, 9.0])]),
    "refine two rounds": ("refine", {}, [(0, [0.0]), (1, [1e-3]),
                                         (1, [2e-7])]),
    "refine inner tolerance clamps": ("refine", {}, [
        (0, [0.0]), (1, [0.1]), (1, [3e-2]), (1, [7e-4])]),
    "refine max rounds": ("refine", {"max_rounds": 2}, [
        (0, [0.0]), (1, [0.5]), (1, [0.4])]),
    "refine relres floor": ("refine", {"tol": 1e-310, "inner_floor": 1e-20}, [
        (0, [0.0]), (1, [1e-301]), (1, [3e-300])]),
    "refine no round": ("refine", {"max_rounds": 0}, [(0, [0.0])]),
}


def loop_case_blocks(torch, name, dtype, device, plain):
    """Case ``name`` of LOOP_CASES in ``dtype`` on ``device``, through
    the twin (``plain``) or the wrapper (the kernel on the card): the
    state block's bytes after every step."""
    from faspsolver_tpu_torch.utils import loops
    kind, params, steps = LOOP_CASES[name]
    F, I = loops.F, loops.I
    if kind == "refine":
        p = {**LOOP_REFINE, **params}
        blk = loops.Block(device, [("refine", torch.float64),
                                   ("inner", dtype)])
        blk.upload({"refine": {("f", F.TOL): p["tol"],
                               ("f", F.INNER_TOL): p["inner_tol"],
                               ("f", F.INNER_FLOOR): p["inner_floor"],
                               ("i", I.MAXIT): p["max_rounds"]}})
        call = loops.refine_plain if plain else loops.refine
        args = (blk["refine"], blk["inner"])
        in_dtype = torch.float64
    else:
        blk = loops.Block(device, [(kind, dtype)])
        blk.upload({kind: loops.krylov_values(**{**LOOP_KRYLOV, **params})})
        call = (loops.PLAIN[kind] if plain
                else lambda ph, x, reg: loops.control(kind, ph, x, reg))
        args = (blk[kind],)
        in_dtype = dtype
    out = []
    for phase, vals in steps:
        call(phase, torch.tensor(vals, dtype=in_dtype, device=device), *args)
        out.append(blk.bytes.cpu().clone())
    return out


def check_loop_control(torch, device, smi):
    """Every case in f32 and f64: the kernel's block after each step
    bit-equal to the twin's on the CPU (and to the twin's run on the
    card); then the times of one control launch (PCG's check): replayed
    from a CUDA graph of 200 launches (device time, how the resident loop
    runs it) and eagerly, an empty one-thread kernel the same ways (the
    launch floor), and the twin on the card.  Returns the kernel's JSON
    row (launches filled in by the caller)."""
    from faspsolver_tpu_torch.ops.stencil2d import HBM_BYTES_PER_S
    from faspsolver_tpu_torch.utils import loops
    from faspsolver_tpu_torch.utils.build import BUILD_LOG
    print_ptxas(BUILD_LOG["loop_control"][2])
    steps = 0
    for name in LOOP_CASES:
        for dt in (torch.float32, torch.float64):
            got = loop_case_blocks(torch, name, dt, device, plain=False)
            want = loop_case_blocks(torch, name, dt, "cpu", plain=True)
            on_card = loop_case_blocks(torch, name, dt, device, plain=True)
            same = all(torch.equal(g, w) and torch.equal(c, w)
                       for g, w, c in zip(got, want, on_card))
            steps += len(got)
            if not same:
                bad = next(k for k, (g, w) in enumerate(zip(got, want))
                           if not torch.equal(g, w))
                print(f"  loop_control {name} {dt}: step {bad} differs: "
                      f"kernel {got[bad].tolist()} twin {want[bad].tolist()}")
            check(same, f"loop_control {name} {dt}: kernel bit-equal to "
                        f"its plain twin")
    print(f"  loop_control: {len(LOOP_CASES)} cases x f32/f64, {steps} "
          f"steps, every block bit-equal to the twin's (CPU and card)")
    blk = loops.Block(device, [("pcg", torch.float32)])
    blk.upload({"pcg": loops.krylov_values(**{**LOOP_KRYLOV,
                                              "maxit": 10 ** 9})})
    reg = blk["pcg"]
    inp = torch.tensor([2.0, 0.5, 0.3, 0.1, 0.04, 1.0], device=device)
    saved = dict(loops.launches)
    ctl = lambda x: loops.control("pcg", loops.CHECK, x, reg)  # noqa: E731
    ms = time_ms(torch, ctl, inp, graph=True)
    eager_ms = time_ms(torch, ctl, inp)
    empty = lambda x: loops.launch_empty(device)  # noqa: E731
    floor_ms = time_ms(torch, empty, inp, graph=True)
    floor_eager_ms = time_ms(torch, empty, inp)
    plain = lambda x: loops.pcg_plain(loops.CHECK, x, reg)  # noqa: E731
    plain_ms = time_ms(torch, plain, inp, reps=20, tries=3)
    loops.launches.update(saved)        # the timing's launches: not a path's
    # the least work of a check: its 6 inputs and the region read and
    # written once; some 30 scalar operations
    nbytes = inp.numel() * 4 + 2 * (loops.F.COUNT * 4 + loops.I.COUNT * 4)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 30 / 67e12) * 1e3
    print(f"  loop_control pcg check: {ms * 1e3:.3f} us per launch in a "
          f"graph ({eager_ms * 1e3:.3f} us eager), empty one-thread kernel "
          f"{floor_ms * 1e3:.3f} us ({floor_eager_ms * 1e3:.3f} us eager), "
          f"plain twin on the card {plain_ms * 1e3:.1f} us; roofline bound "
          f"{bound_ms * 1e3:.6f} us ({nbytes} bytes); {smi}")
    return {"name": "loop_control", "route": "cuda",
            "source": "faspsolver_tpu_torch/csrc/loop_control.cu",
            "replaces": REPLACES["loop"], "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "launch_floor_ms": floor_ms,
            "eager_ms": eager_ms, "cases": len(LOOP_CASES), "steps": steps}


# phase 3, third part: the GMRES family's control (``gmres_entry`` in
# csrc/loop_control.cu) against its twin, bit for bit.  A case is
# (parameters, steps) over GMRES_PARAMS (R the window), a step (phase,
# inputs): 0 init {absres0, x0.x0, |r0|}; 1 cycle; 2 arnoldi, the column
# h_0 .. h_j then hn (:func:`_col` pads it); 3 solve; 4 restart the true
# residual's {|r|, absres, x.x}.  Together the cases take every branch:
# convergence of the least-squares residual, a happy breakdown, the
# rotation's den guard, a full window and its restart, maxit inside a
# window, the adaptive rule's four outcomes, stagnation (-42) and the
# crawl zone within 4 tol, the safe iterate, an entry test already done,
# MOD_REL_RES and REL_PRECRES, an empty window; and two full windows of
# seeded columns at R = 30 and 60 (what phase 3 times).
GMRES_PARAMS = dict(tol=1e-6, abstol=1e-18, maxit=50, stop_type=1,
                    safe=False, adaptive=False, R=4)
_G_INIT = (0, [1.0, 0.0, 1.0])


def _col(R, h, hn):
    """An Arnoldi column for window R: h (entries 0..j), zeros, hn."""
    return list(h) + [0.0] * (R + 1 - len(h)) + [hn]


def _cycles(R, rnorms, steps=1, h=(0.6, 0.3), hn=0.5):
    """Restart cycles of ``steps`` Arnoldi steps each, cycle k ending
    with the true residual rnorms[k] (absres = |r|, x.x = 1)."""
    out = []
    for rn in rnorms:
        out += [(1, [])]
        out += [(2, _col(R, h[:j + 1] if j < len(h) else [0.1] * (j + 1),
                         hn)) for j in range(steps)]
        out += [(3, []), (4, [rn, rn, 1.0])]
    return out


def _window(R, seed):
    """A full window of seeded columns, solved, then a restart."""
    import random
    rnd = random.Random(seed)
    cols = [(2, _col(R, [rnd.uniform(-1.0, 1.0) for _ in range(j + 1)],
                     rnd.uniform(0.5, 1.5))) for j in range(R)]
    return [_G_INIT, (1, [])] + cols + [(3, []), (4, [0.5, 0.5, 1.0])]


GMRES_CASES = {
    "gmres converges in its first window": ({}, [
        _G_INIT, (1, []), (2, _col(4, [0.5], 0.8)),
        (2, _col(4, [0.3, 0.2], 1e-8)), (3, []), (4, [5e-7, 5e-7, 1.0])]),
    "gmres happy breakdown": ({}, [
        _G_INIT, (1, []), (2, _col(4, [2.0], 1e-30)), (3, []),
        (4, [1e-12, 1e-12, 1.0])]),
    "gmres den guard": ({}, [
        _G_INIT, (1, []), (2, _col(4, [0.0], 0.0)), (3, []),
        (4, [1.0, 1.0, 1.0])]),
    "gmres full window restarts": ({"R": 3}, [
        _G_INIT, *_cycles(3, [0.1], steps=3, h=(0.6, 0.3, -0.2)),
        (1, []), (2, _col(3, [0.4], 1e-9)), (3, []),
        (4, [5e-7, 5e-7, 1.0])]),
    "gmres maxit inside a window": ({"maxit": 6}, [
        _G_INIT, *_cycles(4, [0.1, 0.05], steps=4)[:7],
        (1, []), (2, _col(4, [0.5], 0.5)), (2, _col(4, [0.2, 0.4], 0.5)),
        (3, []), (4, [0.05, 0.05, 1.0])]),
    "vgmres adaptive restart rule": ({"R": 8, "adaptive": True}, [
        _G_INIT, *_cycles(8, [0.5, 0.25, 0.2499, 0.025, 0.0125,
                              0.00625])]),
    "gmres stagnation exits": ({}, [
        _G_INIT, *_cycles(4, [0.5] * 5)]),
    "gmres crawl within 4 tol": ({}, [
        _G_INIT, *_cycles(4, [3e-6] * 6)]),
    "gmres safe iterate": ({"safe": True}, [
        _G_INIT, *_cycles(4, [0.5, 0.6, 0.3])]),
    "gmres done at entry": ({}, [(0, [1e-19, 1.0, 1e-19])]),
    "gmres MOD_REL_RES": ({"stop_type": 3}, [
        (0, [1.0, 4.0, 1.0]), *_cycles(4, [0.1, 1e-6])]),
    "gmres REL_PRECRES": ({"stop_type": 2}, [
        (0, [2.0, 1.0, 1.0]), (1, []), (2, _col(4, [0.5], 0.8)),
        (2, _col(4, [0.3, 0.2], 1e-8)), (3, []), (4, [1e-6, 1e-6, 1.0])]),
    "gmres empty window ends": ({}, [_G_INIT, (1, []), (3, []),
                                     (4, [1.0, 1.0, 1.0])]),
    "gmres window 30": ({"R": 30, "tol": 1e-30, "maxit": 1000},
                        _window(30, 30)),
    "gmres window 60": ({"R": 60, "tol": 1e-30, "maxit": 1000},
                        _window(60, 60)),
}


def gmres_case_state(torch, name, dtype, device):
    """Case ``name`` of GMRES_CASES set up on ``device``: (block, its
    two regions, the window's arrays, R)."""
    from faspsolver_tpu_torch.utils import loops
    params, _ = GMRES_CASES[name]
    p = {**GMRES_PARAMS, **params}
    R = p.pop("R")
    blk = loops.Block(device, [("gmres", dtype), ("arnoldi", dtype)])
    blk.upload({"gmres": loops.gmres_values(**p)})
    arr = torch.zeros(loops.gmres_arrays(R), dtype=dtype, device=device)
    return blk, blk["gmres"], blk["arnoldi"], arr, R


def gmres_case_blocks(torch, name, dtype, device, plain):
    """Case ``name`` of GMRES_CASES in ``dtype`` on ``device`` through the
    twin (``plain``) or the wrapper (the kernel on the card): the block's
    bytes and the arrays' after every step."""
    from faspsolver_tpu_torch.utils import loops
    blk, reg, inner, arr, R = gmres_case_state(torch, name, dtype, device)
    call = loops.gmres_plain if plain else loops.gmres
    out = []
    for phase, vals in GMRES_CASES[name][1]:
        inp = torch.tensor(vals or [0.0], dtype=dtype, device=device)
        call(phase, inp, reg, inner, arr, R)
        out.append((blk.bytes.cpu().clone(), arr.cpu().clone()))
    return out


def _same_bits(torch, a, b):
    """Bit-equal (NaN and infinities included)."""
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(ints), b.view(ints))


def check_gmres_control(torch, device, smi):
    """Every case in f32 and f64: the kernel's block and arrays after
    each step bit-equal to the twin's on the CPU and on the card; then
    the times of one arnoldi launch at j = R - 1 (R = 30 and 60) and of
    one solve launch at j = R, each replayed from a CUDA graph of 200
    launches beside the same graph of 200 empty one-thread kernels and,
    for the solve, of 200 ``torch.linalg.solve_triangular`` on the same
    R x R triangle and g, and the twin's on the card.  Returns the kernel's JSON row (launches
    filled in by the caller)."""
    from faspsolver_tpu_torch.ops.stencil2d import HBM_BYTES_PER_S
    from faspsolver_tpu_torch.utils import loops
    steps = 0
    for name in GMRES_CASES:
        for dt in (torch.float32, torch.float64):
            got = gmres_case_blocks(torch, name, dt, device, plain=False)
            want = gmres_case_blocks(torch, name, dt, "cpu", plain=True)
            on_card = gmres_case_blocks(torch, name, dt, device, plain=True)
            bad = [k for k, (g, w, c) in enumerate(zip(got, want, on_card))
                   if not (torch.equal(g[0], w[0]) and torch.equal(c[0], w[0])
                           and _same_bits(torch, g[1], w[1])
                           and _same_bits(torch, c[1], w[1]))]
            steps += len(got)
            if bad:
                k = bad[0]
                print(f"  gmres control {name} {dt}: step {k} differs: "
                      f"kernel {got[k][0].tolist()} {got[k][1].tolist()} "
                      f"twin {want[k][0].tolist()} {want[k][1].tolist()}")
            check(not bad, f"gmres control {name} {dt}: kernel bit-equal "
                           f"to its plain twin")
    print(f"  gmres control: {len(GMRES_CASES)} cases x f32/f64, {steps} "
          f"steps, every block and array bit-equal to the twin's (CPU and "
          f"card)")
    saved = dict(loops.launches)
    empty = lambda x: loops.launch_empty(device)  # noqa: E731
    floor_ms = time_ms(torch, empty, None, graph=True)
    link_ms = chain_links(torch, device)
    row = {}
    for R in (30, 60):
        name = f"gmres window {R}"
        blk, reg, inner, arr, R = gmres_case_state(torch, name,
                                                   torch.float64, device)
        seq = GMRES_CASES[name][1]
        for phase, vals in seq[:R + 1]:       # init, cycle, R - 1 columns
            loops.gmres(phase, torch.tensor(vals or [0.0], device=device,
                                            dtype=torch.float64),
                        reg, inner, arr, R)
        col = torch.tensor(seq[R + 1][1], dtype=torch.float64, device=device)
        j = reg.i[loops.I.J:loops.I.J + 1]
        j0 = j.clone()

        def reset(x):                           # j back to R - 1
            j.copy_(j0)

        def arnoldi(x):
            j.copy_(j0)
            loops.gmres(loops.ARNOLDI, x, reg, inner, arr, R)

        reset_ms = time_ms(torch, reset, col, graph=True)
        arnoldi_ms = time_ms(torch, arnoldi, col, graph=True) - reset_ms
        plain_arnoldi_ms = time_ms(torch, lambda x: (
            j.copy_(j0), loops.gmres_plain(loops.ARNOLDI, x, reg, inner, arr,
                                           R)), col, reps=3, tries=2)
        j.copy_(j0)
        loops.gmres(loops.ARNOLDI, col, reg, inner, arr, R)   # j = R
        solve = lambda x: loops.gmres(loops.SOLVE, x, reg, inner,  # noqa
                                      arr, R)
        solve_ms = time_ms(torch, solve, col, graph=True)
        plain_solve_ms = time_ms(torch, lambda x: loops.gmres_plain(
            loops.SOLVE, x, reg, inner, arr, R), col, reps=3, tries=2)
        # the library's call for the same solve (timed, used nowhere)
        H, g, *_ = loops.gmres_views(arr, R)
        Ht, gt = H[:R, :R].contiguous(), g[:R, None].contiguous()
        solve_library_ms = time_ms(torch, lambda x: torch.linalg.
                                   solve_triangular(Ht, gt, upper=True),
                                   col, graph=True)
        # the least work in f64: the column and both regions in, the
        # column of H, g, cs, sn and the regions out, some 6 R + 12
        # operations (arnoldi); H's upper triangle and g in, y out, R^2
        # operations (solve).  Operations over the FP64 vector peak (34
        # TFLOP/s, NVIDIA's H100 SXM data sheet)
        region = 2 * (loops.F.COUNT * 8 + loops.I.COUNT * 4)
        a_bytes = (R + 2) * 8 + 2 * region + (R + 5) * 8
        s_bytes = (R * (R + 1) // 2 + 2 * R) * 8
        # what the dependent chain alone takes: the launch floor plus
        # R - 1 rotations (arnoldi at j = R - 1) or R steps (solve at j =
        # R) at the card's latency per link (chain_links)
        chain = {"arnoldi": floor_ms + (R - 1) * link_ms[0],
                 "solve": floor_ms + R * link_ms[1]}
        row[R] = {
            "arnoldi_chain_bound_ms": chain["arnoldi"],
            "solve_chain_bound_ms": chain["solve"],
            "arnoldi_ms": arnoldi_ms, "solve_ms": solve_ms,
            "plain_arnoldi_ms": plain_arnoldi_ms,
            "plain_solve_ms": plain_solve_ms,
            "solve_library_ms": solve_library_ms,
            "arnoldi_bound_ms": max(a_bytes / HBM_BYTES_PER_S,
                                    (6 * R + 12) / 34e12) * 1e3,
            "solve_bound_ms": max(s_bytes / HBM_BYTES_PER_S,
                                  R * R / 34e12) * 1e3}
        print(f"  gmres control, f64, R = {R}: arnoldi at j = R - 1 "
              f"{arnoldi_ms * 1e3:.3f} us per launch (graph of 200, less "
              f"the {reset_ms * 1e3:.3f} us of its j reset), solve at j = R "
              f"{solve_ms * 1e3:.3f} us; empty one-thread kernel "
              f"{floor_ms * 1e3:.3f} us; torch.linalg.solve_triangular "
              f"{solve_library_ms * 1e3:.3f} us; plain twin on the card "
              f"{plain_arnoldi_ms * 1e3:.1f} / {plain_solve_ms * 1e3:.1f} "
              f"us; roofline bounds {row[R]['arnoldi_bound_ms'] * 1e3:.6f}"
              f" / {row[R]['solve_bound_ms'] * 1e3:.6f} us; floor + chain "
              f"{chain['arnoldi'] * 1e3:.3f} / {chain['solve'] * 1e3:.3f} "
              f"us; {smi}")
    loops.launches.update(saved)        # the timing's launches: not a path's
    main = row[60]
    return {"name": "loop_control gmres", "route": "cuda",
            "source": "faspsolver_tpu_torch/csrc/loop_control.cu",
            "replaces": REPLACES["gmres"], "max_abs_err": 0.0,
            "ms": main["arnoldi_ms"], "plain_ms": main["plain_arnoldi_ms"],
            "bound_ms": main["arnoldi_bound_ms"], "bound_by": "bytes",
            "library_ms": None, "launch_floor_ms": floor_ms,
            "chain_bound_ms": main["arnoldi_chain_bound_ms"],
            "link_ns": {"rotation": link_ms[0] * 1e6,
                        "solve_step": link_ms[1] * 1e6},
            "timed": "arnoldi at j = R - 1, R = 60, f64",
            "windows": {str(k): v for k, v in row.items()},
            "cases": len(GMRES_CASES), "steps": steps}


def chain_links(torch, device, n=20000):
    """The card's latency (ms) of one link of each dependent chain of
    the GMRES control (``chain_probe`` in csrc/loop_control.cu, f64, one
    warp): (a rotation's multiply and add, a solve step's multiply,
    subtract and division), from a launch of ``n`` links less one of
    none, CUDA events, best of 3 x 5."""
    from faspsolver_tpu_torch.utils import loops
    v = torch.tensor([0.5, 1.0, 0.5, 2.0, 0.0], dtype=torch.float64,
                     device=device)
    out = []
    for kind in (0, 1):
        ms = [time_ms(torch, lambda x: loops.chain_probe(kind, k, v), None,
                      reps=5, tries=3) for k in (0, n)]
        check(math.isfinite(float(v[4])), f"chain probe {kind}: finite")
        out.append((ms[1] - ms[0]) / n)
    print(f"  chain probe, f64: {out[0] * 1e6:.2f} ns per rotation link "
          f"(multiply, add), {out[1] * 1e6:.2f} ns per solve step "
          f"(multiply, subtract, division)")
    return out


# phase 3, fourth part: the multigrid loops' control (``mg_control`` in
# csrc/loop_control.cu) against its twin, bit for bit.  A case is (form,
# parameters, steps) over MG_PARAMS, a step (phase, [relres]): 0 init, 1
# check.  Together the cases take every branch of both forms: converged
# at entry, maxit 0 and 1, a relres exactly at tol (both forms go on),
# NaN (AMG's form runs to maxit, GMG's stops, at entry too), convergence
# and a run to maxit.
MG_PARAMS = dict(tol=1e-6, maxit=20)
_NAN = float("nan")
MG_CASES = {
    "amg converged at entry": ("amg", {}, [(0, [1e-7])]),
    "gmg converged at entry": ("gmg", {}, [(0, [1e-7])]),
    "amg maxit 0": ("amg", {"maxit": 0}, [(0, [0.5])]),
    "gmg maxit 0": ("gmg", {"maxit": 0}, [(0, [0.5])]),
    "amg maxit 1": ("amg", {"maxit": 1}, [(0, [0.5]), (1, [0.2])]),
    "gmg maxit 1": ("gmg", {"maxit": 1}, [(0, [0.5]), (1, [0.2])]),
    "amg relres exactly tol": ("amg", {}, [(0, [1.0]), (1, [1e-6]),
                                           (1, [5e-7])]),
    "gmg relres exactly tol": ("gmg", {}, [(0, [1.0]), (1, [1e-6]),
                                           (1, [5e-7])]),
    "amg NaN runs to maxit": ("amg", {"maxit": 3}, [
        (0, [_NAN]), (1, [_NAN]), (1, [_NAN]), (1, [_NAN])]),
    "gmg NaN stops": ("gmg", {}, [(0, [1.0]), (1, [_NAN])]),
    "gmg NaN at entry": ("gmg", {}, [(0, [_NAN])]),
    "amg converges": ("amg", {}, [(0, [1.0]), (1, [1e-3]), (1, [1e-7])]),
    "gmg converges": ("gmg", {}, [(0, [1.0]), (1, [1e-3]), (1, [1e-7])]),
    "amg runs to maxit": ("amg", {"maxit": 4}, [
        (0, [1.0]), (1, [0.5]), (1, [0.25]), (1, [0.125]), (1, [0.0625])]),
}


def mg_case_blocks(torch, name, dtype, device, plain):
    """Case ``name`` of MG_CASES in ``dtype`` on ``device``, through the
    twin (``plain``) or the wrapper (the kernel on the card): the state
    block's bytes after every step."""
    from faspsolver_tpu_torch.utils import loops
    form, params, steps = MG_CASES[name]
    blk = loops.Block(device, [("mg", dtype)])
    blk.upload({"mg": loops.mg_values(form=form,
                                      **{**MG_PARAMS, **params})})
    call = (loops.mg_plain if plain
            else lambda ph, x, reg: loops.control("mg", ph, x, reg))
    out = []
    for phase, vals in steps:
        call(phase, torch.tensor(vals, dtype=dtype, device=device),
             blk["mg"])
        out.append(blk.bytes.cpu().clone())
    return out


def check_mg_control(torch, device, smi):
    """Every case of MG_CASES in f32 and f64: the ``mg`` entry point's
    block after each step bit-equal to the twin's on the CPU (and to the
    twin's run on the card); then the time of one check launch replayed
    from a CUDA graph and eagerly, beside an empty one-thread kernel.
    Returns the readings, which the loop-control row of the kernels' JSON
    line carries (its launches are counted under ``loop_control``)."""
    from faspsolver_tpu_torch.ops.stencil2d import HBM_BYTES_PER_S
    from faspsolver_tpu_torch.utils import loops
    steps = 0
    for name in MG_CASES:
        for dt in (torch.float32, torch.float64):
            got = mg_case_blocks(torch, name, dt, device, plain=False)
            want = mg_case_blocks(torch, name, dt, "cpu", plain=True)
            on_card = mg_case_blocks(torch, name, dt, device, plain=True)
            same = all(torch.equal(g, w) and torch.equal(c, w)
                       for g, w, c in zip(got, want, on_card))
            steps += len(got)
            if not same:
                bad = next(k for k, (g, w) in enumerate(zip(got, want))
                           if not torch.equal(g, w))
                print(f"  mg {name} {dt}: step {bad} differs: kernel "
                      f"{got[bad].tolist()} twin {want[bad].tolist()}")
            check(same, f"mg {name} {dt}: kernel bit-equal to its twin")
    print(f"  loop_control mg: {len(MG_CASES)} cases x f32/f64, {steps} "
          f"steps, every block bit-equal to the twin's (CPU and card)")
    out = {}
    for dt in (torch.float32, torch.float64):
        blk = loops.Block(device, [("mg", dt)])
        blk.upload({"mg": loops.mg_values(1e-6, 10 ** 9, "gmg")})
        reg = blk["mg"]
        inp = torch.tensor([0.5], dtype=dt, device=device)
        saved = dict(loops.launches)
        ctl = lambda x: loops.control("mg", loops.CHECK, x, reg)  # noqa: E731
        ms = time_ms(torch, ctl, inp, graph=True)
        eager_ms = time_ms(torch, ctl, inp)
        empty = lambda x: loops.launch_empty(device)  # noqa: E731
        floor_ms = time_ms(torch, empty, inp, graph=True)
        plain = lambda x: loops.mg_plain(loops.CHECK, x, reg)  # noqa: E731
        plain_ms = time_ms(torch, plain, inp, reps=20, tries=3)
        loops.launches.update(saved)    # the timing's launches: no path's
        # the least work of a check: its input and the fields it reads
        # and writes, once; a handful of scalar operations
        nbytes = inp.element_size() * 3 + 4 * 7
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 4 / 67e12) * 1e3
        tag = "f32" if dt == torch.float32 else "f64"
        print(f"  loop_control mg check ({tag}): {ms * 1e3:.3f} us per "
              f"launch in a graph ({eager_ms * 1e3:.3f} us eager), empty "
              f"one-thread kernel {floor_ms * 1e3:.3f} us, plain twin on "
              f"the card {plain_ms * 1e3:.1f} us; roofline bound "
              f"{bound_ms * 1e3:.6f} us ({nbytes} bytes); {smi}")
        out[tag] = {"ms": ms, "eager_ms": eager_ms, "launch_floor_ms":
                    floor_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
    return {"mg_cases": len(MG_CASES), "mg_steps": steps, "mg": out}


# phase 3, fifth part: GCG / GCR's control (``gcr_control`` in
# csrc/loop_control.cu) against its twin, bit for bit.  A case is
# (parameters, steps) over GCR_PARAMS (R the window), a step (phase,
# inputs): 0 init {absres0, x0.x0}; 1 cycle; 2 step {qn, |r|}; 3 end the
# true residual's {absres, x.x}.  Together the cases take every branch:
# the entry test met, maxit 0, a breakdown at step 0, tol met mid-window
# and a residual exactly at tol, a false claim of the step's residual
# that the true one refutes, a full window and its restart, maxit
# inside a window, an empty window (j == 0 ends the outer loop), NaN
# (no test stops it: it runs to maxit), and the three stop types.
GCR_PARAMS = dict(tol=1e-6, abstol=1e-18, maxit=50, stop_type=1, R=4)
_R_INIT = (0, [1.0, 0.0])
GCR_CASES = {
    "gcr done at entry": ({}, [(0, [1e-19, 1.0])]),
    "gcr maxit 0": ({"maxit": 0}, [_R_INIT]),
    "gcr breakdown at step 0": ({}, [
        _R_INIT, (1, []), (2, [1e-21, 1.0]), (3, [1.0, 1.0]), (1, []),
        (2, [0.5, 0.3]), (2, [0.5, 5e-7]), (3, [5e-7, 1.0])]),
    "gcr tol met mid-window": ({}, [
        _R_INIT, (1, []), (2, [0.8, 0.3]), (2, [0.6, 4e-7]),
        (3, [4e-7, 1.0])]),
    "gcr relres exactly tol": ({}, [
        _R_INIT, (1, []), (2, [0.8, 1e-6]), (2, [0.6, 5e-7]),
        (3, [1e-6, 1.0]), (1, []), (2, [0.7, 3e-7]), (3, [3e-7, 1.0])]),
    "gcr false claim restarts": ({}, [
        _R_INIT, (1, []), (2, [0.8, 5e-7]), (3, [2e-6, 1.0]), (1, []),
        (2, [0.7, 3e-7]), (3, [3e-7, 1.0])]),
    "gcr full window restarts": ({"R": 3}, [
        _R_INIT, (1, []), (2, [0.9, 0.5]), (2, [0.9, 0.3]),
        (2, [0.9, 0.1]), (3, [0.1, 1.0]), (1, []), (2, [0.9, 5e-7]),
        (3, [5e-7, 1.0])]),
    "gcr maxit inside a window": ({"maxit": 6}, [
        _R_INIT, (1, []), (2, [0.9, 0.5]), (2, [0.9, 0.4]),
        (2, [0.9, 0.3]), (2, [0.9, 0.1]), (3, [0.1, 1.0]), (1, []),
        (2, [0.9, 0.05]), (2, [0.9, 0.04]), (3, [0.04, 1.0])]),
    "gcr empty window ends": ({"R": 0}, [_R_INIT, (1, []),
                                         (3, [1.0, 1.0])]),
    "gcr NaN runs to maxit": ({"maxit": 3}, [
        _R_INIT, (1, []), (2, [_NAN, _NAN]), (2, [_NAN, _NAN]),
        (2, [_NAN, _NAN]), (3, [_NAN, 1.0])]),
    "gcr MOD_REL_RES": ({"stop_type": 3}, [
        (0, [1.0, 4.0]), (1, []), (2, [0.8, 0.3]), (3, [0.3, 9.0]),
        (1, []), (2, [0.8, 1e-7]), (3, [1e-6, 16.0])]),
    "gcr REL_PRECRES": ({"stop_type": 2}, [
        (0, [2.0, 1.0]), (1, []), (2, [0.8, 0.3]), (2, [0.8, 1e-7]),
        (3, [1e-6, 1.0])]),
}


def gcr_case_state(torch, name, dtype, device):
    """Case ``name`` of GCR_CASES set up on ``device``: (block, its two
    regions, R)."""
    from faspsolver_tpu_torch.utils import loops
    params, _ = GCR_CASES[name]
    p = {**GCR_PARAMS, **params}
    R = p.pop("R")
    blk = loops.Block(device, [("gcr", dtype), ("descent", dtype)])
    blk.upload({"gcr": loops.gcr_values(**p)})
    return blk, blk["gcr"], blk["descent"], R


def gcr_case_blocks(torch, name, dtype, device, plain):
    """Case ``name`` of GCR_CASES in ``dtype`` on ``device`` through the
    twin (``plain``) or the wrapper (the kernel on the card): the
    block's bytes after every step, each NaN field written as the CPU's
    NaN (a NaN's payload is the device's own: an arithmetic NaN on the
    card is 0x7fffffff in f32, where the CPU keeps its operand's
    0x7fc00000; the decisions see only that it is a NaN)."""
    from faspsolver_tpu_torch.utils import loops
    blk, reg, inner, R = gcr_case_state(torch, name, dtype, device)
    call = loops.gcr_plain if plain else loops.gcr
    out = []
    for phase, vals in GCR_CASES[name][1]:
        call(phase, torch.tensor(vals or [0.0], dtype=dtype, device=device),
             reg, inner, R)
        raw = blk.bytes.cpu().clone()
        for r in blk.regions.values():
            f = raw[r.offsets[0]:r.offsets[0] + r.f.numel()
                    * r.f.element_size()].view(r.dtype)
            f[torch.isnan(f)] = float("nan")
        out.append(raw)
    return out


def check_gcr_control(torch, device, smi):
    """Every case of GCR_CASES in f32 and f64: the ``gcr`` entry point's
    block after each step bit-equal to the twin's on the CPU and on the
    card; then the time of one step launch (the one a descent step
    runs) replayed from a CUDA graph and eagerly, beside an empty
    one-thread kernel, and the twin's on the card.  Returns the kernel's
    JSON row (launches filled in by the caller)."""
    from faspsolver_tpu_torch.ops.stencil2d import HBM_BYTES_PER_S
    from faspsolver_tpu_torch.utils import loops
    steps = 0
    for name in GCR_CASES:
        for dt in (torch.float32, torch.float64):
            got = gcr_case_blocks(torch, name, dt, device, plain=False)
            want = gcr_case_blocks(torch, name, dt, "cpu", plain=True)
            on_card = gcr_case_blocks(torch, name, dt, device, plain=True)
            same = all(torch.equal(g, w) and torch.equal(c, w)
                       for g, w, c in zip(got, want, on_card))
            steps += len(got)
            if not same:
                bad = next(k for k, (g, w) in enumerate(zip(got, want))
                           if not torch.equal(g, w))
                print(f"  gcr {name} {dt}: step {bad} differs: kernel "
                      f"{got[bad].tolist()} twin {want[bad].tolist()}")
            check(same, f"gcr {name} {dt}: kernel bit-equal to its twin")
    print(f"  loop_control gcr: {len(GCR_CASES)} cases x f32/f64, {steps} "
          f"steps, every block bit-equal to the twin's (CPU and card)")
    saved = dict(loops.launches)
    out = {}
    for dt in (torch.float32, torch.float64):
        blk = loops.Block(device, [("gcr", dt), ("descent", dt)])
        blk.upload({"gcr": loops.gcr_values(1e-6, 1e-18, 2 ** 30, 1)})
        reg, inner = blk["gcr"], blk["descent"]
        loops.gcr(loops.INIT, torch.tensor([1.0, 0.0], dtype=dt,
                                           device=device), reg, inner, 1)
        inp = torch.tensor([0.5, 0.5], dtype=dt, device=device)
        ctl = lambda x: loops.gcr(loops.STEP, x, reg, inner,  # noqa: E731
                                  2 ** 30)
        ms = time_ms(torch, ctl, inp, graph=True)
        eager_ms = time_ms(torch, ctl, inp)
        empty = lambda x: loops.launch_empty(device)  # noqa: E731
        floor_ms = time_ms(torch, empty, inp, graph=True)
        plain = lambda x: loops.gcr_plain(  # noqa: E731
            loops.STEP, x, reg, inner, 2 ** 30)
        plain_ms = time_ms(torch, plain, inp, reps=20, tries=3)
        # the least work of a step: its two inputs, the four fields it
        # reads and the three it writes, once; a division and a handful
        # of comparisons
        nbytes = inp.element_size() * 4 + 4 * 7
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 6 / 67e12) * 1e3
        tag = "f32" if dt == torch.float32 else "f64"
        print(f"  loop_control gcr step ({tag}): {ms * 1e3:.3f} us per "
              f"launch in a graph ({eager_ms * 1e3:.3f} us eager), empty "
              f"one-thread kernel {floor_ms * 1e3:.3f} us, plain twin on "
              f"the card {plain_ms * 1e3:.1f} us; roofline bound "
              f"{bound_ms * 1e3:.6f} us ({nbytes} bytes); {smi}")
        out[tag] = {"ms": ms, "eager_ms": eager_ms, "launch_floor_ms":
                    floor_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}
    loops.launches.update(saved)        # the timing's launches: no path's
    main = out["f64"]
    return {"name": "loop_control gcr", "route": "cuda",
            "source": "faspsolver_tpu_torch/csrc/loop_control.cu",
            "replaces": REPLACES["gcr"], "max_abs_err": 0.0,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "launch_floor_ms": main["launch_floor_ms"],
            "timed": "one step launch, f64 (f32 under \"f32\")",
            "f32": out["f32"], "cases": len(GCR_CASES), "steps": steps}


# phase 8: one GCG descent step on the small grid (poisson_fe_manufactured
# (64), 3,969 dof, f64, Jacobi) at the windows its solves take: GCG's
# full-memory rule gives 1,024 (small grid + diag, the regression core
# set), 200 (small grid + AMG) and 100 (the MatrixMarket set); GCR runs
# 60 and 30; 8 is GCG's least
GCG_STEP_WINDOWS = (8, 30, 60, 100, 200, 1024)


def gcg_step_times(torch, device, smi):
    """The device time of one descent step of the resident GCG / GCR
    tree (``krylov/gcg_gcr.py`` ``_step``: M, A, the masked CGS2 over the
    whole window, the updates, the control) at each window of
    GCG_STEP_WINDOWS, replayed from a CUDA graph of 200 steps (each
    resets j to R - 1 first; the reset's own time is taken off), beside
    one apply of M and A alone.  The masked products read all R rows
    six times per step whatever j is; the step's growth with R is
    theirs.  Returns {R: ms}, with "m_and_a" the apply."""
    import numpy as np
    from faspsolver_tpu_torch.krylov import JacobiPrecond, gcg_gcr
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.testgen import poisson_fe_manufactured
    from faspsolver_tpu_torch.utils import loops
    A, b, *_ = poisson_fe_manufactured(64)
    op = device_operator(A, dtype=torch.float64).to(device)
    M = JacobiPrecond.from_csr(A, torch.float64).to(device)
    bt = torch.as_tensor(b, dtype=torch.float64, device=device)
    saved = dict(loops.launches)
    out = {"m_and_a": time_ms(torch, lambda x: op(M(x)), bt, graph=True)}
    for R in GCG_STEP_WINDOWS:
        st = gcg_gcr._State(bt, R)
        st.block.upload({"gcr": loops.gcr_values(1e-30, 0.0, 10 ** 9, 1)})
        st.b.copy_(bt)
        gcg_gcr._start(st, op, M, 1)
        gcg_gcr._cycle(st)
        rng = np.random.default_rng(R)
        for t in (st.P, st.Q):
            t.copy_(torch.as_tensor(rng.standard_normal(tuple(t.shape)),
                                    device=device) / 64.0)
        j = st.reg.i[loops.I.J:loops.I.J + 1]
        j0 = torch.full_like(j, R - 1)

        def reset(x):
            j.copy_(j0)

        def step(x):
            j.copy_(j0)
            gcg_gcr._step(st, op, M)

        reset_ms = time_ms(torch, reset, bt, graph=True)
        out[R] = time_ms(torch, step, bt, graph=True) - reset_ms
        del st
    loops.launches.update(saved)        # the timing's launches: no path's
    print("  one resident GCG descent step, poisson_fe_manufactured(64) "
          "f64 + Jacobi (graph of 200): "
          + ", ".join(f"R = {R} {out[R] * 1e3:.2f} us"
                      for R in GCG_STEP_WINDOWS)
          + f"; M and A alone {out['m_and_a'] * 1e3:.2f} us; {smi}")
    return {str(k): v for k, v in out.items()}


# the solve loops of the multigrid entry points, each recorded by
# :func:`mg_solves`: (module, function) by kind
MG_LOOPS = {"amg": ("faspsolver_tpu_torch.precond.amg.solve", "_solve"),
            "gmg": ("faspsolver_tpu_torch.precond.gmg", "_gmg_solve"),
            "gmgcg": ("faspsolver_tpu_torch.precond.gmg", "_gmgcg")}


@contextlib.contextmanager
def mg_solves(torch):
    """While the block runs, every multigrid solve loop (AMG as a solver
    and FAMG, GMG's V-cycles, GMG-CG; :data:`MG_LOOPS`, whatever entry
    point called it) is recorded: its kind, whether it ran resident, its
    host reads, program launches, iterations and seconds.  The first
    resident solve of each kind runs twice more, warm and as the eager
    loop (``graphs.eager()``): their launches and graph counters are
    taken back off (checks, not the path), their seconds recorded, the
    warm and eager counts and x held to the resident
    (:func:`check_mg_resident`)."""
    import importlib
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils import graphs, loops
    seen, real = [], {}

    def spy(kind, fn):
        def run(*args, **kw):
            def timed():
                before = graphs.stats["replays"]
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                out.x.cpu()
                return out, time.perf_counter() - t0, \
                    graphs.stats["replays"] - before
            out, s, launches = timed()
            b = args[1] if kind == "amg" else args[0]
            rec = {"kind": kind, "resident": out.resident, "syncs": out.syncs,
                   "launches": launches, "iters": out.iters, "s": s,
                   "n": int(b.numel()),
                   "dtype": str(b.dtype).replace("torch.", "")}
            if out.resident and not any(r["kind"] == kind and "eager_iters"
                                        in r for r in seen):
                saved = [dict(stencil2d.launches), dict(loops.launches),
                         dict(graphs.stats)]
                warm, warm_s, warm_launches = timed()
                with graphs.eager():
                    e, eager_s, _ = timed()
                for counter, was in zip((stencil2d.launches, loops.launches,
                                         graphs.stats), saved):
                    counter.update(was)
                rec.update(warm_s=warm_s, warm_syncs=warm.syncs,
                           warm_launches=warm_launches,
                           warm_bit_equal=torch.equal(warm.x, out.x),
                           warm_x_diff=float((warm.x - out.x).norm()
                                             / max(float(out.x.norm()),
                                                   1e-300)),
                           eager_s=eager_s, eager_iters=e.iters,
                           eager_syncs=e.syncs,
                           bit_equal=torch.equal(out.x, e.x),
                           x_diff=float((out.x - e.x).norm()
                                        / max(float(e.x.norm()), 1e-300)))
            seen.append(rec)
            return out
        return run

    for kind, (mod, name) in MG_LOOPS.items():
        m = importlib.import_module(mod)
        real[kind] = (m, name, getattr(m, name))
        setattr(m, name, spy(kind, real[kind][2]))
    try:
        yield seen
    finally:
        for m, name, fn in real.values():
            setattr(m, name, fn)


def check_mg_resident(torch, device, phase, seen):
    """On the card every resident multigrid solve of the phase is one
    program launch and one host read, at least one ran, and the first of
    each kind agrees with its warm rerun and its eager loop
    (:func:`mg_solves`): the same count, x bit-equal for GMG, and for AMG
    bit-equal or, where the hierarchy's transfers or operators add with
    atomics (RS, SA, UA), within X_DIFF_LIMIT of |x|."""
    res = [r for r in seen if r["resident"]]
    twins = [r for r in res if "eager_iters" in r]
    print(f"  phase {phase}: {len(seen)} multigrid solves "
          f"({', '.join(sorted({r['kind'] for r in seen}))}), {len(res)} "
          f"resident (host reads {sorted({r['syncs'] for r in res})}, "
          f"program launches {sorted({r['launches'] for r in res})}), "
          f"{sum(r['iters'] for r in res)} iterations")
    for r in twins:
        print(f"    first resident {r['kind']} solve, n={r['n']} "
              f"{r['dtype']}: {r['iters']} iterations; cold {r['s']:.4f} "
              f"s, warm {r['warm_s']:.4f} s (reads {r['warm_syncs']}, "
              f"launches {r['warm_launches']}, x bit-equal "
              f"{r['warm_bit_equal']}); eager loop "
              f"{r['eager_s']:.4f} s, {r['eager_iters']} iterations, "
              f"{r['eager_syncs']} reads; x bit-equal {r['bit_equal']} "
              f"(|x - x_eager| / |x| {r['x_diff']:.2e})")
    if torch.device(device).type != "cuda":
        return
    check(res, f"phase {phase}: a resident multigrid solve ran")
    bad = [r for r in res if (r["syncs"], r["launches"]) != (1, 1)]
    check(not bad, f"phase {phase}: every resident multigrid solve is one "
                   f"program launch and one host read: {bad[:3]}")
    for r in twins:
        def close(bits, diff):
            return bits or (r["kind"] == "amg" and diff <= X_DIFF_LIMIT)
        check((r["warm_syncs"], r["warm_launches"]) == (1, 1)
              and close(r["warm_bit_equal"], r["warm_x_diff"])
              and r["eager_syncs"] == r["eager_iters"] + 1
              and r["iters"] == r["eager_iters"]
              and close(r["bit_equal"], r["x_diff"]),
              f"phase {phase}: a resident {r['kind']} solve, its warm "
              f"rerun and its eager loop agree: {r}")


@contextlib.contextmanager
def krylov_solves(torch, kind):
    """While the block runs, every solve of a windowed Krylov loop
    (``kind`` "gmres": ``krylov/gmres.py`` ``_gmres``, the GMRES family;
    "gcr": ``krylov/gcg_gcr.py`` ``_gcr``, GCG and GCR; whatever entry
    point called it) is recorded: whether it ran resident
    (``SolveResult.resident``), whether A and M declare themselves
    capturable on a vector that replays graphs (``graphs.active``), its
    host reads, its program launches and iterations.
    The first resident one also runs once more as the eager loop
    (``graphs.eager()``; its launches are not the path's, its seconds
    are in the phase's), whose count and x it is held to
    (:func:`check_krylov_resident`)."""
    import faspsolver_tpu_torch.krylov  # noqa: F401  (loads the module)
    from faspsolver_tpu_torch.krylov.common import resolve_precond
    from faspsolver_tpu_torch.utils import graphs
    mod = sys.modules[KRYLOV_LOOPS[kind][0]]
    name = KRYLOV_LOOPS[kind][1]
    real = getattr(mod, name)
    seen = []

    def spy(A, b, x0, M, tol, abstol, maxit, restart, *args, **kw):
        before = graphs.stats["replays"]
        out = real(A, b, x0, M, tol, abstol, maxit, restart, *args, **kw)
        resident = out.resident
        rec = {"resident": resident, "syncs": out.syncs,
               "capturable": graphs.active(b) and graphs.capturable(A)
               and graphs.capturable(resolve_precond(M)),
               "launches": graphs.stats["replays"] - before,
               "iters": out.iters, "n": int(b.shape[0]),
               "dtype": str(b.dtype).replace("torch.", "")}
        if resident and not any("eager_iters" in r for r in seen):
            # a check, not the path: its launches are taken back off
            from faspsolver_tpu_torch.ops import stencil2d
            from faspsolver_tpu_torch.utils import loops
            saved = [dict(stencil2d.launches), dict(loops.launches)]
            with graphs.eager():
                e = real(A, b, x0, M, tol, abstol, maxit, restart, *args,
                         **kw)
            stencil2d.launches.update(saved[0])
            loops.launches.update(saved[1])
            rec.update(eager_iters=e.iters, eager_syncs=e.syncs,
                       bit_equal=torch.equal(out.x, e.x),
                       x_diff=float((out.x - e.x).norm()
                                    / max(float(e.x.norm()), 1e-300)),
                       tol=float(tol))
        seen.append(rec)
        return out

    setattr(mod, name, spy)
    try:
        yield seen
    finally:
        setattr(mod, name, real)


def graph_growth(before):
    """The graph counters' growth since ``before`` (a copy of
    ``graphs.stats``): the graph nodes the launches ran, the captures,
    their nodes and seconds, and the graph MB they reserved."""
    from faspsolver_tpu_torch.utils import graphs
    d = {k: graphs.stats[k] - v for k, v in before.items()}
    return {"nodes": d["nodes_replayed"], "captures": d["captures"],
            "graph_nodes": d["nodes_captured"], "capture_s": d["capture_s"],
            "graph_mb": round(d["graph_bytes"] / 2**20, 1)}


@contextlib.contextmanager
def loop_solves(torch):
    """While the block runs, every loop program (``utils.graphs.run_loop``:
    the Krylov loops, the refiner, the multigrid loops, whatever entry
    point called it) is recorded: its loop (the module of its state),
    whether it ran resident, its host reads, program launches,
    iterations, seconds (to its last host read) and graph counters
    (:func:`graph_growth`).  The first resident one runs twice more from
    the state it started from, resident (warm) and as the eager loop
    (``graphs.eager()``), each timed and counted; their
    launches and graph counters are taken back off (checks, not the
    path), and the state is put back as the first run left it, so its
    caller reads that run's result.  A loop run under ``graphs.eager()``
    (another check's rerun) is not recorded.  :func:`check_loop_resident`
    holds the runs together."""
    from faspsolver_tpu_torch.krylov.common import HostReads
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils import graphs, loops
    real = graphs.run_loop
    seen = []

    def spy(st, tree, host, resident):
        if not graphs._enabled:         # another check's eager rerun
            return real(st, tree, host, resident)
        first = resident and not any("eager_iters" in r for r in seen)
        start = [t.clone() for t in st.tensors()] if first else None
        reads, replays = host.count, graphs.stats["replays"]
        before = dict(graphs.stats)
        t0 = time.perf_counter()
        vals = real(st, tree, host, resident)
        secs = time.perf_counter() - t0
        region = next(iter(st.block.regions))

        def iters(v):
            return int(v[region].i[loops.I.IT]) if v else 0

        rec = {"kind": type(st).__module__.rsplit(".", 1)[-1],
               "resident": resident, "syncs": host.count - reads,
               "launches": graphs.stats["replays"] - replays,
               "iters": iters(vals), "s": secs, "n": int(st.x.numel()),
               "dtype": str(st.x.dtype).replace("torch.", ""),
               **graph_growth(before)}
        if first:
            x = st.x.clone()
            end = [t.clone() for t in st.tensors()]
            saved = [dict(stencil2d.launches), dict(loops.launches),
                     dict(graphs.stats)]

            def again(res):
                for t, v in zip(st.tensors(), start):
                    t.copy_(v)
                h = HostReads(st.x.dtype)
                r0, g0 = graphs.stats["replays"], dict(graphs.stats)
                t1 = time.perf_counter()
                v = real(st, tree, h, res)
                return (v, time.perf_counter() - t1, h.count,
                        graphs.stats["replays"] - r0, st.x.clone(),
                        graph_growth(g0))

            warm, warm_s, warm_syncs, warm_launches, wx, wg = again(True)
            with graphs.eager():
                eager, eager_s, eager_syncs, _, ex, eg = again(False)
            for t, v in zip(st.tensors(), end):
                t.copy_(v)
            for counter, was in zip((stencil2d.launches, loops.launches,
                                     graphs.stats), saved):
                counter.update(was)

            def diff(a):
                return float((a - x).norm() / max(float(x.norm()), 1e-300))

            rec.update(warm_s=warm_s, warm_syncs=warm_syncs,
                       warm_launches=warm_launches, warm_iters=iters(warm),
                       warm_bit_equal=torch.equal(wx, x),
                       warm_x_diff=diff(wx), eager_s=eager_s,
                       eager_syncs=eager_syncs, eager_iters=iters(eager),
                       bit_equal=torch.equal(ex, x), x_diff=diff(ex),
                       **{f"warm_{k}": v for k, v in wg.items()},
                       **{f"eager_{k}": v for k, v in eg.items()})
        seen.append(rec)
        return vals

    graphs.run_loop = spy
    try:
        yield seen
    finally:
        graphs.run_loop = real


def _graph_counts(r, tag=""):
    return (f"{r[tag + 'nodes']} nodes run, captures {r[tag + 'captures']} "
            f"({r[tag + 'graph_nodes']} nodes, {r[tag + 'capture_s']:.3f} s, "
            f"{r[tag + 'graph_mb']} MB)")


def check_loop_resident(torch, device, label, seen, atomic=None):
    """A row's loop programs (:func:`loop_solves`): on the card at least
    one ran, each resident with one program launch and one host read,
    and the first agrees with its warm rerun and its eager loop: the
    same count, x bit-equal or, where ``atomic`` names
    the sum that adds with atomics, within X_DIFF_LIMIT of |x| (the
    dtype's limit, X_DIFF_LIMITS).  Prints them, with their seconds,
    host reads, program launches and graph counters; returns the faults
    (empty: none)."""
    res = [r for r in seen if r["resident"]]
    twin = [r for r in res if "eager_iters" in r]
    print(f"    {label}: {len(seen)} loop solves "
          f"({', '.join(sorted({r['kind'] for r in seen}))}), {len(res)} "
          f"resident (host reads {sorted({r['syncs'] for r in res})}, "
          f"program launches {sorted({r['launches'] for r in res})})")
    for r in twin:
        print(f"      first resident {r['kind']} solve, n={r['n']} "
              f"{r['dtype']}: {r['iters']} iterations; cold {r['s']:.4f} s "
              f"(reads {r['syncs']}, launches {r['launches']}, "
              f"{_graph_counts(r)}); warm {r['warm_s']:.4f} s "
              f"({r['warm_iters']} iterations, reads {r['warm_syncs']}, "
              f"launches {r['warm_launches']}, {_graph_counts(r, 'warm_')}, "
              f"x bit-equal {r['warm_bit_equal']}, "
              f"{r['warm_x_diff']:.2e}); eager loop {r['eager_s']:.4f} s, "
              f"{r['eager_iters']} iterations, {r['eager_syncs']} reads, "
              f"{_graph_counts(r, 'eager_')}; x bit-equal {r['bit_equal']} "
              f"(|x - x_eager| / |x| {r['x_diff']:.2e}); warm / eager "
              f"{r['eager_s'] / max(r['warm_s'], 1e-12):.2f} x faster")
        if not (r["bit_equal"] and r["warm_bit_equal"]):
            print(f"      not bit-equal: "
                  f"{atomic or 'no sum of this row adds with atomics'}")
    if torch.device(device).type != "cuda":
        return []
    bad = []
    if not res or len(res) != len(seen):
        bad.append(f"{label}: {len(seen) - len(res)} of {len(seen)} loop "
                   f"solves ran eagerly")
    bad += [f"{label}: {r}" for r in res
            if (r["syncs"], r["launches"]) != (1, 1)]
    for r in twin:
        limit = X_DIFF_LIMITS[r["dtype"]] if atomic else 0.0

        def close(bits, diff):
            return bits or diff <= limit
        if not ((r["warm_syncs"], r["warm_launches"]) == (1, 1)
                and r["iters"] == r["warm_iters"] == r["eager_iters"]
                and r["eager_syncs"] > r["eager_iters"]
                and close(r["warm_bit_equal"], r["warm_x_diff"])
                and close(r["bit_equal"], r["x_diff"])):
            bad.append(f"{label}: resident, warm and eager disagree: {r}")
    return bad


# the windowed Krylov loops :func:`krylov_solves` records: (module,
# function) by kind
KRYLOV_LOOPS = {"gmres": ("faspsolver_tpu_torch.krylov.gmres", "_gmres"),
                "gcr": ("faspsolver_tpu_torch.krylov.gcg_gcr", "_gcr")}


def gmres_solves(torch):
    """:func:`krylov_solves` of the GMRES family."""
    return krylov_solves(torch, "gmres")


def gcr_solves(torch):
    """:func:`krylov_solves` of GCG and GCR."""
    return krylov_solves(torch, "gcr")


# a resident GMRES solve against its eager loop where the sums are not
# deterministic: |x - x_eager| / |x| on the H100 was 6.3e-16 to 1.35e-14
# (PERF.md section 6); the limit leaves a margin of some 7,000
X_DIFF_LIMIT = 1e-10
# phase 9a's rows by dtype: f64 X_DIFF_LIMIT (UA-BSR read 4.1e-16 to
# 4.8e-16 on the H100); f32, the refined stanza's inner vFGMRES over
# UA-BSR, 1.62e-7 on the H100 (PERF.md section 6, PR 18): a last-bit f32
# change carried through a GMRES window; the limit leaves a margin of 60
X_DIFF_LIMITS = {"float64": X_DIFF_LIMIT, "float32": 1e-5}


def check_krylov_resident(torch, device, phase, seen, what,
                          need=True):
    """On the card every resident solve of the phase (``seen``, from
    :func:`krylov_solves`) is one program launch and one host read,
    every solve over a capturable A and M ran resident, at least one ran
    (unless not ``need``), and the one run again eagerly agrees with its
    eager loop: the same count, x bit-equal or, where the
    preconditioner adds with atomics, within X_DIFF_LIMIT of |x|."""
    res = [r for r in seen if r["resident"]]
    twin = [r for r in res if "eager_iters" in r]
    print(f"  phase {phase}: {len(seen)} {what} solves, {len(res)} "
          f"resident (host reads {sorted({r['syncs'] for r in res})}, "
          f"program launches {sorted({r['launches'] for r in res})}), "
          f"{sum(r['iters'] for r in res)} iterations; "
          f"{sum(not r['capturable'] for r in seen)} eager (a module "
          f"that is not capturable, or graphs off); eager check "
          f"{twin[0] if twin else None}")
    if torch.device(device).type != "cuda":
        return
    check(res or not need, f"phase {phase}: a resident {what} solve ran")
    bad = [r for r in res if (r["syncs"], r["launches"]) != (1, 1)]
    check(not bad, f"phase {phase}: every resident {what} solve is "
                   f"one program launch and one host read: {bad[:3]}")
    bad = [r for r in seen if r["capturable"] and not r["resident"]]
    check(not bad, f"phase {phase}: every {what} solve over capturable "
                   f"modules ran resident: {bad[:3]}")
    if twin:
        r = twin[0]
        check(r["eager_syncs"] > r["eager_iters"]
              and r["iters"] == r["eager_iters"]
              and (r["bit_equal"] or r["x_diff"] <= X_DIFF_LIMIT),
              f"phase {phase}: a resident {what} solve and its eager loop "
              f"agree: {r}")


def check_spe01_resident(torch, device, seen):
    """Phase 14: spe01_its's vFGMRES + UA-BSR solve on the 786,432-dof
    BSR file ran resident (one launch, one read)."""
    spe = [r for r in seen if r["n"] == 3 * BSR_NX ** 3]
    print(f"  phase 14: spe01_its's GMRES-family solves {spe}")
    if torch.device(device).type == "cuda":
        check(spe and all(r["resident"] and r["syncs"] == 1 for r in spe),
              f"spe01_its ran resident: {spe}")


def check_gmres_resident(torch, device, phase, seen):
    check_krylov_resident(torch, device, phase, seen, "GMRES-family")


def check_gcr_resident(torch, device, phase, seen, need=True):
    check_krylov_resident(torch, device, phase, seen, "GCG / GCR", need)


# ---------------------------------------------------------------------------
# phases 4, 6, 7: the main paths
# ---------------------------------------------------------------------------

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


def graph_stats():
    """The graph layer's counters (utils/graphs.py), graph MB rounded."""
    from faspsolver_tpu_torch.utils import graphs
    st = dict(graphs.stats)
    st["graph_mb"] = round(st.pop("graph_bytes") / 2**20, 1)
    st["capture_s"] = round(st["capture_s"], 4)
    return st


def timed_solve(torch, device, fn):
    """``fn()`` -> (result, x on the host) timed from the call to x on the
    host, with the kernel launch counts and the graph counters set to 0
    just before it and read just after, and the memory the allocator
    reserved before and after."""
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils import graphs
    sync(torch, device)
    cuda = torch.device(device).type == "cuda"
    mem0 = torch.cuda.memory_reserved(device) if cuda else 0
    reset_counts()
    graphs.reset_stats()
    t0 = time.perf_counter()
    out = fn()
    x = out.x.cpu().numpy() if hasattr(out.x, "cpu") else out.x
    s = time.perf_counter() - t0
    mem1 = torch.cuda.memory_reserved(device) if cuda else 0
    return out, x, {"s": s, "launches": launch_counts(), **graph_stats(),
                    "reserved_mb": [round(mem0 / 2**20, 1),
                                    round(mem1 / 2**20, 1)]}


def graph_line(tag, r):
    return (f"  {tag} solve {r['s']:.4f} s: graph replays {r['replays']} "
            f"({r['nodes_replayed']} nodes), captures {r['captures']} "
            f"({r['nodes_captured']} nodes, {r['capture_s']:.3f} s, "
            f"{r['graph_mb']} MB), reserved {r['reserved_mb'][0]} -> "
            f"{r['reserved_mb'][1]} MB, stencil launches {r['launches']}")


def check_graphed(torch, device, what, *runs):
    """On the card every PCG + AMG solve replays graphs."""
    if torch.device(device).type == "cuda":
        for r in runs:
            check(r["replays"] > 0, f"{what} replayed CUDA graphs: {r}")


def check_resident(torch, device, what, out, *runs):
    """On the card a resident solve is one program launch (cold: its
    capture, then the launch) and one host read."""
    if torch.device(device).type == "cuda":
        for r in runs:
            check(r["replays"] == 1, f"{what}: one program launch: {r}")
        check(out.syncs == 1, f"{what}: one host read, not {out.syncs}")


def drive(torch, device, A, b, hier, refine, anchor, profile=False,
          eager_check=False):
    """The cold solve (CUDA-graph capture included), then the timed warm
    solve, verified on the host in f64; with ``eager_check`` the same
    solve once more as the eager loop, held bit-equal to the graphed."""
    import numpy as np
    from faspsolver_tpu_torch.utils import graphs

    def run():
        return solve(torch, hier, torch.as_tensor(b, device=device), refine)

    out, x_cold, cold = timed_solve(torch, device, run)
    print(graph_line("cold", cold) + f"; rounds {out.rounds}, inner "
          f"iterations {out.iters}, host syncs {out.syncs}")
    out, x, warm = timed_solve(torch, device, run)
    counts = warm["launches"]
    solve_s = warm["s"]

    check(x.shape == (A.nrow,) and bool(np.isfinite(x).all()),
          "finite x of the expected shape")
    relres = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
    print(graph_line("warm", warm))
    print(f"  warm solve (b in, x on host) {solve_s:.4f} s; rounds "
          f"{out.rounds} (JAX anchor {anchor.get('rounds', '-')}), inner "
          f"iterations {out.iters} (anchor {anchor['inner_iters']}), "
          f"verified f64 relres {relres:.3e} (anchor "
          f"{anchor['relres']:.2e}), device relres {out.relres:.3e}, host "
          f"syncs {out.syncs}")
    if torch.device(device).type == "cuda":
        check(counts["float32"] > 0 and counts["float64"] > 0,
              f"the solve launched the kernel in f32 and f64: {counts}")
        check(counts["loop_control"] > 0,
              f"the solve launched the loop-control kernel: {counts}")
    check_resident(torch, device, "the solve", out, cold, warm)
    check(relres < TOL, f"verified relres {relres} < {TOL}")
    res = {"solve_s": solve_s, "cold_solve_s": cold["s"],
           "rounds": out.rounds, "inner_iters": out.iters, "relres": relres,
           "syncs": out.syncs, "cold": cold, "warm": warm}
    if eager_check:
        with graphs.eager():
            e_out, x_e, eager = timed_solve(torch, device, run)
        same = x_e.tobytes() == x.tobytes()
        # the eager loop reads once per round, per inner solve's start,
        # per inner iteration and per recompute, as it did before the
        # loops became resident
        reads = 2 * e_out.rounds + e_out.iters + e_out.recomputes
        print(f"  eager loop solve {eager['s']:.4f} s, rounds "
              f"{e_out.rounds}, inner iterations {e_out.iters}, recomputes "
              f"{e_out.recomputes}, host syncs {e_out.syncs} (want "
              f"{reads}), launches {eager['launches']}; x bit-equal to the "
              f"resident solve's: {same}")
        check(same and (e_out.rounds, e_out.iters, e_out.recomputes)
              == (out.rounds, out.iters, out.recomputes)
              and e_out.syncs == reads and out.syncs == 1
              and eager["launches"] == counts and eager["replays"] == 0,
              "resident and eager solves: bit-equal x, equal counts and "
              "launches; the eager loop's reads, the resident one read")
        res["eager_solve_s"] = eager["s"]
    if profile:
        profile_solve(torch, hier, torch.as_tensor(b, device=device), refine)
    return counts, res


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
                        HEADLINE_REFINE, ANCHOR, profile, eager_check=True)
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
    no CPU-op row counts its kernels twice) over the wall time, for the
    resident solve and for the eager loop.  CUPTI does not record every
    kernel a conditional node's body runs, so the profile also counts the
    stencil kernels it recorded against the wrapper's count: where they
    differ, the resident solve's kernel time is the eager loop's (the
    same kernels) over the resident wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from faspsolver_tpu_torch.utils import graphs
    out = {}
    for label in ("resident", "eager"):
        with contextlib.ExitStack() as stack:
            if label == "eager":
                stack.enter_context(graphs.eager())
            reset_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                solve(torch, hier, b64, refine)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        counted = sum(v for k, v in launch_counts().items()
                      if k not in ("loop_control", "gmres", "mg"))
        rows = prof.key_averages()
        dev = sum(r.self_device_time_total for r in rows
                  if getattr(r, "device_type", None) == DeviceType.CUDA)
        seen = sum(r.count for r in rows
                   if getattr(r, "device_type", None) == DeviceType.CUDA
                   and "stencil2d" in r.key)
        out[label] = {"wall_s": wall, "kernel_s": dev / 1e6,
                      "stencil_seen": seen, "stencil_counted": counted}
        print(f"  profile ({label}): wall {wall * 1e3:.1f} ms (profiled), "
              f"device kernel time {dev / 1e3:.1f} ms, busy share "
              f"{(dev / 1e6) / wall:.3f}; stencil kernels recorded {seen} "
              f"of {counted} launched" if dev else
              f"  profile ({label}): no device time recorded (not "
              f"measured)")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=12))
    r, e = out["resident"], out["eager"]
    if r["stencil_seen"] < r["stencil_counted"]:
        print(f"  resident solve's busy share from the eager loop's kernel "
              f"time: {e['kernel_s'] * 1e3:.1f} ms / {r['wall_s'] * 1e3:.1f}"
              f" ms = {e['kernel_s'] / r['wall_s']:.3f} (CUPTI recorded "
              f"{r['stencil_seen']} of its {r['stencil_counted']} stencil "
              f"kernels)")
    return out


# ---------------------------------------------------------------------------
# phase 8: the user entry point
# ---------------------------------------------------------------------------

def cli(torch, device, argv):
    """The port's CLI entry on ``device`` (None: the CLI's own default)
    in float64: its exit code, the iteration count and verified relres it
    printed, and its wall time."""
    import io
    from faspsolver_tpu_torch.__main__ import main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, device=device, dtype=torch.float64)
    wall = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("Number of iterations")]
    check(len(lines) == 1, f"the CLI printed one iteration line: {lines}")
    words = lines[0].rstrip(".").split()
    return rc, int(words[4]), float(words[-1]), wall


@contextlib.contextmanager
def spied_calls(targets):
    """While the block runs, every ``name: (owner, attribute)`` callable
    is timed and its last result kept: ``{name: {"s": seconds, "out":
    result}}`` (calls nested in one another count once each)."""
    seen = {n: {"s": 0.0, "out": None} for n in targets}
    saved = {n: getattr(owner, attr) for n, (owner, attr) in targets.items()}
    for name, (owner, attr) in targets.items():
        def wrap(*args, _fn=saved[name], _rec=seen[name], **kw):
            t0 = time.perf_counter()
            try:
                _rec["out"] = _fn(*args, **kw)
                return _rec["out"]
            finally:
                _rec["s"] += time.perf_counter() - t0
        setattr(owner, attr, wrap)
    try:
        yield seen
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, saved[name])


SETUP_NAMES = ("setup_ua_bsr", "setup_sa_bsr", "setup_rs", "setup_sa",
               "setup_ua", "setup_bsr_ilu0", "setup_ilu", "setup_schwarz",
               "setup_str_diag", "setup_str_ilu", "setup_str_blockgs",
               "setup_str_schwarz", "setup_blc_precond", "setup_blc_sweeping")


def setup_spies():
    """The drivers' setup calls, for :func:`spied_calls`."""
    from faspsolver_tpu_torch.solvers import drivers
    return {name: (drivers, name) for name in SETUP_NAMES}


def ini_setup_and_solve(torch, device, ini, A, b):
    """The CLI's krylov_amg in its steps, each timed: the AMG setup
    (host, then .to(device)), with the seconds it spent coloring (the
    Gauss-Seidel blocks) and aggregating, the device operator's build,
    and the preconditioned Krylov solve (b in, x on the host) twice over
    the same operator and hierarchy: cold (CUDA-graph capture included)
    and warm, each with its kernel launches and graph counters."""
    import numpy as np
    from faspsolver_tpu_torch.formats import CSRMatrix
    from faspsolver_tpu_torch.constants import AMGType
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import setup_rs, setup_sa, setup_ua
    from faspsolver_tpu_torch.solvers import itsolver
    from faspsolver_tpu_torch.utils.params import (apply_cli_overrides,
                                                   param_init)
    its, amg, _, _ = param_init(apply_cli_overrides(["-ini", ini]))
    setup = {int(AMGType.SA): setup_sa,
             int(AMGType.UA): setup_ua}.get(int(amg.AMG_type), setup_rs)
    mods = [sys.modules[f"faspsolver_tpu_torch.precond.amg.setup_{k}"]
            for k in ("sa", "ua")]
    sync(torch, device)
    with spied_calls({"color_s": (CSRMatrix, "multicolor"),
                      "aggregate_sa_s": (mods[0], "aggregate"),
                      "aggregate_ua_s": (mods[1], "aggregate")}) as spent:
        t0 = time.perf_counter()
        hier = setup(A, amg, dtype=torch.float64, device=device)
        sync(torch, device)
        setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = device_operator(A, dtype=torch.float64).to(device)
    sync(torch, device)
    op_s = time.perf_counter() - t0

    def run():
        # a new preconditioner wrapper per solve, as the CLI makes one
        return itsolver(op, b, M=AMGPrecond(hier, amg.maxit), its=its,
                        dtype=torch.float64, device=device)

    res, x, cold = timed_solve(torch, device, run)
    cold.update(iters=res.iters, syncs=res.syncs)
    res, x, warm = timed_solve(torch, device, run)
    relres = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
    levels = ", ".join(f"{type(l.A).__name__}({l.A.shape[0]})"
                       for l in hier.levels)
    return {"setup_s": setup_s, "color_s": spent["color_s"]["s"],
            "aggregate_s": (spent["aggregate_sa_s"]["s"]
                            + spent["aggregate_ua_s"]["s"]),
            "operator_s": op_s, "solve_s": warm["s"],
            "cold_solve_s": cold["s"], "iters": res.iters, "relres": relres,
            "syncs": res.syncs, "launches": warm["launches"],
            "levels": levels, "cold": cold, "warm": warm}


def drivers_path(torch, device):
    """Phase 8: the repository's ini files through the port's CLI at
    1023^2 (1,046,529 dof) in float64, then one solve per new module on
    the small grid.  Returns the kernel launches of the CLI runs and the
    small grid's solves (not their eager reruns) and the readings."""
    import numpy as np
    from faspsolver_tpu_torch import solvers
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.testgen import (poisson_2d_manufactured,
                                              poisson_fe_manufactured)
    from faspsolver_tpu_torch.utils import graphs, messages
    from faspsolver_tpu_torch.utils.params import AMGParam, ITSParam

    warned = []
    warn = messages.warn
    messages.warn = lambda m: (warned.append(m), warn(m))
    counts = {"float32": 0, "float64": 0, "loop_control": 0,
              "gmres": 0, "mg": 0, "gcr": 0}
    readings = {}
    try:
        A, b, _ = poisson_2d_manufactured(NX)
        for name, (anchor, bound) in INI_ANCHORS.items():
            ini = f"ini/{name}.dat"
            reset_counts()
            rc, iters, relres, wall = cli(torch, device, [
                "-ini", ini, "-problem", "poisson2d", "-size", str(NX)])
            cli_counts = launch_counts()
            for k in counts:
                counts[k] += cli_counts.get(k, 0)
            r = ini_setup_and_solve(torch, device, ini, A, b)
            print(f"  {ini}: CLI rc {rc}, {iters} iterations (JAX anchor "
                  f"{anchor} +- {bound}), verified relres {relres:.6e}, "
                  f"{wall:.3f} s setup + solve, stencil launches "
                  f"{cli_counts}; timed again: setup {r['setup_s']:.3f} s "
                  f"(coloring {r['color_s']:.3f} s, aggregation "
                  f"{r['aggregate_s']:.3f} s), operator {r['operator_s']:.3f}"
                  f" s, {r['iters']} iterations, relres {r['relres']:.3e}, "
                  f"host syncs {r['syncs']}; levels {r['levels']}")
            print(graph_line("  cold", r["cold"]) + f", {r['cold']['iters']}"
                  f" iterations, host syncs {r['cold']['syncs']}")
            print(graph_line("  warm", r["warm"]))
            if torch.device(device).type == "cuda":
                # CG over RS / SA / UA and bamg.dat's vGMRES over UA: the
                # resident loop, one launch and one read
                check(r["cold"]["replays"] == 1 and r["warm"]["replays"] == 1
                      and r["syncs"] == 1 and r["cold"]["syncs"] == 1,
                      f"{ini}: one program launch and one host read per "
                      f"solve: {r['cold']}, {r['warm']}")
            check_graphed(torch, device, ini, r["cold"], r["warm"])
            for it, rel in ((iters, relres), (r["iters"], r["relres"])):
                check(rc == 0 and rel < TOL and abs(it - anchor) <= bound,
                      f"{ini}: converged within {bound} of {anchor}: "
                      f"rc {rc}, {it} iterations, relres {rel}")
            if name == "input" and torch.device(device).type == "cuda":
                check(cli_counts["float64"] > 0
                      and r["launches"]["float64"] > 0,
                      "input.dat's solve launched the f64 kernel")
            readings[name] = {"cli_s": wall, "cli_iters": iters,
                              "cli_relres": relres, **r}

        # the CLI as a user types it, with no device argument: it must
        # run on the card (only a CUDA launch raises the counts)
        reset_counts()
        rc, iters, relres, wall = cli(torch, None, [
            "-ini", "ini/input.dat", "-problem", "poisson2d", "-size",
            str(NX)])
        default_counts = launch_counts()
        n64 = default_counts["float64"]
        for k in counts:
            counts[k] += default_counts.get(k, 0)
        print(f"  ini/input.dat, no device argument: CLI rc {rc}, {iters} "
              f"iterations, verified relres {relres:.6e}, {wall:.3f} s, "
              f"f64 stencil launches {n64}")
        check(rc == 0 and relres < TOL and n64 > 0
              and iters == readings["input"]["cli_iters"],
              f"the CLI without a device argument ran on the card: rc {rc}, "
              f"{iters} iterations, {n64} f64 launches")
        readings["input_default_device"] = {
            "cli_s": wall, "cli_iters": iters, "cli_relres": relres,
            "launches": {"float64": n64}}

        A, b, *_ = poisson_fe_manufactured(64)
        grid = {}
        for name, driver, its, amg, anchor, bound in SMALL_GRID:
            kw = {}
            if its is not None:
                kw["its"] = ITSParam(**its)
            if amg is not None:
                kw["amg"] = AMGParam(**amg)
            t0 = time.perf_counter()
            graphs.reset_stats()
            reset_counts()
            res = getattr(solvers, driver)(A, b, dtype=torch.float64,
                                           device=device, **kw)
            res = res[0] if isinstance(res, tuple) else res
            x = res.x.cpu().numpy()
            grid_counts = launch_counts()
            for k in counts:
                counts[k] += grid_counts.get(k, 0)
            wall = time.perf_counter() - t0
            relres = float(np.linalg.norm(b - A.matvec(x))
                           / np.linalg.norm(b))
            print(f"  {name:24s} {res.iters:4d} iterations (JAX {anchor} "
                  f"+- {bound}), relres {relres:.3e}, host syncs "
                  f"{res.syncs}, {wall:.3f} s")
            check(res.x.device.type == torch.device(device).type
                  and res.converged and relres < 1e-9
                  and abs(res.iters - anchor) <= bound,
                  f"small grid {name}: {res.iters} iterations, relres "
                  f"{relres}")
            grid[name] = {"iters": res.iters, "relres": relres,
                          "syncs": res.syncs, "s": wall,
                          "replays": graphs.stats["replays"]}
            if name in RESIDENT_SMALL_GRID and \
                    torch.device(device).type == "cuda":
                # resident: one read, and its own eager loop's result: bit
                # for bit over the diagonal preconditioner; over RS-AMG,
                # whose transfers add with atomics (index_add_), to 1e-6
                # (each x is within cond(A) 1e-10 of the solution, and
                # cond(A) < 1e4 here) with the row's count allowance
                with graphs.eager():
                    e = getattr(solvers, driver)(A, b, dtype=torch.float64,
                                                 device=device, **kw)
                e = e[0] if isinstance(e, tuple) else e
                diff = float((res.x - e.x).norm() / e.x.norm())
                exact = name.endswith("diag")
                print(f"  {'':24s} eager loop: {e.iters} iterations, host "
                      f"syncs {e.syncs}; x bit-equal: "
                      f"{torch.equal(res.x, e.x)}, relative difference "
                      f"{diff:.2e}")
                check(res.syncs == 1 and grid[name]["replays"] == 1
                      and e.syncs > e.iters
                      and (torch.equal(res.x, e.x) and res.iters == e.iters
                           if exact else diff <= 1e-6
                           and abs(res.iters - e.iters) <= bound),
                      f"small grid {name}: resident (1 read, not "
                      f"{res.syncs}; 1 launch, not {grid[name]['replays']})"
                      f" and its eager loop's result")
                grid[name]["eager_syncs"] = e.syncs
        readings["small_grid"] = grid
    finally:
        messages.warn = warn
    check(not any("falling back" in w for w in warned),
          f"solve_amg's GMRES fallback did not fire: {warned}")
    return counts, readings



# ---------------------------------------------------------------------------
# phase 9: block and factorization preconditioners
# ---------------------------------------------------------------------------

def driver_fields(fields):
    """its / amg / ilu / swz dicts as the port's parameter objects."""
    from faspsolver_tpu_torch.utils import params
    kw = {}
    for key, cls in (("its", params.ITSParam), ("amg", params.AMGParam),
                     ("ilu", params.ILUParam), ("swz", params.SWZParam)):
        if fields.get(key) is not None:
            kw[key] = cls(**fields[key])
    return kw


def device_arg(torch, device):
    """What phase 9 passes as ``device``: nothing on the card (the entry
    points must choose it themselves); "cpu" only in a CPU rehearsal."""
    return None if torch.device(device).type == "cuda" else "cpu"


def drive_driver(torch, device, driver, fields, A, b, split=None):
    """One solve through a port driver with no device argument (it must
    choose the card), float64: the reading, and the preconditioner or
    hierarchy its setup built (now on the card).  ``split`` ({name:
    (owner, attribute)}) times parts of the setup as well, under
    "split" in the reading."""
    import numpy as np
    from faspsolver_tpu_torch import solvers
    from faspsolver_tpu_torch.ops import stencil2d
    args = [A, b]
    if fields.get("nk"):
        args.append(component_basis(A.nrow, A.nb))
    sync(torch, device)
    reset_counts()
    with spied_calls(setup_spies()) as spy, \
            spied_calls(split or {}) as parts:
        t0 = time.perf_counter()
        res = getattr(solvers, driver)(*args, dtype=torch.float64,
                                       device=device_arg(torch, device),
                                       **driver_fields(fields),
                                       **fields.get("kw", {}))
        res = res[0] if isinstance(res, tuple) else res
        x = res.x.cpu().numpy()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    check(res.x.device.type == torch.device(device).type,
          f"{driver} ran on {device}")
    built = [v["out"] for v in spy.values() if v["out"] is not None]
    setup_s = sum(v["s"] for v in spy.values())
    relres = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
    return {"setup_s": setup_s, "solve_s": wall - setup_s,
            "iters": int(res.iters), "converged": bool(res.converged),
            "relres": relres, "syncs": int(res.syncs), "launches": counts,
            "split": {k: v["s"] for k, v in parts.items()}}, (
                built[-1] if built else None)


def drive_refined(torch, device, A, b, amg_fields):
    """bench.py's reservoir stanza: the f32 BSR hierarchy on the card,
    vFGMRES(30) inside solve_refined (f64 residuals on the host)."""
    import numpy as np
    from faspsolver_tpu_torch import default_device
    from faspsolver_tpu_torch.krylov import vfgmres
    from faspsolver_tpu_torch.ops import device_operator, stencil2d
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import setup_sa_bsr, setup_ua_bsr
    from faspsolver_tpu_torch.solvers import solve_refined
    from faspsolver_tpu_torch.utils.params import AMGParam
    param = AMGParam(**amg_fields)
    setup = setup_sa_bsr if int(param.AMG_type) == 2 else setup_ua_bsr
    sync(torch, device)
    reset_counts()
    t0 = time.perf_counter()
    if device_arg(torch, device) is None:
        device = default_device()
    hier = setup(A, param, dtype=torch.float32, device=device)
    op = device_operator(A, dtype=torch.float32).to(device)
    sync(torch, device)
    setup_s = time.perf_counter() - t0
    M = AMGPrecond(hier)

    def inner(r, tol):
        return vfgmres(op, r, M=M, tol=tol, **REFINED_INNER)

    t0 = time.perf_counter()
    res = solve_refined(A, b, inner, dtype=torch.float32,
                        device=device_arg(torch, device), **REFINED)
    solve_s = time.perf_counter() - t0
    relres = float(np.linalg.norm(b - A.matvec(res.x)) / np.linalg.norm(b))
    return {"setup_s": setup_s, "solve_s": solve_s,
            "iters": int(res.inner_iters), "rounds": int(res.rounds),
            "converged": bool(res.converged), "relres": relres,
            "syncs": int(res.syncs), "launches": launch_counts()}, hier


def report(name, r, tol, anchor, bound):
    """Print one phase-9 or phase-10 reading and hold it to its tolerance
    and to its JAX count."""
    extra = f", rounds {r['rounds']}" if "rounds" in r else ""
    if r.get("split"):
        extra += " (setup: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in r["split"].items()) + ")"
    print(f"  {name:46s} {r['iters']:4d} iterations (JAX {anchor} +- "
          f"{bound}){extra}, "
          f"verified relres {r['relres']:.3e}, setup {r['setup_s']:.3f} s, "
          f"solve {r['solve_s']:.3f} s, host reads "
          f"{'not counted' if r['syncs'] is None else r['syncs']}, stencil "
          f"launches {r['launches']}")
    check(r["converged"] and r["relres"] < tol,
          f"{name}: converged with verified relres {r['relres']} < {tol}")
    check(abs(r["iters"] - anchor) <= bound,
          f"{name}: {r['iters']} iterations within {bound} of {anchor}")


def on_card_vs_cpu(torch, label, module, x, scale=None, call=None):
    """One apply of ``module`` (on the card) against a float64 copy of it
    on the CPU, same input: max abs error over ``scale`` (default: the
    largest entry of the CPU result).  Not counted as a main-path
    launch: the caller has read its counts."""
    import copy
    call = call or (lambda m, v: m(v))
    twin = copy.deepcopy(module).cpu()
    y_card = call(module, x)
    sync(torch, x.device)
    y_cpu = call(twin, x.cpu())
    scale = float(y_cpu.abs().max()) if scale is None else scale
    err = float((y_card.cpu() - y_cpu).abs().max()) / scale
    ok = bool(torch.isfinite(y_card).all()) and err <= 1e-13
    print(f"  {label}: card against CPU (f64), max abs error / scale "
          f"{err:.2e} (bound 1e-13) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label} agrees with its CPU version: {err}")
    return err


def apply_seconds(torch, fn, x, reps=5):
    """Mean host-clock seconds of ``fn(x)`` ended by a synchronize."""
    fn(x)
    sync(torch, x.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    sync(torch, x.device)
    return (time.perf_counter() - t0) / reps


def ilu_apply_times(torch, label, M, x, smi):
    """One preconditioner apply as the eager loop over its levels and as
    the replay of its captured CUDA graph."""
    eager = apply_seconds(torch, M.eager, x)
    graph = apply_seconds(torch, M, x)
    same = bool(torch.equal(M.eager(x), M(x)))
    print(f"  {label}: {M.num_levels} levels; one apply eager "
          f"{eager * 1e3:.2f} ms, from its CUDA graph {graph * 1e3:.2f} ms "
          f"({eager / graph:.1f}x), results bit-equal: {same} (mean of 5, "
          f"host clock to a synchronize; {smi})")
    check(same, f"{label}: the graph replays the eager loop's result")
    return {"levels": M.num_levels, "eager_ms": eager * 1e3,
            "graph_ms": graph * 1e3}


def cli_run(torch, device, argv, overrides):
    """The port's CLI with no device argument on a copy of ini/input.dat
    with ``overrides``; the setup's preconditioner is kept."""
    from faspsolver_tpu_torch.ops import stencil2d
    ini = ini_with("ini/input.dat", overrides)
    reset_counts()
    with spied_calls(setup_spies()) as spy:
        rc, iters, relres, wall = cli(torch, device_arg(torch, device),
                                      ["-ini", ini, *argv])
    counts = launch_counts()
    built = [v["out"] for v in spy.values() if v["out"] is not None]
    setup_s = sum(v["s"] for v in spy.values())
    return {"setup_s": setup_s, "solve_s": wall - setup_s, "iters": iters,
            "converged": rc == 0, "relres": relres, "syncs": None,
            "launches": counts}, built[-1]


def block_path(torch, device, smi):
    """Phase 9.  Returns the stencil launches of its solves and the
    readings."""
    import numpy as np
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.precond.amg import smooth
    from faspsolver_tpu_torch.testgen import poisson_fe_manufactured
    from faspsolver_tpu_torch.utils import params
    counts = {"float32": 0, "float64": 0, "loop_control": 0,
              "gmres": 0, "mg": 0, "gcr": 0}
    readings = {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    on_card = torch.device(device).type == "cuda"

    def add(r):
        for k in counts:
            counts[k] += r["launches"].get(k, 0)

    print(f"  9a. block_poisson_3d({BSR_NX}, nb=3)")
    t0 = time.perf_counter()
    A, b = bsr_problem()
    print(f"  {A.nrow_block} block rows, {A.nrow} dof, {A.nnz_block} blocks, "
          f"{A.nnz_block * A.nb ** 2} scalar nonzeros, generated in "
          f"{time.perf_counter() - t0:.2f} s")
    check(A.nrow == 3 * BSR_NX ** 3, "phase 9a's size")
    kept, faults = {}, []
    for name, driver, fields, anchor, bound in BSR_GRID:
        # every Krylov loop of the row resident on the card: one launch
        # and one read per solve; its first solve rerun warm and as the
        # eager loop from the same state
        with loop_solves(torch) as seen:
            if driver == "refined":
                r, built = drive_refined(torch, device, A, b,
                                         fields["amg"])
                tol = REFINED["tol"]
            else:
                if fields == "ini":
                    its, amg, _, _ = params.param_init(
                        params.apply_cli_overrides(["-ini", "ini/bsr.dat"]))
                    fields = {"its": vars(its), "amg": vars(amg)}
                r, built = drive_driver(torch, device, driver, fields, A, b)
                tol = fields["its"]["tol"]
        report(name, r, tol, anchor, bound)
        faults += check_loop_resident(
            torch, device, name, seen,
            atomic=("UA-BSR's restriction (BlockAggRestrict) adds with "
                    "index_add_, atomic on the card") if "UA-BSR" in name
            else None)
        r["loops"] = seen
        add(r)
        readings[name] = r
        kept[driver] = built
        del built
    check(not faults, f"9a: every row resident and equal to its reruns: "
                      f"{faults}")
    x = torch.randn(A.nrow, generator=gen, device=device,
                    dtype=torch.float64)
    hier = kept["krylov_nk_amg"]
    op = hier.levels[0].A
    absop = device_operator(type(A)(A.indptr, A.indices, np.abs(A.data),
                                    A.shape)).to(device)
    on_card_vs_cpu(torch, "BsrEllOperator apply (786,432 dof)", op, x,
                   scale=float(absop(x.abs()).max()))
    del absop
    on_card_vs_cpu(
        torch, "one forward block Gauss-Seidel sweep", hier.levels[0], x,
        call=lambda lvl, v: smooth(lvl.smoother, lvl.A, torch.zeros_like(v),
                                   v, 1, True))
    M = kept["krylov_ilu"]
    on_card_vs_cpu(torch, "block ILU(0) apply", M, x)
    readings["block ILU(0) apply"] = ilu_apply_times(
        torch, "block ILU(0), 786,432 dof", M, x, smi)
    del kept, hier, op, M, A, b

    print(f"  9b. scalar ILU through the CLI, poisson_2d({NX}), float64")
    size = ["-precond", "4", "-problem", "poisson2d", "-size", str(NX)]
    for name, overrides in ILU_RUNS.items():
        anchor, bound = ILU_ANCHORS[name]
        r, M = cli_run(torch, device, size, overrides)
        report(f"CG + {name}", r, TOL, anchor, bound)
        check(on_card and r["launches"]["float64"] > 0 or not on_card,
              f"{name}: the solve applied A through the f64 stencil kernel")
        add(r)
        readings[name] = r
        x = torch.randn(NX * NX, generator=gen, device=device,
                        dtype=torch.float64)
        on_card_vs_cpu(torch, f"{name} apply ({NX}^2)", M, x)
        readings[f"{name} apply"] = ilu_apply_times(
            torch, f"{name}, {NX}^2", M, x, smi)
        del M

    print(f"  9c. Schwarz through the CLI, poisson_2d({SWZ_NX}), float64")
    size = ["-precond", "5", "-problem", "poisson2d", "-size", str(SWZ_NX)]
    faults = []
    for name, overrides in SWZ_RUNS.items():
        anchor, bound = SWZ_ANCHORS[name]
        # the Krylov loop over Schwarz resident on the card: one launch
        # and one read; its solve rerun warm and as the eager loop
        with loop_solves(torch) as seen:
            r, M = cli_run(torch, device, size, overrides)
        report(name, r, TOL, anchor, bound)
        faults += check_loop_resident(torch, device, name, seen)
        r["loops"] = seen
        check(on_card and r["launches"]["float64"] > 0 or not on_card,
              f"{name}: the sweeps applied A through the f64 stencil kernel")
        check(r["setup_s"] < 60.0,
              f"Schwarz host setup at {SWZ_NX}^2 under 60 s: {r['setup_s']}")
        add(r)
        readings[name] = r
        x = torch.randn(SWZ_NX ** 2, generator=gen, device=device,
                        dtype=torch.float64)
        on_card_vs_cpu(torch, f"{name} apply ({SWZ_NX}^2)", M, x)
        del M
    check(not faults, f"9c: every Schwarz solve resident and equal to its "
                      f"reruns: {faults}")

    print("  9d. level smoothers and the rest, poisson_fe_manufactured(64)")
    A, b, *_ = poisson_fe_manufactured(64)
    for name, driver, fields, anchor, bound in LEFTOVER_GRID:
        r, _ = drive_driver(torch, device, driver, fields, A, b)
        report(name, r, 1e-9, anchor, bound)
        add(r)
        readings[name] = r
    return counts, readings


# ---------------------------------------------------------------------------
# phase 10: the rest of the solver surface
# ---------------------------------------------------------------------------

def apply_ms(torch, module, x):
    """Mean host-clock ms of one apply ended by a synchronize."""
    return apply_seconds(torch, module, x) * 1e3


def surface_str(torch, device, smi, add):
    """10a: the STR family on block_poisson_3d(STR_NX, nb=3) in band
    form."""
    import numpy as np
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.ops.str_ops import StrOperator
    from faspsolver_tpu_torch.precond import str_precond
    readings = {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    A, Ab, b = str_problem(STR_NX)
    print(f"  10a. STR: block_poisson_3d({STR_NX}, nb=3) in band form, "
          f"{A.ngrid} grid points, {A.nrow} dof, offsets {A.offsets}, "
          f"built in {time.perf_counter() - t0:.2f} s")
    x = torch.randn(A.nrow, generator=gen, device=device,
                    dtype=torch.float64)
    op = StrOperator.from_str(A).to(device)
    absop = device_operator(type(Ab)(Ab.indptr, Ab.indices, np.abs(Ab.data),
                                     Ab.shape)).to(device)
    scale = float(absop(x.abs()).max())
    err = float((op(x) - device_operator(Ab).to(device)(x)).abs().max())
    print(f"  StrOperator against BsrEllOperator on the card, max abs error "
          f"/ scale {err / scale:.2e} (bound 1e-13)")
    check(err <= 1e-13 * scale, f"StrOperator is the BSR operator: {err}")
    del absop
    on_card_vs_cpu(torch, f"StrOperator apply ({A.nrow:,} dof)", op, x,
                   scale=scale)
    readings["StrOperator apply ms"] = apply_ms(torch, op, x)
    split = {"factor_s": (str_precond, "str_ilu_factor_banded"),
             "wavefronts_s": (str_precond, "_grid_wavefronts"),
             "patch_inverses_s": (str_precond, "_schwarz_patches")}
    kept, faults = {}, []
    for name, driver, fields, anchor, bound in STR_GRID:
        # every Krylov loop over the STR modules resident on the card
        with loop_solves(torch) as seen:
            r, built = drive_driver(torch, device, driver, fields, A, b,
                                    split)
        r["split"] = {k: v for k, v in r["split"].items() if v}
        if built is not None:
            r["apply_ms"] = apply_ms(torch, built, x)
        report(name, r, fields["its"]["tol"], anchor, bound)
        faults += check_loop_resident(torch, device, name, seen)
        r["loops"] = seen
        add(r)
        readings[name] = r
        kept[name] = built
    for name in ("vFGMRES + STR block GS", "vFGMRES + STR ILU(0)",
                 "vFGMRES + STR Schwarz"):
        on_card_vs_cpu(torch, f"{name[10:]} apply", kept[name], x)
    for name in ("vFGMRES + STR ILU(0)", "vFGMRES + STR ILU(1)"):
        readings[f"{name[10:]} apply"] = ilu_apply_times(
            torch, f"{name[10:]}, {A.nrow:,} dof", kept[name], x, smi)
    check(not faults, f"10a: every STR solve resident and equal to its "
                      f"reruns: {faults}")
    return readings


def surface_blc(torch, device, add):
    """10b: the same matrix as a 3 x 3 BLC, then the sweeping
    preconditioner on the z-slabs of poisson_3d."""
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.precond.blc_precond import BlcOperator
    readings = {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    A, b = blc_problem(BLC_NX)
    print(f"  10b. BLC: the same matrix field by field, 3 x 3 blocks of "
          f"{A.row_sizes()[0]:,} rows, built in "
          f"{time.perf_counter() - t0:.2f} s")
    Ab, _ = bsr_problem(BLC_NX)
    x = torch.randn(A.nrow, generator=gen, device=device,
                    dtype=torch.float64)
    op = BlcOperator.from_blc(A).to(device)
    ng = Ab.nrow_block
    yb = device_operator(Ab).to(device)(x.view(3, ng).T.reshape(-1))
    y = op(x)
    err = float((y - yb.view(ng, 3).T.reshape(-1)).abs().max())
    scale = float(y.abs().max())
    print(f"  BlcOperator against the permuted BsrEllOperator on the card, "
          f"max abs error / scale {err / scale:.2e} (bound 1e-13)")
    check(err <= 1e-13 * scale, f"BlcOperator is the BSR operator: {err}")
    readings["BlcOperator apply ms"] = apply_ms(torch, op, x)
    kept, faults = {}, []
    for name, driver, fields, anchor, bound in BLC_GRID:
        # every Krylov loop over the BLC modules resident on the card
        with loop_solves(torch) as seen:
            r, built = drive_driver(torch, device, driver, fields, A, b)
        r["apply_ms"] = apply_ms(torch, built, x)
        report(name, r, fields["its"]["tol"], anchor, bound)
        faults += check_loop_resident(torch, device, name, seen,
                                      atomic=UA_ATOMIC)
        r["loops"] = seen
        add(r)
        readings[name] = r
        kept[name] = built
    on_card_vs_cpu(torch, "BLC sgs apply", kept["vFGMRES + BLC sgs"], x)
    del kept, op, A, Ab
    n, slabs = SWEEP_N, SWEEP_SLABS
    A, b = sweep_problem(n, slabs)
    print(f"  sweeping: poisson_3d({n}) in {slabs} z-slabs of "
          f"{A.row_sizes()[0]:,} rows, {A.nrow:,} dof")
    for name, driver, fields, anchor, bound in SWEEP_GRID:
        with loop_solves(torch) as seen:
            r, built = drive_driver(torch, device, driver, fields, A, b)
        xs = torch.randn(A.nrow, generator=gen, device=device,
                         dtype=torch.float64)
        r["apply_ms"] = apply_ms(torch, built, xs)
        report(name, r, fields["its"]["tol"], anchor, bound)
        faults += check_loop_resident(torch, device, name, seen,
                                      atomic=UA_ATOMIC)
        r["loops"] = seen
        add(r)
        readings[name] = r
        on_card_vs_cpu(torch, "sweeping apply", built, xs)
    check(not faults, f"10b: every BLC and sweeping solve resident and "
                      f"equal to its reruns: {faults}")
    return readings


def surface_gmg(torch, device, smi, add):
    """10c: matrix-free geometric multigrid, held to the JAX counts and
    to the O(h^2) discretisation error.  The solves take f as a NumPy
    array and no device argument, as a user calls them.  Each row runs
    cold (its loop's capture included), warm (the row held to its
    anchor) and as the eager loop (``graphs.eager()``; its launches are
    not the path's): seconds, host reads, program launches and nodes,
    captures, capture seconds and graph MB of each; the resident solves
    are one launch and one read each, and the eager loop's count and x
    equal theirs."""
    from faspsolver_tpu_torch.precond import gmg
    from faspsolver_tpu_torch.utils import graphs
    readings = {}
    n2, n3 = GMG_N2, GMG_N3
    print(f"  10c. GMG on the unit square (n={n2}) and cube (n={n3})")
    for dim, n in ((2, n2), (3, n3)):
        f, _ = gmg_problem(n, dim)
        fc = torch.from_numpy(f).to(device)

        def vcycle(v, n=n, dim=dim):
            return gmg._vcycle(torch.zeros_like(v), v, n, dim)

        card = vcycle(fc)
        sync(torch, device)
        cpu = vcycle(fc.cpu())
        err = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
        ms = apply_ms(torch, vcycle, fc)
        print(f"  one {dim}-D V-cycle at n={n}: {ms:.2f} ms ({smi}); "
              f"card against CPU max abs error / scale {err:.2e} (bound "
              f"1e-13)")
        check(err <= 1e-13, f"{dim}-D V-cycle agrees with the CPU: {err}")
        readings[f"{dim}-D V-cycle ms"] = ms
    cuda = torch.device(device).type == "cuda"
    for name, fn, dim, kw, anchor, bound in GMG_GRID:
        n = n3 if dim == 3 else n2
        f, u = gmg_problem(n, dim)
        solve = lambda: getattr(gmg, fn)(f, n, **kw)  # noqa: E731
        runs = {}
        for tag in ("cold", "warm", "eager"):
            with graphs.eager() if tag == "eager" else \
                    contextlib.nullcontext():
                res, x, r = timed_solve(torch, device, solve)
            r.update(iters=res.iters, syncs=res.syncs, relres=res.relres,
                     resident=res.resident)
            runs[tag] = (res, x, r)
            if tag != "eager":
                add(r)
        res, x, r = runs["warm"]
        err = float(abs(x - u).max())
        eager, xe, re = runs["eager"]
        print(f"  {name:36s} n={n:5d} {res.iters:3d} iterations (JAX "
              f"{anchor} +- {bound}), relres {res.relres:.3e}, max |u - "
              f"exact| {err:.3e} (h^2 {1 / n ** 2:.3e}); {smi}")
        for tag, (_, _, rr) in runs.items():
            print(f"    {tag:5s} {rr['s']:.4f} s, {rr['iters']} iterations, "
                  f"host reads {rr['syncs']}, program launches "
                  f"{rr['replays']} ({rr['nodes_replayed']} nodes), "
                  f"captures {rr['captures']} ({rr['nodes_captured']} "
                  f"nodes, {rr['capture_s']:.3f} s, {rr['graph_mb']} MB), "
                  f"launches {rr['launches']}")
        check(res.x.device.type == "cuda" and res.converged
              and abs(res.iters - anchor) <= bound and err <= 1.0 / n ** 2,
              f"{name}: {res.iters} iterations, relres {res.relres}, "
              f"error {err}")
        if cuda and dim > 1:
            for tag in ("cold", "warm"):
                rr = runs[tag][2]
                check(rr["resident"] and rr["syncs"] == 1
                      and rr["replays"] == 1,
                      f"{name} {tag}: resident, one host read and one "
                      f"program launch: {rr}")
            check(runs["cold"][2]["iters"] == res.iters == eager.iters
                  and re["syncs"] == eager.iters + 1
                  and (x == runs["cold"][1]).all() and (x == xe).all(),
                  f"{name}: cold, warm and eager solves agree bit for bit")
        readings[name] = {"iters": res.iters, "relres": res.relres,
                          "max_err": err, "solve_s": r["s"],
                          "syncs": res.syncs, "cold_s": runs["cold"][2]["s"],
                          "eager_s": re["s"], "eager_syncs": re["syncs"],
                          "nodes": r["nodes_replayed"],
                          "capture_s": runs["cold"][2]["capture_s"],
                          "graph_mb": runs["cold"][2]["graph_mb"]}
    return readings


def surface_leftovers(torch, add):
    """10d: MatFreeOperator over the f64 stencil operator and through the
    six matfree Krylov methods, maxeig on the host and on the card, and
    the C API."""
    import numpy as np
    from faspsolver_tpu_torch import capi, default_device, krylov
    from faspsolver_tpu_torch.krylov import JacobiPrecond
    from faspsolver_tpu_torch.ops import (MatFreeOperator, best_operator,
                                          device_operator, eigen, stencil2d)
    from faspsolver_tpu_torch.solvers import itsolver
    from faspsolver_tpu_torch.testgen import (poisson_2d,
                                              poisson_fe_manufactured)
    from faspsolver_tpu_torch.utils.params import ITSParam
    readings = {}
    place = default_device()
    print(f"  10d. MatFreeOperator, eigen and the C API")
    P = poisson_2d(NX)
    bp = P.matvec(np.random.default_rng(SEED).standard_normal(P.nrow))
    op = best_operator(P, dtype=torch.float64).to(place)
    mf = MatFreeOperator(op, P.nrow, torch.float64)
    M = JacobiPrecond.from_csr(P).to(place)
    reset_counts()
    # the stencil operator declares itself capturable, and so does the
    # MatFreeOperator around it: the CG loop is resident on the card
    faults = []
    with loop_solves(torch) as seen:
        t0 = time.perf_counter()
        res = itsolver(mf, bp, M=M, its=ITSParam(**MATFREE_STENCIL))
        x = res.x.cpu().numpy()
        wall = time.perf_counter() - t0
    r = {"iters": res.iters, "converged": res.converged, "syncs": res.syncs,
         "relres": float(np.linalg.norm(bp - P.matvec(x))
                         / np.linalg.norm(bp)),
         "setup_s": 0.0, "solve_s": wall, "launches": launch_counts()}
    anchor, bound = MATFREE_STENCIL_ANCHOR
    report(f"MatFree {NX}^2 f64 stencil, CG + Jacobi", r,
           MATFREE_STENCIL["tol"], anchor, bound)
    check(r["launches"]["float64"] > 0,
          "the MatFree solve launched the f64 stencil kernel")
    faults += check_loop_resident(torch, place, "MatFree "
                                  "stencil CG", seen)
    r["loops"] = seen
    add(r)
    readings["MatFree stencil CG"] = r

    A, b, *_ = poisson_fe_manufactured(64)
    ell = device_operator(A, prefer="ell").to(place)
    Mj = JacobiPrecond.from_csr(A).to(place)
    bt = torch.from_numpy(b).to(place)
    for name, fn, restart, anchor, bound in MATFREE_GRID:
        kw = dict(MATFREE_ITS, **({"restart": restart} if restart else {}))
        # the ELL operator declares itself capturable, so the loop over
        # the MatFreeOperator around it is resident on the card
        with loop_solves(torch) as seen:
            t0 = time.perf_counter()
            res = getattr(krylov, fn)(MatFreeOperator(ell, A.nrow,
                                                      torch.float64),
                                      bt, M=Mj, **kw)
            x = res.x.cpu().numpy()
            wall = time.perf_counter() - t0
        rel = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
        print(f"  {name:20s} {res.iters:5d} iterations (JAX {anchor} +- "
              f"{bound}), status {res.status}, verified relres {rel:.3e}, "
              f"{wall:.3f} s, host reads {res.syncs}, resident "
              f"{res.resident}")
        faults += check_loop_resident(torch, place, name, seen)
        check(abs(res.iters - anchor) <= bound and rel < 1e-9,
              f"{name}: {res.iters} iterations, relres {rel}")
        readings[name] = {"iters": res.iters, "relres": rel, "s": wall,
                          "syncs": res.syncs, "resident": res.resident,
                          "loops": seen}
    check(not faults, f"10d: every MatFree solve resident and equal to its "
                      f"reruns: {faults}")

    t0 = time.perf_counter()
    lam = eigen.maxeig(P)
    t1 = time.perf_counter()
    lam50 = eigen.maxeig(P, iters=50, tol=0.0)
    v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(P.nrow))
    sync(torch, place)
    t2 = time.perf_counter()
    lam_dev = float(eigen.maxeig_device(op, 50, v0=v0.to(place)))
    t3 = time.perf_counter()
    ref = MAXEIG_ANCHOR
    print(f"  maxeig({NX}^2) on the host {lam!r} (JAX {ref!r}), "
          f"{t1 - t0:.3f} s; 50 power steps on the card from the host's "
          f"start vector {lam_dev!r} against the host's {lam50!r} "
          f"(relative {abs(lam_dev - lam50) / lam50:.1e}, bound 1e-8), "
          f"{t3 - t2:.3f} s")
    check(abs(lam - ref) <= 1e-10 * ref, f"maxeig {lam} is JAX's {ref}")
    check(abs(lam_dev - lam50) <= 1e-8 * lam50,
          f"maxeig_device {lam_dev} follows the host's {lam50}")
    readings["maxeig"] = {"host": lam, "device": lam_dev,
                          "host_s": t1 - t0, "device_s": t3 - t2}

    Ab, bb = bsr_problem()
    from faspsolver_tpu_torch.utils import graphs
    for fn, kw, anchor, bound in CAPI_GRID:
        reset_counts()
        graphs.reset_stats()
        t0 = time.perf_counter()
        if fn == "dbsr_krylov_amg":
            xc, it, rr = capi.dbsr_krylov_amg(
                Ab.nb, Ab.nrow_block, Ab.indptr, Ab.indices,
                Ab.data.reshape(-1), bb, **kw)
            rel = np.linalg.norm(bb - Ab.matvec(xc)) / np.linalg.norm(bb)
        else:
            xc, it, rr = getattr(capi, fn)(P.nrow, P.indptr, P.indices,
                                           P.data, bp, **kw)
            rel = np.linalg.norm(bp - P.matvec(xc)) / np.linalg.norm(bp)
        wall = time.perf_counter() - t0
        r = {"iters": it, "converged": True, "relres": float(rel),
             "setup_s": 0.0, "solve_s": wall, "syncs": None,
             "launches": launch_counts()}
        check(isinstance(xc, np.ndarray), f"capi.{fn} returns NumPy")
        r.update(graph_stats())
        report(f"capi.{fn} (setup + solve)", r, kw["tol"], anchor, bound)
        if fn == "dcsr_amg":
            # AMG as a solver: its loop is one program (the setup
            # launches none)
            print(f"  capi.dcsr_amg: program launches {r['replays']}, "
                  f"captures {r['captures']} ({r['capture_s']:.3f} s, "
                  f"{r['graph_mb']} MB)")
            check(place.type != "cuda" or r["replays"] == 1,
                  f"capi.dcsr_amg ran its AMG loop resident: {r}")
        add(r)
        readings[f"capi.{fn}"] = r
    return readings


def surface_path(torch, device, smi):
    """Phase 10.  Returns the stencil launches of its solves and the
    readings."""
    counts = {"float32": 0, "float64": 0, "loop_control": 0,
              "gmres": 0, "mg": 0, "gcr": 0}

    def add(r):
        for k in counts:
            counts[k] += r["launches"].get(k, 0)

    t0 = time.perf_counter()
    readings = {"str": surface_str(torch, device, smi, add),
                "blc": surface_blc(torch, device, add),
                "gmg": surface_gmg(torch, device, smi, add),
                "leftovers": surface_leftovers(torch, add)}
    readings["phase_s"] = time.perf_counter() - t0
    print(f"  phase 10 took {readings['phase_s']:.1f} s; stencil launches "
          f"{counts}")
    return counts, readings


# ---------------------------------------------------------------------------
# phase 11: the benchmark harness, checkpoint and profiling
# ---------------------------------------------------------------------------

def hold_to_anchor(name, iters, anchors):
    """A harness row's count against its JAX anchor.  A row whose anchor
    reference_anomalies() flags is printed as a reference anomaly with
    both counts and not held to it."""
    ref = anchors[name][0]
    why = reference_anomalies(anchors).get(name)
    if why:
        print(f"  reference anomaly: {name}: JAX {ref} iterations ({why}), "
              f"port {iters}; held to convergence and its relres only")
        return
    bound = max(2, int(0.05 * ref))
    check(abs(iters - ref) <= bound,
          f"{name}: {iters} iterations within {bound} of JAX {ref}")


def harness_generated(torch, device, dtype, anchors):
    """11a / 11b: what ``run_generated("amg")`` does, row by row, with no
    device argument: lMVU, the solver, ``score_problem`` on each of the
    six generated rows; the timed call's result is kept and verified on
    the host in f64."""
    import numpy as np
    from faspsolver_tpu_torch.benchmark import harness
    from faspsolver_tpu_torch.ops import stencil2d
    dev = device_arg(torch, device)
    harness._print_platform(dtype, dev)
    lmvu = harness.compute_lmvu(dtype=dtype, device=dev)
    print(f"  lMVU = {lmvu:.6e} s/row/iter")
    solver = harness._solver_factory("amg", dtype, dev)
    kept = {}

    def keep(A, b):
        kept["out"] = solver(A, b)
        return kept["out"]

    rows = harness.generated_problems(sizes_3d=HARNESS_3D)
    check([n for n, _, _ in rows] == list(anchors),
          f"the generated rows are the anchored ones: {list(anchors)}")
    counts = {"float32": 0, "float64": 0, "loop_control": 0,
              "gmres": 0, "mg": 0, "gcr": 0}
    readings = {"lmvu": lmvu}
    for name, A, b in rows:
        reset_counts()
        r = harness.score_problem(name, A, b, keep, lmvu)
        launches = launch_counts()
        out = kept["out"]
        if isinstance(out.x, torch.Tensor):
            check(out.x.device.type == torch.device(device).type,
                  f"{name}: x lay on {device}")
            x = out.x.cpu().numpy()
        else:                  # the refined mode hands x back on the host
            x = out.x
        x = np.asarray(x, dtype=np.float64)
        check(x.shape == (A.nrow,) and bool(np.isfinite(x).all()),
              f"{name}: finite x of the expected shape")
        relres = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
        print(f"  {name:16s} n={r.n:8d} nnz={r.nnz:9d} iterations "
              f"{r.iters:4d} (JAX {anchors[name][0]}), solve {r.solve_s:.3f} "
              f"s, score {r.score:.1f}, own relres {float(out.relres):.3e}, "
              f"verified f64 relres {relres:.3e}, stencil launches "
              f"{launches}")
        check(r.converged and float(out.relres) < HARNESS_TOL
              and relres < TOL,
              f"{name}: converged, own relres {out.relres} < {HARNESS_TOL}, "
              f"verified {relres} < {TOL}")
        hold_to_anchor(name, r.iters, anchors)
        for k in counts:
            counts[k] += launches.get(k, 0)
        readings[name] = {"n": r.n, "nnz": r.nnz, "iters": r.iters,
                          "solve_s": r.solve_s, "score": r.score,
                          "relres": relres, "launches": launches}
    return counts, readings


@contextlib.contextmanager
def refined_stages(krylov, solvers):
    """While the block runs, every ``solvers.solve_refined`` call is
    recorded as a stage (its inner type, rounds, inner iterations, relres,
    convergence) with the ``krylov.vgmres`` inner solves it made (each
    one's type, iterations, own relres, convergence and status).  The
    modules are either package's (``small_grid_anchors.py`` passes the
    JAX package's): the harness's refined mode looks both names up when
    its factory is made, so the factory must be made inside the block."""
    stages, inner = [], []
    real_vgmres, real_refined = krylov.vgmres, solvers.solve_refined

    def vgmres(A, r, *args, **kw):
        out = real_vgmres(A, r, *args, **kw)
        inner.append((str(r.dtype).rsplit(".", 1)[-1], int(out.iters),
                      float(out.relres), bool(out.converged),
                      int(out.status)))
        return out

    def solve_refined(*args, **kw):
        first = len(inner)
        out = real_refined(*args, **kw)
        dt = kw.get("dtype")
        dt = getattr(dt, "__name__", str(dt)).rsplit(".", 1)[-1]
        stages.append({"dtype": dt,
                       "rounds": int(out.rounds),
                       "inner_iters": int(out.inner_iters),
                       "relres": float(out.relres),
                       "converged": bool(out.converged),
                       "inner": inner[first:]})
        return out

    krylov.vgmres, solvers.solve_refined = vgmres, solve_refined
    try:
        yield stages
    finally:
        krylov.vgmres, solvers.solve_refined = real_vgmres, real_refined


def print_stages(stages):
    for k, s in enumerate(stages):
        seq = " ".join(f"{it}:{rr:.3e}{'' if ok else f'!{st}'}"
                       for _, it, rr, ok, st in s["inner"])
        print(f"    stage {k} ({s['dtype']} inner): {s['rounds']} rounds, "
              f"{s['inner_iters']} inner iterations, relres "
              f"{s['relres']:.3e}, converged {s['converged']}; inner "
              f"iterations:relres (!status: unconverged) {seq}")


def harness_fallbacks(torch, device):
    """11f: the f32 refined mode's two fallbacks (FALLBACK_CASES) through
    ``harness._refined_factory("amg", float32)`` on ``device``: each case's
    banner, total inner iterations and stages (:func:`refined_stages`)
    beside the JAX package's (FALLBACK_ANCHORS), held to convergence and
    verified f64 relres < TOL, and, unless FALLBACK_FAULT stands, to the
    JAX banner and the count within max(2, 5%) of JAX's; each case is
    printed before any is held.  Returns the readings."""
    import io

    import numpy as np
    from faspsolver_tpu_torch import krylov, solvers
    from faspsolver_tpu_torch.benchmark import harness
    from faspsolver_tpu_torch.testgen import jump_2d
    readings, misses = {}, []
    for name, (n, contrast, banner) in FALLBACK_CASES.items():
        A = jump_2d(n, contrast)
        b = A.matvec(np.ones(A.nrow))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with refined_stages(krylov, solvers) as stages, \
                contextlib.redirect_stdout(buf):
            res = harness._refined_factory("amg", torch.float32, device)(A, b)
        secs = time.perf_counter() - t0
        said = buf.getvalue().strip()
        x = np.asarray(res.x.cpu() if isinstance(res.x, torch.Tensor)
                       else res.x, dtype=np.float64)
        relres = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
        ref, ref_stages = FALLBACK_ANCHORS[name]
        bound = max(2, int(0.05 * ref))
        print(f"  {name}: jump_2d({n}, {contrast:g}): {res.iters} inner "
              f"iterations (JAX {ref} +- {bound}), converged {res.converged}, "
              f"verified f64 relres {relres:.3e}, {secs:.1f} s; said {said!r} "
              f"(JAX {banner!r})")
        print_stages(stages)
        print(f"    JAX's stages (rounds, inner iterations): {ref_stages}")
        if not (res.converged and relres < TOL):
            misses.append(f"{name}: converged {res.converged}, verified "
                          f"relres {relres} < {TOL}")
        unlike = ([f"says {said!r}, JAX {banner!r}"] if banner not in said
                  else []) + ([f"{res.iters} inner iterations, JAX {ref} +- "
                               f"{bound}"] if abs(res.iters - ref) > bound
                              else [])
        if unlike and FALLBACK_FAULT:
            print(f"    open fault ({FALLBACK_FAULT}): {'; '.join(unlike)}")
        elif unlike:
            misses += [f"{name}: {u}" for u in unlike]
        readings[name] = {"iters": res.iters, "relres": relres, "said": said,
                          "stages": stages, "s": secs,
                          "as_in_jax": not unlike}
    check(not misses, f"11f: the fallbacks: {misses}")
    return readings


def harness_corpus(torch, device, rows=None):
    """11c: the corpus through the harness CLI with no device argument,
    its first ``rows`` rows (None: all 20); every row asked for must come
    back converged."""
    from faspsolver_tpu_torch.benchmark import harness
    from faspsolver_tpu_torch.benchmark.__main__ import main
    from faspsolver_tpu_torch.ops import stencil2d
    asked = list(HARNESS_CORPUS_F64)[:rows]
    every = harness.corpus_problems
    harness.corpus_problems = lambda scale=255: every(scale)[:rows]
    reset_counts()
    try:
        with spied_calls({"run_corpus": (harness, "run_corpus")}) as spy:
            rc = main(["--corpus"], device=device_arg(torch, device))
    finally:
        harness.corpus_problems = every
    launches = launch_counts()
    results = spy["run_corpus"]["out"] or []
    check(rc == 0, f"main(['--corpus']) returned {rc}")
    check([r.name for r in results] == asked,
          f"every corpus row asked for came back: "
          f"{[r.name for r in results]}")
    readings = {}
    for r in results:
        print(f"  {r.name:16s} {r.iters:4d} iterations (JAX "
              f"{HARNESS_CORPUS_F64[r.name][0]}), solve {r.solve_s:.3f} s, "
              f"score {r.score:.1f}")
        check(r.converged, f"{r.name} converged")
        hold_to_anchor(r.name, r.iters, HARNESS_CORPUS_F64)
        readings[r.name] = {"iters": r.iters, "solve_s": r.solve_s,
                            "score": r.score}
    print(f"  corpus stencil launches {launches}")
    return launches, readings


def bit_equal_on(torch, device, orig, back, label):
    """Every buffer of the loaded module on ``device`` and bit-equal to
    the original's."""
    a, b = dict(orig.named_buffers()), dict(back.named_buffers())
    check(list(a) == list(b) and a, f"{label}: the same buffers")
    for k, t in b.items():
        check(t.device.type == torch.device(device).type
              and t.dtype == a[k].dtype and torch.equal(t, a[k]),
              f"{label}: {k} on {device} and bit-equal")
    return len(a)


def round_trip(torch, device, label, hier, solve, tmp):
    """Two solves from ``hier``, save_hierarchy, load_hierarchy with no
    device argument, a solve from the loaded one: (x1, x2, x3, results)
    with the file's MB and the save / load seconds printed."""
    import os
    from faspsolver_tpu_torch.utils import checkpoint
    first, second = solve(hier), solve(hier)
    path = os.path.join(tmp, f"{label}.pt")
    sync(torch, device)
    t0 = time.perf_counter()
    checkpoint.save_hierarchy(path, hier)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = checkpoint.load_hierarchy(path, device=device_arg(torch, device))
    sync(torch, device)
    load_s = time.perf_counter() - t0
    nbuf = bit_equal_on(torch, device, hier, back, label)
    plans = [m for m in back.modules() if hasattr(m, "_plan")]
    check(all(m._plan is None for m in plans),
          f"{label}: no stencil plan came back from the file")
    third = solve(back)
    mb = os.path.getsize(path) / 1e6
    print(f"  {label}: {nbuf} tensors bit-equal on {device}; file "
          f"{mb:.1f} MB, save {save_s:.3f} s, load {load_s:.3f} s")
    return first, second, third, {"file_mb": mb, "save_s": save_s,
                                  "load_s": load_s, "tensors": nbuf}


def checkpoint_path(torch, device, tmp):
    """11d: phase 4's headline hierarchy and phase 8's input.dat RS
    hierarchy through save_hierarchy / load_hierarchy; 11e's memory
    report of the headline hierarchy."""
    import numpy as np
    from faspsolver_tpu_torch import default_device
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import setup_rs, setup_structured
    from faspsolver_tpu_torch.solvers import itsolver, solve_refined_resident
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils import profiling
    from faspsolver_tpu_torch.utils.params import (apply_cli_overrides,
                                                   param_init)
    dev = torch.device(device_arg(torch, device) or default_device())
    A = poisson_2d(NX)
    b = A.matvec(np.ones(A.nrow))
    readings = {}

    host = setup_structured(A, headline_param(), dtype=torch.float32,
                            smooth_p=True, keep_f64_fine=True)
    sync(torch, dev)
    before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    hier = host.to(dev)
    sync(torch, dev)
    grown = (torch.cuda.memory_allocated() if dev.type == "cuda" else 0) \
        - before
    nbytes = profiling.tree_nbytes(hier)
    print(f"  {profiling.memory_report(hier, 'headline hierarchy')}; the "
          f"allocator grew {grown / 1e6:.2f} MB when it moved to {dev} "
          f"(tree_nbytes / growth {nbytes / max(grown, 1):.4f})")
    readings["memory"] = {"tree_nbytes": nbytes, "allocated_growth": grown}

    def headline(h):
        return solve_refined_resident(h, b, **HEADLINE_REFINE)

    r1, r2, r3, readings["headline"] = round_trip(
        torch, device, "headline", hier, headline, tmp)
    print(f"  headline: rounds / inner iterations {r1.rounds} / "
          f"{r1.inner_iters} original, {r3.rounds} / {r3.inner_iters} "
          f"loaded; two original solves bit-equal: "
          f"{np.array_equal(r1.x, r2.x)}")
    check((r3.rounds, r3.inner_iters) == (r1.rounds, r1.inner_iters)
          and r3.relres < TOL, "the loaded headline hierarchy solves as "
          "the original does")
    if np.array_equal(r1.x, r2.x):
        check(np.array_equal(r3.x, r1.x),
              "headline x from the loaded hierarchy bit-equal")
    del hier, host

    its, amg, _, _ = param_init(apply_cli_overrides(["-ini",
                                                     "ini/input.dat"]))
    hier = setup_rs(A, amg, dtype=torch.float64).to(dev)
    kinds = sorted({type(m).__name__ for m in hier.modules()})
    print(f"  input.dat RS hierarchy: {len(hier.levels)} levels; modules "
          f"{', '.join(kinds)}")
    check("ColorBlock" in kinds, "the RS hierarchy holds GS color blocks")

    def rs(h):
        return itsolver(A, b, M=AMGPrecond(h, amg.maxit), its=its,
                        dtype=torch.float64, device=device_arg(torch, device))

    s1, s2, s3, readings["input_rs"] = round_trip(
        torch, device, "input.dat RS", hier, rs, tmp)
    x1, x2, x3 = (s.x.cpu().numpy() for s in (s1, s2, s3))
    spread = float(np.abs(x2 - x1).max())
    err = float(np.abs(x3 - x1).max())
    print(f"  input.dat RS: iterations {s1.iters} / {s2.iters} original, "
          f"{s3.iters} loaded; max |x2 - x1| {spread:.3e}, max |x3 - x1| "
          f"{err:.3e}")
    check(abs(s3.iters - s1.iters) <= INI_ANCHORS["input"][1]
          and s3.converged, "the loaded RS hierarchy solves as the "
          "original does")
    check(err == 0.0 if spread == 0.0 else err <= 10 * spread,
          f"RS x from the loaded hierarchy within 10 x the spread of two "
          f"original solves ({spread}): {err}")
    readings["input_rs"].update(iters=s3.iters, spread=spread, err=err)
    return readings


def profile_harness_row(torch, device, tmp):
    """11e: fdm2d-1023x1023's timed f64 call inside profiling.trace, as
    its two halves: the harness's f64 solver is ``krylov_amg`` with the
    ``its`` below, that is the driver's AMG setup on the host and the
    hierarchy's move to the card ("setup"), then the Krylov solve
    ("solve").  The device busy share is read from the trace file
    (kernel time over wall time)."""
    import glob
    import os
    from faspsolver_tpu_torch.benchmark import harness
    from faspsolver_tpu_torch.constants import SolverType
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.solvers import drivers
    from faspsolver_tpu_torch.utils import profiling
    from faspsolver_tpu_torch.utils.params import AMGParam, ITSParam
    name, A, b = harness.generated_problems((NX,), ())[0]
    dev = device_arg(torch, device)
    its = ITSParam(itsolver_type=int(SolverType.VGMRES), tol=HARNESS_TOL,
                   maxit=2000, restart=60)
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir):
        sync(torch, device)
        t0 = time.perf_counter()
        with profiling.annotate("setup"):
            hier = drivers._amg_setup_by_type(A, AMGParam(),
                                              torch.float64).to(
                drivers._resolve_device(dev))
        with profiling.annotate("solve"):
            res = drivers.itsolver(A, b, M=AMGPrecond(hier), its=its,
                                   dtype=torch.float64, device=dev)
        harness._sync(res.x)
        wall = time.perf_counter() - t0
    hold_to_anchor(name, res.iters, HARNESS_GEN_F64)
    files = glob.glob(os.path.join(logdir, "*.json"))
    check(len(files) == 1, f"profiling.trace wrote one trace: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernel_us = sum(e.get("dur", 0) for e in events
                    if e.get("cat") == "kernel")
    labels = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    share = kernel_us / 1e6 / wall
    print(f"  {name} f64 traced: {res.iters} iterations, wall {wall:.3f} s "
          f"(profiled), device kernel time {kernel_us / 1e3:.1f} ms, device "
          f"busy share {share:.4f}; trace {os.path.getsize(files[0]) / 1e6:.1f}"
          f" MB, {len(events)} events, annotations {sorted(labels)}")
    check({"setup", "solve"} <= labels, "the trace holds both annotations")
    if torch.device(device).type == "cuda":
        check(kernel_us > 0, "the trace holds device kernels")
    return {"wall_s": wall, "kernel_s": kernel_us / 1e6, "busy_share": share,
            "iters": res.iters}


def harness_path(torch, device, corpus_rows=None):
    """Phase 11, with the first ``corpus_rows`` corpus rows (None: all).
    Returns the stencil launches of its runs and the readings."""
    import shutil
    import tempfile
    counts = {"float32": 0, "float64": 0, "loop_control": 0,
              "gmres": 0, "mg": 0, "gcr": 0}

    def add(c):
        for k in counts:
            counts[k] += c.get(k, 0)

    t0 = time.perf_counter()
    readings = {}
    print("  (a) generated rows, f64")
    c, readings["gen_f64"] = harness_generated(torch, device, torch.float64,
                                               HARNESS_GEN_F64)
    add(c)
    print("  (b) generated rows, the f32 refined mode")
    c, readings["gen_f32"] = harness_generated(torch, device, torch.float32,
                                               HARNESS_GEN_F32)
    add(c)
    print(f"  (c) main(['--corpus']), {corpus_rows or 'all'} rows")
    c, readings["corpus"] = harness_corpus(torch, device, corpus_rows)
    add(c)
    tmp = tempfile.mkdtemp()
    try:
        print("  (d) checkpoint")
        readings["checkpoint"] = checkpoint_path(torch, device, tmp)
        print("  (e) profiling")
        readings["profile"] = profile_harness_row(torch, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("  (f) the f32 refined mode's fallbacks")
    reset_counts()
    readings["fallbacks"] = harness_fallbacks(torch, device_arg(torch, device))
    add(launch_counts())
    readings["phase_s"] = time.perf_counter() - t0
    print(f"  phase 11 took {readings['phase_s']:.1f} s; stencil launches "
          f"of its harness runs {counts}")
    return counts, readings


# ---------------------------------------------------------------------------
# phase 12: the regression runner
# ---------------------------------------------------------------------------

def regression_path(torch, device, sets=("core", "bsr", "matfree", "mm")):
    """Phase 12: the runner's config sets on the generated problems, each
    config function called with no device argument (the card), float64.
    Every row is held to its JAX CPU row: the same verdict, the count
    within its allowance (a REGRESSION_FLOOR row: the verdict only).
    Returns the stencil launches and the readings."""
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.regression import runner
    counts = {"float32": 0, "float64": 0, "loop_control": 0,
              "gmres": 0, "mg": 0, "gcr": 0}
    readings = {}
    t0 = time.perf_counter()
    for kind in sets:
        fn, keys = REGRESSION_SETS[kind]
        probs = regression_problems(keys)
        cfgs = getattr(runner, fn)()
        reset_counts()
        t1 = time.perf_counter()
        res = runner.run_matrix(cfgs, probs)
        sync(torch, device)
        secs = time.perf_counter() - t1
        launches = launch_counts()
        for k in counts:
            counts[k] += launches.get(k, 0)
        npass, nwarn = runner.print_tally(res)
        for r in res:
            if (r.problem, r.name) in REGRESSION_FLOOR:
                it = REGRESSION_ANCHORS[r.problem][r.name][0]
                print(f"  rounding floor: {r.problem} / {r.name}: port "
                      f"{r.iters}, JAX {it} ({REGRESSION_FLOOR[(r.problem, r.name)]});"
                      f" held to its verdict only")
        misses = regression_misses(res, cfgs, probs, hold_extra=False)
        print(f"  12 {kind}: {len(res)} rows, {npass} PASS, {nwarn} "
              f"ATTENTION, {secs:.1f} s, launches {launches}")
        check(not misses, f"12 {kind}: every row at its JAX row: {misses}")
        readings[kind] = {"rows": len(res), "pass": npass,
                          "attention": nwarn, "s": secs,
                          "launches": launches}
    # the configs ran on the card: one row's x, once more
    cfg = [c for c in runner.core_configs() if c[0] == "CG + diag"][0]
    (_, A, b, _), = regression_problems(("fd",))
    x = cfg[1](A, b).x
    check(x.device.type == "cuda" and x.dtype == torch.float64,
          f"the runner's solves run on the card in float64 ({x.device}, "
          f"{x.dtype})")
    readings["phase_s"] = time.perf_counter() - t0
    print(f"  phase 12 took {readings['phase_s']:.1f} s; stencil launches "
          f"{counts}")
    return counts, readings


# ---------------------------------------------------------------------------
# phase 13: the distribution layer
# ---------------------------------------------------------------------------

def _host_relres(A, x, b):
    import numpy as np
    return float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))


def parallel_solves(torch, device, smi=""):
    """Phase 13 on every rank of the process group: (a)-(g),
    each solve timed with the launch counts set to 0 just before it and
    read just after, x gathered and verified on the host in f64, its
    count held to the JAX package's one-device count, its loop resident
    and rerun warm and as the eager loop (:func:`loop_solves`,
    :func:`check_loop_resident`), and what a two-iteration run of it
    communicates recorded.  Returns the launches by solve and the
    readings (rank 0's are printed)."""
    import numpy as np
    from faspsolver_tpu_torch import as_tensor
    from faspsolver_tpu_torch.constants import AMGType, SmootherType
    from faspsolver_tpu_torch.krylov import JacobiPrecond, pcg, vfgmres
    from faspsolver_tpu_torch.ops import device_operator, stencil2d
    from faspsolver_tpu_torch.parallel import (
        assert_neighbor_comm_only, cycle_comm_pattern, dist_dia_operator,
        dist_operator, halo_shard_hierarchy, make_mesh, replicate,
        shard_block_rows, shard_hierarchy, shard_vector)
    from faspsolver_tpu_torch.parallel.comm import mesh_device, record, whole
    from faspsolver_tpu_torch.parallel.dryrun import dryrun_multichip
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import setup_rs, setup_structured
    from faspsolver_tpu_torch.precond.amg.setup_bsr import setup_ua_bsr
    from faspsolver_tpu_torch.testgen import block_poisson_3d, poisson_2d
    from faspsolver_tpu_torch.utils import graphs
    from faspsolver_tpu_torch.utils.params import AMGParam

    mesh = make_mesh()                        # the world's ranks, NCCL
    ws, dev = mesh.size(), mesh_device(mesh)
    rank0 = mesh.get_local_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    f64 = torch.float64
    counts, readings = {}, {"world_size": ws}
    A = poisson_2d(PAR_NX)
    n = A.nrow
    b = A.matvec(np.ones(n))
    bd = shard_vector(as_tensor(b, f64), mesh)

    def solve(key, fn, A, b, anchor, what, atomic=None):
        """``fn(**over)`` solves with PARALLEL_RUNS[anchor] updated by
        ``over``; ``atomic`` names the sum of the path that adds with
        atomics (x then within X_DIFF_LIMIT of the eager loop's)."""
        reset_counts()
        sync(torch, device)
        with loop_solves(torch) as seen:
            t0 = time.perf_counter()
            res = fn()
            x = whole(res.x)[:A.nrow].cpu().numpy()
            secs = time.perf_counter() - t0
        launches = launch_counts()
        rr = _host_relres(A, x, b)
        tol = PARALLEL_RUNS[anchor]["tol"]
        ref, bound = PARALLEL_ANCHORS[anchor]
        say(f"  ({key}) {what}: {res.iters} iterations (JAX one device "
            f"{ref}), host f64 relres {rr:.3e}, {secs:.2f} s with the "
            f"warm and eager reruns, launches {launches}")
        check(res.converged and rr < 10 * tol,
              f"({key}) converged, verified relres {rr:.3e}")
        check(abs(res.iters - ref) <= bound,
              f"({key}) {res.iters} iterations within {bound} of JAX {ref}")
        bad = check_loop_resident(torch, device, f"({key})", seen, atomic)
        check(not bad, f"({key}) resident, warm and eager agree: {bad}")
        with record(mesh) as rec:
            fn(maxit=2)
        say(f"    ({key}) a 2-iteration eager run of its pieces "
            f"communicates: {rec.summary()}")
        counts[key] = launches
        r = seen[0]
        readings[key] = {"iters": res.iters, "relres": rr, "s": secs,
                         "resident": r["resident"], "syncs": r["syncs"],
                         "launches": r["launches"], "cold_s": r["s"],
                         "comm_2_iters": rec.summary(),
                         **{k: r[k] for k in ("warm_s", "eager_s",
                                              "eager_iters", "eager_syncs",
                                              "bit_equal", "x_diff")
                            if k in r}}
        return res

    dinv = shard_vector(as_tensor(1.0 / A.diagonal(), f64), mesh)
    op = dist_operator(A, mesh, dtype=f64)
    solve("a", lambda **o: pcg(op, bd, M=JacobiPrecond(dinv),
                               **{**PARALLEL_RUNS["a"], **o}), A, b, "a",
          f"Jacobi-PCG over dist_operator(poisson_2d({PAR_NX}))")
    del op, dinv
    t0 = time.perf_counter()
    hs0 = setup_structured(A, headline_param(), dtype=f64, smooth_p=True,
                           device=dev)
    op2 = dist_dia_operator(A, mesh, dtype=f64)
    hs = shard_hierarchy(hs0, mesh)
    say(f"  structured setup + placement {time.perf_counter() - t0:.2f} s; "
        f"levels {[lvl.A.shape[0] for lvl in hs.levels]}, sharded "
        f"{hs.sharded_levels}, operators "
        f"{[type(lvl.A).__name__ for lvl in hs.levels]}")
    rb = solve("b", lambda **o: pcg(op2, bd, M=AMGPrecond(hs),
                                    **{**PARALLEL_RUNS["b"], **o}), A, b,
               "b", "AMG-PCG, dist_dia_operator + shard_hierarchy")
    check(counts["b"]["float64"] > 0, "(b) launched the f64 stencil kernel")
    hh, cmaps = halo_shard_hierarchy(hs0, mesh)
    rc = solve("c", lambda **o: pcg(hh.levels[0].A, bd, M=AMGPrecond(hh),
                                    **{**PARALLEL_RUNS["b"], **o}), A, b,
               "b", "AMG-PCG through halo_shard_hierarchy's fine operator")
    check(rc.iters == rb.iters, f"(c) {rc.iters} iterations = (b) "
          f"{rb.iters}")
    check(counts["c"]["float64"] > 0, "(c) launched the f64 stencil kernel")
    del op2, hs
    t0 = time.perf_counter()
    hrs = setup_rs(A, AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                               polynomial_degree=2, coarse_dof=60),
                   dtype=f64, device=dev)
    hh2, cm2 = halo_shard_hierarchy(hrs, mesh, min_size=n // 2)
    say(f"  RS setup + placement {time.perf_counter() - t0:.2f} s; levels "
        f"{[lvl.A.shape[0] for lvl in hh2.levels]}")
    check(not cm2[0].replicated and cm2[0].halo > 0,
          "the RS fine level takes the halo operator")
    solve("d", lambda **o: pcg(hh2.levels[0].A, bd, M=AMGPrecond(hh2),
                               **{**PARALLEL_RUNS["d"], **o}), A, b, "d",
          "RS AMG-PCG through halo_shard_hierarchy",
          atomic="the RS coarse levels' COO transfers add with index_add_")
    Ab = block_poisson_3d(PAR_BSR_NX, nb=3)
    bb = Ab.matvec(np.ones(Ab.nrow))
    t0 = time.perf_counter()
    hb = replicate(setup_ua_bsr(Ab, AMGParam(AMG_type=int(AMGType.UA),
                                             coarse_dof=30), dtype=f64),
                   mesh)
    opb = shard_block_rows(device_operator(Ab, dtype=f64), mesh)
    bbd = shard_vector(as_tensor(bb, f64), mesh)
    say(f"  UA-BSR setup + placement {time.perf_counter() - t0:.2f} s")
    solve("e", lambda **o: vfgmres(opb, bbd, M=AMGPrecond(hb),
                                   **{**PARALLEL_RUNS["e"], **o}), Ab, bb,
          "e", f"vFGMRES(30) over shard_block_rows(block_poisson_3d("
          f"{PAR_BSR_NX}, nb=3)) ({Ab.nrow} dof), replicated UA-BSR",
          atomic="UA-BSR's restriction adds with index_add_")
    say("  warm resident / eager loop s, " + ", ".join(
        f"({k}) {readings[k]['warm_s']:.4f} / {readings[k]['eager_s']:.4f}"
        for k in "abcde" if "warm_s" in readings[k]) + f"; {smi}")
    del opb, hb
    say("  (f) communication of one whole cycle (c), (d); CommMaps")
    for key, h, maps in (("c", hh, cmaps), ("d", hh2, cm2)):
        rec = cycle_comm_pattern(h, mesh)
        assert_neighbor_comm_only(rec, n)
        say(f"    ({key}) {rec.summary()}")
        say(f"    ({key}) CommMaps {[tuple(vars(m).values()) for m in maps]}")
        readings[f"f_{key}"] = rec.summary()
    say(f"  (g) dryrun_multichip({ws})")
    reset_counts()
    with loop_solves(torch) as seen:
        readings["g"] = dryrun_multichip(ws)
    counts["g"] = launch_counts()
    say(f"    {readings['g']}, launches {counts['g']}")
    bad = check_loop_resident(
        torch, device, "(g)", seen,
        atomic="the RS and UA-BSR transfers add with index_add_")
    check(not bad, f"(g) every loop resident: {bad}")
    # one solve under the profiler: the device's busy share.  The eager
    # loop: CUPTI sees only part of a conditional node's body
    with graphs.eager():
        readings["busy"] = _traced_solve(torch, device, hh, bd)
    say(f"  (c) traced, as the eager loop: wall "
        f"{readings['busy']['wall_s']:.3f} s, device kernels "
        f"{readings['busy']['kernel_s'] * 1e3:.1f} ms, busy share "
        f"{readings['busy']['busy_share']:.4f}")
    readings["released"], readings["teardown_s"] = parallel_teardown(mesh)
    say(f"  teardown with the phase's modules alive: "
        f"{readings['released']} programs released, then the group "
        f"destroyed, {readings['teardown_s']:.4f} s (120 s watchdog)")
    check(readings["released"] > 0, "the teardown released the programs "
          "kept for the phase's live modules")
    return counts, readings


def parallel_teardown(mesh):
    """(programs released, s): every kept program whose capture may hold
    a collective of the mesh's groups released (``graphs.release``), then
    the group taken down (``release_mesh``), under a watchdog: a hang
    ends the run with a traceback after 120 s."""
    import faulthandler
    from faspsolver_tpu_torch.parallel import release_mesh
    from faspsolver_tpu_torch.utils import graphs
    faulthandler.dump_traceback_later(120, exit=True)
    try:
        t0 = time.perf_counter()
        n = sum(graphs.release(g) for g in mesh.get_all_groups())
        release_mesh()
        return n, time.perf_counter() - t0
    finally:
        faulthandler.cancel_dump_traceback_later()


def _traced_solve(torch, device, hh, bd):
    """Solve (c) once more inside profiling.trace: kernel time over wall
    time from the trace file."""
    import glob
    import os
    import shutil
    import tempfile
    from faspsolver_tpu_torch.krylov import pcg
    from faspsolver_tpu_torch.parallel.comm import whole
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.utils import profiling
    tmp = tempfile.mkdtemp()
    try:
        with profiling.trace(tmp):
            sync(torch, device)
            t0 = time.perf_counter()
            res = pcg(hh.levels[0].A, bd, M=AMGPrecond(hh),
                      **PARALLEL_RUNS["b"])
            whole(res.x).cpu()
            wall = time.perf_counter() - t0
        files = glob.glob(os.path.join(tmp, "*.json"))
        check(len(files) == 1, f"one trace file: {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernel_us = sum(e.get("dur", 0) for e in events
                    if e.get("cat") == "kernel")
    check(kernel_us > 0, "the trace holds device kernels")
    return {"wall_s": wall, "kernel_s": kernel_us / 1e6,
            "busy_share": kernel_us / 1e6 / wall, "iters": res.iters}


def parallel_path(torch, device, smi=""):
    """Phase 13 on one rank of this card over NCCL (a one-rank group,
    taken down at its end with its modules alive: ``parallel_teardown``;
    here too if it raised).  The script needs one card; on more, the
    phase still runs one rank: 1023^2 = 3^2 11^2 31^2 rows and the 64^3
    block path's 2^18 block rows share no divisor above 1, so no larger
    world splits both evenly (the multi-rank exchange is held on four
    gloo CPU ranks, tests/test_torch_parallel.py, and on one NCCL rank
    per card where there are two or more, tests/test_torch_gpu.py's
    across_ranks tests, the second at 1024^2).  Returns every kernel's
    launches (by key of :func:`launch_counts`) and the readings."""
    from faspsolver_tpu_torch.parallel import release_mesh
    t0 = time.perf_counter()
    try:
        counts, readings = parallel_solves(torch, device, smi)
    finally:
        release_mesh()
    readings["phase_s"] = time.perf_counter() - t0
    # every kernel's launches: the stencil kernel's by dtype and the loop
    # control's by entry point (launch_counts), as the other phases
    total = {k: sum(c[k] for c in counts.values()) for k in launch_counts()}
    print(f"  phase 13 took {readings['phase_s']:.1f} s at world size "
          f"{readings['world_size']}; launches {total}")
    return total, readings


# ---------------------------------------------------------------------------
# phase 14: the tutorials
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def call_records(targets):
    """While the block runs, every call of a ``name: (owner, attribute)``
    callable is recorded in order: its name, seconds, the seconds the
    drivers' setups took inside it (:func:`setup_spies`) and the stencil
    launches it made."""
    calls = []
    with spied_calls(setup_spies()) as setups:
        saved = {n: getattr(owner, attr)
                 for n, (owner, attr) in targets.items()}

        def wrap(name, fn):
            def call(*args, **kw):
                s0 = sum(r["s"] for r in setups.values())
                l0 = launch_counts()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                calls.append({
                    "call": name, "s": time.perf_counter() - t0,
                    "setup_s": sum(r["s"] for r in setups.values()) - s0,
                    "launches": {k: v - l0[k]
                                 for k, v in launch_counts().items()}})
                return out
            return call

        for name, (owner, attr) in targets.items():
            setattr(owner, attr, wrap(name, saved[name]))
        try:
            yield calls
        finally:
            for name, (owner, attr) in targets.items():
                setattr(owner, attr, saved[name])


def run_tutorial(torch, device, mod, arg):
    """One tutorial's ``main([arg])`` with no device argument: what it
    printed, what it returned, its seconds and launches, and each driver
    call's record (:func:`call_records`)."""
    import importlib
    import io
    from faspsolver_tpu_torch import solvers
    from faspsolver_tpu_torch.ops import stencil2d
    m = importlib.import_module(f"tutorials_torch.{mod}")
    if mod == "poisson_its":
        targets = {n: (solvers, n) for n in ("krylov", "krylov_diag",
                                             "krylov_ilu", "krylov_amg")}
    else:
        targets = {n: (m, n) for n in ("krylov_amg", "solve_amg",
                                       "poisson_gmg_2d") if hasattr(m, n)}
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with call_records(targets) as calls, contextlib.redirect_stdout(buf):
        out = m.main([arg])
    sync(torch, device)
    secs = time.perf_counter() - t0
    return buf.getvalue(), out, secs, launch_counts(), calls


def tutorials_path(torch, device, tmp):
    """Phase 14: the six tutorials of tutorials_torch/ at full width, each
    through its ``main`` with no device argument (the card): the FE and
    SPE01 files written by :func:`write_tutorial_data` into the directory
    ``tmp`` (phase 15 reads the SPE01 pair there), fast_path at NX.
    Every printed row is held to its JAX CPU anchor (TUTORIAL_ANCHORS);
    each row's setup and solve seconds and launches are printed.
    Returns the launches and the readings."""
    import re
    t0 = time.perf_counter()
    counts = {"float32": 0, "float64": 0, "loop_control": 0,
              "gmres": 0, "mg": 0, "gcr": 0}
    readings, got = {}, {}
    readings["write_s"] = write_tutorial_data(tmp)
    print(f"  FE and SPE01 files written in {readings['write_s']:.1f} s")
    for mod, _ in TUTORIALS:
        text, out, secs, launches, calls = run_tutorial(
            torch, device, mod, str(NX) if mod == "fast_path" else tmp)
        for ln in text.splitlines():
            print(f"  | {ln}")
        rows = tutorial_lines(text)
        check(len(rows) == max(1, len(calls)),
              f"{mod}: one result line per driver call: {rows}")
        results = (list(out.values()) if isinstance(out, dict)
                   else [out])
        if mod != "fast_path":
            check(all(r.x.device.type == torch.device(device).type
                      for r in results),
                  f"{mod}: the solves ran on {device}")
        for label, call in zip(rows, calls):
            rows[label].update(
                setup_s=call["setup_s"], solve_s=call["s"]
                - call["setup_s"], launches=call["launches"])
            print(f"  {label}: host setup {call['setup_s']:.3f} s, "
                  f"solve (device setup included) "
                  f"{call['s'] - call['setup_s']:.3f} s, stencil "
                  f"launches {call['launches']}")
        if mod == "fast_path":
            setup_s, cold, warm = map(float, re.search(
                r"setup ([.0-9]+)s.*cold ([.0-9]+), warm ([.0-9]+)",
                text, re.S).groups())
            rows["refined solve"].update(setup_s=setup_s,
                                         cold_solve_s=cold, solve_s=warm)
        for k in counts:
            counts[k] += launches.get(k, 0)
        print(f"  {mod}: {secs:.1f} s (the files read included), "
              f"stencil launches {launches}")
        readings[mod] = {"s": secs, "launches": launches, "rows": rows}
        if mod == "fast_path":
            readings[mod]["result"] = {"rounds": out.rounds,
                                       "syncs": out.syncs}
        got.update(rows)
    if torch.device(device).type == "cuda":
        check(readings["fast_path"]["launches"]["float32"] > 0,
              "fast_path launched the f32 kernel")
        # fast_path refines on the host, as the JAX tutorial does: per
        # round one resident inner PCG (one launch, one read) and the
        # round's x to the host
        fp = readings["fast_path"]["result"]
        check(fp["syncs"] == 2 * fp["rounds"],
              f"fast_path: one read per inner solve and one per round: "
              f"{fp}")
        check(readings["poisson_its"]["rows"]["CG+ILU"]["launches"][
            "float64"] > 0, "CG+ILU launched the f64 kernel")
    misses = tutorial_misses(got, TUTORIAL_ANCHORS)
    check(not misses, f"every tutorial row at its JAX anchor: {misses}")
    readings["phase_s"] = time.perf_counter() - t0
    print(f"  phase 14 took {readings['phase_s']:.1f} s; stencil launches "
          f"{counts}")
    return counts, readings


# ---------------------------------------------------------------------------
# phase 15: the headline benchmark (bench_torch.py)
# ---------------------------------------------------------------------------

BENCH_STANZAS = ("", "general_", "fe_auto_")     # the graphed timed solves
BENCH_CHAINS = ("spmv", "stream", "stream_hbm", "spmv_hbm")


def bench_misses(d, spe01_anchor=None):
    """What phase 15 refuses in bench_torch.py's ``detail`` on the card
    (empty: nothing): an ``*_error`` key, a stanza not converged, a count
    away from its anchor (headline ANCHOR's rounds and within 3 of its
    inner iterations; general <= 3 rounds and within 3 of
    GENERAL_ANCHOR; fe_auto within 3 of FE_AUTO_ANCHOR; SPE01 within
    max(2, 5%) of ``spe01_anchor``, default BENCH_SPE01_ANCHOR), a timed
    solve that was not one program launch with one host read and
    loop-control launches, or that captured a graph, an SPE01 inner
    solve that was not one program launch and one host read, a headline
    without
    both kernel dtypes, a marginal-time chain of k applies without k
    stencil launches per rep."""
    anchor = BENCH_SPE01_ANCHOR if spe01_anchor is None else spe01_anchor
    bad = [f"{k}: {v}" for k, v in d.items() if k.endswith("_error")]
    bad += [f"{k}: {d.get(k)}" for k in ("converged", "general_converged",
                                          "fe_auto_converged",
                                          "spe01_converged")
            if d.get(k) is not True]

    def near(key, want, allow):
        got = d.get(key)
        if not isinstance(got, int) or abs(got - want) > allow:
            bad.append(f"{key} {got}, not within {allow} of {want}")

    if d.get("refine_rounds") != ANCHOR["rounds"]:
        bad.append(f"refine_rounds {d.get('refine_rounds')}, not "
                   f"{ANCHOR['rounds']}")
    near("inner_iters", ANCHOR["inner_iters"], 3)
    if not isinstance(d.get("general_rounds"), int) \
            or d["general_rounds"] > 3:
        bad.append(f"general_rounds {d.get('general_rounds')} > 3")
    near("general_inner_iters", GENERAL_ANCHOR["inner_iters"], 3)
    near("fe_auto_inner_iters", FE_AUTO_ANCHOR["inner_iters"], 3)
    near("spe01_inner_iters", anchor, max(2, round(0.05 * anchor)))
    for p in BENCH_STANZAS:
        # a resident solve: one program launch, one host read, and the
        # loop-control kernel ran in it
        for key in ("graph_replays", "host_syncs"):
            if d.get(f"{p}{key}") != 1:
                bad.append(f"{p}{key} {d.get(f'{p}{key}')}, not 1")
        if not d.get(f"{p}loop_control_launches"):
            bad.append(f"{p}loop_control_launches "
                       f"{d.get(f'{p}loop_control_launches')}")
        if d.get(f"{p}graph_captures") != 0:
            bad.append(f"{p}graph_captures {d.get(f'{p}graph_captures')} "
                       f"in a timed solve")
    # SPE01's inner vFGMRES over UA-BSR resident: one program launch per
    # inner solve, and one host read each beside the refinement's own
    solves = d.get("spe01_inner_solves")
    if not (isinstance(solves, int) and solves > 0
            and d.get("spe01_graph_replays") == solves
            and d.get("spe01_host_syncs") == 2 * solves):
        bad.append(f"SPE01 not resident: {solves} inner solves, "
                   f"{d.get('spe01_graph_replays')} program launches, "
                   f"{d.get('spe01_host_syncs')} host reads")
    launches = d.get("stencil_launches") or {}
    if not (launches.get("float32") and launches.get("float64")):
        bad.append(f"headline stencil_launches {launches}")
    chains = d.get("chain_launches_per_rep") or {}
    for label in BENCH_CHAINS:
        per = chains.get(label, {})
        if per != {"1": 1, "8": 8}:
            bad.append(f"chain {label}: stencil launches per rep {per}")
    return bad


def bench_path(torch, device, tmp):
    """Phase 15: ``python bench_torch.py`` as a subprocess on the card,
    its SPE01 stanza on the pair in ``tmp`` (FASP_REFDATA; written by
    :func:`write_spe01_data` when phase 14 has not).  Prints the
    subprocess's readings and every key of its JSON line, holds them to
    :func:`bench_misses`; returns the launches of its three timed solves
    and the readings."""
    import gc
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(tmp, "bsrmat_SPE01.dat")):
        print(f"  SPE01 pair written in {write_spe01_data(tmp):.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "bench_torch.py")], cwd=root,
        env=dict(os.environ, FASP_REFDATA=tmp), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT)
    lines = proc.stdout.splitlines()
    for ln in lines[:-1]:
        print(f"  | {ln}")
    check(proc.returncode == 0 and lines,
          f"bench_torch.py exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(lines[-1])
    d = line["detail"]
    print(f"  {line['metric']} = {line['value']} {line['unit']}, "
          f"vs_baseline {line['vs_baseline']}")
    for k, v in d.items():
        print(f"  {k}: {v}")
    misses = bench_misses(d)
    check(not misses, f"bench_torch.py's readings: {misses}")
    counts = {dt: sum(d[f"{p}stencil_launches"][dt] for p in BENCH_STANZAS)
              for dt in ("float32", "float64")}
    phase_s = time.perf_counter() - t0
    print(f"  phase 15 took {phase_s:.1f} s; stencil launches of the timed "
          f"solves {counts}")
    return counts, {"value": line["value"],
                    "vs_baseline": line["vs_baseline"], "detail": d,
                    "phase_s": phase_s}


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


def scalar_op(torch, dims, coords, coefs, dtype):
    """A constant-coefficient StencilNdOperator on the card (K1's form)."""
    import numpy as np
    from faspsolver_tpu_torch.ops.operators import StencilNdOperator
    np_dt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return StencilNdOperator([np.full((1, 1), c, dtype=np_dt) for c in coefs],
                             coords, dims).to("cuda")


def conv2d_library(torch, op):
    """``F.conv2d`` computing a scalar-form operator's apply: a 3 x 3
    weight with each band's coefficient at its offset, padding 1.  cuDNN's
    TF32 convolutions are switched off, so f32 is computed in f32."""
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    ny, nx = op.dims
    weight = torch.zeros(1, 1, 3, 3, dtype=op.dtype, device="cuda")
    for b, (dy, dx) in zip(op.bands, op.coords):
        weight[0, 0, dy + 1, dx + 1] = b.reshape(())
    return lambda v: F.conv2d(v.view(1, 1, ny, nx), weight, padding=1)


def csr_library(torch, op):
    """``A_csr @ x`` computing a 2-D stencil operator's apply: a
    ``torch.sparse_csr_tensor`` of its matrix in its dtype (cuSPARSE's
    SpMV), built on the card from the plan's bands.  Row (i, j) holds
    band k's coefficient at column (i + dy, j + dx) where that lies in
    the grid, a row's columns ascending; int32 indices."""
    plan = op.plan()
    ny, nx = plan.dims
    n, dev = ny * nx, plan.bands[0].w.device
    bands = sorted(zip(plan.coords, plan.bands),
                   key=lambda cb: cb[0][0] * nx + cb[0][1])
    i = torch.arange(ny, device=dev).view(ny, 1)
    j = torch.arange(nx, device=dev).view(1, nx)
    inside = torch.stack([((i + dy >= 0) & (i + dy < ny) & (j + dx >= 0)
                           & (j + dx < nx)).expand(ny, nx).reshape(-1)
                          for (dy, dx), _ in bands], 1)
    cols = torch.stack([((i + dy) * nx + j + dx).expand(ny, nx).reshape(-1)
                        for (dy, dx), _ in bands], 1)[inside]
    vals = torch.stack([b.coef().expand(ny, nx).reshape(-1)
                        for _, b in bands], 1)[inside]
    crow = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    crow[1:] = inside.sum(1).cumsum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "support is in beta state"
        A = torch.sparse_csr_tensor(crow, cols.to(torch.int32), vals,
                                    size=(n, n), check_invariants=False)
    del inside, cols, vals
    return lambda v: A @ v


def apply_times(torch, ops, smi, reps=200, tries=5, eager=True,
                library=False):
    """Per-apply times of each (label, operator) through the kernel and
    through the plain version, in turns: plain, kernel, kernel, plain;
    beside them the roofline bound from the plan's bytes, an empty kernel
    on the kernel's grid, ``torch.mul`` on the same vector (what the card
    does in practice with one read and one write of it), ``A_csr @ x``
    (``csr_library``: cuSPARSE's SpMV of the same matrix, ``csr_ms``) and,
    with ``library``, ``F.conv2d`` (``library_ms``).  Each library call
    is held to the kernel within 1e-5 of the forward-error scale."""
    from faspsolver_tpu_torch.ops import stencil2d
    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, op in ops:
        plan = op.plan()
        x = torch.ones(op.n, dtype=op.dtype, device="cuda")
        grid = stencil2d.stencil_tiling(plan.dims, op.dtype.itemsize,
                                        sms).grid

        def plain(v, plan=plan):
            return stencil2d.stencil2d_plain(v.view(plan.dims), plan.bands,
                                             plan.coords)

        def empty(v, grid=grid):
            stencil2d.launch_empty(grid, v.device)

        def scale(v):
            return v * 0.9995

        ts = {}
        for graph in (True, False) if eager else (True,):
            kw = dict(reps=reps, tries=tries, graph=graph)
            p1 = time_ms(torch, plain, x, **kw)
            k1 = time_ms(torch, plan, x, **kw)
            k2 = time_ms(torch, plan, x, **kw)
            p2 = time_ms(torch, plain, x, **kw)
            ts[graph] = (min(k1, k2), min(p1, p2))
        kg, pg = ts[True]
        bound = stencil2d.stencil_bound_us(plan.dims, op.dtype, plan.bands)
        row = {"ms": kg, "plain_ms": pg, "bound_ms": bound.us / 1e3,
               "bound_by": bound.by, "bytes": bound.bytes, "grid": grid,
               "floor_ms": time_ms(torch, empty, x, reps=reps, tries=tries,
                                   graph=True),
               "elementwise_ms": time_ms(torch, scale, x, reps=reps,
                                         tries=tries, graph=True),
               "library_ms": None}
        text = (f"  {label}: device time (graph replay) kernel "
                f"{kg * 1e3:.2f} us, plain {pg * 1e3:.2f} us, bound "
                f"{bound.us:.2f} us ({bound.bytes / 1e6:.2f} MB, by "
                f"{bound.by}; kernel at {bound.us / (kg * 1e3):.0%} of it, "
                f"{bound.bytes / kg / 1e9:.3f} TB/s), empty kernel on "
                f"{grid} blocks {row['floor_ms'] * 1e3:.2f} us, torch.mul "
                f"(x read once, y written once: the scalar and factored "
                f"forms' traffic) {row['elementwise_ms'] * 1e3:.2f} us")
        scale = stencil_bound(op, x)
        csr = csr_library(torch, op)
        err = float((csr(x) - plan(x)).abs().max())
        check(err <= 1e-5 * scale,
              f"A_csr @ x computes the same function: {label}: {err}")
        row["csr_ms"] = time_ms(torch, csr, x, reps=reps, tries=tries,
                                graph=True)
        del csr
        text += (f", library A_csr @ x (cuSPARSE SpMV, int32 indices) "
                 f"{row['csr_ms'] * 1e3:.2f} us (CSR / kernel "
                 f"{row['csr_ms'] / kg:.2f})")
        if library:
            lib = conv2d_library(torch, op)
            err = float((lib(x).reshape(-1) - plan(x)).abs().max())
            check(err <= 1e-5 * scale,
                  f"conv2d computes the same function: {label}: {err}")
            row["library_ms"] = time_ms(torch, lib, x, reps=reps,
                                        tries=tries, graph=True)
            text += (f", library F.conv2d (cudnn.allow_tf32=False) "
                     f"{row['library_ms'] * 1e3:.2f} us")
        if eager:
            ke, pe = ts[False]
            text += (f"; eager (host enqueue included) kernel "
                     f"{ke * 1e3:.2f} us, plain {pe * 1e3:.2f} us")
        print(f"{text} per apply (best of {tries} x {reps}, CUDA events; "
              f"{smi})")
        rows[label] = row
    return rows


def form_times(torch, device, smi):
    """Phase 5's rows beyond the main paths' operators: the scalar form
    (K1's) with its library call and the full form (K2's) at 1023^2, then
    the scalar 5-point stencil and the 1-band stream probe above the L2
    (4096^2, 8192^2: bench.py's HBM probes), each with its library call,
    few repetitions there since every apply in a captured graph keeps its
    own y."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    coefs5 = (-0.2499, -0.2499, 0.99999, -0.2499, -0.2499)
    rows = {}
    for dt, tdt in (("f32", torch.float32), ("f64", torch.float64)):
        rows.update(apply_times(torch, [
            (f"1023^2 {dt} scalar 5-pt",
             scalar_op(torch, (NX, NX), coords_5pt(), coefs5, tdt))],
            smi, eager=False, library=True))
        rows.update(apply_times(torch, [
            (f"1023^2 {dt} full 5-pt",
             make_op("full", (NX, NX), coords_5pt(), dt, rng).to(device))],
            smi, eager=False))
    for nh in (4096, 8192):
        rows.update(apply_times(torch, [
            (f"{nh}^2 f32 scalar 5-pt",
             scalar_op(torch, (nh, nh), coords_5pt(), coefs5,
                       torch.float32)),
            (f"{nh}^2 f32 scalar 1-band stream probe",
             scalar_op(torch, (nh, nh), ((0, 1),), (0.9995,),
                       torch.float32))],
            smi, reps=10, tries=3, eager=False, library=True))
        torch.cuda.empty_cache()
    return rows


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    profile = "--profile" in argv
    t0 = time.perf_counter()

    last = [t0]

    def banner(text):
        """A phase's header, with the seconds since the run began and
        those the phase before it took."""
        now = time.perf_counter()
        print(f"== {text}  [{now - t0:.1f} s; the phase before "
              f"{now - last[0]:.1f} s]", flush=True)
        last[0] = now

    banner("1. card")
    smi = card_info(torch)
    banner("2. build")
    build()
    banner("3. kernels against their plain versions")
    worst = check_kernel(torch, device)
    loop_row = check_loop_control(torch, device, smi)
    loop_row.update(check_mg_control(torch, device, smi))
    gmres_row = check_gmres_control(torch, device, smi)
    gcr_row = check_gcr_control(torch, device, smi)
    if "--kernel-only" in argv:
        print("stopped after phase 3 (--kernel-only)")
        return 0
    if "--block-only" in argv:
        banner("9. main path: block and factorization preconditioners")
        with gmres_solves(torch) as seen:
            block_path(torch, device, smi)
        check_gmres_resident(torch, device, 9, seen)
        print("stopped after phase 9 (--block-only)")
        return 0
    if "--surface-only" in argv:
        banner("10. main path: the solver surface")
        with mg_solves(torch) as mg_seen:
            surface_path(torch, device, smi)
        check_mg_resident(torch, device, 10, mg_seen)
        print("stopped after phase 10 (--surface-only)")
        return 0
    if "--harness-only" in argv:
        banner("11. main path: the benchmark harness, checkpoint and "
              "profiling")
        with gmres_solves(torch) as seen:
            harness_path(torch, device)
        check_gmres_resident(torch, device, 11, seen)
        print("stopped after phase 11 (--harness-only)")
        return 0
    if "--regression-only" in argv:
        banner("12. main path: the regression runner")
        with gmres_solves(torch) as seen, mg_solves(torch) as mg_seen, \
                gcr_solves(torch) as gcr_seen:
            regression_path(torch, device)
        check_gmres_resident(torch, device, 12, seen)
        check_mg_resident(torch, device, 12, mg_seen)
        check_gcr_resident(torch, device, 12, gcr_seen)
        print("stopped after phase 12 (--regression-only)")
        return 0
    if "--parallel-only" in argv:
        banner("13. main path: the distribution layer")
        parallel_path(torch, device, smi)
        print("stopped after phase 13 (--parallel-only)")
        return 0
    if "--tutorials-only" in argv:
        banner("14. main path: the tutorials")
        with tempfile.TemporaryDirectory() as tmp:
            with gmres_solves(torch) as seen, mg_solves(torch) as mg_seen:
                tutorials_path(torch, device, tmp)
            check_gmres_resident(torch, device, 14, seen)
            check_spe01_resident(torch, device, seen)
            check_mg_resident(torch, device, 14, mg_seen)
        print("stopped after phase 14 (--tutorials-only)")
        return 0
    if "--bench-only" in argv:
        banner("15. main path: the headline benchmark (bench_torch.py)")
        with tempfile.TemporaryDirectory() as tmp:
            bench_path(torch, device, tmp)
        print("stopped after phase 15 (--bench-only)")
        return 0
    counts, res = {}, {}
    banner("4. main path: headline")
    hier, counts["headline"], res["headline"] = main_path(torch, device,
                                                          profile)
    small_reference_check(torch, device)
    banner("5. per-apply times")
    times = apply_times(torch, (
        ("1023^2 f32 factored 5-pt", hier.levels[0].A),
        ("341^2 f32 factored 9-pt", hier.levels[1].A),
        ("1023^2 f64 factored 5-pt", hier.fine64)), smi)
    del hier
    times.update(form_times(torch, device, smi))
    banner("6. main path: general (classical RS-AMG, P1-FE)")
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
    banner("7. main path: fe_auto (structured SA-AMG, P1-FE)")
    counts["fe_auto"], res["fe_auto"] = fe_auto_path(torch, device, A, b)
    del A, b
    banner("8. main path: drivers (the ini CLI, then the small grid)")
    with gmres_solves(torch) as seen, gcr_solves(torch) as gcr_seen:
        counts["drivers"], res["drivers"] = drivers_path(torch, device)
    check_gmres_resident(torch, device, 8, seen)
    check_gcr_resident(torch, device, 8, gcr_seen)
    gcr_row["gcg_step_ms"] = gcg_step_times(torch, device, smi)
    banner("9. main path: block and factorization preconditioners")
    with gmres_solves(torch) as seen:
        counts["block_and_factorization"], \
            res["block_and_factorization"] = block_path(torch, device, smi)
    check_gmres_resident(torch, device, 9, seen)
    banner("10. main path: the solver surface")
    with mg_solves(torch) as mg_seen:
        counts["solver_surface"], res["solver_surface"] = surface_path(
            torch, device, smi)
    check_mg_resident(torch, device, 10, mg_seen)
    banner("11. main path: the benchmark harness, checkpoint and "
          "profiling")
    # the whole run keeps to its time budget with ten corpus rows;
    # --harness-only runs all twenty
    with gmres_solves(torch) as seen:
        counts["harness"], res["harness"] = harness_path(torch, device,
                                                         corpus_rows=10)
    check_gmres_resident(torch, device, 11, seen)
    banner("12. main path: the regression runner")
    with gmres_solves(torch) as seen, mg_solves(torch) as mg_seen, \
            gcr_solves(torch) as gcr_seen:
        counts["regression"], res["regression"] = regression_path(torch,
                                                                  device)
    check_gmres_resident(torch, device, 12, seen)
    check_mg_resident(torch, device, 12, mg_seen)
    check_gcr_resident(torch, device, 12, gcr_seen)
    banner("13. main path: the distribution layer")
    counts["distribution"], res["distribution"] = parallel_path(
        torch, device, smi)
    with tempfile.TemporaryDirectory() as tmp:
        banner("14. main path: the tutorials")
        with gmres_solves(torch) as seen, mg_solves(torch) as mg_seen:
            counts["tutorials"], res["tutorials"] = tutorials_path(
                torch, device, tmp)
        check_gmres_resident(torch, device, 14, seen)
        check_spe01_resident(torch, device, seen)
        check_mg_resident(torch, device, 14, mg_seen)
        banner("15. main path: the headline benchmark (bench_torch.py)")
        counts["bench"], res["bench"] = bench_path(torch, device, tmp)

    # one entry per kernel, stencil2d<T, K> by element type (the band
    # count K is the operator's); its times are those of the main paths'
    # 1023^2 5-point factored operator, library_ms that of the same
    # operator's matrix as a CSR tensor times x (cuSPARSE's SpMV); every
    # timed shape is under "shapes" (F.conv2d's time on the scalar ones)
    src = "faspsolver_tpu_torch/csrc/stencil2d.cu"
    kernels = []
    for dt, tname, cname, repl, also in (
            ("f32", "float", "float32", "k1", "k2"),
            ("f64", "double", "float64", "k2", "k1")):
        main_row = times[f"1023^2 {dt} factored 5-pt"]
        by_path = {path: c[cname] for path, c in counts.items()}
        kernels.append({
            "name": f"stencil2d<{tname}>", "route": "cuda",
            "source": src, "replaces": REPLACES[repl],
            "also_replaces": REPLACES[also],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst[dt],
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
            "library_ms": main_row["csr_ms"],
            "library_of": f"A_csr @ x (cuSPARSE SpMV) on the 1023^2 {dt} "
                          f"factored 5-pt operator",
            "shapes": {label: row for label, row in times.items()
                       if f" {dt} " in label}})
    by_path = {path: c.get("loop_control", 0) for path, c in counts.items()}
    mg_by_path = {path: c.get("mg", 0) for path, c in counts.items()}
    kernels.append({**loop_row, "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "mg_launches": sum(mg_by_path.values()),
                    "mg_launches_by_path": mg_by_path})
    by_path = {path: c.get("gmres", 0) for path, c in counts.items()}
    kernels.append({**gmres_row, "launches": sum(by_path.values()),
                    "launches_by_path": by_path})
    by_path = {path: c.get("gcr", 0) for path, c in counts.items()}
    check(sum(by_path.values()) > 0, "the gcr control ran on the paths")
    kernels.append({**gcr_row, "launches": sum(by_path.values()),
                    "launches_by_path": by_path})
    print(json.dumps({"kernels": kernels, "main_paths": res}))
    print(f"chip_smoke: all phases in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
