"""Run chip_smoke.py's driver grids through either package's drivers on
the CPU in float64, to record the JAX package's iteration counts (the
anchors the port is held to on the card).

    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py            # phase 8
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py leftover   # phase 9d
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py bsr 64     # phase 9a
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py cli 4 1023 # phase 9b/c
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py str 64     # phase 10a
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py blc 64     # phase 10b
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py sweep 96 12
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py gmg 1024 128  # 10c
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py surface 1023  # 10d
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py matfree 1e-13
    python tests/small_grid_anchors.py matfree 1e-13 cuda   # on the card
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py harness gen f64
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py harness gen f32
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py harness gen f64 101
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py harness corpus f64
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py fallbacks
    python tests/small_grid_anchors.py fallbacks port 2
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py regression core
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py regression mm
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py regression bsr
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py regression matfree
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py parallel 1023
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py gcg-floor
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py tutorials <dir>
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py bench-spe01 64

``small`` (the default) prints the count of every ``chip_smoke.SMALL_GRID``
config on poisson_fe_manufactured(64) (3,969 dof), ``leftover`` those of
``chip_smoke.LEFTOVER_GRID`` on the same problem, ``bsr <nx>`` those of
``chip_smoke.BSR_GRID`` on block_poisson_3d(nx, nb=3), and ``cli <precond>
<size> [key=value ...]`` the JAX CLI's count on ini/input.dat with the
given preconditioner id, grid size and ini overrides (as chip_smoke's
phases 9b and 9c write them into a temporary ini).  ``str <nx>``,
``blc <nx>`` and ``sweep <n> <slabs>`` print the counts of
``chip_smoke.STR_GRID``, ``BLC_GRID`` and ``SWEEP_GRID`` on
``str_problem(nx)``, ``blc_problem(nx)`` and ``sweep_problem(n, slabs)``;
``gmg <n2> <n3>`` those of ``chip_smoke.GMG_GRID``; ``surface <nx>`` the
matrix-free runs (``MATFREE_GRID`` on the small grid, the stencil
operator at nx^2), ``maxeig`` at nx^2 and the C API (``CAPI_GRID``: CSR
at nx^2, BSR on ``bsr_problem()``).  ``matfree <tol>`` prints
``MATFREE_GRID``'s counts at ``tol`` through both packages on the CPU,
``matfree <tol> cuda`` the port's on the CUDA device without JAX.
``harness gen|corpus f64|f32`` runs the JAX package's benchmark harness
(phase 11's anchors) and imports nothing of the port; ``harness gen f64
<n> ...`` only its 3-D rows at those sizes (``101`` the 1,030,301-dof
row, some 20 minutes a precision).  ``fallbacks``
runs the JAX package's f32 refined mode on ``chip_smoke.FALLBACK_CASES``
(phase 11f's ``FALLBACK_ANCHORS``, with each stage's rounds and inner
solves); ``fallbacks port [threads]`` the port's on the CPU, without
JAX, in the CPU's GMRES arithmetic and in the card's.
``regression core|mm|bsr|matfree`` runs the JAX package's regression
runner (``run_matrix``) over ``chip_smoke.regression_problems`` and
prints every row as phase 12's ``REGRESSION_ANCHORS`` holds it;
``parallel <nx>`` prints the JAX package's one-device counts of phase
13's solves (``chip_smoke.PARALLEL_RUNS``) at nx^2 (and 64^3 blocks);
``gcg-floor`` the MatrixMarket grid's GCG rows jitted and as an eager
JAX loop (``chip_smoke.REGRESSION_FLOOR``).
``tutorials <dir> [name ...]`` runs the JAX tutorials (``tutorials/``,
all of ``chip_smoke.TUTORIALS`` or the named ones) on the files
``chip_smoke.write_tutorial_data`` writes into ``<dir>`` (written there
unless ``csrmat_FE.dat`` is), tpu_fast_path at ``chip_smoke.NX``, and
prints phase 14's ``TUTORIAL_ANCHORS``.
``bench-spe01 <nx>`` writes ``bsr_problem(nx)`` as the SPE01 pair by the
port's writers (``chip_smoke.write_spe01_data``, as phase 15 hands it to
``bench_torch.py``), reads it back by the JAX package's readers and runs
bench.py's SPE01 stanza through the JAX package: phase 15's
``BENCH_SPE01_ANCHOR``.
``tests/test_torch_drivers.py`` runs the port's side with :func:`run`.
Not collected by pytest (no ``test_`` prefix).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def problem():
    from faspsolver_tpu_torch.testgen import poisson_fe_manufactured
    A, b, *_ = poisson_fe_manufactured(64)
    return A, b


def _packages(pkg: str):
    if pkg == "jax":
        import faspsolver_tpu.solvers.drivers as solvers
        from faspsolver_tpu.utils import params
    else:
        import faspsolver_tpu_torch.solvers as solvers
        from faspsolver_tpu_torch.utils import params
    return solvers, params


def _to_jax(A):
    """The JAX package's container of a port CSR, BSR, STR or BLC
    matrix."""
    from faspsolver_tpu import formats
    cls = getattr(formats, type(A).__name__)
    name = type(A).__name__
    if name == "STRMatrix":
        return cls(A.nx, A.ny, A.nz, A.nc, A.diag, A.offsets, A.offdiag)
    if name == "BLCMatrix":
        return cls([[None if b is None else _to_jax(b) for b in row]
                    for row in A.blocks])
    return cls(A.indptr, A.indices, A.data, A.shape)


def run_fields(pkg: str, driver: str, fields: dict, A, b):
    """One driver call through ``pkg`` ("jax" or "port") with the
    parameter objects built from ``fields`` (its / amg / ilu / swz dicts,
    ``nk``: the component-wise constant basis): the SolveResult and x as
    a NumPy array."""
    solvers, params = _packages(pkg)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    for key, cls in (("its", params.ITSParam), ("amg", params.AMGParam),
                     ("ilu", params.ILUParam), ("swz", params.SWZParam)):
        if fields.get(key) is not None:
            kw[key] = cls(**fields[key])
    args = [_to_jax(A) if pkg == "jax" else A, b]
    if fields.get("nk"):
        args.append(chip_smoke.component_basis(A.nrow, A.nb))
    kw.update(fields.get("kw", {}))
    res = getattr(solvers, driver)(*args, **kw)
    res = res[0] if isinstance(res, tuple) else res
    x = np.asarray(res.x) if pkg == "jax" else res.x.numpy()
    return res, x


def run(pkg: str, cfg, A, b):
    """One SMALL_GRID config (name, driver, its, amg, ...)."""
    _, driver, its, amg, *_ = cfg
    return run_fields(pkg, driver, dict(its=its, amg=amg), A, b)


def _step_ok(A, o):
    """(ng,) bool: whether the step from grid point g to g + o stays on the
    nx x ny x nz grid, o decomposed as dx + nx dy + nx ny dz with every
    step in {-1, 0, 1} (the 7-point stencil and the ILU(1) fill it
    makes)."""
    nx, ny, nz = A.nx, A.ny, A.nz
    hits = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1) if dx + nx * dy + nx * ny * dz == o]
    assert len(hits) == 1, (o, hits)
    g = np.arange(A.ngrid)
    ok = np.ones(A.ngrid, dtype=bool)
    for c, d, n in zip((g % nx, g // nx % ny, g // (nx * ny)), hits[0],
                       (nx, ny, nz)):
        ok &= (c + d >= 0) & (c + d < n)
    return ok


def _anchor_solver(bands, tri, ng, nc, lower, ok):
    """One triangle of the JAX factor's bands as JAX ``_BTriLevel``s, on
    the longest-path levels of the dependencies that stay on the grid
    (node by node, as the JAX package's ``_grid_wavefronts`` walks
    them)."""
    import jax.numpy as jnp
    from faspsolver_tpu.precond.ilu import BlockTriangularSolver, _BTriLevel
    lvl = np.zeros(ng, dtype=np.int64)
    deps = [(o, ok[o].tolist()) for o in tri]
    for g in (range(ng) if lower else range(ng - 1, -1, -1)):
        lvl[g] = max([lvl[g + o] + 1 for o, m in deps if m[g]], default=0)
    order = np.argsort(lvl, kind="stable")
    bounds = np.searchsorted(lvl[order], np.arange(lvl.max() + 2))
    dinv = None if lower else np.linalg.inv(bands[0])
    levels = []
    for a, z in zip(bounds[:-1], bounds[1:]):
        rows = order[a:z]
        cols = np.full((len(rows), len(tri)), ng, dtype=np.int32)
        blks = np.zeros((len(rows), len(tri), nc, nc))
        for s, o in enumerate(tri):
            sel = ok[o][rows]
            cols[sel, s] = rows[sel] + o
            blks[sel, s] = bands[o][rows[sel]]
        di = np.broadcast_to(np.eye(nc), (len(rows), nc, nc)) if lower \
            else dinv[rows]
        levels.append(_BTriLevel(
            rows=jnp.asarray(rows.astype(np.int32)), cols=jnp.asarray(cols),
            vals=jnp.asarray(blks), dinv=jnp.asarray(di)))
    return BlockTriangularSolver(levels=tuple(levels), n=ng)


def jax_str_ilu(A, fill: int):
    """The JAX package's banded block ILU of an STR matrix (its factor,
    ``str_ilu_factor_banded``), applied by the JAX BlockTriangularSolver
    over the grid's wavefronts.  The JAX setup schedules the solves on
    the 1-D index (262,144 single-row levels per factor at 64^3), which
    JAX cannot trace at that size.  Here every dependency whose step
    leaves the grid is dropped, after checking that the factor's block
    on it is zero: the solves compute the same sums, on 190 levels per
    factor at 64^3."""
    from faspsolver_tpu.precond import str_precond as jax_str
    from faspsolver_tpu.precond.ilu import BSRILUPrecond
    bands, offs = jax_str.str_ilu_factor_banded(_to_jax(A), fill)
    ng = A.ngrid
    g = np.arange(ng)
    ok = {}
    for o in offs:
        if o:
            ok[o] = _step_ok(A, o)
            wraps = ~ok[o] & (g + o >= 0) & (g + o < ng)
            assert not np.any(bands[o][wraps]), f"band {o} wraps"
    lower = sorted(o for o in ok if o < 0)
    upper = sorted(o for o in ok if o > 0)
    return BSRILUPrecond(
        Lsolve=_anchor_solver(bands, lower, ng, A.nc, True, ok),
        Usolve=_anchor_solver(bands, upper, ng, A.nc, False, ok), nb=A.nc)


def str_run(A, b, driver, fields):
    """One STR_GRID entry through the JAX package: its driver, or for
    krylov_ilu its itsolver over :func:`jax_str_ilu`."""
    if driver != "krylov_ilu":
        return run_fields("jax", driver, fields, A, b)
    from faspsolver_tpu.solvers.drivers import itsolver
    from faspsolver_tpu.utils.params import ITSParam
    res = itsolver(_to_jax(A), b, M=jax_str_ilu(A, fields["ilu"]["ILU_lfil"]),
                   its=ITSParam(**fields["its"]))
    return res, np.asarray(res.x)


def _print_grid(label, grid, A, b, run):
    for name, driver, fields, anchor, _ in grid:
        t0 = time.perf_counter()
        res, x = run(A, b, driver, fields)
        relres = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
        print(f"{label} {name:36s} {int(res.iters):5d} iterations, status "
              f"{int(res.status)}, relres {relres:.3e}  (recorded {anchor}; "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)


def _gmg(n2: int, n3: int):
    import jax.numpy as jnp
    from faspsolver_tpu.precond import gmg
    for name, fn, dim, kw, anchor, _ in chip_smoke.GMG_GRID:
        n = n3 if dim == 3 else n2
        f, u = chip_smoke.gmg_problem(n, dim)
        t0 = time.perf_counter()
        res = getattr(gmg, fn)(jnp.asarray(f), n, **kw)
        err = np.abs(np.asarray(res.x) - u).max()
        print(f"n={n} {name:34s} {int(res.iters):4d} iterations, relres "
              f"{float(res.relres):.3e}, max |u - exact| {err:.3e}  "
              f"(recorded {anchor}; {time.perf_counter() - t0:.1f} s)",
              flush=True)


def _surface(nx: int):
    import jax.numpy as jnp
    from faspsolver_tpu import capi, krylov
    from faspsolver_tpu.krylov import JacobiPrecond
    from faspsolver_tpu.ops import MatFreeOperator, device_operator
    from faspsolver_tpu.ops.eigen import maxeig
    from faspsolver_tpu_torch.testgen import poisson_2d
    A, b = problem()
    Aj = _to_jax(A)
    for name, fn, restart, anchor, _ in chip_smoke.MATFREE_GRID:
        op = device_operator(Aj, prefer="ell")
        kw = dict(chip_smoke.MATFREE_ITS)
        if restart:
            kw["restart"] = restart
        res = getattr(krylov, fn)(MatFreeOperator(fn=op, n=A.nrow,
                                                  _dtype=op.dtype),
                                  jnp.asarray(b), M=JacobiPrecond.from_csr(Aj),
                                  **kw)
        print(f"{name:20s} {int(res.iters):5d} iterations, status "
              f"{int(res.status)}  (recorded {anchor})", flush=True)
    P = poisson_2d(nx)
    Pj = _to_jax(P)
    bp = P.matvec(np.random.default_rng(chip_smoke.SEED)
                  .standard_normal(P.nrow))
    op = device_operator(Pj)
    t0 = time.perf_counter()
    res = krylov.pcg(MatFreeOperator(fn=op, n=P.nrow, _dtype=op.dtype),
                     jnp.asarray(bp), M=JacobiPrecond.from_csr(Pj),
                     **chip_smoke.MATFREE_STENCIL)
    print(f"matfree {nx}^2 stencil CG + Jacobi {int(res.iters):5d} "
          f"iterations, status {int(res.status)}  (recorded "
          f"{chip_smoke.MATFREE_STENCIL_ANCHOR[0]}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"maxeig({nx}^2) = {maxeig(Pj)!r}  (recorded "
          f"{chip_smoke.MAXEIG_ANCHOR!r})", flush=True)
    Ab, bb = chip_smoke.bsr_problem(chip_smoke.STR_NX)
    for fn, kw, anchor, _ in chip_smoke.CAPI_GRID:
        t0 = time.perf_counter()
        if fn == "dbsr_krylov_amg":
            out = capi.dbsr_krylov_amg(Ab.nb, Ab.nrow_block, Ab.indptr,
                                       Ab.indices, Ab.data.reshape(-1), bb,
                                       **kw)
        else:
            out = getattr(capi, fn)(P.nrow, P.indptr, P.indices, P.data,
                                    bp, **kw)
        print(f"capi.{fn:16s} {out[1]:5d} iterations, relres {out[2]:.3e}"
              f"  (recorded {anchor}; {time.perf_counter() - t0:.1f} s)",
              flush=True)


def _matfree(tol: float, device: str):
    """``MATFREE_GRID`` at ``tol`` on the small grid: the port's count on
    ``device`` and, on the CPU, the JAX package's beside it, each with
    its status and verified relres."""
    import torch
    from faspsolver_tpu_torch import krylov
    from faspsolver_tpu_torch.krylov import JacobiPrecond
    from faspsolver_tpu_torch.ops import MatFreeOperator, device_operator
    A, b = problem()
    ell = device_operator(A, prefer="ell").to(device)
    M = JacobiPrecond.from_csr(A).to(device)
    bt = torch.from_numpy(b).to(device)

    def relres(x):
        return np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)

    for name, fn, restart, *_ in chip_smoke.MATFREE_GRID:
        kw = dict(chip_smoke.MATFREE_ITS, tol=tol,
                  **({"restart": restart} if restart else {}))
        res = getattr(krylov, fn)(MatFreeOperator(ell, A.nrow, torch.float64),
                                  bt, M=M, **kw)
        line = (f"tol {tol:g} {name:18s} port ({device}) {res.iters:5d} "
                f"iterations, status {res.status}, relres "
                f"{relres(res.x.cpu().numpy()):.3e}")
        if device == "cpu":
            import jax.numpy as jnp
            from faspsolver_tpu import krylov as jax_krylov
            from faspsolver_tpu.krylov import JacobiPrecond as JaxJacobi
            from faspsolver_tpu.ops import MatFreeOperator as JaxMatFree
            from faspsolver_tpu.ops import device_operator as jax_operator
            Aj = _to_jax(A)
            op = jax_operator(Aj, prefer="ell")
            ref = getattr(jax_krylov, fn)(
                JaxMatFree(fn=op, n=A.nrow, _dtype=op.dtype), jnp.asarray(b),
                M=JaxJacobi.from_csr(Aj), **kw)
            line += (f"; JAX {int(ref.iters):5d} iterations, status "
                     f"{int(ref.status)}, relres "
                     f"{relres(np.asarray(ref.x)):.3e}")
        print(line, flush=True)


def ini_fields(params, ini: str) -> dict:
    its, amg, _, _ = params.param_init(params.apply_cli_overrides(
        ["-ini", os.path.join(ROOT, ini)]))
    return dict(its=its, amg=amg)


def jax_refined(A, b, amg_fields: dict):
    """bench.py's reservoir stanza through the JAX package: the f32 BSR
    hierarchy under vFGMRES inside ``solve_refined``."""
    import jax.numpy as jnp
    from faspsolver_tpu.krylov import vfgmres
    from faspsolver_tpu.ops import device_operator
    from faspsolver_tpu.precond import AMGPrecond
    from faspsolver_tpu.precond.amg.setup_bsr import (setup_sa_bsr,
                                                      setup_ua_bsr)
    from faspsolver_tpu.solvers import solve_refined
    from faspsolver_tpu.utils.params import AMGParam
    Aj = _to_jax(A)
    param = AMGParam(**amg_fields)
    setup = setup_sa_bsr if int(param.AMG_type) == 2 else setup_ua_bsr
    M = AMGPrecond(setup(Aj, param, dtype=jnp.float32))
    op = device_operator(Aj, dtype=jnp.float32)

    def inner(r, tol):
        return vfgmres(op, r, M=M, tol=tol, **chip_smoke.REFINED_INNER)

    return solve_refined(Aj, b, inner, dtype=jnp.float32,
                         **chip_smoke.REFINED)


def _harness(kind: str, precision: str, sizes_3d=()):
    """The JAX package's own harness functions on the CPU, one solve per
    row: ``gen`` over ``generated_problems()`` at its default sizes (with
    ``sizes_3d``, only the 3-D rows of those sizes), ``corpus`` over
    ``corpus_problems(255)``, with ``_solver_factory("amg")`` in f64 (x64
    on) or its f32 refined mode (x64 off).  Prints each row's iterations
    and whether the f32 ladder rescued or escalated it (in f32 with its
    refinement stages, ``chip_smoke.refined_stages``), then the table
    chip_smoke.py holds the port to."""
    import contextlib
    import io

    import jax
    jax.config.update("jax_enable_x64", precision == "f64")
    import faspsolver_tpu.krylov as krylov
    import faspsolver_tpu.solvers as solvers
    from faspsolver_tpu.benchmark.harness import (_solver_factory,
                                                  corpus_problems,
                                                  generated_problems)
    if kind != "gen":
        rows = corpus_problems(255)
    elif sizes_3d:
        rows = generated_problems(sizes_2d=(), sizes_3d=sizes_3d)
    else:
        rows = generated_problems()
    table = {}
    for name, A, b in rows:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with chip_smoke.refined_stages(krylov, solvers) as stages, \
                contextlib.redirect_stdout(buf):
            res = _solver_factory("amg")(A, b)     # a new closure per row
        said = buf.getvalue()
        flag = ("escalate" if "f64 escalation" in said else
                "rescue" if "diagscaled-inner" in said else "")
        x = np.asarray(res.x, dtype=np.float64)
        relres = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
        table[name] = (int(res.iters), flag)
        print(f"{name:16s} n={A.nrow:8d} iters={int(res.iters):5d} "
              f"converged={bool(res.converged)} relres={relres:.3e} "
              f"{flag or '-'} ({time.perf_counter() - t0:.1f} s) "
              f"{said.strip()}", flush=True)
        chip_smoke.print_stages(stages)
    print(f"HARNESS_{kind.upper()}_{precision.upper()} = {table!r}")
    print("reference anomalies:", chip_smoke.reference_anomalies(table))


def _fallbacks():
    """The JAX package's f32 refined mode (x64 off) on each of
    ``chip_smoke.FALLBACK_CASES``: the banner it prints, its total inner
    iterations and its stages (``chip_smoke.refined_stages``), then phase
    11f's ``FALLBACK_ANCHORS``."""
    import contextlib
    import io

    import jax
    jax.config.update("jax_enable_x64", False)
    import faspsolver_tpu.krylov as krylov
    import faspsolver_tpu.solvers as solvers
    from faspsolver_tpu.benchmark.harness import _solver_factory
    from faspsolver_tpu_torch.testgen import jump_2d
    table = {}
    for name, (n, contrast, banner) in chip_smoke.FALLBACK_CASES.items():
        A = jump_2d(n, contrast)
        b = A.matvec(np.ones(A.nrow))
        buf = io.StringIO()
        with chip_smoke.refined_stages(krylov, solvers) as stages, \
                contextlib.redirect_stdout(buf):
            res = _solver_factory("amg")(_to_jax(A), b)
        x = np.asarray(res.x, dtype=np.float64)
        relres = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
        print(f"{name}: jump_2d({n}, {contrast:g}) iters={int(res.iters)} "
              f"converged={bool(res.converged)} relres={relres:.3e} "
              f"said {buf.getvalue().strip()!r} (banner {banner!r} "
              f"{'found' if banner in buf.getvalue() else 'MISSING'})")
        chip_smoke.print_stages(stages)
        table[name] = (int(res.iters), [(s["rounds"], s["inner_iters"])
                                        for s in stages])
    print(f"FALLBACK_ANCHORS = {table!r}")


def _fallbacks_port(threads):
    """The port's f32 refined mode on the CPU (no JAX) on each of
    ``chip_smoke.FALLBACK_CASES``, in the CPU's GMRES arithmetic and in
    the card's (``krylov.gmres._on_host`` false: masked full-window
    products, the control's back-substitution), with ``threads`` torch
    threads (None: torch's default): the banner, the total inner
    iterations and the stages, as phase 11f prints them on the card."""
    import contextlib
    import io
    import unittest.mock

    import torch
    import faspsolver_tpu_torch.krylov as krylov
    import faspsolver_tpu_torch.solvers as solvers
    from faspsolver_tpu_torch.benchmark import harness
    from faspsolver_tpu_torch.testgen import jump_2d
    if threads:
        torch.set_num_threads(threads)
    gmres = sys.modules["faspsolver_tpu_torch.krylov.gmres"]
    for arithmetic in ("cpu", "card"):
        patch = (unittest.mock.patch.object(gmres, "_on_host", lambda b: False)
                 if arithmetic == "card" else contextlib.nullcontext())
        for name, (n, contrast, banner) in chip_smoke.FALLBACK_CASES.items():
            A = jump_2d(n, contrast)
            b = A.matvec(np.ones(A.nrow))
            buf = io.StringIO()
            with patch, chip_smoke.refined_stages(krylov, solvers) as stages, \
                    contextlib.redirect_stdout(buf):
                res = harness._refined_factory("amg", torch.float32,
                                               "cpu")(A, b)
            print(f"{arithmetic} arithmetic, {torch.get_num_threads()} "
                  f"threads, {name}: {res.iters} inner iterations (JAX "
                  f"{chip_smoke.FALLBACK_ANCHORS[name][0]}), converged "
                  f"{res.converged}, said {buf.getvalue().strip()!r}")
            chip_smoke.print_stages(stages)


def jax_regression_problems(keys):
    """chip_smoke.regression_problems with the JAX package's containers."""
    return [(name, _to_jax(A), b, sol)
            for name, A, b, sol in chip_smoke.regression_problems(keys)]


def _regression(kind: str):
    from faspsolver_tpu.regression import runner
    cfg_fn, keys = chip_smoke.REGRESSION_SETS[kind]
    t0 = time.perf_counter()
    res = runner.run_matrix(getattr(runner, cfg_fn)(),
                            jax_regression_problems(keys))
    for r in res:
        print(f"    ({r.problem!r}, {r.name!r}): ({r.iters}, {r.ok}, "
              f"{r.extra!r}),", flush=True)
    print(f"# {len(res)} rows, {time.perf_counter() - t0:.1f} s")


def _jax_param(port_param):
    from faspsolver_tpu.utils.params import AMGParam
    return AMGParam(**vars(port_param))


def _parallel(nx: int):
    """The JAX package's one-device counts of phase 13's solves."""
    import jax.numpy as jnp
    from faspsolver_tpu.constants import AMGType, SmootherType
    from faspsolver_tpu.krylov import JacobiPrecond, pcg, vfgmres
    from faspsolver_tpu.ops import device_operator
    from faspsolver_tpu.precond import AMGPrecond
    from faspsolver_tpu.precond.amg import setup_rs, setup_structured
    from faspsolver_tpu.precond.amg.setup_bsr import setup_ua_bsr
    from faspsolver_tpu.utils.params import AMGParam
    from faspsolver_tpu_torch.testgen import block_poisson_3d, poisson_2d
    runs = chip_smoke.PARALLEL_RUNS
    A = poisson_2d(nx)
    Aj = _to_jax(A)
    b = jnp.asarray(A.matvec(np.ones(A.nrow)))

    def show(key, res, t0):
        print(f"    {key!r}: {int(res.iters)},  # converged "
              f"{bool(res.converged)}, relres {float(res.relres):.3e}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    show("a", pcg(device_operator(Aj, prefer="ell"), b, M=JacobiPrecond(
        jnp.asarray(1.0 / A.diagonal())), **runs["a"]), t0)
    t0 = time.perf_counter()
    h = setup_structured(Aj, _jax_param(chip_smoke.headline_param()),
                         smooth_p=True)
    show("b", pcg(device_operator(Aj, prefer="dia"), b, M=AMGPrecond(h),
                  **runs["b"]), t0)
    t0 = time.perf_counter()
    hr = setup_rs(Aj, AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                               polynomial_degree=2, coarse_dof=60))
    show("d", pcg(hr.levels[0].A, b, M=AMGPrecond(hr), **runs["d"]), t0)
    t0 = time.perf_counter()
    Ab = block_poisson_3d(chip_smoke.PAR_BSR_NX, nb=3)
    Abj = _to_jax(Ab)
    hb = setup_ua_bsr(Abj, AMGParam(AMG_type=int(AMGType.UA),
                                    coarse_dof=30))
    show("e", vfgmres(device_operator(Abj), jnp.asarray(
        Ab.matvec(np.ones(Ab.nrow))), M=AMGPrecond(hb), **runs["e"]), t0)


def _gcg_floor():
    """The mm set's GCG rows through the JAX package twice: its jitted
    gcg, and the same arithmetic as an eager JAX loop (op by op, no
    fusion).  Where the two counts part by more than the row's allowance
    the JAX package disagrees with itself: the count at tol 1e-15 is set
    by rounding (chip_smoke.REGRESSION_FLOOR)."""
    import jax.numpy as jnp
    from faspsolver_tpu.krylov import JacobiPrecond, gcg
    from faspsolver_tpu.ops import device_operator
    from faspsolver_tpu.precond import AMGPrecond, setup_ilu
    from faspsolver_tpu.precond.amg import setup_rs
    from faspsolver_tpu.utils.params import AMGParam, ILUParam
    # mm_configs' preconditioner families (runner.py:331-342)
    fams = {"": lambda A: None, " + diag": JacobiPrecond.from_csr,
            " + ILUk": lambda A: setup_ilu(A, ILUParam(ILU_type=1,
                                                       ILU_lfil=2)),
            " + ILUt": lambda A: setup_ilu(A, ILUParam(ILU_type=2,
                                                       ILU_droptol=1e-3)),
            " + ILUtp": lambda A: setup_ilu(A, ILUParam(
                ILU_type=3, ILU_droptol=1e-3, ILU_permtol=0.01)),
            " + AMG": lambda A: AMGPrecond(setup_rs(A, AMGParam()))}

    def eager(op, b, M, tol=1e-15, maxit=100):
        n = b.shape[0]
        x = jnp.zeros_like(b)
        r = b - op(x)
        normr0 = jnp.sqrt(r @ r)
        P, Q = jnp.zeros((maxit, n)), jnp.zeros((maxit, n))
        for j in range(maxit):
            p = M(r) if M is not None else r
            q = op(p)
            mask = (jnp.arange(maxit) < j).astype(b.dtype)
            for _ in range(2):
                h = (Q @ q) * mask
                p, q = p - h @ P, q - h @ Q
            qn = jnp.sqrt(q @ q)
            p, q = p / qn, q / qn
            a = q @ r
            x, r = x + a * p, r - a * q
            P, Q = P.at[j].set(p), Q.at[j].set(q)
            if float(jnp.sqrt(r @ r) / normr0) < tol:
                return j + 1
        return maxit

    for name, A, b, _ in jax_regression_problems(("plate", "shell")):
        op = device_operator(A, prefer="ell")
        for fam, build in fams.items():
            M = build(A)
            jit = int(gcg(op, jnp.asarray(b), M=M, tol=1e-15,
                          maxit=100).iters)
            print(f"    ({name!r}, {'GCG' + fam!r}): ({jit}, "
                  f"{eager(op, jnp.asarray(b), M)}),", flush=True)


def _tutorials(datadir: str, names):
    """The JAX tutorials run in this process, each as a script; prints
    each one's output and the rows it printed as phase 14 reads them."""
    import contextlib
    import io
    import runpy
    if not os.path.exists(os.path.join(datadir, "csrmat_FE.dat")):
        os.makedirs(datadir, exist_ok=True)
        print(f"wrote the files in "
              f"{chip_smoke.write_tutorial_data(datadir):.1f} s", flush=True)
    table = {}
    for mod, script in chip_smoke.TUTORIALS:
        if names and mod not in names:
            continue
        sys.argv = [script, str(chip_smoke.NX) if mod == "fast_path"
                    else datadir]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(ROOT, "tutorials", f"{script}.py"),
                           run_name="__main__")
        print(f"{buf.getvalue()}({script}: "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        table.update(chip_smoke.tutorial_lines(buf.getvalue()))
    print(f"TUTORIAL_ANCHORS = {table!r}")


def _bench_spe01(nx: int):
    """bench.py's SPE01 stanza through the JAX package on the pair that
    phase 15 writes for ``bench_torch.py``."""
    import tempfile
    from faspsolver_tpu.io import read_bsr, read_vec
    d = tempfile.mkdtemp()
    print(f"wrote the pair in {chip_smoke.write_spe01_data(d, nx):.1f} s",
          flush=True)
    t0 = time.perf_counter()
    A = read_bsr(os.path.join(d, "bsrmat_SPE01.dat"))
    b = read_vec(os.path.join(d, "rhs_SPE01.dat"))
    print(f"read it in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    res = jax_refined(A, b, chip_smoke._STANZA)
    print(f"nx={nx} bench.py SPE01 stanza: {res.inner_iters} inner "
          f"iterations, {res.rounds} rounds, relres {res.relres:.3e}, "
          f"converged {bool(res.converged)}  "
          f"({time.perf_counter() - t0:.1f} s)")


def _main(argv):
    if argv[:1] == ["matfree"] and argv[2:] == ["cuda"]:
        _matfree(float(argv[1]), "cuda")        # the port alone, no JAX
        return
    if argv[:1] == ["harness"]:
        _harness(argv[1], argv[2],              # the JAX package alone
                 tuple(int(n) for n in argv[3:]))
        return
    if argv[:2] == ["fallbacks", "port"]:
        _fallbacks_port(int(argv[2]) if argv[2:] else None)   # no JAX
        return
    if argv[:1] == ["fallbacks"]:
        _fallbacks()
        return
    import jax
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from native_parity import ensure_native
    ensure_native()
    mode = argv[0] if argv else "small"
    if mode == "regression":
        _regression(argv[1])
        return
    if mode == "bench-spe01":
        _bench_spe01(int(argv[1]))
        return
    if mode == "tutorials":
        _tutorials(argv[1], argv[2:])
        return
    if mode == "gcg-floor":
        _gcg_floor()
        return
    if mode == "parallel":
        _parallel(int(argv[1]))
        return
    if mode == "cli":
        from faspsolver_tpu.__main__ import main
        ini = chip_smoke.ini_with("ini/input.dat", dict(
            kv.split("=") for kv in argv[3:]), os.environ.get("TMPDIR"))
        t0 = time.perf_counter()
        rc = main(["-ini", ini, "-precond", argv[1], "-problem",
                   "poisson2d", "-size", argv[2]])
        print(f"rc {rc}, {time.perf_counter() - t0:.1f} s")
        return
    if mode == "str":
        A, _, b = chip_smoke.str_problem(int(argv[1]))
        _print_grid(f"nx={argv[1]}", chip_smoke.STR_GRID, A, b, str_run)
        return
    if mode == "blc":
        A, b = chip_smoke.blc_problem(int(argv[1]))
        _print_grid(f"nx={argv[1]}", chip_smoke.BLC_GRID, A, b,
                    lambda A, b, d, f: run_fields("jax", d, f, A, b))
        return
    if mode == "sweep":
        A, b = chip_smoke.sweep_problem(int(argv[1]), int(argv[2]))
        _print_grid(f"n={argv[1]}", chip_smoke.SWEEP_GRID, A, b,
                    lambda A, b, d, f: run_fields("jax", d, f, A, b))
        return
    if mode == "gmg":
        _gmg(int(argv[1]), int(argv[2]))
        return
    if mode == "surface":
        _surface(int(argv[1]))
        return
    if mode == "matfree":
        _matfree(float(argv[1]), "cpu")
        return
    if mode == "bsr":
        nx = int(argv[1])
        A, b = chip_smoke.bsr_problem(nx)
        from faspsolver_tpu.utils import params
        for name, driver, fields, *_ in chip_smoke.BSR_GRID:
            t0 = time.perf_counter()
            if driver == "refined":
                res = jax_refined(A, b, fields["amg"])
                text = (f"{res.inner_iters:5d} inner iterations, "
                        f"{res.rounds} rounds, relres {res.relres:.3e}")
            else:
                if fields == "ini":
                    ini = ini_fields(params, "ini/bsr.dat")
                    fields = {k: vars(v) for k, v in ini.items()}
                res, x = run_fields("jax", driver, fields, A, b)
                relres = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
                text = (f"{int(res.iters):5d} iterations, status "
                        f"{int(res.status)}, relres {relres:.3e}")
            print(f"nx={nx} {name:46s} {text}  "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return
    A, b = problem()
    if mode == "leftover":
        for name, driver, fields, anchor, _ in chip_smoke.LEFTOVER_GRID:
            res, _ = run_fields("jax", driver, fields, A, b)
            print(f"{name:40s} {int(res.iters):5d}  status "
                  f"{int(res.status)}  (recorded {anchor})", flush=True)
        return
    for cfg in chip_smoke.SMALL_GRID:
        res, _ = run("jax", cfg, A, b)
        print(f"{cfg[0]:24s} {int(res.iters):5d}  status {int(res.status)}"
              f"  (recorded {cfg[4]})")


if __name__ == "__main__":
    _main(sys.argv[1:])
