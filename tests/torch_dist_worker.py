"""Rank bodies of tests/test_torch_parallel.py: run in processes spawned
by ``torch.multiprocessing``, one per rank of a gloo process group on
the CPU.  This module imports the port and never jax: a spawned rank
re-imports the module that defines its function.

``spawn_ranks(ws, out_dir)`` starts ``ws`` ranks; each runs
:func:`rank_results` and saves what it found to ``out_dir/rank<r>.pt``.
Not collected by pytest (no ``test_`` prefix).
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 11


def _host(x):
    """A DTensor or tensor as a host float64 array (the whole vector)."""
    from faspsolver_tpu_torch.parallel.comm import whole
    return whole(x).detach().cpu().numpy()


def _record(rec) -> dict:
    return {"p2p_sends": rec.p2p_sends, "p2p_elements": rec.p2p_elements,
            "collectives": list(rec.collectives)}


def rank_results(ws: int) -> dict:
    """Every distributed check of the parallel tests on this rank."""
    from faspsolver_tpu_torch import as_tensor
    from faspsolver_tpu_torch.constants import CGPT
    from faspsolver_tpu_torch.krylov import JacobiPrecond, pcg
    from faspsolver_tpu_torch.krylov.common import dot
    from faspsolver_tpu_torch.ops import DiaOperator, device_operator
    from faspsolver_tpu_torch.parallel import (
        HaloDiaOperator, assert_neighbor_comm_only, cycle_comm_pattern,
        dist_dia_operator, dist_operator, halo_dia_operator,
        halo_shard_hierarchy, make_mesh, shard_hierarchy, shard_vector)
    from faspsolver_tpu_torch.parallel.comm import record
    from faspsolver_tpu_torch.parallel.dryrun import dryrun_multichip
    from faspsolver_tpu_torch.parallel.halo import (comm_pattern,
                                                    halo_banded_transfer)
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import setup_rs, setup_structured
    from faspsolver_tpu_torch.precond.amg.coarsen_rs import coarsen
    from faspsolver_tpu_torch.precond.amg.interp import interpolate
    from faspsolver_tpu_torch.precond.amg.transfer import banded_transfer
    from faspsolver_tpu_torch.testgen import (poisson_2d,
                                              poisson_3d_manufactured)
    from faspsolver_tpu_torch.utils.params import AMGParam

    mesh = make_mesh(ws, device="cpu")
    rng = np.random.default_rng(SEED)
    out = {}

    def t(a):
        return as_tensor(a, torch.float64)

    # sharded SpMV
    A = poisson_2d(30)
    x = rng.standard_normal(A.ncol)
    out["spmv"] = _host(dist_operator(A, mesh)(shard_vector(t(x), mesh))
                        )[:A.nrow]

    # PCG on the sharded ELL operator and on one device
    A, b, u = poisson_3d_manufactured(9)
    r1 = pcg(device_operator(A, prefer="ell"), t(b), tol=1e-10, maxit=500)
    rd = pcg(dist_operator(A, mesh), shard_vector(t(b), mesh), tol=1e-10,
             maxit=500)
    out["pcg"] = dict(x1=r1.x.numpy(), it1=r1.iters, xd=_host(rd.x)[:A.nrow],
                      itd=rd.iters, conv=rd.converged)

    # the sharded dot
    out["dot"] = float(_host(dot(*[shard_vector(t(np.arange(1024.0)),
                                                mesh)] * 2)))

    # the row-split DIA SpMV and its communication
    A = poisson_2d(24)
    x = rng.standard_normal(A.nrow)
    op = dist_dia_operator(A, mesh)
    out["dia_spmv"] = _host(op(shard_vector(t(x), mesh)))[:A.nrow]
    A = poisson_2d(40)
    op = dist_dia_operator(A, mesh)
    with record(mesh) as rec:
        op(shard_vector(t(np.zeros(A.nrow)), mesh))
    out["dia_record"] = _record(rec)

    # structured AMG: sharded hierarchy against one device
    A = poisson_2d(32)
    b = A.matvec(np.ones(A.nrow))
    hier = setup_structured(A, AMGParam(coarse_dof=60), smooth_p=True)
    r1 = pcg(DiaOperator.from_csr(A), t(b), M=AMGPrecond(hier), tol=1e-10,
             maxit=100)
    hs = shard_hierarchy(hier, mesh, min_size=256)
    r2 = pcg(dist_dia_operator(A, mesh), shard_vector(t(b), mesh),
             M=AMGPrecond(hs), tol=1e-10, maxit=100)
    out["structured"] = dict(it1=r1.iters, it2=r2.iters, x1=r1.x.numpy(),
                             x2=_host(r2.x)[:A.nrow],
                             placed=hs.sharded_levels)

    # an RS hierarchy with Gauss-Seidel sweeps: sharded ELL / COO levels,
    # transfers between two sharded levels, sweeps on the gathered vector
    hr = setup_rs(A, AMGParam(coarse_dof=60))
    r1 = pcg(device_operator(A, prefer="ell"), t(b), M=AMGPrecond(hr),
             tol=1e-10, maxit=100)
    hrs = shard_hierarchy(hr, mesh, min_size=256)
    r2 = pcg(dist_operator(A, mesh), shard_vector(t(b), mesh),
             M=AMGPrecond(hrs), tol=1e-10, maxit=100)
    out["rs_gs"] = dict(it1=r1.iters, it2=r2.iters, x1=r1.x.numpy(),
                        x2=_host(r2.x)[:A.nrow], placed=hrs.sharded_levels,
                        kinds=[type(lvl.smoother).__name__
                               for lvl in hrs.levels])

    # the halo operator: SpMV, comm map and record, PCG
    A = poisson_2d(32)
    op = halo_dia_operator(A, mesh)
    x = rng.standard_normal(op.n)
    cm = op.comm_map
    b = A.matvec(np.ones(A.nrow))
    dinv = 1.0 / A.diagonal()
    r1 = pcg(DiaOperator.from_csr(A), t(b), M=JacobiPrecond(t(dinv)),
             tol=1e-10, maxit=400)
    r2 = pcg(op, shard_vector(t(b), mesh),
             M=JacobiPrecond(shard_vector(t(dinv), mesh)), tol=1e-10,
             maxit=400)
    out["halo"] = dict(
        spmv=_host(op(shard_vector(t(x), mesh)))[:A.nrow], x=x,
        comm_map=(cm.n_shards, cm.n_local, cm.halo, cm.replicated,
                  cm.bytes_per_exchange),
        record=_record(comm_pattern(op)),
        it1=r1.iters, it2=r2.iters, conv=r2.converged, x1=r1.x.numpy(),
        x2=_host(r2.x)[:A.nrow])

    # the halo hierarchy: its cycle, iteration parity, the whole cycle's
    # communication
    A = poisson_2d(64)
    b = A.matvec(np.ones(A.nrow))
    hs = setup_structured(A, AMGParam(coarse_dof=60), smooth_p=True)
    hh, cmaps = halo_shard_hierarchy(hs, mesh, min_size=512)
    res = pcg(hh.levels[0].A, shard_vector(t(b), mesh), M=AMGPrecond(hh),
              tol=1e-8, maxit=50)
    res1 = pcg(hs.levels[0].A, t(b), M=AMGPrecond(hs), tol=1e-8, maxit=50)
    rec = cycle_comm_pattern(hh, mesh)
    try:
        assert_neighbor_comm_only(rec, A.nrow)
        verdict = "ok"
    except AssertionError as e:
        verdict = str(e)
    out["halo_hier"] = dict(
        fine_is_halo=isinstance(hh.levels[0].A, HaloDiaOperator),
        cmaps=[(c.n_shards, c.n_local, c.halo, c.replicated)
               for c in cmaps],
        it=res.iters, it1=res1.iters, relres=res.relres,
        relres1=res1.relres, record=_record(rec), verdict=verdict)

    # the distributed banded transfers against one device
    A = poisson_2d(64)
    marker, S = coarsen(A, 0.25, 0.9, method="rs")
    P = interpolate(A, marker, S, interp_type=1, trunc_threshold=0.2)
    fpos = np.flatnonzero(marker == CGPT)
    bt = banded_transfer(P, fpos)
    hb = halo_banded_transfer(bt[0], mesh)
    trng = np.random.default_rng(0)
    xc = trng.standard_normal(bt[0].n_coarse)
    xf = trng.standard_normal(bt[0].n_fine)
    xcs = shard_vector(t(xc), mesh)
    with record(mesh) as rec:
        yhp = hb[0](xcs)
    out["banded"] = dict(
        has_rem=bt[0].has_rem, xc=xc, xf=xf,
        yp=bt[0](t(xc)).numpy(), yr=bt[1](t(xf)).numpy(),
        yhp=_host(yhp), yhr=_host(hb[1](shard_vector(t(xf), mesh))),
        record=_record(rec))

    # every check of the JAX package's dryrun_multichip
    out["dryrun"] = dryrun_multichip(ws, device="cpu")

    # the resident PCG's control flow over DTensors: phase 13's (a)-(d)
    # trees run as the device runs their graph
    out["resident"] = resident_forms(mesh, "abcd", emulate=True)
    return out


# the card test's size on several ranks: phase 13's solves
# (chip_smoke.PARALLEL_RUNS) at FULL_NX^2 (1024^2 = 1,048,576 dof: its
# structured levels 1024^2, 342^2 and 114^2 split evenly over 2 or 4
# ranks) and FULL_BSR_NX^3 blocks of 3 (786,432 dof)
FULL_NX, FULL_BSR_NX = 1024, 64


def resident_forms(mesh, forms: str, emulate: bool, full: bool = False,
                   hold=None) -> dict:
    """Phase 13's forms over the mesh's DTensors, by letter in ``forms``:
    (a) Jacobi-PCG over the row-split ELL operator; (b) AMG-PCG over the
    row-split DIA operator and its structured hierarchy placed by
    shard_hierarchy; (c) the same through halo_shard_hierarchy; (d) the
    RS hierarchy through halo_shard_hierarchy (its fine level only
    placed); (e) vFGMRES(30) over the block rows of a block_poisson_3d
    matrix with a replicated UA-BSR hierarchy.  At a small size
    (poisson_2d(32), block_poisson_3d(8, nb=3), tol 1e-10, placements
    from 256 rows), or with ``full`` at phase 13's settings
    (``chip_smoke``: ``headline_param`` for (b) and (c),
    ``PARALLEL_RUNS``; the placements' own ``min_size``) on
    poisson_2d(FULL_NX) and block_poisson_3d(FULL_BSR_NX, nb=3).  Each by
    :func:`_resident_and_eager`; ``placement`` holds (b)-(d)'s level
    sizes and whether each is split; (c) also the record of one whole
    cycle, taken with graphs on and under graphs.eager() (not with
    ``full``).  ``hold``: a list that keeps every module built alive."""
    from faspsolver_tpu_torch import as_tensor
    from faspsolver_tpu_torch.krylov import JacobiPrecond, pcg, vfgmres
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.parallel import (
        cycle_comm_pattern, dist_dia_operator, dist_operator,
        halo_shard_hierarchy, replicate, shard_block_rows, shard_hierarchy,
        shard_vector)
    from faspsolver_tpu_torch.parallel.comm import mesh_device
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import (setup_rs, setup_structured,
                                                  setup_ua_bsr)
    from faspsolver_tpu_torch.testgen import block_poisson_3d, poisson_2d
    from faspsolver_tpu_torch.utils import graphs
    from faspsolver_tpu_torch.utils.params import AMGParam

    if full:
        import chip_smoke
        nx, bsr_nx, place = FULL_NX, FULL_BSR_NX, {}
        param = chip_smoke.headline_param()
        runs = {k: chip_smoke.PARALLEL_RUNS[k] for k in "abde"}
        runs["c"] = runs["b"]
    else:
        nx, bsr_nx, place = 32, 8, {"min_size": 256}
        param = AMGParam(coarse_dof=60)
        runs = {k: dict(tol=1e-10, maxit=400) for k in "abcd"}
        runs["e"] = dict(tol=1e-10, maxit=200, restart=30)
    hold = [] if hold is None else hold
    f64, dev = torch.float64, mesh_device(mesh)
    A = poisson_2d(nx)
    bd = shard_vector(as_tensor(A.matvec(np.ones(A.nrow)), f64), mesh)
    hs0 = setup_structured(A, param, dtype=f64, smooth_p=True, device=dev)
    hh, cmaps = halo_shard_hierarchy(hs0, mesh, **place)
    out = {"placement": {}}

    def levels(h, split):
        return [(lvl.A.shape[0], bool(s)) for lvl, s in zip(h.levels, split)]

    for form in forms:
        if form == "a":
            op = dist_operator(A, mesh, dtype=f64)
            M = JacobiPrecond(shard_vector(as_tensor(1.0 / A.diagonal(),
                                                     f64), mesh))
        elif form == "b":
            op = dist_dia_operator(A, mesh, dtype=f64)
            hs = shard_hierarchy(hs0, mesh, **place)
            M = AMGPrecond(hs)
            out["placement"]["b"] = levels(hs, hs.sharded_levels)
        elif form == "c":
            op, M = hh.levels[0].A, AMGPrecond(hh)
            out["placement"]["c"] = levels(
                hh, [not c.replicated for c in cmaps])
        elif form == "d":
            hrs = setup_rs(A, AMGParam(smoother=13, polynomial_degree=2,
                                       coarse_dof=60), dtype=f64, device=dev)
            hh2, cm2 = halo_shard_hierarchy(hrs, mesh, min_size=A.nrow // 2)
            op, M = hh2.levels[0].A, AMGPrecond(hh2)
            out["placement"]["d"] = levels(
                hh2, [not c.replicated for c in cm2])
        if form == "e":
            Ab = block_poisson_3d(bsr_nx, nb=3)
            hb = replicate(setup_ua_bsr(Ab, AMGParam(AMG_type=3,
                                                     coarse_dof=30),
                                        dtype=f64), mesh)
            op = shard_block_rows(device_operator(Ab, dtype=f64), mesh)
            M = AMGPrecond(hb)
            bb = shard_vector(as_tensor(Ab.matvec(np.ones(Ab.nrow)), f64),
                              mesh)
            out[form] = _resident_and_eager(lambda: vfgmres(
                op, bb, M=M, **runs["e"]), emulate, arrays=not full)
        else:
            out[form] = _resident_and_eager(
                lambda: pcg(op, bd, M=M, **runs[form]), emulate,
                arrays=not full)
        hold += [op, M]
    hold += [hs0, hh]
    if "c" in forms and not full:
        rec = cycle_comm_pattern(hh, mesh)
        with graphs.eager():
            rec_eager = cycle_comm_pattern(hh, mesh)
        out["c"]["record"] = _record(rec)
        out["c"]["record_eager"] = _record(rec_eager)
    return out


# what reads a tensor's value on the host (``.item()``, ``bool()``)
_HOST_READS = ("_local_scalar_dense", "is_nonzero", "item")


class _HostReadSpy(TorchDispatchMode):
    """Notes every operation that reads a value on the host, except while
    ``paused`` (the loop control's plain twin, which the kernel replaces
    on the card); counts the operations it watched."""

    def __init__(self):
        super().__init__()
        self.reads, self.ops, self.paused = [], 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops += 1
            if func._opname in _HOST_READS:
                self.reads.append(str(func))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _resident(emulate: bool):
    """Yields a :class:`_HostReadSpy` and the list of each loop's state
    block as the loop left it.  With ``emulate``, the resident path on
    gloo DTensors: ``graphs.active`` admits them (outside a piece, as
    outside a capture), ``graphs.Resident`` is a stand-in that runs the
    warm-up and each launch as the device runs the graph (each If and
    While decided by its region's flag, read without a counted host
    read), every piece under the spy, and ``graphs.Program`` one whose
    replay runs the function again.  Each stand-in refuses to run once
    destroyed.  Without, the real path (the spy watches nothing)."""
    from faspsolver_tpu_torch.utils import graphs, loops
    spy, blocks, inside = _HostReadSpy(), [], [False]

    @contextlib.contextmanager
    def piece():
        inside[0] = True
        try:
            with spy:
                yield
        finally:
            inside[0] = False

    class Emulated:
        def __init__(self, tree, device, keep=()):
            self.device = torch.device(device)
            saved = [k.clone() for k in keep]
            with piece():
                for p in graphs._pieces(tree):
                    p.fn()
            for k, v in zip(keep, saved):
                k.copy_(v)
            self.tree = tree

        def launch(self):
            def run(items):
                for item in items:
                    if isinstance(item, graphs.Piece):
                        with piece():
                            item.fn()
                    elif isinstance(item, graphs.If):
                        if int(item.reg.i[loops.I.NEED]):
                            run(item.body)
                    else:
                        while int(item.reg.i[loops.I.CONT]):
                            run(item.body)
            if self.tree is None:
                raise RuntimeError("launching a released resident loop")
            run(self.tree)
            graphs.stats["replays"] += 1

        def account(self, vals):
            pass

        def destroy(self):
            self.tree = None

    class Replayed:
        def __init__(self, fn, device, keep=(), pool=None):
            self.device = torch.device(device)
            self.fn, self.out = fn, fn().clone()

        def replay(self):
            if self.fn is None:
                raise RuntimeError("replaying a released program")
            self.out.copy_(self.fn())
            graphs.stats["replays"] += 1
            return self.out

        def destroy(self):
            self.fn = None

    def paused(fn):
        def run(*args):
            spy.paused += 1
            try:
                return fn(*args)
            finally:
                spy.paused -= 1
        return run

    def run_loop(st, tree, host, resident):
        vals = real_run(st, tree, host, resident)
        blocks.append(st.block.bytes.cpu().numpy())
        return vals

    saved = (graphs.active, graphs.Resident, graphs.Program,
             graphs.run_loop, dict(loops.PLAIN))
    real_run = graphs.run_loop
    graphs.run_loop = run_loop
    if emulate:
        graphs.active = lambda x: (graphs._enabled and not inside[0]
                                   and isinstance(x, torch.Tensor))
        graphs.Resident, graphs.Program = Emulated, Replayed
        loops.PLAIN.update({k: paused(f) for k, f in saved[4].items()})
    try:
        yield spy, blocks
    finally:
        (graphs.active, graphs.Resident, graphs.Program,
         graphs.run_loop) = saved[:4]
        loops.PLAIN.update(saved[4])


def _resident_and_eager(solve, emulate: bool, arrays: bool = True) -> dict:
    """``solve()`` on the resident path (``emulate``: see
    :func:`_resident`) cold and warm, each with its program launches and
    seconds, then as the eager loop: counts, host reads, seconds, x of
    each (with ``arrays``; else only each x's distance from the eager
    loop's, relative to its norm), the cold solve's state block, what
    the spy saw in the pieces, and the graph counters of the three
    runs."""
    import time
    from faspsolver_tpu_torch.utils import graphs

    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    runs = []
    with _resident(emulate) as (spy, blocks):
        for eager in (False, False, True):
            before = dict(graphs.stats)
            sync()
            t0 = time.perf_counter()
            with graphs.eager() if eager else contextlib.nullcontext():
                res = solve()
            sync()
            runs.append((res, time.perf_counter() - t0,
                         {k: graphs.stats[k] - v
                          for k, v in before.items()}))
    (res, s, g), (warm, ws, gw), (eager, es, _) = runs
    xs = {k: _host(r.x) for k, r in (("x", res), ("warm_x", warm),
                                     ("eager_x", eager))}
    ref = float(np.linalg.norm(xs["eager_x"]))
    out = dict(resident=res.resident, syncs=res.syncs, it=res.iters,
               launches=g["replays"], captures=g["captures"],
               nodes_captured=g["nodes_captured"],
               warm_resident=warm.resident, warm_syncs=warm.syncs,
               warm_it=warm.iters, warm_launches=gw["replays"],
               eager_resident=eager.resident, eager_syncs=eager.syncs,
               eager_it=eager.iters, cold_s=s, warm_s=ws, eager_s=es,
               x_diff=float(np.linalg.norm(xs["x"] - xs["eager_x"])) / ref,
               warm_x_diff=float(np.linalg.norm(xs["warm_x"]
                                                - xs["eager_x"])) / ref,
               block=blocks[0], host_reads=spy.reads, ops=spy.ops)
    if arrays:
        out.update(xs)
    return out


def _rank_main(rank: int, ws: int, init: str, out_dir: str,
               backend: str, full: bool) -> None:
    import datetime
    import faulthandler
    import time
    from faspsolver_tpu_torch.parallel import make_mesh, teardown
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=ws,
                            timeout=datetime.timedelta(seconds=300))
    # a rank that raises exits without taking the group down: NCCL's
    # teardown waits for the ranks still in a collective
    hold = []                  # the modules, alive through the teardown
    if backend == "nccl":
        out = resident_forms(make_mesh(ws), "abcde", emulate=False,
                             full=full, hold=hold)
    else:
        out = rank_results(ws)
    # the graphs that captured the group's collectives are released, with
    # their modules alive; a hang is a failure with a traceback
    faulthandler.dump_traceback_later(120, exit=True)
    t0 = time.perf_counter()
    out["released"] = teardown()
    out["teardown_s"] = time.perf_counter() - t0
    faulthandler.cancel_dump_traceback_later()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    del hold


def spawn_ranks(ws: int, out_dir: str, backend: str = "gloo",
                full: bool = False) -> list:
    """Run :func:`rank_results` on ``ws`` gloo ranks on the CPU, or with
    ``backend="nccl"`` :func:`resident_forms` (a)-(e) on the real
    resident path, one rank per card (``full``: at phase 13's size);
    each rank then takes the group down through ``parallel.teardown``
    with its modules alive (``released``: the programs it released,
    ``teardown_s``).  Every rank's results, by rank."""
    import torch.multiprocessing as mp
    init = "file://" + os.path.join(tempfile.mkdtemp(dir=out_dir), "store")
    mp.spawn(_rank_main, args=(ws, init, out_dir, backend, full), nprocs=ws)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(ws)]
