"""Rank bodies of tests/test_torch_parallel.py: run in processes spawned
by ``torch.multiprocessing``, one per rank of a gloo process group on
the CPU.  This module imports the port and never jax: a spawned rank
re-imports the module that defines its function.

``spawn_ranks(ws, out_dir)`` starts ``ws`` ranks; each runs
:func:`rank_results` and saves what it found to ``out_dir/rank<r>.pt``.
Not collected by pytest (no ``test_`` prefix).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

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
    return out


def _rank_main(rank: int, ws: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=ws)
    try:
        torch.save(rank_results(ws), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(ws: int, out_dir: str) -> list:
    """Run :func:`rank_results` on ``ws`` gloo ranks; every rank's
    results, by rank."""
    import torch.multiprocessing as mp
    init = "file://" + os.path.join(tempfile.mkdtemp(dir=out_dir), "store")
    mp.spawn(_rank_main, args=(ws, init, out_dir), nprocs=ws)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(ws)]
