"""One sharded solve step of every distributed path on an n-rank mesh
(the port's counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``,
with every check it makes, on the same tiny shapes).

Every rank of the process group calls :func:`dryrun_multichip` with the
group's size; without a group it runs on one rank of ``device``
(:func:`pcsr.make_mesh`).  The JAX checks read HLO text for
collective-permute and all-gather; these read the communication record
(:func:`halo.comm_pattern`): P2P sends present at more than one rank, no
all-gather.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import as_tensor
from ..constants import AggregationType, AMGType, SmootherType
from ..krylov import JacobiPrecond, pcg, vfgmres
from ..ops import device_operator
from ..precond import AMGPrecond
from ..precond.amg import mgcycle, setup_rs, setup_structured, setup_ua
from ..precond.amg.setup_bsr import setup_ua_bsr
from ..testgen import block_poisson_3d, poisson_2d
from ..utils.params import AMGParam
from .comm import mesh_device, whole
from .dist_dia import dist_dia_operator, shard_hierarchy
from .halo import (assert_neighbor_comm_only, comm_pattern,
                   cycle_comm_pattern, halo_dia_operator,
                   halo_shard_hierarchy)
from .pcsr import (dist_operator, make_mesh, replicate, shard_block_rows,
                   shard_vector)


def _finite(x) -> bool:
    return bool(torch.all(torch.isfinite(whole(x))))


def _neighbour_only(rec, ws: int) -> bool:
    return (ws == 1 or rec.p2p_sends > 0) and not rec.of_kind("gather")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run one sharded solve step of each path on an ``n_devices``-rank
    mesh and check it; returns the iteration counts."""
    mesh = make_mesh(n_devices, device=device)
    ws = mesh.size()
    dev = mesh_device(mesh)
    dt = torch.float64
    its = {}

    A = poisson_2d(24)                         # tiny shapes: 576 dof
    b = A.matvec(np.ones(A.nrow))

    # row-split operator and vectors; Jacobi on the split diagonal
    op = dist_operator(A, mesh, dtype=dt)
    bd = shard_vector(as_tensor(b, dt), mesh)
    dinv = shard_vector(as_tensor(1.0 / A.diagonal(), dt), mesh)
    res = pcg(op, bd, M=JacobiPrecond(dinv), tol=1e-6, maxit=3)
    assert _finite(res.x)
    its["jacobi_pcg"] = res.iters

    # an AMG cycle over a replicated hierarchy beside a sharded solve
    param = AMGParam(aggregation_type=int(AggregationType.PAIRWISE),
                     smoother=int(SmootherType.CHEBYSHEV),
                     polynomial_degree=2)
    hier = replicate(setup_ua(A, param, dtype=dt), mesh)
    op1 = dist_operator(A, mesh, dtype=dt)
    r = pcg(op1, bd, M=None, tol=1e-10, maxit=2)
    z = mgcycle(hier, whole(bd)[:A.nrow])
    assert _finite(r.x) and _finite(z)

    # the structured path: row-split DIA (neighbour halo) and a sharded
    # hierarchy with replicated coarse levels.  The JAX package takes
    # n = 8 max(devices, 2); below three ranks that grid (256 dof) makes
    # the RS fine level below a dense operator, which takes no halo, and
    # the JAX dryrun_multichip(1) fails its own check there: from 24 on
    n = 8 * max(ws, 3)
    A2 = poisson_2d(n)                         # n^2 dof, even shards
    b2 = A2.matvec(np.ones(A2.nrow))
    hs0 = setup_structured(A2, AMGParam(coarse_dof=60), dtype=dt,
                           smooth_p=True, device=dev)
    assert hs0 is not None
    op2 = dist_dia_operator(A2, mesh, dtype=dt)
    hs = shard_hierarchy(hs0, mesh, min_size=n)
    b2d = shard_vector(as_tensor(b2, dt), mesh)
    res2 = pcg(op2, b2d, M=AMGPrecond(hs), tol=1e-5, maxit=30)
    assert res2.converged
    its["structured"] = res2.iters

    # the explicit halo operator: P2P, no gather
    op3 = halo_dia_operator(A2, mesh, dtype=dt)
    res3 = pcg(op3, b2d, M=JacobiPrecond(shard_vector(
        as_tensor(1.0 / A2.diagonal(), dt), mesh)), tol=1e-4, maxit=50)
    assert _finite(res3.x)
    assert _neighbour_only(comm_pattern(op3), ws)
    its["halo_jacobi"] = res3.iters

    # the production path: per-level halo operators, PCG through them,
    # the whole cycle neighbour-only
    hh, cmaps = halo_shard_hierarchy(hs0, mesh, min_size=A2.nrow // 2)
    assert not cmaps[0].replicated and cmaps[0].halo > 0
    res4 = pcg(hh.levels[0].A, b2d, M=AMGPrecond(hh), tol=1e-5, maxit=30)
    assert res4.converged
    assert res4.iters == res2.iters            # parity with the GSPMD form
    assert_neighbor_comm_only(cycle_comm_pattern(hh, mesh), A2.nrow)
    its["halo_structured"] = res4.iters

    # classical RS-AMG through the same halo placement: the fine level's
    # bands come from its adaptive format, so it takes the halo operator
    Ag = poisson_2d(n)
    bg = Ag.matvec(np.ones(Ag.nrow))
    hrs = setup_rs(Ag, AMGParam(smoother=int(SmootherType.CHEBYSHEV),
                                polynomial_degree=2, coarse_dof=60),
                   dtype=dt, device=dev)
    hh2, cm2 = halo_shard_hierarchy(hrs, mesh, min_size=Ag.nrow // 2)
    assert not cm2[0].replicated and cm2[0].halo > 0, \
        "RS fine level must take the explicit-halo operator"
    bgd = shard_vector(as_tensor(bg, dt), mesh)
    res5 = pcg(hh2.levels[0].A, bgd, M=AMGPrecond(hh2), tol=1e-5,
               maxit=40)
    assert res5.converged
    assert_neighbor_comm_only(cycle_comm_pattern(hh2, mesh), Ag.nrow)
    its["halo_rs"] = res5.iters

    # the BSR block path (reference flow SolBSR.c:349): block rows split,
    # UA-BSR hierarchy replicated; then the matrix's scalar-banded halo
    # view, neighbour-only
    Ab = block_poisson_3d(12, nb=3)            # 1728 block rows, 5184 dof
    bb = Ab.matvec(np.ones(Ab.nrow))
    hb = replicate(setup_ua_bsr(Ab, AMGParam(AMG_type=int(AMGType.UA),
                                             coarse_dof=30), dtype=dt), mesh)
    opb = shard_block_rows(device_operator(Ab, dtype=dt), mesh)
    bbd = shard_vector(as_tensor(bb, dt), mesh)
    res6 = vfgmres(opb, bbd, M=AMGPrecond(hb), tol=1e-5, maxit=40,
                   restart=20)
    assert res6.converged
    its["bsr"] = res6.iters
    Ac = Ab.to_csr()
    op_blk = halo_dia_operator(Ac, mesh, dtype=dt)
    rb = pcg(op_blk, bbd, M=JacobiPrecond(shard_vector(
        as_tensor(1.0 / Ac.diagonal(), dt), mesh)), tol=1e-4, maxit=60)
    assert _finite(rb.x)
    assert _neighbour_only(comm_pattern(op_blk), ws)
    its["bsr_halo_jacobi"] = rb.iters
    return its
