"""Row-block-distributed sparse operators over a 1-D device mesh (port of
``faspsolver_tpu/parallel/pcsr.py``).

The reference is OpenMP shared-memory only; this layer spreads a solve
over the ranks of a ``torch.distributed`` process group, one device per
rank.  The JAX package places arrays with ``jax.device_put`` and lets
GSPMD derive the communication; here:

- a mesh is a 1-D ``DeviceMesh`` over the process group's ranks, its
  dimension named ``axis``;
- vectors are DTensors split by rows, ``Shard(0)`` (rows padded to a
  multiple of the mesh size); the Krylov solvers run unchanged on them:
  a dot of two sharded vectors is a pending sum that the solvers reduce
  once (``krylov.common.replicated``);
- an operator's arrays are DTensors split the same way (ELL and block
  rows ``Shard(0)``); the ELL apply gathers x whole and reads its own
  rows, the form of the JAX package's GSPMD gather (an all-gather);
- a replicated module is held whole by every rank; a sharded vector
  that meets one is gathered (:func:`on_whole`), as GSPMD does.

``make_mesh`` uses the process group the caller initialised; with none it
makes a one-rank group (NCCL on the card, gloo for ``device="cpu"``)
whose ``FileStore`` lies under ``tempfile.mkdtemp()``, and
:func:`release_mesh` takes it down.  Before the group's NCCL
communicator is made (at its first collective) it sets
``NCCL_GRAPH_MIXING_SUPPORT=0`` unless the environment says otherwise:
with NCCL's support for mixing captured and uncaptured launches on one
communicator, every captured collective waits on an external event, and
the conditional body of a resident loop takes no event node
(``utils/graphs.py``).  The port's launches on a communicator are
ordered by the current stream and the same on every rank, which is
what NCCL asks of a communicator without that support.

Teardown: NCCL's ``destroy_process_group`` does not return while a CUDA
graph that captured the group's collectives lives, and the modules that
solved keep their resident graphs.  A group the caller initialised is
taken down by :func:`teardown` (every rank: ``graphs.release`` of the
group's programs, then ``destroy_process_group``), with the modules
still alive or not; :func:`release_mesh` does the same for the group
``make_mesh`` made.  A module that solves again on a live group
captures anew.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from .. import as_tensor, default_device, np_dtype
from ..formats import CSRMatrix
from ..ops.operators import BsrEllOperator, EllOperator, block_ell_apply
from .comm import (local_rows, mesh_device, replicated, sharded, slab,
                   split, whole)

# the one-rank process group make_mesh made itself: (store directory,)
_OWN_GROUP: list = []


def make_mesh(n_devices: Optional[int] = None, axis: str = "rows",
              device=None):
    """1-D device mesh over the first ``n_devices`` ranks of the process
    group (all of them by default).  Raises where the group has fewer
    ranks than asked.  Without a process group, a request for one rank
    makes a one-rank group on ``device`` (None: the CUDA device, as the
    drivers do; it raises where there is none).  Call it before the
    group's first collective: it turns NCCL's graph mixing off (module
    docstring)."""
    from torch.distributed.device_mesh import DeviceMesh
    os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
    if not dist.is_initialized():
        if (n_devices or 1) != 1:
            raise RuntimeError(
                f"requested a {n_devices}-rank mesh but no process group is "
                f"initialised; start {n_devices} processes and call "
                f"torch.distributed.init_process_group(world_size="
                f"{n_devices}) in each first")
        _init_one_rank(device)
    ws = dist.get_world_size()
    n = n_devices or ws
    if ws < n:
        raise RuntimeError(
            f"requested a {n}-rank mesh but the process group has only "
            f"{ws} rank(s); start {n} processes")
    if device is not None:
        dev_type = torch.device(device).type
    else:
        dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, list(range(n)), mesh_dim_names=(axis,))


def _init_one_rank(device) -> None:
    dev = torch.device(device) if device is not None else default_device()
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        backend = "nccl"
    store_dir = tempfile.mkdtemp(prefix="fasp_pg_")
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        rank=0, world_size=1)
    _OWN_GROUP.append(store_dir)


def release_mesh() -> None:
    """Take down the one-rank process group :func:`make_mesh` made (and
    its store), its graphs released first (:func:`teardown`); a group the
    caller initialised is left alone."""
    while _OWN_GROUP:
        store_dir = _OWN_GROUP.pop()
        if dist.is_initialized():
            teardown()
        shutil.rmtree(store_dir, ignore_errors=True)


def teardown(group=None) -> int:
    """Take down a process group the caller initialised (None: the
    default group and every other, as ``destroy_process_group()``):
    release every kept program whose capture may hold its collectives
    (``graphs.release``; for None, those of every group), then destroy
    it.  NCCL's teardown otherwise waits for those graphs.  Call it on
    every rank; returns the number of programs released."""
    from ..utils import graphs
    groups = graphs.captured_groups() if group is None else [group]
    n = sum(graphs.release(g) for g in groups)
    dist.destroy_process_group(group)
    return n


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_rows(t: torch.Tensor, target: int) -> torch.Tensor:
    if t.shape[0] == target:
        return t
    pad = t.new_zeros((target - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def shard_rows(op: EllOperator, mesh, axis: str = "rows") -> EllOperator:
    """An ELL operator's arrays split by rows over the mesh.  Rows are
    padded with zero rows to a multiple of the mesh size, and the
    operator works on the padded square system (padded rows stay zero in
    every Krylov iterate)."""
    dev = mesh_device(mesh)
    target = _round_up(op.cols.shape[0], mesh.size())
    cols = _pad_rows(op.cols, target).to(dev)
    vals = _pad_rows(op.vals, target).to(dev)
    out = EllOperator(cols, vals, target, target)
    out.register_buffer("cols", split(cols, mesh))
    out.register_buffer("vals", split(vals, mesh))
    return out


def ell_apply(op: EllOperator, x):
    """y = A x for an ELL operator split by rows: x gathered whole, each
    rank its own rows."""
    mesh = x.device_mesh
    xw = whole(x)
    cols = local_rows(op.cols, mesh)
    g = xw.index_select(0, cols.reshape(-1)).reshape(cols.shape)
    return sharded((local_rows(op.vals, mesh) * g).sum(dim=1), mesh, op.n)


def shard_block_rows(op: BsrEllOperator, mesh, axis: str = "rows"
                     ) -> BsrEllOperator:
    """A block-ELL (BSR) operator's block rows split over the mesh; the
    apply gathers x whole (the GSPMD form of the reference's SPE01 flow,
    SolBSR.c:349).  The block-row count must divide the mesh size."""
    if op.nbrow % mesh.size():
        raise ValueError("nbrow must divide the mesh size")
    dev = mesh_device(mesh)
    out = BsrEllOperator(op.cols.to(dev), op.vals.to(dev), op.nbrow,
                         op.nbcol, op.nb)
    out.register_buffer("cols", split(out.cols, mesh))
    out.register_buffer("blocks", split(out.blocks, mesh))
    return out


def bsr_apply(op: BsrEllOperator, x):
    """y = A x for a block-ELL operator split by block rows."""
    mesh = x.device_mesh
    xw = whole(x)
    y = block_ell_apply(local_rows(op.blocks, mesh),
                        local_rows(op.cols, mesh),
                        xw.reshape(op.nbcol, op.nb)).reshape(-1)
    return sharded(y, mesh, op.n)


def shard_vector(x, mesh, axis: str = "rows"):
    """A vector split by rows over the mesh, zero-padded to a multiple of
    the mesh size."""
    dev = mesh_device(mesh)
    x = x.to(dev) if isinstance(x, torch.Tensor) else as_tensor(x, None, dev)
    target = _round_up(x.shape[0], mesh.size())
    return split(_pad_rows(x, target), mesh)


def replicate(tree, mesh):
    """A module (an AMG hierarchy for the coarse levels) or a tensor held
    whole by every rank of the mesh.  A module is moved to the mesh's
    device and stays plain: a sharded vector that reaches it is gathered
    (:func:`on_whole`); a tensor becomes a replicated DTensor."""
    dev = mesh_device(mesh)
    if isinstance(tree, torch.nn.Module):
        return tree.to(dev)
    return replicated(tree.to(dev), mesh)


def on_whole(fn, x):
    """fn applied to the whole of a DTensor vector on every rank, the
    result laid out as x is (every rank keeps its own rows)."""
    y = fn(whole(x))
    mesh = x.device_mesh
    if any(p.is_shard() for p in x.placements):
        lo, hi = slab(mesh, y.shape[0])
        return sharded(y[lo:hi], mesh, y.shape[0])
    return replicated(y, mesh)


def dist_operator(A: CSRMatrix, mesh, dtype=None, axis: str = "rows"
                  ) -> EllOperator:
    """A row-split ELL operator straight from a host matrix: rows padded
    with zero rows to a multiple of the mesh size (the JAX package's
    ``row_align``), the square padded system; pad b the same way
    (:func:`shard_vector`) and read x[:n]."""
    npdt = np_dtype(dtype)
    n = A.nrow
    ell = EllOperator.from_csr(A, dtype=npdt)
    target = _round_up(max(n, 1), mesh.size())
    cols = _pad_rows(ell.cols[:n], target)
    vals = _pad_rows(ell.vals[:n], target)
    return shard_rows(EllOperator(cols, vals, target, target), mesh, axis)
