"""What the distribution layer sends between ranks, and a record of it.

The JAX package shards arrays over a device mesh (GSPMD), exchanges halos
with ``jax.lax.ppermute`` inside ``shard_map`` regions and checks its
communication on the compiled HLO text.  Here a vector is a DTensor over
a 1-D ``DeviceMesh`` (one rank per device), the operators exchange their
halos with their neighbours by point-to-point sends (:func:`exchange`,
``dist.batch_isend_irecv``) and gather a whole vector (:func:`whole`)
where an operator needs all of it.  :func:`record` collects what one run
communicates: the P2P sends and elements counted in :func:`exchange`,
and every collective operation the dispatcher sees, with its element
count.  Those are the operations ``torch.distributed.tensor.debug.
CommDebugMode`` counts (the c10d and functional collectives, P2P not
among them); its counts carry no sizes, and its module tracker fails on
modules that call other modules' ``forward`` inside a recorded cycle, so
the record keeps its own.  A record runs its block eagerly
(``utils.graphs.eager()``): a replayed graph issues its sends and
collectives from the device, where neither count sees them.

Over an NCCL mesh the sends, the all-gathers and DTensor's all-reduces
are issued on the current stream and ``req.wait()`` makes that stream
wait for them (a stream dependency, no host block), so a CUDA graph
captures them as nodes (``utils/graphs.py``); over gloo they run, and
wait, on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import is_dtensor
from ..utils import graphs

# P2P sends and elements since the process started, counted where the
# host calls exchange() (read by record(), which runs eagerly)
_P2P = {"sends": 0, "elements": 0}

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_NOT_COLLECTIVES = ("send", "recv", "wait", "barrier", "monitored")


def mesh_device(mesh) -> torch.device:
    """The device this rank's local tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def slab(mesh, n: int) -> Tuple[int, int]:
    """[start, end) of this rank's rows of an n-row vector split evenly."""
    ws = mesh.size()
    if n % ws:
        raise ValueError(f"{n} rows do not split evenly over {ws} ranks")
    b = n // ws
    r = mesh.get_local_rank()
    return r * b, (r + 1) * b


def sharded(local: torch.Tensor, mesh, n: int, dim: int = 0):
    """This rank's piece of a tensor split along ``dim`` (n entries in
    all) as a DTensor, with no communication."""
    from torch.distributed.tensor import DTensor, Shard
    shape = list(local.shape)
    shape[dim] = n
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, [Shard(dim)], run_check=False,
                              shape=torch.Size(shape), stride=stride)


def replicated(t: torch.Tensor, mesh):
    """A tensor every rank holds whole, as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()], run_check=False)


def split(t: torch.Tensor, mesh, dim: int = 0):
    """A tensor every rank holds whole, split along ``dim``: this rank
    keeps its piece (no communication)."""
    n = t.shape[dim]
    lo, hi = slab(mesh, n)
    return sharded(t.narrow(dim, lo, hi - lo).contiguous(), mesh, n, dim)


def local_part(x, mesh, n: int) -> torch.Tensor:
    """This rank's rows of an n-row vector: a sharded DTensor's local
    piece, or the rank's slab of a vector every rank holds whole."""
    if is_dtensor(x):
        return x.to_local()
    lo, hi = slab(mesh, n)
    return x[lo:hi]


def local_rows(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This rank's piece of an operator's array along ``dim``: a split
    DTensor's local piece, or the rank's slice of an array every rank
    holds whole (a replicated operator given a sharded vector)."""
    if is_dtensor(t):
        return t.to_local()
    lo, hi = slab(mesh, t.shape[dim])
    return t.narrow(dim, lo, hi - lo)


def whole(x) -> torch.Tensor:
    """The whole vector on every rank (an all-gather for a sharded
    DTensor, nothing for a plain tensor)."""
    return x.full_tensor() if is_dtensor(x) else x


def emit(y_local: torch.Tensor, mesh, n: int, shard: bool):
    """Rows computed by this rank as a level's vector: sharded, or whole
    on every rank (an all-gather)."""
    if shard:
        return sharded(y_local, mesh, n)
    if mesh.size() == 1:
        return y_local
    out = y_local.new_empty(n)
    dist.all_gather_into_tensor(out, y_local.contiguous(),
                                group=mesh.get_group())
    return out


def exchange(mesh, to_left: torch.Tensor, to_right: torch.Tensor):
    """Send ``to_left`` to rank i - 1 and ``to_right`` to rank i + 1;
    return ``(from_left, from_right)``, what they sent this rank.  The
    end ranks receive zeros, the zero halo of the matrix boundary (the
    JAX package's ``ppermute`` to i +- 1, ``halo.py:119-122``)."""
    r, ws = mesh.get_local_rank(), mesh.size()
    ranks = mesh.mesh.flatten().tolist()
    group = mesh.get_group()
    to_left, to_right = to_left.contiguous(), to_right.contiguous()
    from_left = torch.zeros(to_right.shape, dtype=to_right.dtype,
                            device=to_right.device)
    from_right = torch.zeros(to_left.shape, dtype=to_left.dtype,
                             device=to_left.device)
    ops = []
    if r + 1 < ws:
        ops += [dist.P2POp(dist.isend, to_right, ranks[r + 1], group),
                dist.P2POp(dist.irecv, from_right, ranks[r + 1], group)]
        _P2P["sends"] += 1
        _P2P["elements"] += to_right.numel()
    if r > 0:
        ops += [dist.P2POp(dist.isend, to_left, ranks[r - 1], group),
                dist.P2POp(dist.irecv, from_left, ranks[r - 1], group)]
        _P2P["sends"] += 1
        _P2P["elements"] += to_left.numel()
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


def neighbour_blocks(mesh, x_l: torch.Tensor) -> torch.Tensor:
    """[left neighbour's block; this block; right neighbour's block],
    zeros at the ends (the JAX package's ``_nbr_ext``)."""
    from_left, from_right = exchange(mesh, x_l, x_l)
    return torch.cat([from_left, x_l, from_right])


@dataclasses.dataclass
class CommRecord:
    """One run's communication on this rank: P2P sends and the elements
    they carried, and every collective as (operation, elements)."""
    world_size: int
    p2p_sends: int = 0
    p2p_elements: int = 0
    collectives: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)

    def of_kind(self, word: str) -> List[int]:
        """Element counts of the collectives whose name holds ``word``
        ("gather", "reduce", "scatter")."""
        return [e for name, e in self.collectives if word in name]

    def summary(self) -> str:
        kinds: Dict[str, List[int]] = {}
        for name, e in self.collectives:
            kinds.setdefault(name, []).append(e)
        parts = [f"{k} x{len(v)} (largest {max(v)})"
                 for k, v in sorted(kinds.items())]
        return (f"P2P sends {self.p2p_sends} ({self.p2p_elements} "
                f"elements); collectives: {', '.join(parts) or 'none'}")


class _CollectiveSpy(TorchDispatchMode):
    """Notes every collective operation with its largest tensor (for an
    all-gather, the gathered vector)."""

    def __init__(self, rec: CommRecord):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._opname
        if (func.namespace in _COLLECTIVE_NAMESPACES
                and not name.startswith(_NOT_COLLECTIVES)):
            leaves, _ = tree_flatten((args, kwargs, out))
            elems = max((t.numel() for t in leaves
                         if isinstance(t, torch.Tensor)), default=0)
            self.rec.collectives.append((name, elems))
        return out


@contextlib.contextmanager
def record(mesh):
    """Record what the block communicates on this rank, running it
    eagerly (a graph's replay would send unseen)."""
    rec = CommRecord(world_size=mesh.size())
    sends, elems = _P2P["sends"], _P2P["elements"]
    with graphs.eager(), _CollectiveSpy(rec):
        yield rec
    rec.p2p_sends = _P2P["sends"] - sends
    rec.p2p_elements = _P2P["elements"] - elems
