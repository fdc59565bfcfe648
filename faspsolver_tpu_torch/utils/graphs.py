"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs a solve as one compiled device program (``jax.jit``
over ``lax.while_loop``), cached by the signature of its arguments.  Here
the same work is captured once as CUDA graphs and replayed:

- :class:`Program` captures a function of static tensors (a side-stream
  warm-up run first, then the capture) and replays it; the programs of
  one solve's loop share a memory pool (the PCG's two segments, the
  refinement round's two stages);
- :func:`cached` keeps programs per module, weakly (a program dies with
  its module), and captures again when the key changes: the key holds
  the buffers' addresses (:func:`fingerprint`), so a module that moved
  (``.to()``, ``.double()``) is captured anew and a copy captures its own;
- :class:`GraphedModule` replays a module's whole apply (the ILU
  preconditioners, the AMG cycles).

A captured function issues device work on the current stream and
nothing else: no host read, no host-to-device copy.  It reads and writes
tensors allocated outside the capture; its result is copied into static
outputs allocated outside the capture too.  So what one program's replay
overwrites in a shared pool is only the intermediates of another, which
nothing reads.

A module declares that its apply keeps these rules with ``capturable``
(:func:`capturable`).  Only modules whose apply was read for host reads
declare it, so anything else runs eagerly and is never tried and caught.
On a CPU tensor, a DTensor, inside another capture (graphs nest inline)
or under :func:`eager`, the same functions simply run (:func:`active`).

A replay issues nothing through the stencil kernel's wrapper, so each
program records the launches its capture made and adds them to
``ops.stencil2d.launches`` at every replay: a warm graphed solve counts
the launches an eager one does (a cold one adds those of each program's
warm-up run, which really ran).  ``stats`` counts captures, replays, graph
nodes, capture seconds and the memory the captures reserved.
"""
from __future__ import annotations

import contextlib
import ctypes
import time
import weakref

import torch
from torch import nn

from .. import is_dtensor
from ..ops import stencil2d

_enabled = True
_programs = weakref.WeakKeyDictionary()

stats = {"captures": 0, "capture_s": 0.0, "graph_bytes": 0,
         "nodes_captured": 0, "replays": 0, "nodes_replayed": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = type(stats[k])(0)


@contextlib.contextmanager
def eager():
    """Run everything eagerly on the card too (a check against the
    graphs: the same functions, launched one by one)."""
    global _enabled
    saved, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = saved


def active(t) -> bool:
    """Whether work on ``t`` replays graphs: a plain CUDA tensor, graphs
    not switched off, and no capture under way (a capture takes nested
    work inline)."""
    return (_enabled and isinstance(t, torch.Tensor) and not is_dtensor(t)
            and t.device.type == "cuda"
            and not torch.cuda.is_current_stream_capturing())


def capturable(obj) -> bool:
    """Whether ``obj`` declares that its apply may be captured."""
    return bool(getattr(obj, "capturable", False))


def identity(obj):
    """(home, static): the module whose buffers a graph over ``obj``
    reads, and the settings it bakes in.  A module may say
    (``graph_identity``): an AMG preconditioner is its hierarchy and its
    cycle count, so a new wrapper of one hierarchy replays its graphs."""
    fn = getattr(obj, "graph_identity", None)
    return fn() if fn is not None else (obj, ())


def fingerprint(module) -> tuple:
    """The addresses, dtypes and shapes of a module's buffers (the port's
    modules hold no parameters): what a captured graph reads."""
    if not isinstance(module, nn.Module):
        return ()
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                 for t in module.buffers())


def _ref(obj):
    return (lambda: None) if obj is None else weakref.ref(obj)


def cached(homes, slot, key, build):
    """``build()``'s value for ``homes`` (modules, or None for a part
    that holds nothing) under ``slot``, built anew when ``key`` differs
    or a home is not the one it was built for.  Kept while ``homes[0]``
    lives, one value per slot."""
    first, rest = homes[0], homes[1:]
    slots = _programs.setdefault(first, {})
    hit = slots.get(slot)
    if (hit is not None and hit[0] == key
            and all(r() is h for r, h in zip(hit[1], rest))):
        return hit[2]
    slots.pop(slot, None)            # the stale graph goes before a new one
    value = build()
    slots[slot] = (key, tuple(_ref(h) for h in rest), value)
    return value


def peek(home, slot):
    """What :func:`cached` keeps for ``home`` under ``slot``, or None."""
    hit = _programs.get(home, {}).get(slot) if home is not None else None
    return None if hit is None else hit[2]


def _count_nodes(graph):
    """Nodes of a kept graph, through the driver (None if it says no)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(int(graph.raw_cuda_graph())), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


class Program:
    """``fn()`` captured once as a CUDA graph on ``device``.

    ``fn`` reads and writes tensors allocated outside the capture and
    returns None or a tensor.  It runs once for real first, on a side
    stream (libraries load, plans build); the tensors in ``keep`` are
    restored after that run, so the warm-up changes no state (its
    launches ran and count).  The capture runs nothing: its stencil
    launches are recorded, and each :meth:`replay` adds them to the
    counter.  Its result lands in ``self.out``, a static tensor that every
    replay overwrites.  ``pool`` is another program's ``pool`` to share
    (its memory pool; default a new one).  ``capture_s`` times the
    capture and instantiation (not the warm-up), ``bytes`` the memory
    they reserved."""

    def __init__(self, fn, device, keep=(), pool=None):
        device = torch.device(device)
        saved = [t.clone() for t in keep]
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        for t, s in zip(keep, saved):
            t.copy_(s)
        self.out = None if out is None else torch.empty_like(out)
        del out, saved
        # what the capture reserves: the pool's growth from here on
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(stencil2d.launches)
        with torch.cuda.graph(self.graph, pool=pool):
            out = fn()
            if out is not None:
                self.out.copy_(out)
        self.pool = self.graph.pool()
        self.launches = {k: stencil2d.launches[k] - v
                         for k, v in before.items()}
        stencil2d.launches.update(before)     # the capture launched nothing
        self.nodes = _count_nodes(self.graph)
        self.graph.instantiate()
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.bytes = torch.cuda.memory_reserved(device) - reserved
        stats["captures"] += 1
        stats["capture_s"] += self.capture_s
        stats["graph_bytes"] += self.bytes
        stats["nodes_captured"] += self.nodes or 0

    def replay(self):
        self.graph.replay()
        for k, v in self.launches.items():
            stencil2d.launches[k] += v
        stats["replays"] += 1
        stats["nodes_replayed"] += self.nodes or 0
        return self.out


class GraphedModule(nn.Module):
    """A module whose apply ``eager(r)`` is a long run of small launches
    with static shapes and no host read.  On a CUDA tensor ``forward``
    replays it from a graph captured at the first call for r's dtype and
    shape (again after the buffers moved); elsewhere it runs ``eager``.

    The graph is kept by the module's home (:func:`identity`), so a new
    wrapper of the same buffers replays it; ``_graph`` reads and sets
    it, and a move (``nn.Module._apply``) drops it."""

    capturable = True

    @property
    def _graph(self):
        return peek(*self._graph_slot())

    @_graph.setter
    def _graph(self, value):
        home, slot = self._graph_slot()
        slots = _programs.setdefault(home, {})
        if value is None:
            slots.pop(slot, None)
        else:
            slots[slot] = (None, (), value)

    def _graph_slot(self):
        home, static = identity(self)
        return home, ("apply",) + static

    def _apply(self, fn, *args, **kwargs):
        self._graph = None
        return super()._apply(fn, *args, **kwargs)

    def eager(self, r: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        if not (active(r) and capturable(self)):
            return self.eager(r)
        home, slot = self._graph_slot()
        key = (r.dtype, tuple(r.shape), r.device, fingerprint(home))
        prog = cached((home,), slot, key,
                      lambda: _apply_program(self.eager, r))
        prog.r_in.copy_(r)
        return prog.replay().clone()


def _apply_program(fn, r: torch.Tensor) -> Program:
    r_in = r.clone()
    prog = Program(lambda: fn(r_in), r.device)
    prog.r_in = r_in
    return prog
