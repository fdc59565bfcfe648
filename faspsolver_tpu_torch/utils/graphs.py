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
  preconditioners, the AMG cycles);
- :func:`release` destroys the kept programs that captured a process
  group's collectives (or all of them), which NCCL's teardown of the
  group waits for: ``parallel.teardown`` and ``parallel.release_mesh``
  call it before ``destroy_process_group``.  A module that solves again
  captures anew.

A captured function issues device work on the current stream and
nothing else: no host read, no host-to-device copy.  It reads and writes
tensors allocated outside the capture; its result is copied into static
outputs allocated outside the capture too.  So what one program's replay
overwrites in a shared pool is only the intermediates of another, which
nothing reads.

A module declares that its apply keeps these rules with ``capturable``
(:func:`capturable`).  Only modules whose apply was read for host reads
declare it, so anything else runs eagerly and is never tried and caught.
On a CPU tensor, a DTensor whose mesh does not communicate over NCCL
(gloo), inside another capture (graphs nest inline) or under
:func:`eager`, the same functions simply run (:func:`active`).  A DTensor
on CUDA over an NCCL mesh is captured as a plain tensor is: its local
ops and the collectives that DTensor and ``parallel/comm.py`` issue on
the current stream become nodes of the graph (the counterpart of the
JAX package's ``psum`` and ``ppermute`` inside one jitted loop).  Every
flag a control kernel reads is computed from all-reduced, replicated
values, which every rank holds bit for bit, so every rank leaves each
While at the same step and meets the same collectives.

A replay issues nothing through the kernels' wrappers, so each program
records the launches its capture made and adds them to
``ops.stencil2d.launches`` and ``utils.loops.launches`` at every replay:
a warm graphed solve counts the launches an eager one does (a cold one
adds those of each program's warm-up run, which really ran).  ``stats`` counts captures, replays, graph
nodes, capture seconds and the memory the captures reserved.

The solve loops (the counterpart of ``lax.while_loop`` / ``lax.cond``)
are trees of :class:`Piece` (a function of static tensors), :class:`If`
and :class:`While`, whose conditions are flags of a loop's state region
(``utils/loops.py``): ``NEED`` for an If, ``CONT`` for a While.  The
same tree runs two ways:

- :func:`run_eager`, the eager loop: the pieces in order, each condition
  read on the host (one counted read of the state block at a While's
  entry, at each If, and after a body whose If ran or that has none);
- :class:`Resident`, one CUDA graph: every piece captured once (a
  warm-up run of all of them first, undone through ``keep``; one memory
  pool), embedded as a child graph, and each If / While a conditional
  node whose handle the loop-control kernel sets from the same flag.  A
  solve is one launch of it and one read of the block at the end.  The
  device counts the executions of each body (``NBODY``, ``NIF``), from
  which :meth:`Resident.account` adds each piece's recorded launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import time
import weakref
from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch import nn

from .. import is_dtensor
from ..ops import stencil2d
from . import loops

_enabled = True
_programs = weakref.WeakKeyDictionary()
# every kept program (a loop state's Resident, a module's Program),
# weakly: (the process groups its capture may hold collectives of, the
# loop state that holds it)
_kept = weakref.WeakKeyDictionary()

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
    """Whether work on ``t`` replays graphs: a CUDA tensor (a DTensor:
    its local part on CUDA, its mesh over NCCL), graphs not switched
    off, and no capture under way (a capture takes nested work
    inline)."""
    if not (_enabled and isinstance(t, torch.Tensor)):
        return False
    if is_dtensor(t):
        if not over_nccl(t.device_mesh):
            return False
        t = t.to_local()
    return (t.device.type == "cuda"
            and not torch.cuda.is_current_stream_capturing())


def over_nccl(mesh) -> bool:
    """Whether every process group of a device mesh is NCCL's, whose
    collectives a CUDA graph captures (gloo's run on the host)."""
    import torch.distributed as dist
    return all(dist.get_backend(g) == "nccl" for g in mesh.get_all_groups())


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
    modules hold no parameters): what a captured graph reads.  A DTensor
    buffer holds no storage of its own: its local part's, with the
    mesh's size and this rank."""
    if not isinstance(module, nn.Module):
        return ()
    return tuple(_address(t) for t in module.buffers())


def _address(t) -> tuple:
    if is_dtensor(t):
        mesh = t.device_mesh
        return _address(t.to_local()) + (mesh.size(),
                                         mesh.get_local_rank())
    return (t.data_ptr(), t.dtype, tuple(t.shape))


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


def _groups(tensors) -> tuple:
    """The process groups of the meshes of the DTensors among
    ``tensors``: those whose collectives a capture over them may hold."""
    out = []
    for t in tensors:
        if is_dtensor(t):
            out += [g for g in t.device_mesh.get_all_groups()
                    if g not in out]
    return tuple(out)


def _keep(prog, tensors, owner=None):
    """Note ``prog`` as kept (by ``owner``, a loop state, or by a
    module's :func:`cached` slot), captured over ``tensors``."""
    _kept[prog] = (_groups(tensors), _ref(owner))
    return prog


def kept(group=None) -> list:
    """The kept programs whose capture may hold ``group``'s collectives
    (every kept program when ``group`` is None)."""
    return [p for p, (groups, _) in list(_kept.items())
            if group is None or group in groups]


def captured_groups() -> list:
    """Every process group whose collectives a kept program's capture
    may hold."""
    out = []
    for groups, _ in list(_kept.values()):
        out += [g for g in groups if g not in out]
    return out


def release(group=None) -> int:
    """Destroy every kept program whose capture may hold ``group``'s
    collectives (a process group; None: every kept program) and drop it
    from the module or loop state that keeps it, so a later solve
    captures anew; returns how many.  The device is synchronized first:
    no launch of them is pending.  NCCL's teardown of a group waits for
    every graph that captured its collectives, so a multi-rank run calls
    this (through ``parallel.teardown``) before
    ``destroy_process_group``."""
    progs = kept(group)
    devices = {p.device for p in progs if p.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)
    gone = set()
    for p in progs:
        _, owner = _kept.pop(p)
        p.destroy()
        st = owner()
        if st is not None and st.prog is p:
            st.prog = None
            gone.add(id(st))
        gone.add(id(p))
    for slots in list(_programs.values()):
        for slot, hit in list(slots.items()):
            if id(hit[2]) in gone:
                del slots[slot]
    for d in devices:
        torch.cuda.synchronize(d)
    return len(progs)


_COUNTERS = (stencil2d.launches, loops.launches)


@contextlib.contextmanager
def _recorded():
    """Record the kernel launches a capture issues, by the counters' keys
    (the stencil kernel's dtypes, the loop control's entry points), and
    take them back off the counters: a capture launches nothing."""
    before = [dict(c) for c in _COUNTERS]
    made = {}
    try:
        yield made
    finally:
        for c, b in zip(_COUNTERS, before):
            made.update({k: c[k] - v for k, v in b.items()})
            c.update(b)


def _add_launches(recorded, times: int) -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] += recorded[k] * times


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
    stream (libraries load, plans build, a DTensor's first collective
    creates the NCCL communicator and the distribution layer its
    per-rank caches: a capture can make none of them); the tensors in
    ``keep`` are restored after that run, so the warm-up changes no
    state (its launches ran and count).  The capture runs nothing: its
    stencil launches are recorded, and each :meth:`replay` adds them to
    the counter.  Its result lands in ``self.out``, a static tensor that
    every replay overwrites.  ``pool`` is another program's ``pool`` to
    share (its memory pool; default a new one).  ``capture_s`` times the
    capture and instantiation (not the warm-up), ``bytes`` the memory
    they reserved.  :meth:`destroy` frees the graph; a replay after it
    raises."""

    def __init__(self, fn, device, keep=(), pool=None):
        device = self.device = torch.device(device)
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
        with _recorded() as self.launches:
            with torch.cuda.graph(self.graph, pool=pool):
                out = fn()
                if out is not None:
                    self.out.copy_(out)
        self.pool = self.graph.pool()
        self.nodes = _count_nodes(self.graph)
        self.graph.instantiate()
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.bytes = torch.cuda.memory_reserved(device) - reserved
        stats["captures"] += 1
        stats["capture_s"] += self.capture_s
        stats["graph_bytes"] += self.bytes
        stats["nodes_captured"] += self.nodes or 0

    def destroy(self) -> None:
        self.graph.reset()
        self.graph = None

    def replay(self):
        if self.graph is None:
            raise RuntimeError("replaying a released program")
        self.graph.replay()
        _add_launches(self.launches, 1)
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
    return _keep(prog, (r,))


# ---------------------------------------------------------------------------
# resident loops: lax.while_loop / lax.cond as CUDA conditional nodes
# ---------------------------------------------------------------------------

class Piece(NamedTuple):
    """Device work on static tensors: no host read, no allocation that
    outlives it, nothing but kernels and device copies."""
    fn: Callable[[], None]


class If(NamedTuple):
    """``body`` runs where ``reg``'s ``NEED`` flag is set (the
    counterpart of ``lax.cond``); the control before it sets the flag
    and ``reg.h_if``."""
    reg: "loops.Region"
    body: Sequence


class While(NamedTuple):
    """``body`` runs while ``reg``'s ``CONT`` flag is set (the
    counterpart of ``lax.while_loop``): set before the loop by an init
    control, and by the body's last control.  ``entry``: the entry test
    where the host knows it (the eager loop then reads nothing first)."""
    reg: "loops.Region"
    body: Sequence
    entry: Optional[bool] = None


def run_eager(tree: Sequence, block, host):
    """Run a loop tree eagerly, reading ``block`` on the host through
    ``host`` (``krylov.common.HostReads``) where a condition is needed:
    at a While's entry (unless ``entry`` says), at each If, and after a
    body whose If ran or that has none (a check leaves the While's
    ``CONT`` as the body's end will set it when its If does not run).
    Returns the last read (decoded), or None if nothing was read."""
    last = [None]

    def read(reg):
        last[0] = host.block(block)
        return last[0][reg.name].i

    def run(items):
        for item in items:
            if isinstance(item, Piece):
                item.fn()
                continue
            if not isinstance(item, While):
                raise TypeError("an If runs inside a While body")
            cont = (item.entry if item.entry is not None
                    else read(item.reg)[loops.I.CONT])
            while cont:
                cont = None
                for sub in item.body:
                    if isinstance(sub, If):
                        i = read(sub.reg)
                        if i[loops.I.NEED]:
                            run(sub.body)
                        else:
                            cont = i[loops.I.CONT]
                    else:
                        run((sub,))
                if cont is None:
                    cont = read(item.reg)[loops.I.CONT]

    run(tree)
    return last[0]


def _pieces(tree):
    """The tree's pieces in execution order."""
    for item in tree:
        if isinstance(item, Piece):
            yield item
        else:
            yield from _pieces(item.body)


def _regions(tree):
    for item in tree:
        if not isinstance(item, Piece):
            yield item.reg
            yield from _regions(item.body)


# node kinds a conditional body refuses (CUgraphNodeType values)
_NODE_KINDS = {3: "host", 6: "event wait", 7: "event record",
               8: "external semaphore signal", 9: "external semaphore wait",
               10: "memory allocation", 11: "memory free",
               12: "batch memory operation"}


# CUgraphInstantiateResult values
_INSTANTIATE = {1: "error", 2: "invalid structure",
                3: "node operation not supported",
                4: "multiple devices not supported",
                5: "conditional handle unused"}


def _destroy(lib, graph, exe):
    if exe.value:
        lib.fasp_graph_exec_destroy(exe)
    if graph.value:
        lib.fasp_graph_destroy(graph)


class Resident:
    """A loop tree as ONE CUDA graph on ``device``, launched once per
    solve.

    The pieces run once for real first (libraries load, plans build,
    NCCL communicators and the distribution layer's per-rank caches are
    made, and each side of every If is warmed), then the tensors in
    ``keep`` are restored.  Each piece is then captured with
    ``torch.cuda.graph`` (all into one memory pool: they never run
    concurrently) and embedded as a child graph node; each If / While
    becomes a conditional node
    whose handle is created in the graph that holds it and handed to the
    control kernels through their region (``h_if`` / ``h_while``) while
    the pieces are captured.  A piece inside a conditional may hold
    kernels, device copies and memsets only: anything else raises, as
    does any failed call.  ``capture_s`` times the captures and the
    instantiation, ``bytes`` the memory they reserved.  :meth:`destroy`
    frees the graphs; a launch after it raises."""

    def __init__(self, tree: Sequence, device, keep=()):
        device = torch.device(device)
        lib = loops.library()
        self._lib = lib
        saved = [t.clone() for t in keep]
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        # eagerly: a module's own graph (GraphedModule) is not made for a
        # program that captures it inline
        with torch.cuda.stream(side), eager():
            for piece in _pieces(tree):
                piece.fn()
        cur.wait_stream(side)
        for t, s in zip(keep, saved):
            t.copy_(s)
        del saved
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        weakref.finalize(self, _destroy, lib, self._graph, self._exec)
        loops.check_graph(lib.fasp_graph_create(ctypes.byref(self._graph)),
                    "cudaGraphCreate")
        self.pool = None
        self.runs = []          # (captured graph, launches, nodes, counter)
        regs = list(_regions(tree))
        try:
            self._build(self._graph, tree, None)
        finally:
            for reg in regs:
                reg.h_while = reg.h_if = 0
        result, kind = ctypes.c_int(0), ctypes.c_int(-1)
        loops.check_graph(lib.fasp_graph_instantiate(
            ctypes.byref(self._exec), self._graph, ctypes.byref(result),
            ctypes.byref(kind)),
            f"instantiating the resident loop's graph (result "
            f"{_INSTANTIATE.get(result.value, result.value)}, at a node "
            f"of kind {kind.value})")
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.bytes = torch.cuda.memory_reserved(device) - reserved
        self.nodes = sum(r[2] for r in self.runs)
        self.device = device
        stats["captures"] += len(self.runs)
        stats["capture_s"] += self.capture_s
        stats["graph_bytes"] += self.bytes
        stats["nodes_captured"] += self.nodes

    def _handle(self, graph) -> int:
        h = ctypes.c_ulonglong(0)
        loops.check_graph(self._lib.fasp_graph_handle(graph, ctypes.byref(h)),
                    "cudaGraphConditionalHandleCreate")
        return h.value

    def _build(self, graph, items, counter):
        lib = self._lib
        # the handles of this level's conditionals first: the pieces
        # before a conditional set it
        for item in items:
            if isinstance(item, While):
                item.reg.h_while = self._handle(graph)
            elif isinstance(item, If):
                item.reg.h_if = self._handle(graph)
        prev = None
        for item in items:
            node = ctypes.c_void_p()
            if isinstance(item, Piece):
                cg = self._capture(item, counter)
                loops.check_graph(lib.fasp_graph_add_child(
                    graph, prev, ctypes.c_void_p(cg.raw_cuda_graph()),
                    ctypes.byref(node)), "adding a loop piece to its graph")
            else:
                body = ctypes.c_void_p()
                kind = isinstance(item, While)
                loops.check_graph(lib.fasp_graph_add_conditional(
                    graph, prev, item.reg.h_while if kind else item.reg.h_if,
                    int(kind), ctypes.byref(node), ctypes.byref(body)),
                    "adding a conditional node")
                self._build(body, item.body, (
                    item.reg.name, loops.I.NBODY if kind else loops.I.NIF))
            prev = node

    def _capture(self, piece, counter):
        cg = torch.cuda.CUDAGraph(keep_graph=True)
        with _recorded() as launched:
            with torch.cuda.graph(cg, pool=self.pool):
                piece.fn()
        if self.pool is None:
            self.pool = cg.pool()
        n, refused = ctypes.c_size_t(0), ctypes.c_int(-1)
        loops.check_graph(self._lib.fasp_graph_node_kinds(
            ctypes.c_void_p(cg.raw_cuda_graph()), ctypes.byref(n),
            ctypes.byref(refused)), "reading a captured piece's nodes")
        if counter is not None and refused.value >= 0:
            raise RuntimeError(
                f"a piece of a resident loop holds a "
                f"{_NODE_KINDS.get(refused.value, refused.value)} node, "
                f"which a conditional body does not take (a captured NCCL "
                f"collective holds event nodes unless "
                f"NCCL_GRAPH_MIXING_SUPPORT=0 was set before its "
                f"communicator was made, as parallel.make_mesh does)")
        self.runs.append((cg, launched, int(n.value), counter))
        return cg

    def destroy(self) -> None:
        """Free the executable, the graph and the pieces' captured graphs
        (the finalizer then finds nothing left to free)."""
        _destroy(self._lib, self._graph, self._exec)
        self._graph.value = self._exec.value = None
        for cg, *_ in self.runs:
            cg.reset()
        self.runs, self.pool = [], None

    def launch(self) -> None:
        """One launch of the whole loop on the current stream."""
        if not self._exec.value:
            raise RuntimeError("launching a released resident loop")
        loops.check_graph(self._lib.fasp_graph_launch(
            self._exec, ctypes.c_void_p(
                torch.cuda.current_stream(self.device).cuda_stream)),
            "launching the resident loop")
        stats["replays"] += 1

    def account(self, vals) -> None:
        """Add each piece's recorded launches and nodes times its
        executions in the launch just read (``vals``: the decoded
        block)."""
        for _, launched, nodes, counter in self.runs:
            times = 1 if counter is None else int(
                vals[counter[0]].i[counter[1]])
            _add_launches(launched, times)
            stats["nodes_replayed"] += nodes * times


class LoopState:
    """The static tensors of one loop program (subclasses set them) with
    its state block and, once captured, its :class:`Resident`."""

    block = None
    prog: Optional[Resident] = None

    def tensors(self):
        """Every tensor the program changes (the block included), for
        the warm-up's ``keep``; nested loop states' too."""
        out = [] if self.block is None else [self.block.bytes]
        for v in vars(self).values():
            if isinstance(v, LoopState):
                out += v.tensors()
            elif isinstance(v, torch.Tensor) and all(v is not t
                                                     for t in out):
                out.append(v)
        return out


def run_loop(st: LoopState, tree: Callable[[], Sequence], host,
             resident: bool):
    """Run a loop program over state ``st``: launch its resident program
    (captured from ``tree()`` at the first resident run) and read the
    block once, or run ``tree()`` eagerly.  Returns the decoded block of
    the last read (None if the eager loop read nothing)."""
    if not resident:
        return run_eager(tree(), st.block, host)
    if st.prog is None:
        keep = st.tensors()
        st.prog = _keep(Resident(tree(), st.block.bytes.device, keep),
                        keep, st)
    st.prog.launch()
    vals = host.block(st.block)
    st.prog.account(vals)
    return vals
