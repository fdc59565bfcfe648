"""``utils.graphs.release`` and the distribution layer's teardown on one
gloo rank on the CPU, in process.

NCCL's ``destroy_process_group`` does not return while a CUDA graph that
captured the group's collectives lives, so the port drops the programs
it keeps (a loop state's resident loop, a module's own graph) before a
group goes down.  Here the resident path runs on gloo DTensors through
``torch_dist_worker._resident(emulate=True)``: stand-ins that run each
program as the device runs its graph, registered and released by the
port's own bookkeeping as real programs are.  The release on the card
is held by ``tests/test_torch_gpu.py``'s across-ranks tests.
"""
import ctypes

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_dist_worker import _resident


@pytest.fixture
def own_group(tmp_path):
    """A one-rank gloo group this test initialised (as a caller does),
    taken down after the test if it still stands."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method="file://" + str(tmp_path / "store"))
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _solver(mesh):
    """AMG-PCG over the row-split DIA operator of poisson_2d(32) and its
    sharded structured hierarchy (phase 13's (b) at a small size):
    ``solve()`` and the two modules that keep its programs."""
    from faspsolver_tpu_torch import as_tensor
    from faspsolver_tpu_torch.krylov import pcg
    from faspsolver_tpu_torch.parallel import (dist_dia_operator,
                                               shard_hierarchy, shard_vector)
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import setup_structured
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils.params import AMGParam
    f64 = torch.float64
    A = poisson_2d(32)
    bd = shard_vector(as_tensor(A.matvec(np.ones(A.nrow)), f64), mesh)
    op = dist_dia_operator(A, mesh, dtype=f64)
    hs = shard_hierarchy(setup_structured(A, AMGParam(coarse_dof=60),
                                          dtype=f64, smooth_p=True),
                         mesh, min_size=256)
    M = AMGPrecond(hs)
    return (lambda: pcg(op, bd, M=M, tol=1e-10, maxit=400)), op, M, bd


def test_release_drops_every_kept_program_and_a_solve_captures_anew(
        own_group):
    """A resident solve keeps its loop program with the operator, and
    the preconditioner applied alone keeps the cycle's program with the
    hierarchy; both are registered with the mesh's group.  release(group)
    destroys both and returns 2: nothing is kept for the modules
    (``graphs.peek`` None, the loop state's program None, the registry
    holds nothing of the group), a destroyed program refuses to run, and
    a second release is a no-op.  The next solve captures anew, with the
    same count and x bit for bit.  (The registry is queried by group:
    programs that other tests of this process keep hold no group.)"""
    from faspsolver_tpu_torch.parallel import make_mesh
    from faspsolver_tpu_torch.utils import graphs
    mesh = make_mesh(device="cpu")
    group = mesh.get_group()
    solve, op, M, bd = _solver(mesh)
    home = graphs.identity(M)[0]
    with _resident(emulate=True):
        first = solve()
        M(bd)
        slots = {h: list(graphs._programs[h]) for h in (op, home)}
        progs = graphs.kept(group)
        states = [graphs.peek(op, s) for s in slots[op]]
    assert first.resident and first.syncs == 1
    assert len(progs) == 2 and set(progs) <= set(graphs.kept())
    assert group in graphs.captured_groups()
    assert [st.prog in progs for st in states] == [True]
    assert graphs.release(group) == 2
    assert graphs.kept(group) == []
    assert group not in graphs.captured_groups()
    for h, ss in slots.items():
        assert all(graphs.peek(h, s) is None for s in ss), h
    assert states[0].prog is None
    for p in progs:
        with pytest.raises(RuntimeError, match="released"):
            p.launch() if hasattr(p, "launch") else p.replay()
    assert graphs.release(group) == 0
    with _resident(emulate=True):
        again = solve()
        assert len(graphs.kept(group)) == 1
        assert graphs.kept(group)[0] not in progs
    assert again.resident and again.syncs == 1
    assert again.iters == first.iters > 3
    assert torch.equal(again.x.to_local(), first.x.to_local())
    assert graphs.release(group) == 1 and graphs.kept(group) == []


def test_release_of_another_group_keeps_the_programs(own_group):
    """release(group) drops only the programs whose capture may hold that
    group's collectives: a group no program saw releases nothing."""
    from faspsolver_tpu_torch.parallel import make_mesh
    from faspsolver_tpu_torch.utils import graphs
    mesh = make_mesh(device="cpu")
    other = dist.new_group([0])
    solve = _solver(mesh)[0]
    with _resident(emulate=True):
        solve()
    assert other not in graphs.captured_groups()
    assert graphs.release(other) == 0
    assert len(graphs.kept(mesh.get_group())) == 1
    assert graphs.release(mesh.get_group()) == 1


@pytest.mark.parametrize("how", ["teardown", "release_mesh"])
def test_teardown_releases_before_it_destroys_the_group(how, tmp_path,
                                                       monkeypatch):
    """``parallel.teardown`` (a group the caller initialised) and
    ``release_mesh`` (the group make_mesh made) release the group's
    programs before ``destroy_process_group``, with the modules alive:
    when the group goes down the registry is empty."""
    from faspsolver_tpu_torch.parallel import (make_mesh, release_mesh,
                                               teardown)
    from faspsolver_tpu_torch.utils import graphs
    assert not dist.is_initialized()
    if how == "teardown":
        dist.init_process_group(
            "gloo", rank=0, world_size=1,
            init_method="file://" + str(tmp_path / "store"))
    seen, groups = [], []
    destroy = dist.destroy_process_group

    def watched(group=None):
        seen.append(len(graphs.kept(groups[0])))
        destroy(group)

    monkeypatch.setattr(dist, "destroy_process_group", watched)
    try:
        mesh = make_mesh(device="cpu")
        groups.append(mesh.get_group())
        solve, op, M, bd = _solver(mesh)
        with _resident(emulate=True):
            solve()
        assert len(graphs.kept(groups[0])) == 1
        if how == "teardown":
            assert teardown() == 1
        else:
            release_mesh()
    finally:
        if dist.is_initialized():
            destroy()
    assert seen == [0] and not dist.is_initialized()
    assert graphs.kept(groups[0]) == []
    del op, M                      # alive through the teardown


def test_a_destroyed_program_is_never_replayed():
    """The real classes after ``destroy``: a Program resets its CUDA graph
    and refuses to replay; a Resident frees its handles (so its finalizer
    frees nothing) and refuses to launch."""
    from faspsolver_tpu_torch.utils import graphs

    class Graph:
        resets = 0

        def reset(self):
            Graph.resets += 1

    p = object.__new__(graphs.Program)
    p.graph = Graph()
    p.destroy()
    assert Graph.resets == 1 and p.graph is None
    with pytest.raises(RuntimeError, match="released"):
        p.replay()
    r = object.__new__(graphs.Resident)
    r._lib, r._graph, r._exec = None, ctypes.c_void_p(), ctypes.c_void_p()
    r.runs, r.pool = [(Graph(), {}, 0, None)], object()
    r.destroy()
    assert Graph.resets == 2 and r.runs == [] and r.pool is None
    assert r._graph.value is None and r._exec.value is None
    with pytest.raises(RuntimeError, match="released"):
        r.launch()

