"""The port's checkpoints against the JAX package's
(``utils/checkpoint.py``), on the JAX test's inputs
(``tests/test_aux_subsystems.py:93-112``): a structured hierarchy saved,
loaded and solved in both packages, iterates read across packages, and
the port's own promises — bit-equal tensors, no CUDA graph or stencil
plan inside a checkpoint, and the drivers' device rule."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native

from faspsolver_tpu.krylov import pcg as jax_pcg
from faspsolver_tpu.ops import device_operator as jax_device_operator
from faspsolver_tpu.precond import AMGPrecond as JaxAMGPrecond
from faspsolver_tpu.precond.amg import setup_structured as jax_setup
from faspsolver_tpu.testgen import poisson_2d_manufactured as jax_problem
from faspsolver_tpu.utils import checkpoint as jax_ckpt
from faspsolver_tpu.utils.params import AMGParam as JaxAMGParam
from faspsolver_tpu_torch.constants import SmootherType
from faspsolver_tpu_torch.krylov import pcg
from faspsolver_tpu_torch.ops import device_operator
from faspsolver_tpu_torch.ops.operators import StencilNdOperator
from faspsolver_tpu_torch.precond import AMGPrecond, setup_ilu
from faspsolver_tpu_torch.precond.amg import setup_rs, setup_structured
from faspsolver_tpu_torch.utils.graphs import GraphedModule
from faspsolver_tpu_torch.testgen import poisson_2d, poisson_2d_manufactured
from faspsolver_tpu_torch.utils import checkpoint
from faspsolver_tpu_torch.utils.params import AMGParam

torch.set_num_threads(2)
ensure_native()


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _port_solve(A, b, hier):
    return pcg(device_operator(A), torch.from_numpy(b), M=AMGPrecond(hier),
               tol=1e-10, maxit=100)


def _assert_bit_equal(h1, h2):
    b1, b2 = dict(h1.named_buffers()), dict(h2.named_buffers())
    assert list(b1) == list(b2) and b1
    for name, t in b1.items():
        assert t.dtype == b2[name].dtype and torch.equal(t, b2[name]), name


def test_hierarchy_checkpoint_matches_jax(tmp_path):
    """Both packages save, load and solve: equal iterations, x within
    1e-10, equal meta; the port's loaded hierarchy gives x bit-equal to
    the unsaved one."""
    A, b, xex = poisson_2d_manufactured(24)
    h = setup_structured(A, AMGParam(coarse_dof=60), dtype=torch.float64,
                         smooth_p=True)
    p = str(tmp_path / "h.pt")
    checkpoint.save_hierarchy(p, h)
    h2 = checkpoint.load_hierarchy(p, device="cpu")
    _assert_bit_equal(h, h2)
    r, r0 = _port_solve(A, b, h2), _port_solve(A, b, h)
    assert r.converged and torch.equal(r.x, r0.x)
    assert np.abs(r.x.numpy() - xex).max() < 1e-8

    Aj, bj, _ = jax_problem(24)
    pj = str(tmp_path / "h.npz")
    jax_ckpt.save_hierarchy(pj, jax_setup(Aj, JaxAMGParam(coarse_dof=60),
                                          smooth_p=True))
    rj = jax_pcg(jax_device_operator(Aj, prefer="dia"), jnp.asarray(bj),
                 M=JaxAMGPrecond(jax_ckpt.load_hierarchy(pj)), tol=1e-10,
                 maxit=100)
    assert r.iters == int(rj.iters)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-10)
    assert checkpoint.load_pytree(p, device="cpu")[1] == \
        jax_ckpt.load_pytree(pj)[1] == \
        {"kind": "amg_hierarchy", "levels": [l.A.shape[0] for l in h.levels]}


def test_iterates_cross_between_packages(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(50)
    jax_ckpt.save_iterate(str(tmp_path / "jax.npz"), jnp.asarray(x), 7,
                          1.5e-9)
    x2, it, rr = checkpoint.load_iterate(str(tmp_path / "jax.npz"))
    assert np.array_equal(x2, x) and (it, rr) == (7, 1.5e-9)
    checkpoint.save_iterate(str(tmp_path / "port.npz"),
                            torch.from_numpy(x), 11, 2.5e-7)
    x3, it, rr = jax_ckpt.load_iterate(str(tmp_path / "port.npz"))
    assert np.array_equal(x3, x) and (it, rr) == (11, 2.5e-7)


def test_load_hierarchy_refuses_other_files(tmp_path):
    p = str(tmp_path / "tree.pt")
    checkpoint.save_pytree(p, {"x": torch.ones(3)}, {"kind": "other"})
    tree, meta = checkpoint.load_pytree(p, device="cpu")
    assert torch.equal(tree["x"], torch.ones(3)) and meta == {"kind": "other"}
    with pytest.raises(ValueError, match="not an AMG hierarchy"):
        checkpoint.load_hierarchy(p, device="cpu")
    q = str(tmp_path / "plain.pt")
    torch.save([torch.ones(2)], q)
    with pytest.raises(ValueError, match="not written by save_pytree"):
        checkpoint.load_hierarchy(q, device="cpu")


def test_load_follows_the_drivers_device_rule(tmp_path, monkeypatch):
    """No device argument means the CUDA device: without one, loading
    raises and names device="cpu"; device="cpu" loads on the host."""
    A = poisson_2d(24)
    p = str(tmp_path / "h.pt")
    checkpoint.save_hierarchy(p, setup_structured(A, AMGParam(coarse_dof=60),
                                                  dtype=torch.float64))
    _no_cuda(monkeypatch)
    for load in (checkpoint.load_hierarchy, checkpoint.load_pytree):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load(p)
    h = checkpoint.load_hierarchy(p, device="cpu")
    assert {t.device.type for t in h.buffers()} == {"cpu"}


def test_rs_hierarchy_with_color_blocks_round_trips(tmp_path):
    A = poisson_2d(31)
    b = np.random.default_rng(3).standard_normal(A.nrow)
    h = setup_rs(A, AMGParam(smoother=int(SmootherType.GS)),
                 dtype=torch.float64)
    names = {type(m).__name__ for m in h.modules()}
    assert "ColorBlock" in names, names
    p = str(tmp_path / "rs.pt")
    checkpoint.save_hierarchy(p, h)
    h2 = checkpoint.load_hierarchy(p, device="cpu")
    _assert_bit_equal(h, h2)
    assert {type(m).__name__ for m in h2.modules()} == names
    r, r0 = _port_solve(A, b, h2), _port_solve(A, b, h)
    assert r.converged and r.iters == r0.iters and torch.equal(r.x, r0.x)


def test_no_stencil_plan_or_cuda_graph_inside_a_checkpoint(tmp_path):
    """A stencil operator's plan and a preconditioner's CUDA graph are not
    written (a lock, which no pickle can hold, stands in for the graph);
    the first apply after the load builds the plan again."""
    op = StencilNdOperator([torch.full((1, 1), 2.0, dtype=torch.float64),
                            -torch.ones((1, 1), dtype=torch.float64)],
                           ((0, 0), (0, 1)), (5, 6))
    x = torch.arange(30, dtype=torch.float64)
    y = op(x)
    assert op._plan is not None
    M = setup_ilu(poisson_2d(12), dtype=torch.float64)
    assert isinstance(M, GraphedModule)
    M._graph = threading.Lock()
    p = str(tmp_path / "mods.pt")
    checkpoint.save_pytree(p, {"op": op, "M": M})
    tree, _ = checkpoint.load_pytree(p, device="cpu")
    assert tree["op"]._plan is None and tree["M"]._graph is None
    assert torch.equal(tree["op"](x), y) and tree["op"]._plan is not None
    r = torch.ones(144, dtype=torch.float64)
    M._graph = None
    assert torch.equal(tree["M"](r), M(r))
