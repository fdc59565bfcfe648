"""The port's distribution layer (``faspsolver_tpu_torch/parallel``) on
four gloo ranks on the CPU, held to the JAX package's ``parallel`` on a
four-device mesh of the eight virtual CPU devices and to one device.

One spawn of four ranks serves the file (``torch_dist_worker``, which
imports no jax); every test reads all ranks' results.  One counterpart
per test of ``tests/test_parallel.py``, in its order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dist_worker import SEED, spawn_ranks

WS = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(WS, str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def mesh():
    from faspsolver_tpu.parallel import make_mesh
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return make_mesh(WS)


def _same_on_every_rank(ranks, key, sub=None):
    vals = [r[key] if sub is None else r[key][sub] for r in ranks]
    for v in vals[1:]:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(vals[0]))
    return vals[0]


def _rng():
    # the worker draws from one generator seeded SEED, in this order
    return np.random.default_rng(SEED)


def test_sharded_spmv_matches(ranks, mesh):
    from faspsolver_tpu.parallel import dist_operator, shard_vector
    from faspsolver_tpu_torch.testgen import poisson_2d
    A = poisson_2d(30)
    x = _rng().standard_normal(A.ncol)
    y = _same_on_every_rank(ranks, "spmv")
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-13)
    import small_grid_anchors as sga
    op = dist_operator(sga._to_jax(A), mesh)
    yj = np.asarray(op(shard_vector(jnp.asarray(x), mesh)))[:A.nrow]
    np.testing.assert_allclose(y, yj, rtol=1e-13)


def test_sharded_pcg_matches_single_device(ranks, mesh):
    from faspsolver_tpu.krylov import pcg
    from faspsolver_tpu.parallel import dist_operator, shard_vector
    from faspsolver_tpu_torch.testgen import poisson_3d_manufactured
    import small_grid_anchors as sga
    A, b, u = poisson_3d_manufactured(9)
    r = ranks[0]["pcg"]
    assert r["conv"] and r["itd"] == r["it1"]
    np.testing.assert_allclose(r["xd"], r["x1"], atol=1e-8)
    np.testing.assert_allclose(r["xd"], u, atol=1e-6)
    rj = pcg(dist_operator(sga._to_jax(A), mesh),
             shard_vector(jnp.asarray(b), mesh), tol=1e-10, maxit=500)
    assert int(rj.iters) == r["itd"]
    np.testing.assert_allclose(r["xd"], np.asarray(rj.x)[:A.nrow],
                               atol=1e-10)


def test_sharded_dot_is_exact(ranks):
    assert _same_on_every_rank(ranks, "dot") == float(
        np.dot(np.arange(1024.0), np.arange(1024.0)))


def test_sharded_dia_spmv_matches(ranks, mesh):
    from faspsolver_tpu.parallel import dist_dia_operator, shard_vector
    from faspsolver_tpu_torch.testgen import poisson_2d
    import small_grid_anchors as sga
    A = poisson_2d(24)
    rng = _rng()
    rng.standard_normal(900)
    x = rng.standard_normal(A.nrow)
    y = _same_on_every_rank(ranks, "dia_spmv")
    np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12)
    op = dist_dia_operator(sga._to_jax(A), mesh)
    yj = np.asarray(jax.jit(lambda o, v: o(v))(
        op, shard_vector(jnp.asarray(x), mesh)))[:A.nrow]
    np.testing.assert_allclose(y, yj, rtol=1e-13, atol=1e-12)


def test_sharded_structured_amg_matches(ranks, mesh):
    """Row-split DIA and the sharded hierarchy reproduce the one-device
    structured AMG-PCG solve, and the JAX package's sharded count."""
    from faspsolver_tpu.krylov import pcg
    from faspsolver_tpu.parallel import (dist_dia_operator, shard_hierarchy,
                                         shard_vector)
    from faspsolver_tpu.precond import AMGPrecond
    from faspsolver_tpu.precond.amg import setup_structured
    from faspsolver_tpu.utils.params import AMGParam
    from faspsolver_tpu_torch.testgen import poisson_2d
    import small_grid_anchors as sga
    s = _same_on_every_rank(ranks, "structured", "it2")
    r = ranks[0]["structured"]
    assert r["placed"][0] and not r["placed"][-1]
    assert s == r["it1"]
    np.testing.assert_allclose(r["x2"], r["x1"], atol=1e-10)
    A = poisson_2d(32)
    b = A.matvec(np.ones(A.nrow))
    Aj = sga._to_jax(A)
    hier = setup_structured(Aj, AMGParam(coarse_dof=60), smooth_p=True)
    rj = pcg(dist_dia_operator(Aj, mesh), shard_vector(jnp.asarray(b), mesh),
             M=AMGPrecond(shard_hierarchy(hier, mesh, min_size=256)),
             tol=1e-10, maxit=100)
    assert int(rj.iters) == s
    np.testing.assert_allclose(r["x2"], np.asarray(rj.x)[:A.nrow],
                               atol=1e-10)


def test_sharded_rs_hierarchy_with_gauss_seidel_matches(ranks):
    """A classical RS hierarchy (multicolor Gauss-Seidel, ELL and COO
    levels, transfers between two sharded levels) placed by
    shard_hierarchy reproduces the one-device solve."""
    r = ranks[0]["rs_gs"]
    assert r["placed"][:2] == (True, True) and not r["placed"][-1]
    assert "WholeSmoother" in r["kinds"]
    assert _same_on_every_rank(ranks, "rs_gs", "it2") == r["it1"]
    np.testing.assert_allclose(r["x2"], r["x1"], atol=1e-10)


def _jax_halo(mesh):
    from faspsolver_tpu.parallel.halo import halo_dia_operator
    from faspsolver_tpu_torch.testgen import poisson_2d
    import small_grid_anchors as sga
    A = poisson_2d(32)
    return A, halo_dia_operator(sga._to_jax(A), mesh)


def test_halo_dia_spmv_matches(ranks, mesh):
    A, opj = _jax_halo(mesh)
    h = ranks[0]["halo"]
    y = _same_on_every_rank(ranks, "halo", "spmv")
    np.testing.assert_allclose(y, A.matvec(h["x"][:A.nrow]), rtol=1e-12,
                               atol=1e-11)
    xd = jax.device_put(jnp.asarray(h["x"]), NamedSharding(mesh, P("rows")))
    yj = np.asarray(jax.jit(opj.__call__)(xd))[:A.nrow]
    np.testing.assert_allclose(y, yj, rtol=1e-13, atol=1e-12)


def test_halo_dia_comm_is_neighbor_p2p_not_allgather(ranks, mesh):
    """The fine-level SpMV exchanges halos by P2P (every rank sends) and
    gathers nothing; its CommMap equals the JAX one at four shards."""
    _, opj = _jax_halo(mesh)
    cm = opj.comm_map
    assert _same_on_every_rank(ranks, "halo", "comm_map") is not None
    for r in ranks:
        assert tuple(r["halo"]["comm_map"]) == (
            cm.n_shards, cm.n_local, cm.halo, cm.replicated,
            cm.bytes_per_exchange) == (4, 256, 32, False, 64)
        rec = r["halo"]["record"]
        assert rec["p2p_sends"] > 0 and rec["collectives"] == []


def test_halo_dia_pcg_matches_single_device(ranks, mesh):
    from faspsolver_tpu.krylov import JacobiPrecond, pcg
    A, opj = _jax_halo(mesh)
    h = ranks[0]["halo"]
    assert h["conv"] and abs(h["it2"] - h["it1"]) <= 1
    np.testing.assert_allclose(h["x2"], h["x1"], atol=1e-8)
    b = A.matvec(np.ones(A.nrow))
    sh = NamedSharding(mesh, P("rows"))
    rj = pcg(opj, jax.device_put(jnp.asarray(b), sh),
             M=JacobiPrecond(jax.device_put(jnp.asarray(1.0 / A.diagonal()),
                                            sh)), tol=1e-10, maxit=400)
    assert abs(int(rj.iters) - h["it2"]) <= 1


def test_halo_shard_hierarchy_production_cycle(ranks, mesh):
    """Per-level halo operators and CommMaps, AMG-PCG with iteration
    parity against one device and the JAX package, and the whole
    cycle's record: neighbour P2P on every rank, no fine-sized gather."""
    from faspsolver_tpu.krylov import pcg
    from faspsolver_tpu.parallel import halo_shard_hierarchy, shard_vector
    from faspsolver_tpu.precond import AMGPrecond
    from faspsolver_tpu.precond.amg import setup_structured
    from faspsolver_tpu.utils.params import AMGParam
    from faspsolver_tpu_torch.testgen import poisson_2d
    import small_grid_anchors as sga
    A = poisson_2d(64)
    b = A.matvec(np.ones(A.nrow))
    hs = setup_structured(sga._to_jax(A), AMGParam(coarse_dof=60),
                          smooth_p=True)
    hh, cmaps = halo_shard_hierarchy(hs, mesh, min_size=512)
    rj = pcg(hh.levels[0].A, shard_vector(jnp.asarray(b), mesh),
             M=AMGPrecond(hh), tol=1e-8, maxit=50)
    for r in ranks:
        h = r["halo_hier"]
        assert h["fine_is_halo"] and h["verdict"] == "ok"
        assert [tuple(c) for c in h["cmaps"]] == [
            (c.n_shards, c.n_local, c.halo, c.replicated) for c in cmaps]
        assert h["it"] == h["it1"] == int(rj.iters)
        assert abs(h["relres"] - h["relres1"]) < 1e-12
        rec = h["record"]
        assert rec["p2p_sends"] > 0
        assert all(e < A.nrow // 2 for _, e in rec["collectives"])


def test_gspmd_dia_spmv_comm_is_neighbor_p2p(ranks):
    """The GSPMD-form row-split DIA apply exchanges its halo by P2P and
    gathers nothing (the JAX test reads collective-permute in the HLO)."""
    for r in ranks:
        rec = r["dia_record"]
        assert rec["p2p_sends"] > 0 and rec["collectives"] == []


def test_halo_places_const_compressed_levels():
    """ConstDia and Sum levels give the JAX package's flat bands, so the
    halo path takes constant-compressed levels too."""
    from faspsolver_tpu.ops import operators as jops
    from faspsolver_tpu.parallel.halo import _flat_level_bands as jflat
    from faspsolver_tpu_torch import as_tensor
    from faspsolver_tpu_torch.ops import operators as tops
    from faspsolver_tpu_torch.parallel.halo import _flat_level_bands

    n = 4096
    offs = (-64, 0, 64)
    consts = np.array([-1.0, 4.0, -1.0])
    rng = np.random.default_rng(0)
    masks, full = [], np.zeros((3, n))
    for k, off in enumerate(offs):
        m = rng.random(n) < 0.8
        valid = np.zeros(n, dtype=bool)
        valid[max(0, -off):min(n, n - off)] = True
        m &= valid
        masks.append(tops.pack_bits(m))
        full[k] = np.where(m, consts[k], 0.0)
    masks = np.stack(masks)
    cop = tops.ConstDiaOperator(as_tensor(consts), as_tensor(masks), offs, n)
    fb = _flat_level_bands(cop)
    np.testing.assert_array_equal(fb[0], full)
    assert tuple(fb[1]) == offs
    extra = np.zeros((1, n))
    extra[0, :n - 1] = rng.standard_normal(n - 1)
    sop = tops.SumOperator([cop, tops.DiaOperator(as_tensor(extra), (1,), n)])
    fb2 = _flat_level_bands(sop)
    assert fb2[0].shape == (4, n) and tuple(fb2[1]) == (-64, 0, 64, 1)
    jcop = jops.ConstDiaOperator(jnp.asarray(consts), jnp.asarray(masks),
                                 offs, n)
    jsop = jops.SumOperator(parts=(jcop, jops.DiaOperator(
        jnp.asarray(extra), (1,), n)))
    jb = jflat(jsop)
    np.testing.assert_array_equal(fb2[0], jb[0])
    assert tuple(fb2[1]) == tuple(jb[1])


def test_flat_level_bands_of_a_stencil_level_equal_jax():
    """A structured hierarchy's stencil and DIA levels flatten to the
    JAX package's bands and offsets."""
    from faspsolver_tpu.parallel.halo import _flat_level_bands as jflat
    from faspsolver_tpu.precond.amg import setup_structured as jsetup
    from faspsolver_tpu_torch.parallel.halo import _flat_level_bands
    from faspsolver_tpu_torch.precond.amg import setup_structured
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils.params import AMGParam
    import small_grid_anchors as sga
    from faspsolver_tpu.utils.params import AMGParam as JParam
    A = poisson_2d(200)
    h = setup_structured(A, AMGParam(coarse_dof=60), smooth_p=True)
    hj = jsetup(sga._to_jax(A), JParam(coarse_dof=60), smooth_p=True)
    kinds = set()
    for lvl, lj in zip(h.levels, hj.levels):
        fb, fj = _flat_level_bands(lvl.A), jflat(lj.A)
        kinds.add(type(lvl.A).__name__)
        if fj is None:
            assert fb is None
            continue
        assert tuple(fb[1]) == tuple(int(o) for o in fj[1])
        np.testing.assert_allclose(fb[0], np.asarray(fj[0]), rtol=1e-14,
                                   atol=1e-14)
    assert "StencilNdOperator" in kinds


def test_halo_banded_transfer_parity(ranks):
    """The halo banded prolongation and restriction reproduce the
    one-device BandedProlong / BandedRestrict of both packages; one
    prolongation exchanges by P2P and gathers nothing."""
    from faspsolver_tpu.constants import CGPT
    from faspsolver_tpu.precond.amg.coarsen_rs import coarsen
    from faspsolver_tpu.precond.amg.interp import interpolate
    from faspsolver_tpu.precond.amg.transfer import banded_transfer
    from faspsolver_tpu_torch.testgen import poisson_2d
    import small_grid_anchors as sga
    A = sga._to_jax(poisson_2d(64))
    marker, S = coarsen(A, 0.25, 0.9, method="rs")
    Pm = interpolate(A, marker, S, interp_type=1, trunc_threshold=0.2)
    btj = banded_transfer(Pm, np.flatnonzero(marker == CGPT))
    for r in ranks:
        h = r["banded"]
        assert not h["has_rem"]
        assert np.abs(h["yhp"] - h["yp"]).max() < 1e-12
        assert np.abs(h["yhr"] - h["yr"]).max() < 1e-12
        assert np.abs(h["yp"] - np.asarray(btj[0](jnp.asarray(h["xc"])))
                      ).max() < 1e-12
        assert np.abs(h["yr"] - np.asarray(btj[1](jnp.asarray(h["xf"])))
                      ).max() < 1e-12
        assert h["record"]["p2p_sends"] > 0
        assert h["record"]["collectives"] == []


def test_dryrun_multichip(ranks):
    """Every check of the JAX package's dryrun_multichip passes on four
    ranks, with the same counts on every rank; the halo hierarchy's
    count equals the GSPMD form's."""
    its = _same_on_every_rank(ranks, "dryrun")
    assert its["halo_structured"] == its["structured"]
    assert all(v > 0 for v in its.values())


def test_make_mesh_without_a_group_needs_the_card_or_one_rank():
    """With no process group, make_mesh makes a one-rank group only: more
    ranks raise, and no device argument means the CUDA device, which
    raises here; ``device="cpu"`` makes a gloo group, released after."""
    import torch.distributed as dist
    from faspsolver_tpu_torch.parallel import make_mesh, release_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            make_mesh()
    m = make_mesh(device="cpu")
    try:
        assert m.size() == 1 and dist.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="only 1 rank"):
            make_mesh(2)
    finally:
        release_mesh()
    assert not dist.is_initialized()


def test_public_names_equal_jax():
    """The package exports the JAX package's names, and each module has
    every public name of its JAX counterpart."""
    import importlib
    import faspsolver_tpu.parallel as jp
    import faspsolver_tpu_torch.parallel as tp
    assert tp.__all__ == jp.__all__
    for mod in ("pcsr", "dist_dia", "halo"):
        j = importlib.import_module(f"faspsolver_tpu.parallel.{mod}")
        t = importlib.import_module(f"faspsolver_tpu_torch.parallel.{mod}")
        names = {n for n, v in vars(j).items()
                 if (not n.startswith("_") or n == "_flat_level_bands")
                 and getattr(v, "__module__", None) == j.__name__}
        assert names <= set(vars(t)), names - set(vars(t))
