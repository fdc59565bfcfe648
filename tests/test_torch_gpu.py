"""Tests of the port that need a CUDA device.  They import no jax, so on
the GPU machine (which has no jax) they run without the repository's
conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Elsewhere each skips with its reason."""
import contextlib

import numpy as np
import pytest
import resident_cases
import torch

from faspsolver_tpu_torch.ops import stencil2d

torch.set_num_threads(2)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["scalar", "factored", "full"])
def test_cuda_kernel_matches_plain(form):
    """The CUDA kernel against the plain version on the card, within the
    forward-error bound 2 k u sum|c||x| (FMA contraction differs)."""
    _need_cuda()
    import chip_smoke
    for dt, u in (("f32", 2.0 ** -24), ("f64", 2.0 ** -53)):
        for dims, coords in (((17, 33), chip_smoke.coords_9pt()),
                             ((64, 48), chip_smoke.coords_5pt())):
            op = chip_smoke.make_op(form, dims, coords, dt,
                                    np.random.default_rng(1)).to("cuda")
            x = torch.randn(op.n, dtype=op.dtype, device="cuda")
            before = stencil2d.launches[op.dtype]
            yk = op(x)
            assert stencil2d.launches[op.dtype] == before + 1
            plan = op.plan()
            yp = stencil2d.stencil2d_plain(x.reshape(dims), plan.bands,
                                           plan.coords).reshape(-1)
            err = float((yk - yp).abs().max())
            assert err <= 2 * len(coords) * u * chip_smoke.stencil_bound(
                op, x)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["scalar", "factored", "full"])
def test_cuda_kernel_matches_plain_on_ragged_tiles(form):
    """Grids that the tile divides in neither direction, more tiles than
    one block walks at once, f32 and f64, 5 and 9 bands: the kernel
    against the plain version within 2 k u sum|c||x|, and the tiles'
    walk in plain PyTorch (CPU) against the same plain version, bit for
    bit."""
    _need_cuda()
    import chip_smoke
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt, u in (("f32", 2.0 ** -24), ("f64", 2.0 ** -53)):
        for dims, coords in (((37, 300), chip_smoke.coords_9pt()),
                             ((1000, 999), chip_smoke.coords_5pt()),
                             ((24, 1023), chip_smoke.coords_fe7())):
            til = stencil2d.stencil_tiling(dims, 4, sms)
            assert dims[0] % til.ty and dims[1] % til.tx
            op = chip_smoke.make_op(form, dims, coords, dt,
                                    np.random.default_rng(2))
            plan = op.plan()
            xc = torch.randn(op.n, dtype=op.dtype)
            yp = stencil2d.stencil2d_plain(xc.reshape(dims), plan.bands,
                                           plan.coords)
            assert torch.equal(stencil2d.stencil2d_tiled_plain(
                xc.reshape(dims), plan.bands, plan.coords, til), yp)
            op = op.to("cuda")
            yk = op(xc.cuda())
            torch.cuda.synchronize()
            err = float((yk.cpu() - yp.reshape(-1)).abs().max())
            assert err <= 2 * len(coords) * u * chip_smoke.stencil_bound(
                op, xc.cuda())


@pytest.mark.cuda
def test_every_form_and_order_launches_the_kernel():
    """Scalar, factored and full bands, in sorted, unsorted and repeated
    offsets, each launch the kernel once and agree with the plain
    version."""
    _need_cuda()
    import chip_smoke
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for coords in (chip_smoke.coords_5pt(), ((0, 1), (0, 0), (-1, 0)),
                   ((0, 0), (1, 1), (0, 0), (-1, -1))):
        for form in ("scalar", "factored", "full"):
            for dt, tdt in (("f32", torch.float32), ("f64", torch.float64)):
                op = chip_smoke.make_op(form, (40, 150), coords, dt,
                                        rng).to("cuda")
                stencil2d.reset_launches()
                chip_smoke.kernel_vs_plain(torch, op, gen, form)
                assert stencil2d.launches[tdt] == 1


@pytest.mark.cuda
def test_cli_and_drivers_default_to_the_card(capsys):
    """With no device argument the CLI and a driver run on the card: the
    f64 kernel launches (a CPU apply never counts) and x comes back on
    the CUDA device."""
    _need_cuda()
    from faspsolver_tpu_torch import solvers
    from faspsolver_tpu_torch.__main__ import main
    from faspsolver_tpu_torch.testgen import poisson_2d
    stencil2d.reset_launches()
    rc = main(["-ini", "ini/input.dat", "-problem", "poisson2d", "-size",
               "63"])
    assert rc == 0 and "Number of iterations" in capsys.readouterr().out
    assert stencil2d.launches[torch.float64] > 0
    A = poisson_2d(63)
    b = np.random.default_rng(6).standard_normal(A.nrow)
    stencil2d.reset_launches()
    res, hier = solvers.krylov_amg(A, b)
    assert res.x.is_cuda and res.converged
    assert all(t.is_cuda for t in hier.buffers())
    assert stencil2d.launches[torch.float64] > 0
    stencil2d.reset_launches()
    cpu = solvers.krylov_amg(A, b, device="cpu")[0]
    assert not cpu.x.is_cuda and cpu.iters == res.iters
    assert stencil2d.launches[torch.float64] == 0


@pytest.mark.cuda
def test_kernel_raises_on_mismatched_device_or_dtype():
    """On a CUDA tensor the wrapper launches or raises — never falls
    back to the plain version."""
    _need_cuda()
    from faspsolver_tpu_torch.ops.operators import StencilNdOperator
    op = StencilNdOperator([np.ones((1, 1))], ((0, 1),), (4, 5)).to("cuda")
    with pytest.raises(ValueError):
        op(torch.ones(20, dtype=torch.float32, device="cuda"))  # f64 bands
    with pytest.raises(ValueError):
        op(torch.ones(20, dtype=torch.float16, device="cuda"))


@pytest.mark.cuda
def test_small_refined_solve_runs_through_the_kernel():
    """poisson_2d(191) end to end on the card: the hierarchy moves in one
    .to() call, both kernel instantiations launch, the solution verifies
    on the host."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.testgen import poisson_2d
    A = poisson_2d(191)
    hier = chip_smoke.setup(torch, A, "cuda")
    assert all(b.is_cuda for b in hier.buffers())
    b = A.matvec(np.ones(A.nrow))
    stencil2d.reset_launches()
    out = chip_smoke.solve(torch, hier, torch.as_tensor(b, device="cuda"))
    assert stencil2d.launches[torch.float32] > 0
    assert stencil2d.launches[torch.float64] > 0
    x = out.x.cpu().numpy()
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) < 1e-6


def _fe256():
    from faspsolver_tpu_torch.testgen import assemble_poisson, unit_square_mesh
    A, b, _ = assemble_poisson(unit_square_mesh(256),
                               lambda p: np.ones(len(p)))
    return A, b


def _rel(got, ref):
    return float((got.cpu() - ref).norm() / ref.norm())


@pytest.mark.cuda
def test_rs_operators_on_the_card_match_the_cpu():
    """Every operator and transfer class of the RS path (and ELL/COO
    device operators) applies on the card as on the CPU; index_add_ sums
    atomically there, so f32 agrees to rounding, not bit for bit."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.ops.operators import device_operator
    from faspsolver_tpu_torch.precond.amg import setup_rs
    A, _ = _fe256()
    gen = torch.Generator().manual_seed(3)
    seen = set()
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        cpu = setup_rs(A, chip_smoke.general_param(), dtype=dt,
                       keep_f64_fine=True)
        card = setup_rs(A, chip_smoke.general_param(), dtype=dt,
                        keep_f64_fine=True, device="cuda")
        pairs = [(c.A, g.A) for c, g in zip(cpu.levels, card.levels)]
        pairs += [(t(c), t(g)) for c, g in zip(cpu.levels[:-1],
                                               card.levels[:-1])
                  for t in (lambda l: l.P, lambda l: l.R)]
        pairs += [(device_operator(A, dtype=dt, prefer=p),
                   device_operator(A, dtype=dt, prefer=p).to("cuda"))
                  for p in ("ell", "coo")]
        for c, g in pairs:
            for m in c.modules():
                seen.add(type(m).__name__)
            x = torch.randn(c.shape[1], generator=gen, dtype=dt)
            assert _rel(g(x.to("cuda")), c(x)) < tol, type(c).__name__
    assert {"StencilNdOperator", "HybridDiaOperator", "SumOperator",
            "ConstDiaOperator", "DiaOperator", "CooOperator",
            "DenseOperator", "EllOperator", "BandedProlong",
            "BandedRestrict", "CooProlong", "CooRestrict"} <= seen


@pytest.mark.cuda
def test_rs_refined_solve_runs_through_the_kernel():
    """unit_square_mesh(256) through setup_rs on the card: the f32 fine
    level and the f64 fine operator launch the kernel; the solution
    verifies on the host."""
    _need_cuda()
    import chip_smoke
    A, b = _fe256()
    hier = chip_smoke.setup_general(torch, A, "cuda")
    assert all(t.is_cuda for t in hier.buffers())
    stencil2d.reset_launches()
    out = chip_smoke.solve(torch, hier, torch.as_tensor(b, device="cuda"),
                           chip_smoke.GENERAL_REFINE)
    assert stencil2d.launches[torch.float32] > 0
    assert stencil2d.launches[torch.float64] > 0
    x = out.x.cpu().numpy()
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) < 1e-6


def _drivers_on(device, fn, **kw):
    from faspsolver_tpu_torch import solvers
    from faspsolver_tpu_torch.testgen import poisson_2d
    A = poisson_2d(63)
    b = np.random.default_rng(6).standard_normal(A.nrow)
    res = getattr(solvers, fn)(A, b, device=device, **kw)
    return res[0] if isinstance(res, tuple) else res


@pytest.mark.cuda
@pytest.mark.parametrize("fn,kw", [
    ("krylov_amg", {}),
    ("solve_amg", dict(amli=True))], ids=["krylov_amg-RS-GS", "solve_amg-AMLI"])
def test_drivers_on_the_card_match_the_cpu(fn, kw):
    """CG + RS-AMG with C/F-ordered GS, and AMLI AMG as a solver, at 63^2
    in f64: the card takes the CPU's iterations, x within 1e-10, and the
    RS fine level runs the f64 kernel."""
    _need_cuda()
    from faspsolver_tpu_torch.utils.params import AMGParam, ITSParam
    args = dict(amg=AMGParam(cycle_type=3, amli_degree=3, maxit=40,
                             tol=1e-10)) if kw else \
        dict(its=ITSParam(tol=1e-10), amg=AMGParam())
    cpu = _drivers_on("cpu", fn, **args)
    stencil2d.reset_launches()
    card = _drivers_on("cuda", fn, **args)
    assert stencil2d.launches[torch.float64] > 0
    assert card.x.is_cuda and card.converged
    assert card.iters == cpu.iters
    assert float((card.x.cpu() - cpu.x).abs().max()) < 1e-10


BLOCK_DRIVERS = [
    ("krylov_amg", dict(its=dict(itsolver_type=6, tol=1e-9, restart=30),
                        amg=dict(AMG_type=3, aggregation_type=2,
                                 coarse_dof=30, smoother=2))),
    ("krylov_nk_amg", dict(its=dict(itsolver_type=6, tol=1e-9, restart=30),
                           amg=dict(AMG_type=3, aggregation_type=2,
                                    coarse_dof=30), nk=True)),
    ("krylov_ilu", dict(its=dict(itsolver_type=4, tol=1e-9, restart=30))),
    ("krylov_diag", dict(its=dict(itsolver_type=1, tol=1e-9, maxit=500))),
]


@pytest.mark.cuda
@pytest.mark.parametrize("driver,fields", BLOCK_DRIVERS,
                         ids=[d for d, _ in BLOCK_DRIVERS])
def test_block_drivers_on_the_card_match_the_cpu(driver, fields):
    """The BSR drivers with no device argument run on the card; counts
    within 2 of the CPU's (the block restriction adds atomically) and x
    within 1e-8."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch import solvers
    A, b = chip_smoke.bsr_problem(10)
    args = [A, b] + ([chip_smoke.component_basis(A.nrow, A.nb)]
                     if fields.get("nk") else [])
    kw = chip_smoke.driver_fields(fields)
    card = getattr(solvers, driver)(*args, **kw)
    cpu = getattr(solvers, driver)(*args, device="cpu", **kw)
    card, cpu = (r[0] if isinstance(r, tuple) else r for r in (card, cpu))
    assert card.x.device.type == "cuda" and card.converged
    assert abs(card.iters - cpu.iters) <= 2
    assert float((card.x.cpu() - cpu.x).abs().max()) < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ILUk", "ILUt", "block ILU(0)", "Schwarz"])
def test_factorization_preconditioners_on_the_card_match_the_cpu(kind):
    """One apply on the card against the same module on the CPU; the ILU
    applies replay a CUDA graph whose result equals the eager loop's bit
    for bit, and a move drops the graph."""
    _need_cuda()
    import copy
    import chip_smoke
    from faspsolver_tpu_torch.precond import (setup_bsr_ilu0, setup_ilu,
                                              setup_schwarz)
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils.params import ILUParam
    if kind == "block ILU(0)":
        A, _ = chip_smoke.bsr_problem(8)
        M = setup_bsr_ilu0(A)
    elif kind == "Schwarz":
        A = poisson_2d(40)
        M = setup_schwarz(A)
    else:
        A = poisson_2d(40)
        M = setup_ilu(A, ILUParam(ILU_type=1 if kind == "ILUk" else 2))
    card = copy.deepcopy(M).to("cuda")
    r = torch.randn(A.nrow, dtype=torch.float64)
    z = card(r.cuda())
    want = M(r)
    assert float((z.cpu() - want).abs().max()) <= \
        1e-12 * float(want.abs().max())
    if kind != "Schwarz":
        assert card._graph is not None
        assert torch.equal(card(r.cuda()), card.eager(r.cuda()))
        r2 = torch.randn(A.nrow, dtype=torch.float64)
        assert torch.equal(card(r2.cuda()), card.eager(r2.cuda()))
        assert card.to(torch.float32)._graph is None
    else:
        assert stencil2d.launches[torch.float64] > 0


def _str_modules():
    import chip_smoke
    from faspsolver_tpu_torch.ops.str_ops import StrOperator
    from faspsolver_tpu_torch.precond import str_precond
    A, _, _ = chip_smoke.str_problem(8)
    return A, {"StrOperator": StrOperator.from_str(A),
               "STR diag": str_precond.setup_str_diag(A),
               "STR block GS": str_precond.setup_str_blockgs(A),
               "STR ILU(0)": str_precond.setup_str_ilu(A, 0),
               "STR ILU(1)": str_precond.setup_str_ilu(A, 1),
               "STR Schwarz": str_precond.setup_str_schwarz(A, nsweeps=2)}


def _blc_modules():
    import chip_smoke
    from faspsolver_tpu_torch.precond import blc_precond
    from faspsolver_tpu_torch.utils.params import AMGParam
    A, _ = chip_smoke.blc_problem(6)
    S, _ = chip_smoke.sweep_problem(8, 4)
    amg = AMGParam(coarse_dof=40)
    mods = {"BlcOperator": (A, blc_precond.BlcOperator.from_blc(A)),
            "sweeping": (S, blc_precond.setup_blc_sweeping(S, amg=amg))}
    for mode in ("diag", "lower", "upper", "sgs"):
        mods[f"BLC {mode}"] = (A, blc_precond.setup_blc_precond(
            A, mode=mode, amg=amg))
    return mods


@pytest.mark.cuda
def test_str_and_blc_modules_on_the_card_match_the_cpu():
    """One apply of every STR and BLC operator and preconditioner on the
    card against the same module on the CPU (f64, 1e-12 of the scale);
    the STR ILU replays its CUDA graph bit-equal to its eager loop."""
    _need_cuda()
    import copy
    A, mods = _str_modules()
    pairs = [(A, name, M) for name, M in mods.items()]
    pairs += [(B, name, M) for name, (B, M) in _blc_modules().items()]
    for mat, name, M in pairs:
        card = copy.deepcopy(M).to("cuda")
        r = torch.randn(mat.nrow, dtype=torch.float64)
        z, want = card(r.cuda()), M(r)
        assert float((z.cpu() - want).abs().max()) <= \
            1e-12 * float(want.abs().max()), name
        if name.startswith("STR ILU"):
            assert card._graph is not None
            assert torch.equal(card(r.cuda()), card.eager(r.cuda()))


@pytest.mark.cuda
def test_str_blc_and_gmg_solves_on_the_card_match_the_cpu():
    """The STR, BLC and GMG solves with no device argument run on the
    card, with the CPU's counts (within 1) and x within 1e-8."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch import solvers
    from faspsolver_tpu_torch.precond import gmg
    from faspsolver_tpu_torch.utils.params import ITSParam
    its = ITSParam(itsolver_type=6, tol=1e-9, restart=30)
    A, _, b = chip_smoke.str_problem(8)
    B, bb = chip_smoke.blc_problem(6)
    runs = [(solvers.krylov_ilu, A, b, {}),
            (solvers.krylov_blockgs, A, b, dict(smoother="schwarz")),
            (solvers.krylov_block, B, bb, dict(mode="sgs"))]
    for fn, mat, rhs, kw in runs:
        card = fn(mat, rhs, its=its, **kw)
        cpu = fn(mat, rhs, its=its, device="cpu", **kw)
        assert card.x.is_cuda and card.converged, fn.__name__
        assert abs(card.iters - cpu.iters) <= 1, fn.__name__
        assert float((card.x.cpu() - cpu.x).abs().max()) < 1e-8
    f, _ = chip_smoke.gmg_problem(64, 2)
    card = gmg.poisson_gmgcg_2d(f, 64)          # a NumPy f goes to the card
    cpu = gmg.poisson_gmgcg_2d(f, 64, device="cpu")
    assert card.x.is_cuda and card.iters == cpu.iters
    assert float((card.x.cpu() - cpu.x).abs().max()) < 1e-10


@pytest.mark.cuda
def test_matfree_eigen_and_capi_on_the_card():
    """A MatFreeOperator over the f64 stencil operator launches the
    kernel; maxeig_device on the card follows the host iterates; the C
    API with no device argument solves on the card and hands x back as
    a NumPy array."""
    _need_cuda()
    from faspsolver_tpu_torch import capi
    from faspsolver_tpu_torch.krylov import JacobiPrecond
    from faspsolver_tpu_torch.ops import MatFreeOperator, best_operator, eigen
    from faspsolver_tpu_torch.solvers import itsolver
    from faspsolver_tpu_torch.testgen import poisson_2d
    A = poisson_2d(63)
    b = np.random.default_rng(7).standard_normal(A.nrow)
    op = MatFreeOperator(best_operator(A), A.nrow, torch.float64).to("cuda")
    stencil2d.reset_launches()
    res = itsolver(op, b, M=JacobiPrecond.from_csr(A).to("cuda"))
    assert res.x.is_cuda and res.converged
    assert stencil2d.launches[torch.float64] > res.iters
    v0 = np.random.default_rng(0).standard_normal(A.nrow)
    lam = float(eigen.maxeig_device(op, 50, v0=torch.from_numpy(v0).cuda()))
    assert abs(lam - eigen.maxeig(A, iters=50, tol=0.0)) <= 1e-8 * lam
    x, it, rr = capi.dcsr_krylov_amg(A.nrow, A.indptr, A.indices, A.data, b,
                                     tol=1e-8)
    assert isinstance(x, np.ndarray) and rr < 1e-8
    assert np.linalg.norm(b - A.matvec(x)) < 1e-7 * np.linalg.norm(b)


@pytest.mark.cuda
def test_checkpoint_round_trip_and_harness_rows_on_the_card(tmp_path):
    """A headline hierarchy saved from the card and loaded with no device
    argument lands on the card bit-equal, carries no stencil plan and
    solves as the original does, and loaded on the CPU within 3 inner
    iterations of it; an ILU preconditioner's CUDA graph is dropped and
    captured again.  Two harness rows (f64, AMG) on the card
    take the CPU's iterations within 2 and converge."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.benchmark import harness
    from faspsolver_tpu_torch.ops.operators import StencilNdOperator
    from faspsolver_tpu_torch.precond import setup_ilu
    from faspsolver_tpu_torch.solvers import solve_refined_resident
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils import checkpoint
    A = poisson_2d(191)
    b = A.matvec(np.ones(A.nrow))
    hier = chip_smoke.setup(torch, A, "cuda")
    r1 = solve_refined_resident(hier, b)
    r2 = solve_refined_resident(hier, b)
    p = str(tmp_path / "h.pt")
    checkpoint.save_hierarchy(p, hier)
    back = checkpoint.load_hierarchy(p)
    got, ref = dict(back.named_buffers()), dict(hier.named_buffers())
    assert list(got) == list(ref)
    assert all(t.is_cuda and torch.equal(t, ref[k]) for k, t in got.items())
    stencils = [m for m in back.modules() if isinstance(m, StencilNdOperator)]
    assert stencils and all(m._plan is None for m in stencils)
    r3 = solve_refined_resident(back, b)
    assert (r3.rounds, r3.inner_iters) == (r1.rounds, r1.inner_iters)
    if np.array_equal(r1.x, r2.x):
        assert np.array_equal(r3.x, r1.x)
    assert any(m._plan is not None for m in stencils if m._kernel)
    host = checkpoint.load_hierarchy(p, device="cpu")
    assert all(t.device.type == "cpu" for t in host.buffers())
    r4 = solve_refined_resident(host, b)
    assert r4.rounds == r1.rounds and abs(r4.inner_iters - r1.inner_iters) <= 3
    assert np.linalg.norm(b - A.matvec(r4.x)) / np.linalg.norm(b) < 1e-6

    M = setup_ilu(poisson_2d(31), device="cuda")
    r = torch.ones(31 * 31, dtype=torch.float64, device="cuda")
    z = M(r)
    assert M._graph is not None
    checkpoint.save_pytree(str(tmp_path / "ilu.pt"), M)
    M2, _ = checkpoint.load_pytree(str(tmp_path / "ilu.pt"))
    assert M2._graph is None
    assert torch.equal(M2(r), z) and M2._graph is not None

    lmvu = harness.compute_lmvu(63, 10)
    for name, A, b in (harness.generated_problems((24,), ())
                       + harness.corpus_problems(24)[-4:-3]):
        card = harness.score_problem(name, A, b,
                                     harness._solver_factory("amg"), lmvu)
        cpu = harness.score_problem(name, A, b, harness._solver_factory(
            "amg", device="cpu"), lmvu)
        assert card.converged and cpu.converged
        assert abs(card.iters - cpu.iters) <= 2, (name, card, cpu)


@pytest.mark.cuda
def test_gs_sweeps_on_the_card_are_bit_equal_to_the_cpu():
    """Rows of up to 8 entries sum left to right on every device, so on
    the f32 RS hierarchy the harness's f32 mode builds, every such color's
    row sums, and a GS sweep each way on every level whose colors are all
    that narrow (the fine level's 4 entries among them), are bit-equal on
    the card and on the CPU; wider colors' row sums differ by no more than
    the forward-error bound of any summation order."""
    _need_cuda()
    from faspsolver_tpu_torch.precond.amg import setup_rs, smoothers
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils.params import AMGParam
    hier = setup_rs(poisson_2d(127), AMGParam(), dtype=torch.float32,
                    device="cpu")
    card = setup_rs(poisson_2d(127), AMGParam(), dtype=torch.float32,
                    device="cuda")
    gen = torch.Generator().manual_seed(3)
    narrow_levels = 0
    for lc, ld in zip(hier.levels, card.levels):
        if lc.smoother is None:
            continue
        n = lc.A.shape[0]
        x, b = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
        widths = set()
        for cc, cd in zip(lc.smoother.colors, ld.smoother.colors):
            k = cc.cols.shape[1]
            widths.add(k)
            got, want = cd.offdiag(x.cuda()).cpu(), cc.offdiag(x)
            if k <= smoothers._ORDERED_WIDTH:
                assert torch.equal(got, want)
            else:                      # the forward-error bound k u sum|p|
                g = x.index_select(0, cc.cols.reshape(-1)).reshape(
                    cc.cols.shape)
                bound = k * 2.0 ** -24 * (cc.vals * g).abs().sum(dim=1)
                assert bool(((got - want).abs() <= bound).all())
        if max(widths) > smoothers._ORDERED_WIDTH:
            continue
        narrow_levels += 1
        for forward in (True, False):
            got = smoothers.smooth(ld.smoother, ld.A, x.cuda(), b.cuda(), 1,
                                   forward)
            want = smoothers.smooth(lc.smoother, lc.A, x, b, 1, forward)
            assert torch.equal(got.cpu(), want)
    assert narrow_levels >= 1


def _graphed_and_eager(solve):
    """``solve()`` graphed (cold, then warm) and under graphs.eager():
    the results, the stencil and loop-control launches and the graph
    replays of each."""
    from faspsolver_tpu_torch.utils import graphs, loops
    runs = []
    for eager in (False, False, True):
        stencil2d.reset_launches()
        loops.reset_launches()
        graphs.reset_stats()
        with graphs.eager() if eager else contextlib.nullcontext():
            out = solve()
        torch.cuda.synchronize()
        runs.append((out, {**stencil2d.launches, **loops.launches},
                     graphs.stats["replays"]))
    return runs


@pytest.mark.cuda
def test_graphed_pcg_amg_is_bit_equal_to_the_eager_loop():
    """PCG + structured AMG on poisson_2d(255) and the refined solve
    around it: resident (one CUDA graph with conditional nodes, one
    launch and one host read per solve), cold and warm, x is bit-equal
    to the eager loop's, with equal iterations, and the warm solve's
    stencil and loop-control launches equal the eager loop's."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.krylov import pcg
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.testgen import poisson_2d
    A = poisson_2d(255)
    hier = chip_smoke.setup(torch, A, "cuda")
    b = torch.as_tensor(A.matvec(np.ones(A.nrow)), device="cuda")
    b32 = b.float()
    for solve in (lambda: pcg(hier.levels[0].A, b32, M=AMGPrecond(hier),
                              tol=1e-6, maxit=60),
                  lambda: chip_smoke.solve(torch, hier, b)):
        (cold, n_cold, r_cold), (warm, n_warm, r_warm), (eager, n_e, r_e) = \
            _graphed_and_eager(solve)
        assert r_cold == 1 and r_warm == 1 and r_e == 0
        for got in (cold, warm):
            assert torch.equal(got.x, eager.x)
            assert got.iters == eager.iters
            assert got.syncs == 1 < eager.syncs
        # a replay counts what its capture recorded; the cold solve also
        # ran each program once for real before capturing it
        assert n_warm == n_e and n_e[torch.float32] > 0
        assert all(n_cold[k] >= n_e[k] for k in n_e)


@pytest.mark.cuda
def test_graphs_capture_again_after_a_move():
    """After ``.to(torch.float64)`` the solve captures new graphs (the
    old ones read the f32 buffers) and matches the eager f64 loop."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.krylov import pcg
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils import graphs
    A = poisson_2d(127)
    hier = chip_smoke.setup(torch, A, "cuda")
    b = torch.as_tensor(A.matvec(np.ones(A.nrow)), device="cuda")
    M = AMGPrecond(hier)
    pcg(hier.levels[0].A, b.float(), M=M, tol=1e-6)
    M.to(torch.float64)
    graphs.reset_stats()
    got = pcg(hier.levels[0].A, b, M=M, tol=1e-6)
    assert graphs.stats["captures"] > 0 and graphs.stats["replays"] > 0
    with graphs.eager():
        want = pcg(hier.levels[0].A, b, M=M, tol=1e-6)
    assert torch.equal(got.x, want.x) and got.iters == want.iters


@pytest.mark.cuda
def test_checkpoint_round_trip_captures_again(tmp_path):
    """A hierarchy loaded from a checkpoint is new modules: its solve
    captures its own graphs and equals the original's."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils import checkpoint, graphs
    A = poisson_2d(127)
    hier = chip_smoke.setup(torch, A, "cuda")
    b = torch.as_tensor(A.matvec(np.ones(A.nrow)), device="cuda")
    first = chip_smoke.solve(torch, hier, b)
    p = str(tmp_path / "h.pt")
    checkpoint.save_hierarchy(p, hier)
    back = checkpoint.load_hierarchy(p, device="cuda")
    graphs.reset_stats()
    again = chip_smoke.solve(torch, back, b)
    assert graphs.stats["captures"] > 0 and graphs.stats["replays"] > 0
    assert torch.equal(again.x, first.x)
    assert (again.rounds, again.iters) == (first.rounds, first.iters)


@pytest.mark.cuda
def test_loop_control_kernel_is_bit_equal_to_its_twin():
    """Every entry point of csrc/loop_control.cu over chip_smoke's edge
    cases, f32 and f64: the state block after each step bit-equal to the
    plain twin's on the CPU."""
    _need_cuda()
    import chip_smoke
    for name in chip_smoke.LOOP_CASES:
        for dt in (torch.float32, torch.float64):
            got = chip_smoke.loop_case_blocks(torch, name, dt, "cuda",
                                              plain=False)
            want = chip_smoke.loop_case_blocks(torch, name, dt, "cpu",
                                               plain=True)
            for k, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w), (name, dt, k)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pcg", "bicgstab", "minres"])
def test_resident_krylov_reads_once_and_equals_the_eager_loop(method):
    """Each resident loop over structured AMG on poisson_2d(127) (the
    safe variant too): one launch, one host read, x bit-equal to the
    eager loop's on the card, equal iterations and status, and the warm
    solve's launches equal the eager loop's."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch import krylov
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.testgen import poisson_2d
    A = poisson_2d(127)
    hier = chip_smoke.setup(torch, A, "cuda")
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(A.nrow),
                        device="cuda", dtype=torch.float32)
    for safe in (False, True):
        solve = lambda: getattr(krylov, method)(  # noqa: E731
            hier.levels[0].A, b, M=AMGPrecond(hier), tol=1e-6, maxit=60,
            safe=safe)
        (cold, _, r_cold), (warm, n_warm, r_warm), (eager, n_e, r_e) = \
            _graphed_and_eager(solve)
        assert (r_cold, r_warm, r_e) == (1, 1, 0)
        for got in (cold, warm):
            assert torch.equal(got.x, eager.x)
            assert (got.iters, got.status, got.syncs) == (eager.iters,
                                                          eager.status, 1)
        assert n_warm == n_e and n_e[method] > 0


@pytest.mark.cuda
def test_gmres_control_kernel_is_bit_equal_to_its_twin():
    """The GMRES entry point of csrc/loop_control.cu over chip_smoke's
    GMRES_CASES, f32 and f64: the state block and the window's arrays
    after each step bit-equal to the plain twin's on the CPU."""
    _need_cuda()
    import chip_smoke
    for name in chip_smoke.GMRES_CASES:
        for dt in (torch.float32, torch.float64):
            got = chip_smoke.gmres_case_blocks(torch, name, dt, "cuda",
                                               plain=False)
            want = chip_smoke.gmres_case_blocks(torch, name, dt, "cpu",
                                                plain=True)
            for k, ((gb, ga), (wb, wa)) in enumerate(zip(got, want)):
                assert torch.equal(gb, wb), (name, dt, k)
                assert chip_smoke._same_bits(torch, ga, wa), (name, dt, k)


@pytest.mark.cuda
def test_gmres_control_solves_past_the_default_shared_limit():
    """Full windows of R = 100 and R = 168 in f64 (the solve's tile of H's
    upper triangle and four vectors 43.6 KB and 118.9 KB, the second past
    the default 48 KB a block may take) bit-equal to the twin; R = 241 (a
    tile past the card's opt-in limit) refused at its solve, R = 257 (past
    the solve's registers) at its first launch."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.utils import loops
    for R, fits in ((100, True), (168, True), (241, False), (257, False)):
        out = []
        for device in ("cuda", "cpu") if fits else ("cuda",):
            blk = loops.Block(device, [("gmres", torch.float64),
                                       ("arnoldi", torch.float64)])
            blk.upload({"gmres": loops.gmres_values(
                1e-30, 1e-18, 1000, 1, False, False)})
            arr = torch.zeros(loops.gmres_arrays(R), dtype=torch.float64,
                              device=device)
            call = loops.gmres if device == "cuda" else loops.gmres_plain
            for phase, vals in chip_smoke._window(R, R)[:R + 3]:
                inp = torch.tensor(vals or [0.0], dtype=torch.float64,
                                   device=device)
                if not fits and (phase == loops.SOLVE or R > 256):
                    with pytest.raises(RuntimeError):
                        call(phase, inp, blk["gmres"], blk["arnoldi"], arr,
                             R)
                    break
                call(phase, inp, blk["gmres"], blk["arnoldi"], arr, R)
            out.append(arr.cpu())
        if fits:
            assert chip_smoke._same_bits(torch, out[0], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rescue", "escalation"])
def test_refined_fallbacks_on_the_card_are_reached_as_in_jax(case, capsys):
    """The harness's f32 refined mode on the card over the two jump_2d
    cases of tests/test_torch_harness.py (chip_smoke.FALLBACK_CASES): the
    banner the JAX package prints there, convergence, verified f64 relres
    < 1e-6, and the inner iterations within max(2, 5%) of the JAX
    package's CPU count (chip_smoke.FALLBACK_ANCHORS, printed by
    tests/small_grid_anchors.py fallbacks)."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.benchmark import harness
    from faspsolver_tpu_torch.testgen import jump_2d
    n, contrast, banner = chip_smoke.FALLBACK_CASES[case]
    ref = chip_smoke.FALLBACK_ANCHORS[case][0]
    A = jump_2d(n, contrast)
    b = A.matvec(np.ones(A.nrow))
    res = harness._refined_factory("amg", torch.float32, "cuda")(A, b)
    said = capsys.readouterr().out
    x = np.asarray(res.x.cpu() if isinstance(res.x, torch.Tensor) else res.x,
                   dtype=np.float64)
    relres = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
    assert banner in said, said
    assert res.converged and relres < 1e-6
    assert abs(res.iters - ref) <= max(2, int(0.05 * ref)), (res.iters, ref)


def _gmres_problem():
    """poisson_2d(127) on the card: its f64 operator and Jacobi, the f32
    structured AMG hierarchy, and seeded right-hand sides of both."""
    import chip_smoke
    from faspsolver_tpu_torch.krylov import JacobiPrecond
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.testgen import poisson_2d
    A = poisson_2d(127)
    b = np.random.default_rng(4).standard_normal(A.nrow)
    op64 = device_operator(A, dtype=torch.float64).to("cuda")
    jac = JacobiPrecond.from_csr(A, torch.float64).to("cuda")
    hier = chip_smoke.setup(torch, A, "cuda")
    return (op64, jac, torch.as_tensor(b, device="cuda"),
            hier, torch.as_tensor(b, device="cuda", dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "amg"])
@pytest.mark.parametrize("method", ["gmres", "vgmres", "vfgmres"])
def test_resident_gmres_reads_once_and_equals_the_eager_loop(method,
                                                             precond):
    """The GMRES family resident over Jacobi (f64) and structured AMG
    (f32) on poisson_2d(127), plain and safe: one program launch and one
    host read per solve, cold and warm, x bit-equal to the eager loop's
    on the card with equal iterations and status, the eager loop's reads
    1 + iterations + cycles, and the warm solve's launches equal the
    eager loop's."""
    _need_cuda()
    from faspsolver_tpu_torch import krylov
    from faspsolver_tpu_torch.precond import AMGPrecond
    op64, jac, b64, hier, b32 = _gmres_problem()
    op, b = (op64, b64) if precond == "jacobi" else (hier.levels[0].A, b32)
    for safe in (False, True):
        solve = lambda: getattr(krylov, method)(  # noqa: E731
            op, b, M=jac if precond == "jacobi" else AMGPrecond(hier),
            tol=1e-8, maxit=300, restart=12, safe=safe)
        (cold, _, r_cold), (warm, n_warm, r_warm), (eager, n_e, r_e) = \
            _graphed_and_eager(solve)
        assert (r_cold, r_warm, r_e) == (1, 1, 0)
        for got in (cold, warm):
            assert torch.equal(got.x, eager.x)
            assert (got.iters, got.status, got.syncs) == (eager.iters,
                                                          eager.status, 1)
            assert got.resident and not eager.resident
        assert eager.iters > 12 and eager.syncs > 1 + eager.iters
        assert n_warm == n_e and n_e["gmres"] > 0


@pytest.mark.cuda
def test_resident_gmres_state_is_kept_per_window():
    """vGMRES(10) and vGMRES(20) over the same operator and Jacobi each
    capture their own program (the cached state is keyed on the window)
    and each equals its eager loop; the second solve of each replays."""
    _need_cuda()
    from faspsolver_tpu_torch.krylov import vgmres
    from faspsolver_tpu_torch.utils import graphs
    op64, jac, b64, _, _ = _gmres_problem()
    for restart, captures in ((10, True), (20, True), (10, False),
                              (20, False)):
        graphs.reset_stats()
        got = vgmres(op64, b64, M=jac, tol=1e-8, maxit=300, restart=restart)
        assert (graphs.stats["captures"] > 0) == captures, restart
        assert got.syncs == 1 and graphs.stats["replays"] == 1
        with graphs.eager():
            want = vgmres(op64, b64, M=jac, tol=1e-8, maxit=300,
                          restart=restart)
        assert torch.equal(got.x, want.x) and got.iters == want.iters


@pytest.mark.cuda
def test_resident_gmres_raises_when_its_capture_fails():
    """A preconditioner that declares itself capturable but reads the
    host in its apply: the resident GMRES raises at its capture and does
    not run the eager loop instead."""
    _need_cuda()
    from faspsolver_tpu_torch.krylov import gmres

    class HostReading(torch.nn.Module):
        capturable = True

        def forward(self, r):
            return r * float(r.abs().max() > 0)

    op64, _, b64, _, _ = _gmres_problem()
    with pytest.raises(RuntimeError):
        gmres(op64, b64, M=HostReading(), tol=1e-8, maxit=50, restart=10)


@pytest.mark.cuda
def test_mg_control_kernel_is_bit_equal_to_its_twin():
    """The ``mg`` entry point of csrc/loop_control.cu over chip_smoke's
    MG_CASES (both forms of the test, NaN included), f32 and f64: the
    state block after each step bit-equal to the plain twin's on the
    CPU."""
    _need_cuda()
    import chip_smoke
    for name in chip_smoke.MG_CASES:
        for dt in (torch.float32, torch.float64):
            got = chip_smoke.mg_case_blocks(torch, name, dt, "cuda",
                                            plain=False)
            want = chip_smoke.mg_case_blocks(torch, name, dt, "cpu",
                                             plain=True)
            for k, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w), (name, dt, k)


def _mg_hierarchies():
    """poisson_2d(63) on the card in f64: the structured SA hierarchy
    (banded transfers, deterministic sums) and a classical RS one (its
    transfers' remainders add with atomics), each in V and nonlinear-AMLI
    cycles, and a seeded right-hand side."""
    from faspsolver_tpu_torch.constants import CycleType
    from faspsolver_tpu_torch.precond.amg import setup_rs, setup_structured
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils.params import AMGParam
    A = poisson_2d(63)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal(A.nrow),
                        device="cuda")
    hiers = {}
    for name, setup in (("SA", setup_structured), ("RS", setup_rs)):
        for cyc in ("V", "NL_AMLI"):
            hiers[f"{name} {cyc}"] = setup(A, AMGParam(
                coarse_dof=60, cycle_type=int(getattr(CycleType, cyc))),
                dtype=torch.float64).to("cuda")
    return hiers, b


@pytest.mark.cuda
def test_resident_amg_solve_reads_once_and_equals_the_eager_loop():
    """AMG as a solver over the structured SA and a classical RS
    hierarchy, V and NL-AMLI cycles, and FAMG: one program launch and one
    host read per solve, cold and warm, equal iterations and x equal to
    the eager loop's (bit for bit over the structured hierarchy; the RS
    transfers add with atomics: within 1e-10 of |x|), the eager loop's
    reads iterations + 1, and the warm solve's launches equal the eager
    loop's."""
    _need_cuda()
    from faspsolver_tpu_torch.precond.amg import amg_solve, famg_solve
    hiers, b = _mg_hierarchies()
    for name, hier in hiers.items():
        assert hier.capturable, name
        for fn in (amg_solve, famg_solve):
            solve = lambda: fn(hier, b, tol=1e-10, maxit=40)  # noqa: E731
            (cold, _, r_cold), (warm, n_warm, r_warm), (eager, n_e, r_e) = \
                _graphed_and_eager(solve)
            what = (name, fn.__name__)
            assert (r_cold, r_warm, r_e) == (1, 1, 0), what
            for got in (cold, warm):
                assert got.resident and not eager.resident, what
                assert (got.iters, got.syncs) == (eager.iters, 1), what
                if name.startswith("SA"):
                    assert torch.equal(got.x, eager.x), what
                else:
                    diff = float((got.x - eager.x).norm())
                    assert diff <= 1e-10 * float(eager.x.norm()), (what, diff)
            famg = fn is famg_solve
            assert eager.syncs == eager.iters + (0 if famg else 1), what
            assert n_warm == n_e and n_e["mg"] > 0, (what, n_warm, n_e)


@pytest.mark.cuda
@pytest.mark.parametrize("fn,dim,n,kw", [
    ("poisson_gmg_2d", 2, 128, {}),
    ("poisson_gmg_2d", 2, 128, {"full_first": True}),
    ("poisson_gmg_3d", 3, 32, {}),
    ("poisson_gmg_3d", 3, 32, {"full_first": True}),
    ("poisson_gmgcg_2d", 2, 128, {}),
    ("poisson_gmgcg_3d", 3, 32, {})])
def test_resident_gmg_reads_once_and_equals_the_eager_loop(fn, dim, n, kw):
    """GMG's V-cycle and CG loops on the card: one program launch and one
    host read per solve, cold and warm, x bit-equal to the eager loop's
    with equal iterations, the eager loop's reads iterations + 1, the
    warm solve's launches equal the eager loop's; a second grid size
    keeps its own program."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.precond import gmg
    from faspsolver_tpu_torch.utils import graphs
    gmg.clear_programs()
    for size in (n, n // 2):
        f, _ = chip_smoke.gmg_problem(size, dim)
        solve = lambda: getattr(gmg, fn)(f, size, **kw)  # noqa: E731
        graphs.reset_stats()
        (cold, _, r_cold), (warm, n_warm, r_warm), (eager, n_e, r_e) = \
            _graphed_and_eager(solve)
        assert (r_cold, r_warm, r_e) == (1, 1, 0)
        for got in (cold, warm):
            assert got.resident and not eager.resident and got.converged
            assert torch.equal(got.x, eager.x)
            assert (got.iters, got.syncs) == (eager.iters, 1)
        assert eager.syncs == eager.iters + 1
        assert n_warm == n_e and n_e["mg"] == eager.iters + 1
    assert len(gmg._PROGRAMS) == 2
    gmg.clear_programs()
    assert not gmg._PROGRAMS


@pytest.mark.cuda
def test_resident_mg_raises_when_its_capture_fails():
    """A hierarchy part that declares itself capturable but reads the
    host in its apply: the resident AMG solve raises at its capture and
    does not run the eager loop instead."""
    _need_cuda()
    from faspsolver_tpu_torch.precond.amg import amg_solve

    class HostReading(torch.nn.Module):
        capturable = True

        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            return self.inner(x) * float(x.abs().max() >= 0)

    hiers, b = _mg_hierarchies()
    hier = hiers["SA V"]
    hier.coarse = HostReading(hier.coarse)
    assert hier.capturable
    with pytest.raises(RuntimeError):
        amg_solve(hier, b, tol=1e-10, maxit=40)


@pytest.mark.cuda
def test_gcr_control_kernel_is_bit_equal_to_its_twin():
    """The ``gcr`` entry point of csrc/loop_control.cu over chip_smoke's
    GCR_CASES (every branch, the three stop types, NaN), f32 and f64:
    the state block after each step bit-equal to the plain twin's on the
    CPU."""
    _need_cuda()
    import chip_smoke
    for name in chip_smoke.GCR_CASES:
        for dt in (torch.float32, torch.float64):
            got = chip_smoke.gcr_case_blocks(torch, name, dt, "cuda",
                                             plain=False)
            want = chip_smoke.gcr_case_blocks(torch, name, dt, "cpu",
                                              plain=True)
            for k, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w), (name, dt, k)


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "amg"])
@pytest.mark.parametrize("method", ["gcr", "gcg"])
def test_resident_gcr_reads_once_and_equals_the_eager_loop(method,
                                                           precond):
    """GCR(12) and GCG (its full-memory window) resident over Jacobi (f64)
    and structured AMG (f32) on poisson_2d(127): one program launch and
    one host read per solve, cold and warm, x bit-equal to the eager
    loop's on the card with equal iterations and status, the eager
    loop's reads 1 + steps + cycles, and the warm solve's launches equal
    the eager loop's."""
    _need_cuda()
    from faspsolver_tpu_torch import krylov
    from faspsolver_tpu_torch.precond import AMGPrecond
    op64, jac, b64, hier, b32 = _gmres_problem()
    op, b = (op64, b64) if precond == "jacobi" else (hier.levels[0].A, b32)
    kw = {"restart": 12} if method == "gcr" else {}
    solve = lambda: getattr(krylov, method)(  # noqa: E731
        op, b, M=jac if precond == "jacobi" else AMGPrecond(hier),
        tol=1e-8 if precond == "jacobi" else 1e-5, maxit=300, **kw)
    (cold, _, r_cold), (warm, n_warm, r_warm), (eager, n_e, r_e) = \
        _graphed_and_eager(solve)
    assert (r_cold, r_warm, r_e) == (1, 1, 0)
    for got in (cold, warm):
        assert torch.equal(got.x, eager.x)
        assert (got.iters, got.status, got.syncs) == (eager.iters,
                                                      eager.status, 1)
        assert got.resident and not eager.resident
    assert eager.iters > 3 and eager.syncs > 1 + eager.iters
    assert n_warm == n_e and n_e["gcr"] > 0


@pytest.mark.cuda
def test_resident_gcr_raises_when_its_capture_fails():
    """A preconditioner that declares itself capturable but reads the
    host in its apply: the resident GCR raises at its capture and does
    not run the eager loop instead."""
    _need_cuda()
    from faspsolver_tpu_torch.krylov import gcr

    class HostReading(torch.nn.Module):
        capturable = True

        def forward(self, r):
            return r * float(r.abs().max() > 0)

    op64, _, b64, _, _ = _gmres_problem()
    with pytest.raises(RuntimeError):
        gcr(op64, b64, M=HostReading(), tol=1e-8, maxit=50, restart=10)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vFGMRES + UA-BSR", "CG + block Jacobi",
                                  "refined f32 vFGMRES + UA-BSR"])
def test_resident_bsr_solves_read_once_and_equal_the_eager_loop(case):
    """The block path resident on block_poisson_3d(10, nb=3): vFGMRES(30)
    over UA-BSR (f64), CG over block Jacobi (f64) and the refined
    stanza's f32 vFGMRES over UA-BSR inside solve_refined.  Each solve
    is one program launch and one host read (the refined one: per inner
    solve, beside the refinement's own read per round); the eager loop
    on the card gives the same count and x, bit for bit over block
    Jacobi, and within the atomics' reach over UA-BSR (its restriction
    adds with index_add_): chip_smoke.X_DIFF_LIMITS of |x| by dtype."""
    _need_cuda()
    import chip_smoke
    from faspsolver_tpu_torch.krylov import BlockJacobiPrecond, pcg, vfgmres
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import setup_ua_bsr
    from faspsolver_tpu_torch.solvers import solve_refined
    from faspsolver_tpu_torch.utils.params import AMGParam
    A, b = chip_smoke.bsr_problem(10)
    refined = case.startswith("refined")
    dt = torch.float32 if refined else torch.float64
    op = device_operator(A, dtype=dt).to("cuda")
    if case == "CG + block Jacobi":
        M = BlockJacobiPrecond.from_bsr(A, dt).to("cuda")
    else:
        M = AMGPrecond(setup_ua_bsr(A, AMGParam(
            AMG_type=3, coarse_dof=30, aggregation_type=2,
            strong_coupled=0.08), dtype=dt, device="cuda"))
    bt = torch.as_tensor(b, dtype=dt, device="cuda")

    def solve():
        if case == "CG + block Jacobi":
            return pcg(op, bt, M=M, tol=1e-9, maxit=2000)
        if not refined:
            return vfgmres(op, bt, M=M, tol=1e-9, maxit=500, restart=30)
        return solve_refined(A, b, lambda r, tol: vfgmres(
            op, r, M=M, tol=tol, maxit=100, restart=30), tol=1e-6,
            max_rounds=4, dtype=torch.float32, device="cuda")

    (cold, _, r_cold), (warm, _, r_warm), (eager, _, r_e) = \
        _graphed_and_eager(solve)
    if refined:
        assert r_cold == r_warm == cold.rounds and r_e == 0
        assert cold.syncs == warm.syncs == 2 * cold.rounds
        assert eager.syncs > eager.inner_iters
        pairs = [(cold.inner_iters, eager.inner_iters),
                 (warm.inner_iters, eager.inner_iters)]
        xs = [(torch.as_tensor(g.x), torch.as_tensor(eager.x))
              for g in (cold, warm)]
    else:
        assert (r_cold, r_warm, r_e) == (1, 1, 0)
        assert cold.syncs == warm.syncs == 1
        assert cold.resident and warm.resident and not eager.resident
        assert eager.syncs > eager.iters
        pairs = [(cold.iters, eager.iters), (warm.iters, eager.iters)]
        xs = [(g.x, eager.x) for g in (cold, warm)]
    assert all(g == e > 3 for g, e in pairs), pairs
    for g, e in xs:
        if case == "CG + block Jacobi":
            assert torch.equal(g, e)
        else:
            diff = float((g - e).norm() / e.norm())
            assert diff <= chip_smoke.X_DIFF_LIMITS[str(dt)[6:]], diff


@pytest.mark.cuda
@pytest.mark.parametrize("case", resident_cases.CASES)
def test_resident_str_blc_schwarz_solves_read_once_and_equal_the_eager_loop(
        case):
    """The cases of ``tests/resident_cases.py`` at the card's size
    (block_poisson_3d(16, nb=3) in STR and BLC form, poisson_3d(32) in 4
    slabs, poisson_2d(127), the ELL operator of
    poisson_fe_manufactured(32) behind a MatFreeOperator): cold and warm
    each one program launch and one host read; the eager loop on the
    card gives the same count and status, and x bit for bit, or within
    chip_smoke.X_DIFF_LIMIT of |x| where UA-AMG's restriction adds with
    index_add_ (the BLC and sweeping cases)."""
    _need_cuda()
    import chip_smoke
    solve, _, _ = resident_cases.build(case, "card", "cuda")
    (cold, _, r_cold), (warm, _, r_warm), (eager, _, r_e) = \
        _graphed_and_eager(solve)
    assert (r_cold, r_warm, r_e) == (1, 1, 0)
    assert cold.syncs == warm.syncs == 1
    assert cold.resident and warm.resident and not eager.resident
    assert eager.syncs > eager.iters
    assert cold.iters == warm.iters == eager.iters > 3
    assert cold.status == warm.status == eager.status
    for g in (cold, warm):
        if case in resident_cases.ATOMIC:
            diff = float((g.x - eager.x).norm() / eager.x.norm())
            assert diff <= chip_smoke.X_DIFF_LIMIT, diff
        else:
            assert torch.equal(g.x, eager.x)


@pytest.mark.cuda
def test_resident_matfree_solve_needs_a_capturable_function():
    """A MatFreeOperator over a plain function keeps CG eager on the card
    (one host read per step, no program launched); over the ELL operator
    itself, a module that declares itself capturable, the same solve is
    resident, cold and warm: one launch, one read, the same count and x
    bit for bit."""
    _need_cuda()
    from faspsolver_tpu_torch.krylov import JacobiPrecond, pcg
    from faspsolver_tpu_torch.ops import MatFreeOperator, device_operator
    from faspsolver_tpu_torch.testgen import poisson_fe_manufactured
    from faspsolver_tpu_torch.utils import graphs
    P, b, *_ = poisson_fe_manufactured(32)
    ell = device_operator(P, prefer="ell").to("cuda")
    M = JacobiPrecond.from_csr(P).to("cuda")
    bt = torch.from_numpy(b).cuda()
    plain = MatFreeOperator(lambda v: ell(v), P.nrow, torch.float64)
    graphs.reset_stats()
    eager = pcg(plain, bt, M=M, tol=1e-9, maxit=2000)
    assert graphs.stats["replays"] == 0 and not eager.resident
    assert eager.syncs > eager.iters > 3
    wrapped = MatFreeOperator(ell, P.nrow, torch.float64)
    for _ in ("cold", "warm"):
        graphs.reset_stats()
        got = pcg(wrapped, bt, M=M, tol=1e-9, maxit=2000)
        assert got.resident and got.syncs == 1
        assert graphs.stats["replays"] == 1
        assert got.iters == eager.iters and torch.equal(got.x, eager.x)


@pytest.fixture
def nccl_mesh():
    """A one-rank NCCL mesh on this card (the process group make_mesh
    makes, taken down after the test)."""
    _need_cuda()
    from faspsolver_tpu_torch.parallel import make_mesh, release_mesh
    mesh = make_mesh()
    try:
        yield mesh
    finally:
        release_mesh()


# the distribution layer's solves at the card's size: phase 13's forms
# (chip_smoke.parallel_solves) on poisson_2d(127) and
# block_poisson_3d(8, nb=3); the other Krylov loops over the row-split
# ELL operator of poisson_2d(63) and Jacobi.  DIST_ATOMIC: the cases
# whose sums add with index_add_ (RS's coarse COO transfers, UA-BSR's
# aggregation)
DIST_CASES = ["Jacobi-PCG", "AMG-PCG shard_hierarchy",
              "AMG-PCG halo_shard_hierarchy", "RS AMG-PCG halo",
              "vFGMRES shard_block_rows", "BiCGstab", "MINRES", "GMRES",
              "GCR"]
DIST_ATOMIC = ("RS AMG-PCG halo", "vFGMRES shard_block_rows")


def _dist_solve(case, mesh):
    """``solve()`` of a distribution-layer case over DTensor vectors of
    ``mesh``."""
    import chip_smoke
    from faspsolver_tpu_torch import as_tensor
    from faspsolver_tpu_torch.krylov import (JacobiPrecond, bicgstab, gcr,
                                             gmres, minres, pcg, vfgmres)
    from faspsolver_tpu_torch.ops import device_operator
    from faspsolver_tpu_torch.parallel import (
        dist_dia_operator, dist_operator, halo_shard_hierarchy, replicate,
        shard_block_rows, shard_hierarchy, shard_vector)
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import (setup_rs, setup_structured,
                                                  setup_ua_bsr)
    from faspsolver_tpu_torch.testgen import block_poisson_3d, poisson_2d
    from faspsolver_tpu_torch.utils.params import AMGParam
    f64 = torch.float64
    if case == "vFGMRES shard_block_rows":
        Ab = block_poisson_3d(8, nb=3)
        hb = replicate(setup_ua_bsr(Ab, AMGParam(AMG_type=3, coarse_dof=30),
                                    dtype=f64), mesh)
        opb = shard_block_rows(device_operator(Ab, dtype=f64), mesh)
        bb = shard_vector(as_tensor(Ab.matvec(np.ones(Ab.nrow)), f64), mesh)
        return lambda: vfgmres(opb, bb, M=AMGPrecond(hb), tol=1e-8,
                               maxit=200, restart=30)
    A = poisson_2d(127)
    bd = shard_vector(as_tensor(A.matvec(np.ones(A.nrow)), f64), mesh)
    dev = bd.to_local().device
    if case.startswith("AMG-PCG"):
        hs0 = setup_structured(A, chip_smoke.headline_param(), dtype=f64,
                               smooth_p=True, device=dev)
        if case.endswith("halo_shard_hierarchy"):
            hh, _ = halo_shard_hierarchy(hs0, mesh)
            op, M = hh.levels[0].A, AMGPrecond(hh)
        else:
            op = dist_dia_operator(A, mesh, dtype=f64)
            M = AMGPrecond(shard_hierarchy(hs0, mesh))
        return lambda: pcg(op, bd, M=M, tol=1e-8, maxit=200)
    if case == "RS AMG-PCG halo":
        hrs = setup_rs(A, AMGParam(smoother=13, polynomial_degree=2,
                                   coarse_dof=60), dtype=f64, device=dev)
        hh, _ = halo_shard_hierarchy(hrs, mesh, min_size=A.nrow // 2)
        return lambda: pcg(hh.levels[0].A, bd, M=AMGPrecond(hh), tol=1e-8,
                           maxit=200)
    if case != "Jacobi-PCG":
        A = poisson_2d(63)
        bd = shard_vector(as_tensor(A.matvec(np.ones(A.nrow)), f64), mesh)
    op = dist_operator(A, mesh, dtype=f64)
    M = JacobiPrecond(shard_vector(as_tensor(1.0 / A.diagonal(), f64), mesh))
    fn = {"Jacobi-PCG": pcg, "BiCGstab": bicgstab, "MINRES": minres,
          "GMRES": gmres, "GCR": gcr}[case]
    kw = {"restart": 30} if case in ("GMRES", "GCR") else {}
    return lambda: fn(op, bd, M=M, tol=1e-8, maxit=2000, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DIST_CASES)
def test_resident_dtensor_solves_read_once_and_equal_the_eager_loop(
        case, nccl_mesh):
    """A Krylov loop over DTensor vectors of a one-rank NCCL mesh runs
    resident, cold and warm: one program launch and one host read; the
    eager loop (graphs.eager()) on the same card gives the same count
    and status, the same stencil and loop-control launches as the warm
    solve, and x bit for bit, or within chip_smoke.X_DIFF_LIMIT of |x|
    where a sum adds with index_add_ (DIST_ATOMIC)."""
    import chip_smoke
    from faspsolver_tpu_torch.utils import graphs
    solve = _dist_solve(case, nccl_mesh)
    (cold, _, r_cold), (warm, l_warm, r_warm), (eager, l_e, r_e) = \
        _graphed_and_eager(solve)
    assert graphs.active(cold.x)
    assert (r_cold, r_warm, r_e) == (1, 1, 0)
    assert cold.syncs == warm.syncs == 1
    assert cold.resident and warm.resident and not eager.resident
    assert eager.syncs > eager.iters
    assert cold.iters == warm.iters == eager.iters > 3
    assert cold.status == warm.status == eager.status
    assert l_warm == l_e
    for g in (cold, warm):
        gx, ex = g.x.to_local(), eager.x.to_local()
        if case in DIST_ATOMIC:
            diff = float((gx - ex).norm() / ex.norm())
            assert diff <= chip_smoke.X_DIFF_LIMIT, diff
        else:
            assert torch.equal(gx, ex)


@pytest.mark.cuda
def test_resident_dtensor_solve_raises_when_its_capture_fails(nccl_mesh):
    """A preconditioner that declares itself capturable but reads the
    host in its apply: the resident PCG over DTensor vectors raises at
    its capture and does not run the eager loop instead."""
    from faspsolver_tpu_torch import as_tensor
    from faspsolver_tpu_torch.krylov import pcg
    from faspsolver_tpu_torch.parallel import dist_operator, shard_vector
    from faspsolver_tpu_torch.testgen import poisson_2d

    class HostReading(torch.nn.Module):
        capturable = True

        def forward(self, r):
            return r * float(r.to_local().abs().max() > 0)

    A = poisson_2d(31)
    op = dist_operator(A, nccl_mesh, dtype=torch.float64)
    bd = shard_vector(as_tensor(A.matvec(np.ones(A.nrow)), torch.float64),
                      nccl_mesh)
    with pytest.raises(RuntimeError):
        pcg(op, bd, M=HostReading(), tol=1e-8, maxit=100)


@pytest.mark.cuda
def test_dtensor_comm_record_is_the_same_replayed_or_eager(nccl_mesh):
    """A communication record runs its block eagerly: one whole cycle of
    the halo hierarchy recorded with graphs on (its AMG program already
    captured and replayed once) equals the record under graphs.eager(),
    and so does a recorded PCG solve whose resident program was captured
    before; the solve inside the record runs as the eager loop.  The
    cycle's program replays outside a record, its z bit-equal to the
    eager cycle's."""
    from faspsolver_tpu_torch import as_tensor
    from faspsolver_tpu_torch.krylov import pcg
    from faspsolver_tpu_torch.parallel import (cycle_comm_pattern,
                                               halo_shard_hierarchy,
                                               shard_vector)
    from faspsolver_tpu_torch.parallel.comm import record
    from faspsolver_tpu_torch.precond import AMGPrecond
    from faspsolver_tpu_torch.precond.amg import setup_structured
    from faspsolver_tpu_torch.testgen import poisson_2d
    from faspsolver_tpu_torch.utils import graphs
    from faspsolver_tpu_torch.utils.params import AMGParam
    mesh = nccl_mesh
    A = poisson_2d(127)
    bd = shard_vector(as_tensor(A.matvec(np.ones(A.nrow)), torch.float64),
                      mesh)
    hs0 = setup_structured(A, AMGParam(coarse_dof=60), dtype=torch.float64,
                           smooth_p=True, device=bd.to_local().device)
    hh, _ = halo_shard_hierarchy(hs0, mesh)
    M = AMGPrecond(hh)
    graphs.reset_stats()
    z = M(bd)
    assert graphs.stats["replays"] == 1
    with graphs.eager():
        ze = M(bd)
    assert torch.equal(z.to_local(), ze.to_local())
    graphed = cycle_comm_pattern(hh, mesh)
    with graphs.eager():
        eager = cycle_comm_pattern(hh, mesh)
    assert graphed == eager

    def solve():
        return pcg(hh.levels[0].A, bd, M=M, tol=1e-8, maxit=200)

    assert solve().resident
    with record(mesh) as rec:
        res = solve()
    with graphs.eager(), record(mesh) as rec_e:
        res_e = solve()
    assert not res.resident and res.syncs == res_e.syncs
    assert rec == rec_e
    assert rec.p2p_sends == 0        # one rank: no neighbour to send to


@pytest.mark.cuda
def test_resident_dtensor_solves_across_ranks_equal_the_eager_loop(tmp_path):
    """One NCCL rank per card, on a machine with two cards or more (it
    skips on one: NCCL takes one rank per card): phase 13's forms
    (a)-(e) at a small size (``torch_dist_worker.resident_forms``) run
    resident on every rank, their halo sends, all-gathers and
    all-reduces captured inside the conditional bodies, cold and warm,
    one launch and one read each, with the eager loop's count and x
    within chip_smoke.X_DIFF_LIMIT of |x| (a collective's algorithm may
    differ between a capture and an eager call); the state block is the
    same bytes on every rank; one whole cycle of (c) sends P2P, and its
    record is the same with graphs on as under graphs.eager()."""
    _need_cuda()
    ws = torch.cuda.device_count()
    if ws < 2:
        pytest.skip("needs two CUDA devices or more (one NCCL rank each)")
    import chip_smoke
    from torch_dist_worker import spawn_ranks
    ranks = spawn_ranks(ws, str(tmp_path), backend="nccl")
    for form in "abcde":
        blk = ranks[0][form]["block"]
        for r in ranks:
            d = r[form]
            assert d["resident"] and d["warm_resident"]
            assert not d["eager_resident"]
            assert d["syncs"] == d["warm_syncs"] == 1
            assert d["launches"] == d["warm_launches"] == 1
            assert d["eager_syncs"] > d["eager_it"]
            assert d["it"] == d["warm_it"] == d["eager_it"] > 3
            np.testing.assert_array_equal(d["block"], blk)
            for x in (d["x"], d["warm_x"]):
                diff = float(np.linalg.norm(x - d["eager_x"])
                             / np.linalg.norm(d["eager_x"]))
                assert diff <= chip_smoke.X_DIFF_LIMIT, (form, diff)
        d = ranks[0][form]
        print(f"{ws} ranks ({form}): {d['it']} iterations, captures "
              f"{d['captures']} ({d['nodes_captured']} nodes), x bit-equal "
              f"to the eager loop {np.array_equal(d['x'], d['eager_x'])}")
    for r in ranks:
        assert r["c"]["record"] == r["c"]["record_eager"]
        assert r["c"]["record"]["p2p_sends"] > 0
    print(f"{ws} ranks, one cycle of (c): {ranks[0]['c']['record']}")
    print(f"{ws} ranks, teardown: programs released "
          f"{[r['released'] for r in ranks]}, s "
          f"{[round(r['teardown_s'], 4) for r in ranks]}")


# the JAX package's one-device counts of phase 13's solves at 1024^2 and
# 64^3 blocks of 3 (torch_dist_worker.FULL_NX, FULL_BSR_NX), from
#     JAX_PLATFORMS=cpu python tests/small_grid_anchors.py parallel 1024
FULL_ANCHORS = {"a": 1508, "b": 13, "d": 7, "e": 24}


@pytest.mark.cuda
def test_resident_dtensor_solves_at_full_size_across_ranks(tmp_path):
    """Phase 13's forms (a)-(e) at its settings (``resident_forms(...,
    full=True)``) on one NCCL rank per card, on a machine with two cards
    or more (it skips on one): poisson_2d(1024) (1,048,576 dof), whose
    structured levels of at least the placements' min_size that the
    world size divides are split (at 2 or 4 ranks 1024^2, 342^2 and
    114^2; 38^2 and 13^2 replicated), and block_poisson_3d(64, nb=3)
    (786,432 dof, 262,144 block rows split).  On every rank, cold and
    warm: one launch and one read per solve, the eager loop's count,
    within chip_smoke.PARALLEL_ANCHORS' allowance of the JAX package's
    one-device count at this size (FULL_ANCHORS), x within
    chip_smoke.X_DIFF_LIMIT of the eager loop's, and the state block the
    same bytes on every rank.  Then every rank takes the group down
    through ``parallel.teardown`` with its modules alive, under a 120 s
    watchdog (a hang fails with a traceback), releasing its programs.
    Prints each rank's warm resident s and us per iteration, the
    programs released and the teardown s, beside each card's name and
    power limit."""
    _need_cuda()
    ws = torch.cuda.device_count()
    if ws < 2:
        pytest.skip("needs two CUDA devices or more (one NCCL rank each)")
    import subprocess
    import chip_smoke
    from torch_dist_worker import FULL_NX, spawn_ranks
    ranks = spawn_ranks(ws, str(tmp_path), backend="nccl", full=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    split = {n: n >= 8192 and n % ws == 0
             for n, _ in ranks[0]["placement"]["b"]}
    if ws in (2, 4):
        assert [n for n, s in split.items() if s] == [
            FULL_NX ** 2, 342 ** 2, 114 ** 2]
    for r in ranks:
        assert r["placement"] == ranks[0]["placement"]
        assert dict(r["placement"]["b"]) == split
        assert r["placement"]["c"] == r["placement"]["b"]
        assert r["placement"]["d"][0] == (FULL_NX ** 2, True)
    for form in "abcde":
        anchor = "b" if form == "c" else form
        blk = ranks[0][form]["block"]
        for r in ranks:
            d = r[form]
            assert d["resident"] and d["warm_resident"]
            assert not d["eager_resident"]
            assert d["syncs"] == d["warm_syncs"] == 1
            assert d["launches"] == d["warm_launches"] == 1
            assert d["eager_syncs"] > d["eager_it"]
            assert d["it"] == d["warm_it"] == d["eager_it"]
            assert abs(d["it"] - FULL_ANCHORS[anchor]) <= \
                chip_smoke.PARALLEL_ANCHORS[anchor][1], (form, d["it"])
            assert max(d["x_diff"], d["warm_x_diff"]) <= \
                chip_smoke.X_DIFF_LIMIT, (form, d["x_diff"])
            np.testing.assert_array_equal(d["block"], blk)
        print(f"{ws} ranks ({form}): {ranks[0][form]['it']} iterations "
              f"(JAX one device {FULL_ANCHORS[anchor]}), warm resident s / "
              f"us per iteration / eager s by rank " + "; ".join(
                  f"{r[form]['warm_s']:.4f} / "
                  f"{r[form]['warm_s'] / r[form]['it'] * 1e6:.1f} / "
                  f"{r[form]['eager_s']:.4f}" for r in ranks)
              + f"; x within {max(r[form]['x_diff'] for r in ranks):.2e}")
    print(f"{ws} ranks, levels (size, split): (b) "
          f"{ranks[0]['placement']['b']}, (d) {ranks[0]['placement']['d']}")
    for r in ranks:
        assert r["released"] > 0 and r["teardown_s"] < 120
    print(f"{ws} ranks, teardown with the modules alive: programs released "
          f"{[r['released'] for r in ranks]}, s "
          f"{[round(r['teardown_s'], 4) for r in ranks]}; cards {smi}")
