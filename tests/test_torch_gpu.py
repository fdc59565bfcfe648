"""Tests of the port that need a CUDA device.  They import no jax, so on
the GPU machine (which has no jax) they run without the repository's
conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Elsewhere each skips with its reason."""
import numpy as np
import pytest
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
