"""The STR, BLC, Schwarz and matrix-free solves that run resident on the
card, as cases shared by ``tests/test_torch_graphs.py`` (CPU, the graph
control flow emulated) and ``tests/test_torch_gpu.py`` (the card).  No
jax here: the GPU machine has none."""
import numpy as np
import torch

# case -> (problem, Krylov method, preconditioner); "small" sizes for
# the CPU, "card" sizes for the card's test suite
CASES = ("CG + STR diag", "vFGMRES + STR ILU(0)", "vFGMRES + STR block GS",
         "vFGMRES + STR Schwarz", "vFGMRES + BLC diag", "vFGMRES + BLC sgs",
         "vFGMRES + sweeping", "GMRES + forward Schwarz",
         "CG + symmetric Schwarz", "matfree CG", "matfree GCG")
# the cases whose preconditioner adds with atomics on the card: UA-AMG's
# restriction (AggRestrict, index_add_) on the BLC diagonal blocks
ATOMIC = ("vFGMRES + BLC diag", "vFGMRES + BLC sgs", "vFGMRES + sweeping")
SIZES = {"small": dict(str=8, sweep=(16, 4), grid=31, fe=16),
         "card": dict(str=16, sweep=(32, 4), grid=127, fe=32)}
_GMRES = dict(tol=1e-9, maxit=500, restart=30)
_CG = dict(tol=1e-9, maxit=2000)


def build(case, size, device):
    """(solve, A, M): ``solve()`` runs the case's Krylov method over its
    operator A and preconditioner M, both built once on ``device``, with
    b on ``device``; each call starts from x0 = 0."""
    import chip_smoke
    from faspsolver_tpu_torch import krylov
    from faspsolver_tpu_torch.krylov import JacobiPrecond
    from faspsolver_tpu_torch.ops import MatFreeOperator, device_operator
    from faspsolver_tpu_torch.ops.str_ops import StrOperator
    from faspsolver_tpu_torch.precond import (setup_blc_precond,
                                              setup_blc_sweeping,
                                              setup_schwarz, setup_str_blockgs,
                                              setup_str_diag, setup_str_ilu,
                                              setup_str_schwarz)
    from faspsolver_tpu_torch.precond.blc_precond import BlcOperator
    from faspsolver_tpu_torch.testgen import (poisson_2d,
                                              poisson_fe_manufactured)
    from faspsolver_tpu_torch.utils.params import SWZParam
    n = SIZES[size]
    fn, kw = krylov.vfgmres, _GMRES
    if "STR" in case:
        S, _, b = chip_smoke.str_problem(n["str"])
        if "diag" in case:
            A, M, fn, kw = StrOperator.from_str(S), setup_str_diag(S), \
                krylov.pcg, _CG
        elif "ILU" in case:
            A, M = StrOperator.from_str(S), setup_str_ilu(S, fill=0)
        else:
            M = (setup_str_schwarz(S) if "Schwarz" in case
                 else setup_str_blockgs(S))
            A = M.A
    elif "BLC" in case:
        B, b = chip_smoke.blc_problem(n["str"])
        A = BlcOperator.from_blc(B)
        M = setup_blc_precond(B, mode=case.rsplit(" ", 1)[1])
    elif "sweeping" in case:
        B, b = chip_smoke.sweep_problem(*n["sweep"])
        A, M = BlcOperator.from_blc(B), setup_blc_sweeping(B)
    elif "Schwarz" in case:
        P = poisson_2d(n["grid"])
        b = P.matvec(np.ones(P.nrow))
        sym = "symmetric" in case
        M = setup_schwarz(P, SWZParam(SWZ_type=3 if sym else 1))
        A = M.A
        if sym:
            fn, kw = krylov.pcg, _CG
        else:
            fn = krylov.gmres
    else:
        P, b, *_ = poisson_fe_manufactured(n["fe"])
        A = MatFreeOperator(device_operator(P, prefer="ell"), P.nrow,
                            torch.float64)
        M = JacobiPrecond.from_csr(P)
        fn, kw = ((krylov.pcg, _CG) if case == "matfree CG"
                  else (krylov.gcg, dict(tol=1e-9, maxit=500)))
    A, M = A.to(device), M.to(device)
    bt = torch.as_tensor(b, dtype=torch.float64, device=device)

    def solve():
        return fn(A, bt, M=M, **kw)
    return solve, A, M
