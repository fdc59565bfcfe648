"""The card's fast path: structured SA-AMG + f32 + refinement.

The port of tutorials/tpu_fast_path.py, the headline configuration of
bench.py as a tutorial: the setup, then the refined solve, whose inner
f32 AMG-PCG replays CUDA graphs on the card, run twice to show the cold
solve (the capture included) beside the warm one.
Run: python -m tutorials_torch.fast_path [NX] [--device cpu]
"""
import sys
import time

import numpy as np
import torch

from faspsolver_tpu_torch.constants import SmootherType
from faspsolver_tpu_torch.krylov import pcg
from faspsolver_tpu_torch.precond import AMGPrecond
from faspsolver_tpu_torch.precond.amg import setup_structured
from faspsolver_tpu_torch.solvers import solve_refined
from faspsolver_tpu_torch.testgen import poisson_2d
from faspsolver_tpu_torch.utils.params import AMGParam

from tutorials_torch import parse


def main(argv, device=None):
    args, device = parse(argv, device)
    # size: 511 (261k dof) by default; 127 for a quick CPU run, 1023 for
    # the 1M-dof bench problem
    NX = int(args[0]) if args else 511
    A = poisson_2d(NX)
    b = A.matvec(np.ones(A.nrow))

    t0 = time.perf_counter()
    hier = setup_structured(
        A, AMGParam(smoother=int(SmootherType.CHEBYSHEV), polynomial_degree=2,
                    coarse_dof=800), dtype=torch.float32, smooth_p=True,
        device=device)
    print(f"setup {time.perf_counter()-t0:.2f}s, "
          f"levels {[l.A.shape[0] for l in hier.levels]}")

    M = AMGPrecond(hier)
    op = hier.levels[0].A

    def run():
        t0 = time.perf_counter()
        res = solve_refined(
            A, b, lambda r, tol: pcg(op, r, M=M, tol=tol, maxit=40),
            tol=1e-8, dtype=torch.float32, device=device)
        return res, time.perf_counter() - t0

    res, cold = run()
    print(f"refined solve: rounds={res.rounds} inner={res.inner_iters} "
          f"relres={res.relres:.3e}")
    res, warm = run()
    print(f"solve seconds (b in, x on the host): cold {cold:.4f}, "
          f"warm {warm:.4f}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
