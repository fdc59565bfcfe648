"""Ini-driven solver CLI (port of ``faspsolver_tpu/__main__.py``).

Reference: test/main/test.c (problem dispatch + solver/precond dispatch,
ini-configured) and the CLI flag set of fasp_param_set (AuxParam.c:41,
doc/userguide.tex:861).

Usage:
    python -m faspsolver_tpu_torch -ini ini/input.dat
    python -m faspsolver_tpu_torch -solver 1 -precond 2 -maxit 200 \
        -tol 1e-8 -mat data/csrmat_FE.dat -rhs data/rhs_FE.dat
    python -m faspsolver_tpu_torch -problem poisson2d -size 255 -device cpu

Problems: explicit -mat/-rhs files, or generated (-problem poisson2d|
poisson3d|fe2d with -size N).  The solve runs on the CUDA device in
float64; ``-device cpu`` asks for the CPU (without a CUDA device and
without that flag the run raises), and ``FASP_TPU_F32=1`` selects
float32.  ``main`` also takes the device and dtype as arguments; the
flag and the variable apply only where those are ``None``.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch


def main(argv, device=None, dtype=None) -> int:
    if dtype is None and os.environ.get("FASP_TPU_F32") == "1":
        dtype = torch.float32

    from . import default_device
    from .constants import PrecondType
    from .io import read_csrvec, read_mtx, read_vec
    from .solvers import (krylov, krylov_amg, krylov_diag, krylov_ilu,
                          krylov_swz)
    from .testgen import (poisson_2d_manufactured, poisson_3d_manufactured,
                          poisson_fe_manufactured)
    from .utils import messages
    from .utils.params import apply_cli_overrides, param_init

    # split off driver-only flags before the reference flag parser
    args = list(argv)
    extra = {}
    for key in ("-mat", "-rhs", "-problem", "-size", "-device"):
        if key in args:
            i = args.index(key)
            extra[key[1:]] = args[i + 1]
            del args[i:i + 2]

    if device is None:
        device = extra.get("device") or default_device()

    inp = apply_cli_overrides(args)
    its, amg, ilu, swz = param_init(inp)

    # ---- problem ----------------------------------------------------------
    sol = None
    if "mat" in extra:
        if "rhs" in extra:
            if extra["mat"].endswith(".mtx"):
                A = read_mtx(extra["mat"])
                b = read_vec(extra["rhs"])
            else:
                A, b = read_csrvec(extra["mat"], extra["rhs"])
        else:
            A = read_mtx(extra["mat"]) if extra["mat"].endswith(".mtx") \
                else read_csrvec(extra["mat"], None)
            b = A.matvec(np.ones(A.nrow))
    else:
        size = int(extra.get("size", 64))
        prob = extra.get("problem", "poisson2d")
        if prob == "poisson3d":
            A, b, sol = poisson_3d_manufactured(size)
        elif prob == "fe2d":
            A, b, *_ = poisson_fe_manufactured(size)
        else:
            A, b, sol = poisson_2d_manufactured(size)

    messages.message(its.print_level, f"problem: n={A.nrow}, nnz={A.nnz}")

    # ---- solve ------------------------------------------------------------
    kw = dict(its=its, dtype=dtype, device=device)
    t0 = time.perf_counter()
    pt = int(inp.precond_type)
    if pt == PrecondType.NONE:
        res = krylov(A, b, **kw)
    elif pt == PrecondType.DIAG:
        res = krylov_diag(A, b, **kw)
    elif pt == PrecondType.ILU:
        res = krylov_ilu(A, b, ilu=ilu, **kw)
    elif pt == PrecondType.SCHWARZ:
        res = krylov_swz(A, b, swz=swz, **kw)
    else:
        res, _ = krylov_amg(A, b, amg=amg, **kw)
    x = res.x.cpu().numpy()
    wall = time.perf_counter() - t0

    r = b - A.matvec(x)
    relres = float(np.linalg.norm(r) / max(np.linalg.norm(b), 1e-300))
    print(f"Number of iterations = {int(res.iters)} with relative "
          f"residual {relres:.6e}.")
    print(f"Solver costs {wall:.4f} seconds.")
    if sol is not None:
        print(f"Max diff vs exact solution: {np.abs(x - sol).max():.6e}")
    return 0 if bool(res.converged) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
