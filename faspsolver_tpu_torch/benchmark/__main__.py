"""CLI: python -m faspsolver_tpu_torch.benchmark [--data DIR]
[--solver amg|ilu|cg] [--min N] [--max N] [--f32] [--device cpu]
[--corpus [--scale N]] [--gen]

Reference: benchmark/run.sh driving benchmark.ex over benchmark/input.dat.
Scores the ``.mtx`` files of ``--data`` (none given: nothing is scored),
the generated diversity corpus (``--corpus``) or the generated FDM
problems (``--gen``) on the CUDA device in float64; ``--f32`` selects the
mixed-precision mode (f32 inner Krylov inside f64 refinement), and
``--device cpu`` asks for the CPU (without a CUDA device and without it,
the run raises).  ``main`` also takes the device as an argument, which
wins over ``--device``.  Exit code 0 only if there is at least one row
and every row converged.
"""
import sys

import torch


def main(argv, device=None) -> int:
    from .harness import run_benchmark, run_corpus, run_generated

    def opt(flag, default):
        return argv[argv.index(flag) + 1] if flag in argv else default

    if device is None:
        device = opt("--device", None)
    dtype = torch.float32 if "--f32" in argv else torch.float64
    if "--corpus" in argv:
        results = run_corpus(solver_kind=opt("--solver", "amg"),
                             scale=int(opt("--scale", 255)), dtype=dtype,
                             device=device)
    elif "--gen" in argv:
        results = run_generated(solver_kind=opt("--solver", "amg"),
                                dtype=dtype, device=device)
    else:
        results = run_benchmark(opt("--data", None),
                                solver_kind=opt("--solver", "ilu"),
                                min_size=int(opt("--min", 0)),
                                max_size=int(opt("--max", 200_000)),
                                dtype=dtype, device=device)
    return 0 if results and all(r.converged for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
