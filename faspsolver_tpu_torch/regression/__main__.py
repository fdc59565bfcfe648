"""CLI entry: python -m faspsolver_tpu_torch.regression [--mm] [--matfree]
[--bsr] [--fast] [--device cpu]

Reproduces the reference regression drivers (regression.c /
regression_mm.c / regression_mf.c, testbsr.c) over the reference's data
directory (``FASP_REFDATA``) and prints the PASS/ATTENTION tally.  Exit
code 0 iff everything passed.  Runs in float64 on the CUDA device (an
error where there is none) unless ``--device cpu``; the JAX package's CLI
forces the CPU instead.
"""
import sys

from .. import default_device
from .runner import (bsr_configs, bsr_problems, core_configs,
                     matfree_configs, mm_configs, mm_problems,
                     print_tally, run_matrix, _problems)


def main(argv) -> int:
    # the card unless asked for the CPU; an error where there is none
    device = (argv[argv.index("--device") + 1] if "--device" in argv
              else default_device())
    if "--mm" in argv:
        results = run_matrix(mm_configs(device), mm_problems())
    elif "--matfree" in argv:
        results = run_matrix(matfree_configs(device), _problems())
    elif "--bsr" in argv:
        results = run_matrix(bsr_configs(device), bsr_problems())
    else:
        cfgs = core_configs(device)
        probs = _problems()
        if "--fast" in argv:
            cfgs = cfgs[:12]
            probs = probs[:1]
        results = run_matrix(cfgs, probs)
    _, nwarn = print_tally(results)
    return 1 if nwarn else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
