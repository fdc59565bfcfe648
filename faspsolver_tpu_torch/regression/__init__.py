"""The reference's regression matrix over the port (port of
``faspsolver_tpu/regression``)."""
from .runner import (check_solu, core_configs, matfree_configs, mm_configs,
                     mm_problems, print_tally, run_matrix)

__all__ = ["check_solu", "core_configs", "matfree_configs", "mm_configs",
           "mm_problems", "print_tally", "run_matrix"]
