from .drivers import (itsolver, itsolver_s, krylov, krylov_amg, krylov_amg_nk,
                      krylov_block, krylov_blockgs, krylov_diag, krylov_ilu,
                      krylov_ilu_m, krylov_nk_amg, krylov_s, krylov_sweeping,
                      krylov_swz, solve_amg, solve_famg)
from .refine import (RefinedResult, make_resident_refiner, solve_refined,
                     solve_refined_device, solve_refined_resident)

__all__ = ["itsolver", "itsolver_s", "krylov", "krylov_amg", "krylov_amg_nk",
           "krylov_block", "krylov_blockgs", "krylov_diag", "krylov_ilu",
           "krylov_ilu_m", "krylov_nk_amg", "krylov_s", "krylov_sweeping",
           "krylov_swz", "solve_amg", "solve_famg",
           "RefinedResult", "make_resident_refiner",
           "solve_refined", "solve_refined_device", "solve_refined_resident"]
