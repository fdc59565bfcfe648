from .aggregation import (aggregate_pairwise, aggregate_vmb, strength_graph,
                          tentative_prolongation)
from .cycles import amli_coefs, amli_cycle, fmg_cycle, mgcycle, nl_amli_cycle
from .coarsen_rs import (cf_split_cr, cf_split_pmis, cf_split_rs, coarsen,
                         strong_couplings)
from .interp import (interp_direct, interp_energymin, interp_extended,
                     interp_standard, interpolate, truncate)
from .bsr_smoothers import (BsrColorBlock, BsrSmootherData,
                            build_bsr_smoother, bsr_smooth)
from .hierarchy import (AMGHierarchy, AMGLevel, CoarseSolver,
                        IterativeCoarseSolver, NearKernel,
                        make_coarse_solver)
from .setup_bsr import setup_sa_bsr, setup_ua_bsr
from .setup_rs import setup_cr, setup_rs
from .setup_sa import setup_sa
from .setup_ua import setup_ua
from .smoothers import (ColorBlock, PrecondSmoother, SmootherData,
                        build_smoother, smooth)
from .solve import amg_solve, famg_solve
from .structured import (PairProlong, PairRestrict, detect_dims,
                         setup_structured)
from .transfer import (AggProlong, AggRestrict, BlockAggProlong,
                       BlockAggRestrict, csr_transfer)

__all__ = ["AMGHierarchy", "AMGLevel", "AggProlong", "AggRestrict",
           "BlockAggProlong", "BlockAggRestrict", "BsrColorBlock",
           "BsrSmootherData", "CoarseSolver", "ColorBlock",
           "IterativeCoarseSolver", "NearKernel", "PrecondSmoother",
           "SmootherData", "bsr_smooth", "build_bsr_smoother", "setup_cr",
           "setup_sa_bsr", "setup_ua_bsr", "aggregate_pairwise", "aggregate_vmb",
           "amg_solve", "amli_coefs", "amli_cycle", "build_smoother",
           "csr_transfer", "famg_solve", "fmg_cycle", "make_coarse_solver",
           "mgcycle", "nl_amli_cycle", "setup_rs", "setup_sa",
           "setup_structured",
           "setup_ua", "smooth", "strength_graph", "tentative_prolongation",
           "cf_split_cr", "cf_split_pmis", "cf_split_rs", "coarsen",
           "strong_couplings", "interp_direct", "interp_energymin",
           "interp_extended", "interp_standard", "interpolate", "truncate",
           "detect_dims", "PairProlong", "PairRestrict"]
