from .cycles import mgcycle
from .hierarchy import (AMGHierarchy, AMGLevel, CoarseSolver,
                        IterativeCoarseSolver, make_coarse_solver)
from .setup_rs import setup_rs
from .smoothers import SmootherData, build_smoother, smooth
from .structured import setup_structured

__all__ = ["AMGHierarchy", "AMGLevel", "CoarseSolver",
           "IterativeCoarseSolver", "SmootherData", "build_smoother",
           "make_coarse_solver", "mgcycle", "setup_rs", "setup_structured",
           "smooth"]
