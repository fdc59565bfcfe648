from . import amg
from .blc_precond import (BlcOperator, BlcPrecond, BlcSweepingPrecond,
                          setup_blc_precond, setup_blc_sweeping)
from .gmg import (poisson_gmg_1d, poisson_gmg_2d, poisson_gmg_3d,
                  poisson_gmgcg_2d, poisson_gmgcg_3d)
from .ilu import (BSRILUPrecond, ILUPrecond, TriangularSolver,
                  setup_bsr_ilu0, setup_ilu)
from .preconditioners import AMGNKPrecond, AMGPrecond, FMGPrecond
from .schwarz import SchwarzPrecond, setup_schwarz
from .str_precond import (StrBlockGSPrecond, StrDiagPrecond,
                          StrSchwarzSmoother, setup_str_blockgs,
                          setup_str_diag, setup_str_ilu, setup_str_schwarz)

__all__ = ["AMGNKPrecond", "AMGPrecond", "BSRILUPrecond", "BlcOperator",
           "BlcPrecond", "BlcSweepingPrecond", "FMGPrecond", "ILUPrecond",
           "SchwarzPrecond", "StrBlockGSPrecond", "StrDiagPrecond",
           "StrSchwarzSmoother", "TriangularSolver", "amg",
           "poisson_gmg_1d", "poisson_gmg_2d", "poisson_gmg_3d",
           "poisson_gmgcg_2d", "poisson_gmgcg_3d", "setup_blc_precond",
           "setup_blc_sweeping", "setup_bsr_ilu0", "setup_ilu",
           "setup_schwarz", "setup_str_blockgs", "setup_str_diag",
           "setup_str_ilu", "setup_str_schwarz"]
