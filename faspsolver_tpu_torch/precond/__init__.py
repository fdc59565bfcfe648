from . import amg
from .ilu import (BSRILUPrecond, ILUPrecond, TriangularSolver,
                  setup_bsr_ilu0, setup_ilu)
from .preconditioners import AMGNKPrecond, AMGPrecond, FMGPrecond
from .schwarz import SchwarzPrecond, setup_schwarz

__all__ = ["AMGNKPrecond", "AMGPrecond", "BSRILUPrecond", "FMGPrecond",
           "ILUPrecond", "SchwarzPrecond", "TriangularSolver", "amg",
           "setup_bsr_ilu0", "setup_ilu", "setup_schwarz"]
