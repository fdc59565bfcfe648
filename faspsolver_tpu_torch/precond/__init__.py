from . import amg
from .preconditioners import AMGNKPrecond, AMGPrecond, FMGPrecond

__all__ = ["AMGNKPrecond", "AMGPrecond", "FMGPrecond", "amg"]
