from .bicgstab import bicgstab
from .gcg_gcr import gcg, gcr
from .gmres import gmres, vfgmres, vgmres
from .minres import minres
from .pcg import pcg
from .precond import BlockJacobiPrecond, IdentityPrecond, JacobiPrecond
from .result import SolveResult

__all__ = [
    "bicgstab", "gcg", "gcr", "gmres", "vfgmres", "vgmres", "minres", "pcg",
    "BlockJacobiPrecond", "IdentityPrecond", "JacobiPrecond",
    "SolveResult",
]
