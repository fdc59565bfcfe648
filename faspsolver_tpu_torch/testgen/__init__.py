from .fdm import (anisotropic_2d, anisotropic_3d, convdiff_2d, jump_2d,
                  poisson_2d, poisson_2d_manufactured, poisson_3d,
                  poisson_3d_manufactured, stretched_2d)
from .fem import TriMesh, assemble_poisson, unit_square_mesh

__all__ = ["poisson_2d", "poisson_2d_manufactured", "poisson_3d",
           "poisson_3d_manufactured", "anisotropic_2d", "anisotropic_3d",
           "convdiff_2d", "jump_2d", "stretched_2d", "TriMesh",
           "assemble_poisson", "unit_square_mesh"]
