from .fdm import (anisotropic_2d, anisotropic_3d, block_poisson_3d,
                  convdiff_2d, jump_2d, poisson_2d,
                  poisson_2d_manufactured, poisson_3d,
                  poisson_3d_manufactured, stretched_2d)
from .fem import (TriMesh, assemble_mass, assemble_poisson,
                  heat_backward_euler_system, l2_error,
                  poisson_fe_manufactured, quad_points, refine_uniform,
                  unit_square_mesh)

__all__ = ["poisson_2d", "poisson_2d_manufactured", "poisson_3d",
           "poisson_3d_manufactured", "anisotropic_2d", "anisotropic_3d",
           "convdiff_2d", "jump_2d", "stretched_2d", "block_poisson_3d",
           "TriMesh", "assemble_mass", "assemble_poisson",
           "heat_backward_euler_system", "l2_error",
           "poisson_fe_manufactured", "quad_points", "refine_uniform",
           "unit_square_mesh"]
