from .. import default_dtype
from . import blas1, eigen, stencil2d
from .blas1 import (axpby, axpy, dot, dot2, norm1, norm2, norminf, relerr,
                    update_xr)
from .eigen import maxeig, maxeig_device
from .operators import (BsrEllOperator, ConstDiaOperator, CooOperator,
                        DenseOperator, DiaNdOperator, DiaOperator, EllOperator,
                        FactoredBand, HybridDiaOperator, MatFreeOperator,
                        StencilNdOperator, SumOperator, best_operator,
                        device_operator, dia_bands_from_csr, dia_fill_ok,
                        factor_band_2d)
from .str_ops import StrOperator

__all__ = ["BsrEllOperator", "ConstDiaOperator", "CooOperator",
           "DenseOperator", "DiaNdOperator", "DiaOperator", "EllOperator",
           "FactoredBand", "HybridDiaOperator", "MatFreeOperator",
           "StencilNdOperator", "StrOperator", "SumOperator", "axpby", "axpy",
           "best_operator", "blas1", "default_dtype", "device_operator",
           "dia_bands_from_csr", "dia_fill_ok", "dot", "dot2", "eigen",
           "factor_band_2d", "maxeig", "maxeig_device", "norm1", "norm2",
           "norminf", "relerr", "stencil2d", "update_xr"]
