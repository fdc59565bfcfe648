from . import blas1, stencil2d
from .operators import (BsrEllOperator, ConstDiaOperator, CooOperator, DenseOperator,
                        DiaNdOperator, DiaOperator, EllOperator, FactoredBand,
                        HybridDiaOperator, StencilNdOperator, SumOperator,
                        best_operator, device_operator, dia_bands_from_csr,
                        factor_band_2d)

__all__ = ["BsrEllOperator", "ConstDiaOperator", "CooOperator", "DenseOperator",
           "DiaNdOperator", "DiaOperator", "EllOperator", "FactoredBand",
           "HybridDiaOperator", "StencilNdOperator", "SumOperator",
           "best_operator", "blas1", "device_operator", "dia_bands_from_csr",
           "factor_band_2d", "stencil2d"]
