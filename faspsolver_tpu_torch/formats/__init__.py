from .blc import BLCMatrix
from .bsr import BSRMatrix
from .csr import CSRMatrix, spgemm
from .csrl import CSRLMatrix
from .str_grid import STRMatrix

__all__ = ["BLCMatrix", "BSRMatrix", "CSRLMatrix", "CSRMatrix", "STRMatrix",
           "spgemm"]
