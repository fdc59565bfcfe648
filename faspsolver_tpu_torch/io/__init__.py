from .readers import (matrix_read, read_bsr, read_coo, read_coovec_bin,
                      read_csr, read_csrvec, read_hb, read_mesh, read_mtx,
                      read_str, read_vec, read_vecind)
from .writers import (write_bsr, write_coo, write_coovec_bin, write_csr,
                      write_mtx, write_samg, write_str, write_vec,
                      write_vecind)

__all__ = [
    "matrix_read", "read_bsr", "read_coo", "read_coovec_bin", "read_csr",
    "read_csrvec", "read_hb", "read_mesh", "read_mtx", "read_str",
    "read_vec", "read_vecind",
    "write_bsr", "write_coo", "write_coovec_bin", "write_csr", "write_mtx",
    "write_samg", "write_str", "write_vec", "write_vecind",
]
