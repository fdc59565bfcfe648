"""Simple preconditioner operators (port of
``faspsolver_tpu/krylov/precond.py``).

Reference: the opaque ``precond{void* data; void (*fct)(...)}`` callback
(base/include/fasp.h:1095-1103) — here a preconditioner is any callable
``r -> z``; array-holding ones are modules.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import as_tensor
from ..ops.operators import block_diag_apply


class IdentityPrecond(nn.Module):
    """No preconditioning (reference: precond_type NONE)."""

    capturable = True

    def graph_identity(self):
        return None, ("IdentityPrecond",)     # holds nothing: one graph

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return r


class JacobiPrecond(nn.Module):
    """Diagonal (Jacobi) preconditioner (reference: fasp_precond_diag,
    PreCSR.c:172)."""

    capturable = True       # no host read in the apply (utils/graphs.py)

    def __init__(self, dinv):
        super().__init__()
        self.register_buffer("dinv", dinv if isinstance(dinv, torch.Tensor)
                             else as_tensor(dinv))

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return self.dinv * r

    @classmethod
    def from_csr(cls, A, dtype=None) -> "JacobiPrecond":
        d = A.diagonal()
        return cls(as_tensor(np.where(d != 0.0,
                                      1.0 / np.where(d == 0, 1, d), 1.0),
                             dtype))


class BlockJacobiPrecond(nn.Module):
    """Block-diagonal preconditioner with precomputed block inverses
    (reference: fasp_precond_dbsr_diag, PreBSR.c:49)."""

    def __init__(self, dinv):
        super().__init__()
        self.register_buffer("dinv", dinv if isinstance(dinv, torch.Tensor)
                             else as_tensor(dinv))       # (nbrow, nb, nb)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return block_diag_apply(self.dinv, r.reshape(-1, self.dinv.shape[1])
                                ).reshape(-1)

    @classmethod
    def from_bsr(cls, A, dtype=None) -> "BlockJacobiPrecond":
        return cls(as_tensor(A.diag_inv(), dtype))
