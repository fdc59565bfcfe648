"""faspsolver_tpu_torch: the PyTorch/CUDA port of faspsolver_tpu.

The drivers and ini CLI over every matrix family (CSR, BSR, the
structured-grid STR and the block-composite BLC: ``solvers/drivers.py``,
``__main__.py``), the flat-array C API (``capi.py``), the Krylov family,
classical / SA / UA / structured / block AMG with their cycles, ILU,
Schwarz, the STR and BLC preconditioners, matrix-free geometric
multigrid and f64 refinement, with every 2-D stencil apply going through
a hand-written CUDA kernel (``ops/stencil2d.py``,
``csrc/stencil2d.cu``).  The layout mirrors the JAX package module for
module, and the top level re-exports the JAX package's names.  This package imports ``torch`` and never
``jax`` (nor ``faspsolver_tpu``, whose ``__init__`` imports jax).

Device and dtype policy (stands in for the JAX package's
``default_dtype``, which follows ``jax_enable_x64``, and its ambient
device): every entry point takes ``dtype`` and ``device`` explicitly.
``dtype=None`` means float64 (the reference's REAL=double).  The drivers
and the CLI run on the CUDA device unless the caller asks for the CPU
(``device="cpu"`` / ``-device cpu``): ``device=None`` follows an operator
or hierarchy that was passed in already on a device, else
:func:`default_device`, which raises where there is no CUDA device.  The
``setup_*`` functions are the exception: their ``device=None`` builds on
the host and returns the hierarchy there, to be moved in one call with
``hier.to(device)``.  The performance mode passes ``torch.float32``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

__version__ = "0.1.0"


def default_dtype() -> torch.dtype:
    """float64: conformance mode; performance callers pass float32."""
    return torch.float64


def default_device() -> torch.device:
    """The CUDA device; where there is none it raises instead of running
    on the CPU unasked."""
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device is available; pass device=\"cpu\" (CLI: -device "
        "cpu) to run on the CPU")


def is_dtensor(x) -> bool:
    """Whether x is a ``torch.distributed.tensor.DTensor`` (a vector of
    the distribution layer, ``faspsolver_tpu_torch.parallel``); false
    without importing the DTensor module when nothing has loaded it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def torch_dtype(dtype) -> torch.dtype:
    """Normalize a torch / NumPy / None dtype to a torch dtype."""
    if dtype is None:
        return default_dtype()
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def np_dtype(dtype) -> np.dtype:
    """Normalize a torch / NumPy / None dtype to a NumPy dtype."""
    return torch.empty(0, dtype=torch_dtype(dtype)).numpy().dtype


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """Host array -> owned, contiguous tensor (a copy, never a view of
    the setup's NumPy buffers)."""
    arr = np.array(a, dtype=np_dtype(dtype) if dtype is not None else None,
                   copy=True, order="C")
    return torch.from_numpy(arr).to(device or "cpu")


# the sub-packages import the helpers above from this module, so they
# come after them
from . import constants  # noqa: E402
from .constants import (AMGType, AggregationType, CoarseningType,  # noqa: E402
                        CycleType, ILUType, InterpType, PrecondType,
                        PrintLevel, SchwarzType, SmootherType, SolverType,
                        StopType)
from .formats import BLCMatrix, BSRMatrix, CSRMatrix, STRMatrix  # noqa: E402
from .ops import (BsrEllOperator, CooOperator, DenseOperator,  # noqa: E402
                  EllOperator, MatFreeOperator, device_operator)
from .utils import (AMGParam, FaspError, ILUParam, ITSParam,  # noqa: E402
                    InputParam, SWZParam, apply_cli_overrides, param_init,
                    parse_ini)
