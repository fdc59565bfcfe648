"""Checkpoint / resume for solver state and AMG hierarchies (port of
``faspsolver_tpu/utils/checkpoint.py``).

The reference persists matrices/vectors through its BlaIO writers and
keeps direct-solver factorizations alive across solves via the staged
MUMPS/PARDISO job API (XtrMumps.c fasp_solver_mumps_steps).  Here: the
hierarchy's module tree (every tensor, with the structure that holds
them) is written by ``torch.save``, so an expensive setup is paid once
and reused across processes, plus plain solver-iterate snapshots.

Format: one ``torch.save`` file holding ``{"tree": ..., "meta": ...}``.
Tensors keep their bits and their sharing; a CUDA graph or a stencil
plan is never written (the modules holding them drop them when pickled,
as for ``copy.deepcopy``) and is built again at the first apply after a
load.  Iterates use the JAX package's ``.npz`` layout (``x``,
``iteration``, ``relres``), so an iterate written by either package loads
in the other.

SECURITY: checkpoints are TRUSTED input only.  ``load_pytree`` unpickles
the file (``torch.load(..., weights_only=False)``: the module tree's
classes are arbitrary), so loading a checkpoint from an untrusted source
can execute arbitrary code, exactly like ``torch.load`` itself.  Never
feed user-uploaded files to ``load_pytree`` or ``load_hierarchy``.

Device rule (the drivers'): ``load_pytree`` and ``load_hierarchy`` place
every tensor on the CUDA device when ``device`` is None, and raise where
there is none; ``device="cpu"`` asks for the host.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .. import default_device

_KEYS = {"tree", "meta"}


def save_pytree(path: str, tree: Any, meta: dict = None) -> None:
    """Save any tree of tensors and modules (e.g. an AMGHierarchy) to
    one file."""
    torch.save({"tree": tree, "meta": dict(meta or {})}, path)


def load_pytree(path: str, device=None) -> Tuple[Any, dict]:
    """Load a tree saved by :func:`save_pytree` onto ``device`` (None:
    the CUDA device); returns (tree, meta).

    TRUSTED INPUT ONLY: unpickles the file (see module docstring)."""
    device = torch.device(device) if device is not None else default_device()
    blob = torch.load(path, map_location=device, weights_only=False)
    if not (isinstance(blob, dict) and set(blob) == _KEYS):
        raise ValueError(f"{path} was not written by save_pytree")
    return blob["tree"], blob["meta"]


def save_hierarchy(path: str, hier, extra_meta: dict = None) -> None:
    """Persist an AMG hierarchy (setup is the expensive phase; reference
    re-runs it per matrix — here it can be checkpointed)."""
    meta = dict(kind="amg_hierarchy",
                levels=[int(l.A.shape[0]) for l in hier.levels])
    meta.update(extra_meta or {})
    save_pytree(path, hier, meta)


def load_hierarchy(path: str, device=None):
    """The hierarchy saved by :func:`save_hierarchy`, on ``device``
    (None: the CUDA device).  TRUSTED INPUT ONLY."""
    tree, meta = load_pytree(path, device)
    if meta.get("kind") != "amg_hierarchy":
        raise ValueError(f"{path} is not an AMG hierarchy checkpoint")
    return tree


def save_iterate(path: str, x, iteration: int, relres: float) -> None:
    """Solver-iterate snapshot for long runs (resume support); a tensor
    ``x`` is written from the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    np.savez_compressed(path, x=np.asarray(x),
                        iteration=np.int64(iteration),
                        relres=np.float64(relres))


def load_iterate(path: str):
    """(x as a NumPy array, iteration, relres) of a saved iterate."""
    with np.load(path) as z:
        return z["x"], int(z["iteration"]), float(z["relres"])
