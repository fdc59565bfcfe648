"""Run chip_smoke.py's phase-8 small grid through either package's
drivers on the CPU in float64 (poisson_fe_manufactured(64), 3,969 dof).

    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py

prints the JAX package's iteration count for every config: the anchors
recorded in ``chip_smoke.SMALL_GRID``.  ``tests/test_torch_drivers.py``
runs the port's side with :func:`run`.  Not collected by pytest (no
``test_`` prefix).
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def problem():
    from faspsolver_tpu_torch.testgen import poisson_fe_manufactured
    A, b, *_ = poisson_fe_manufactured(64)
    return A, b


def run(pkg: str, cfg, A, b):
    """One SMALL_GRID config through ``pkg`` ("jax" or "port"): the
    driver's SolveResult, x as a NumPy array."""
    _, driver, its, amg, *_ = cfg
    if pkg == "jax":
        import faspsolver_tpu.solvers as solvers
        from faspsolver_tpu.formats import CSRMatrix
        from faspsolver_tpu.utils import params
        A = CSRMatrix(A.indptr, A.indices, A.data, A.shape)
    else:
        import faspsolver_tpu_torch.solvers as solvers
        from faspsolver_tpu_torch.utils import params
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if its is not None:
        kw["its"] = params.ITSParam(**its)
    if amg is not None:
        kw["amg"] = params.AMGParam(**amg)
    res = getattr(solvers, driver)(A, b, **kw)
    res = res[0] if isinstance(res, tuple) else res
    x = np.asarray(res.x) if pkg == "jax" else res.x.numpy()
    return res, x


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from native_parity import ensure_native
    ensure_native()
    A, b = problem()
    for cfg in chip_smoke.SMALL_GRID:
        res, _ = run("jax", cfg, A, b)
        print(f"{cfg[0]:24s} {int(res.iters):5d}  status {int(res.status)}"
              f"  (recorded {cfg[4]})")
