"""Run chip_smoke.py's driver grids through either package's drivers on
the CPU in float64, to record the JAX package's iteration counts (the
anchors the port is held to on the card).

    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py            # phase 8
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py leftover   # phase 9d
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py bsr 64     # phase 9a
    JAX_PLATFORMS=cpu python tests/small_grid_anchors.py cli 4 1023 # phase 9b/c

``small`` (the default) prints the count of every ``chip_smoke.SMALL_GRID``
config on poisson_fe_manufactured(64) (3,969 dof), ``leftover`` those of
``chip_smoke.LEFTOVER_GRID`` on the same problem, ``bsr <nx>`` those of
``chip_smoke.BSR_GRID`` on block_poisson_3d(nx, nb=3), and ``cli <precond>
<size> [key=value ...]`` the JAX CLI's count on ini/input.dat with the
given preconditioner id, grid size and ini overrides (as chip_smoke's
phases 9b and 9c write them into a temporary ini).
``tests/test_torch_drivers.py`` runs the port's side with :func:`run`.
Not collected by pytest (no ``test_`` prefix).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def problem():
    from faspsolver_tpu_torch.testgen import poisson_fe_manufactured
    A, b, *_ = poisson_fe_manufactured(64)
    return A, b


def _packages(pkg: str):
    if pkg == "jax":
        import faspsolver_tpu.solvers.drivers as solvers
        from faspsolver_tpu.utils import params
    else:
        import faspsolver_tpu_torch.solvers as solvers
        from faspsolver_tpu_torch.utils import params
    return solvers, params


def _to_jax(A):
    from faspsolver_tpu import formats
    cls = getattr(formats, type(A).__name__)
    return cls(A.indptr, A.indices, A.data, A.shape)


def run_fields(pkg: str, driver: str, fields: dict, A, b):
    """One driver call through ``pkg`` ("jax" or "port") with the
    parameter objects built from ``fields`` (its / amg / ilu / swz dicts,
    ``nk``: the component-wise constant basis): the SolveResult and x as
    a NumPy array."""
    solvers, params = _packages(pkg)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    for key, cls in (("its", params.ITSParam), ("amg", params.AMGParam),
                     ("ilu", params.ILUParam), ("swz", params.SWZParam)):
        if fields.get(key) is not None:
            kw[key] = cls(**fields[key])
    args = [_to_jax(A) if pkg == "jax" else A, b]
    if fields.get("nk"):
        args.append(chip_smoke.component_basis(A.nrow, A.nb))
    res = getattr(solvers, driver)(*args, **kw)
    res = res[0] if isinstance(res, tuple) else res
    x = np.asarray(res.x) if pkg == "jax" else res.x.numpy()
    return res, x


def run(pkg: str, cfg, A, b):
    """One SMALL_GRID config (name, driver, its, amg, ...)."""
    _, driver, its, amg, *_ = cfg
    return run_fields(pkg, driver, dict(its=its, amg=amg), A, b)


def ini_fields(params, ini: str) -> dict:
    its, amg, _, _ = params.param_init(params.apply_cli_overrides(
        ["-ini", os.path.join(ROOT, ini)]))
    return dict(its=its, amg=amg)


def jax_refined(A, b, amg_fields: dict):
    """bench.py's reservoir stanza through the JAX package: the f32 BSR
    hierarchy under vFGMRES inside ``solve_refined``."""
    import jax.numpy as jnp
    from faspsolver_tpu.krylov import vfgmres
    from faspsolver_tpu.ops import device_operator
    from faspsolver_tpu.precond import AMGPrecond
    from faspsolver_tpu.precond.amg.setup_bsr import (setup_sa_bsr,
                                                      setup_ua_bsr)
    from faspsolver_tpu.solvers import solve_refined
    from faspsolver_tpu.utils.params import AMGParam
    Aj = _to_jax(A)
    param = AMGParam(**amg_fields)
    setup = setup_sa_bsr if int(param.AMG_type) == 2 else setup_ua_bsr
    M = AMGPrecond(setup(Aj, param, dtype=jnp.float32))
    op = device_operator(Aj, dtype=jnp.float32)

    def inner(r, tol):
        return vfgmres(op, r, M=M, tol=tol, **chip_smoke.REFINED_INNER)

    return solve_refined(Aj, b, inner, dtype=jnp.float32,
                         **chip_smoke.REFINED)


def _main(argv):
    import jax
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from native_parity import ensure_native
    ensure_native()
    mode = argv[0] if argv else "small"
    if mode == "cli":
        from faspsolver_tpu.__main__ import main
        ini = chip_smoke.ini_with("ini/input.dat", dict(
            kv.split("=") for kv in argv[3:]), os.environ.get("TMPDIR"))
        t0 = time.perf_counter()
        rc = main(["-ini", ini, "-precond", argv[1], "-problem",
                   "poisson2d", "-size", argv[2]])
        print(f"rc {rc}, {time.perf_counter() - t0:.1f} s")
        return
    if mode == "bsr":
        nx = int(argv[1])
        A, b = chip_smoke.bsr_problem(nx)
        from faspsolver_tpu.utils import params
        for name, driver, fields, *_ in chip_smoke.BSR_GRID:
            t0 = time.perf_counter()
            if driver == "refined":
                res = jax_refined(A, b, fields["amg"])
                text = (f"{res.inner_iters:5d} inner iterations, "
                        f"{res.rounds} rounds, relres {res.relres:.3e}")
            else:
                if fields == "ini":
                    ini = ini_fields(params, "ini/bsr.dat")
                    fields = {k: vars(v) for k, v in ini.items()}
                res, x = run_fields("jax", driver, fields, A, b)
                relres = np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)
                text = (f"{int(res.iters):5d} iterations, status "
                        f"{int(res.status)}, relres {relres:.3e}")
            print(f"nx={nx} {name:46s} {text}  "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return
    A, b = problem()
    if mode == "leftover":
        for name, driver, fields, anchor, _ in chip_smoke.LEFTOVER_GRID:
            res, _ = run_fields("jax", driver, fields, A, b)
            print(f"{name:40s} {int(res.iters):5d}  status "
                  f"{int(res.status)}  (recorded {anchor})", flush=True)
        return
    for cfg in chip_smoke.SMALL_GRID:
        res, _ = run("jax", cfg, A, b)
        print(f"{cfg[0]:24s} {int(res.iters):5d}  status {int(res.status)}"
              f"  (recorded {cfg[4]})")


if __name__ == "__main__":
    _main(sys.argv[1:])
