"""The PyTorch port imports torch and never jax: checked in a fresh
interpreter (this test process has jax loaded by conftest)."""
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "faspsolver_tpu_torch",
    "faspsolver_tpu_torch.__main__",
    "faspsolver_tpu_torch.benchmark",
    "faspsolver_tpu_torch.benchmark.__main__",
    "faspsolver_tpu_torch.benchmark.harness",
    "faspsolver_tpu_torch.capi",
    "faspsolver_tpu_torch.constants",
    "faspsolver_tpu_torch.convert",
    "faspsolver_tpu_torch.formats",
    "faspsolver_tpu_torch.formats.blc",
    "faspsolver_tpu_torch.formats.bsr",
    "faspsolver_tpu_torch.formats.csrl",
    "faspsolver_tpu_torch.formats.str_grid",
    "faspsolver_tpu_torch.io",
    "faspsolver_tpu_torch.io.readers",
    "faspsolver_tpu_torch.io.writers",
    "faspsolver_tpu_torch.krylov",
    "faspsolver_tpu_torch.krylov.bicgstab",
    "faspsolver_tpu_torch.krylov.common",
    "faspsolver_tpu_torch.krylov.gcg_gcr",
    "faspsolver_tpu_torch.krylov.gmres",
    "faspsolver_tpu_torch.krylov.minres",
    "faspsolver_tpu_torch.krylov.pcg",
    "faspsolver_tpu_torch.krylov.precond",
    "faspsolver_tpu_torch.native",
    "faspsolver_tpu_torch.ops",
    "faspsolver_tpu_torch.ops.blas1",
    "faspsolver_tpu_torch.ops.eigen",
    "faspsolver_tpu_torch.ops.operators",
    "faspsolver_tpu_torch.ops.stencil2d",
    "faspsolver_tpu_torch.ops.str_ops",
    "faspsolver_tpu_torch.parallel",
    "faspsolver_tpu_torch.parallel.comm",
    "faspsolver_tpu_torch.parallel.dist_dia",
    "faspsolver_tpu_torch.parallel.dryrun",
    "faspsolver_tpu_torch.parallel.halo",
    "faspsolver_tpu_torch.parallel.pcsr",
    "faspsolver_tpu_torch.precond",
    "faspsolver_tpu_torch.precond.amg",
    "faspsolver_tpu_torch.precond.amg.aggregation",
    "faspsolver_tpu_torch.precond.amg.band_algebra",
    "faspsolver_tpu_torch.precond.amg.bsr_smoothers",
    "faspsolver_tpu_torch.precond.amg.coarsen_rs",
    "faspsolver_tpu_torch.precond.amg.cycles",
    "faspsolver_tpu_torch.precond.amg.hierarchy",
    "faspsolver_tpu_torch.precond.amg.interp",
    "faspsolver_tpu_torch.precond.amg.setup_bsr",
    "faspsolver_tpu_torch.precond.amg.setup_rs",
    "faspsolver_tpu_torch.precond.amg.setup_sa",
    "faspsolver_tpu_torch.precond.amg.setup_ua",
    "faspsolver_tpu_torch.precond.amg.smoothers",
    "faspsolver_tpu_torch.precond.amg.solve",
    "faspsolver_tpu_torch.precond.amg.structured",
    "faspsolver_tpu_torch.precond.amg.transfer",
    "faspsolver_tpu_torch.precond.blc_precond",
    "faspsolver_tpu_torch.precond.gmg",
    "faspsolver_tpu_torch.precond.ilu",
    "faspsolver_tpu_torch.precond.preconditioners",
    "faspsolver_tpu_torch.precond.schwarz",
    "faspsolver_tpu_torch.precond.str_precond",
    "faspsolver_tpu_torch.regression",
    "faspsolver_tpu_torch.regression.__main__",
    "faspsolver_tpu_torch.regression.runner",
    "faspsolver_tpu_torch.solvers",
    "faspsolver_tpu_torch.solvers.drivers",
    "faspsolver_tpu_torch.solvers.refine",
    "faspsolver_tpu_torch.testgen",
    "faspsolver_tpu_torch.testgen.fdm",
    "faspsolver_tpu_torch.testgen.fem",
    "faspsolver_tpu_torch.testgen.structural",
    "faspsolver_tpu_torch.utils",
    "faspsolver_tpu_torch.utils.build",
    "faspsolver_tpu_torch.utils.checkpoint",
    "faspsolver_tpu_torch.utils.graphics",
    "faspsolver_tpu_torch.utils.graphs",
    "faspsolver_tpu_torch.utils.messages",
    "faspsolver_tpu_torch.utils.params",
    "faspsolver_tpu_torch.utils.profiling",
]


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_port_imports_without_jax():
    """Every slice module imports; neither jax nor the JAX package is
    loaded along the way."""
    _run("import importlib, sys\n"
         f"for m in {MODULES!r}: importlib.import_module(m)\n"
         "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
         " or m == 'faspsolver_tpu' or m.startswith('faspsolver_tpu.')]\n"
         "assert not bad, bad\n")


def test_spawned_test_ranks_import_no_jax():
    """The module whose functions tests/test_torch_parallel.py spawns as
    ranks (a spawned rank re-imports it) loads neither jax nor the JAX
    package, nor does the rank body's import of the port."""
    _run("import sys\n"
         "sys.path.insert(0, 'tests')\n"
         "import torch_dist_worker\n"
         "import faspsolver_tpu_torch.parallel.dryrun\n"
         "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
         " or m == 'faspsolver_tpu' or m.startswith('faspsolver_tpu.')]\n"
         "assert not bad, bad\n")


def test_package_import_alone_gives_the_top_level_names():
    """``import faspsolver_tpu_torch as fasp`` alone (the helpers come
    before the sub-packages that import them) loads no jax, builds no
    library, and ``fasp.device_operator(A)`` works."""
    out = _run("import sys, numpy as np\n"
               "import faspsolver_tpu_torch as fasp\n"
               "from faspsolver_tpu_torch import native\n"
               "from faspsolver_tpu_torch.ops import stencil2d\n"
               "assert 'jax' not in sys.modules\n"
               "assert native._lib is None and not native._tried\n"
               "assert stencil2d._lib is None\n"
               "A = fasp.CSRMatrix.eye(4)\n"
               "op = fasp.device_operator(A)\n"
               "print(type(op).__name__, op(fasp.as_tensor(np.ones(4))).sum()"
               ".item())\n")
    assert out.split() == ["DenseOperator", "4.0"]


def test_cli_runs_without_jax():
    """``python -m faspsolver_tpu_torch`` on ini/input.dat solves on the
    CPU when asked to (``-device cpu``) and loads no jax."""
    out = _run("import runpy, sys\n"
               "sys.argv = ['x', '-ini', 'ini/input.dat', '-problem', "
               "'poisson2d', '-size', '15', '-device', 'cpu']\n"
               "try:\n"
               "    runpy.run_module('faspsolver_tpu_torch', "
               "run_name='__main__')\n"
               "except SystemExit as e:\n"
               "    assert e.code == 0, e.code\n"
               "assert 'jax' not in sys.modules\n")
    assert "Number of iterations = " in out


def test_cli_without_a_device_argument_does_not_fall_back_to_the_cpu():
    """In a fresh interpreter on a machine without a CUDA device the CLI
    with no -device exits non-zero with the error that names -device cpu,
    and prints no result."""
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "faspsolver_tpu_torch", "-ini",
         "ini/input.dat", "-problem", "poisson2d", "-size", "15"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "-device cpu" in out.stderr
    assert "Number of iterations" not in out.stdout


def test_kernel_module_needs_no_nvcc_or_gpu():
    """Importing the kernel module and applying a stencil to a CPU tensor
    neither finds nvcc (PATH has none here) nor builds or loads the CUDA
    library; the plain version runs and no launch is counted."""
    out = _run(
        "import shutil, torch\n"
        "from faspsolver_tpu_torch.ops import stencil2d\n"
        "from faspsolver_tpu_torch.ops.operators import StencilNdOperator\n"
        "op = StencilNdOperator([torch.ones(1, 1)], ((0, 1),), (3, 4))\n"
        "y = op(torch.arange(12.0))\n"
        "assert stencil2d._lib is None\n"
        "assert all(v == 0 for v in stencil2d.launches.values())\n"
        "print(shutil.which('nvcc'), torch.cuda.is_available(), "
        "y.tolist())\n")
    nvcc, _cuda, y = out.split(" ", 2)
    assert nvcc == "None"
    assert eval(y) == [1.0, 2.0, 3.0, 0.0, 5.0, 6.0, 7.0, 0.0,
                       9.0, 10.0, 11.0, 0.0]


@pytest.mark.parametrize("module", ["faspsolver_tpu_torch.constants",
                                    "faspsolver_tpu_torch.utils.params",
                                    "faspsolver_tpu_torch.utils.messages",
                                    "faspsolver_tpu_torch.formats.csr",
                                    "faspsolver_tpu_torch.formats.bsr",
                                    "faspsolver_tpu_torch.formats.str_grid",
                                    "faspsolver_tpu_torch.formats.blc",
                                    "faspsolver_tpu_torch.formats.csrl",
                                    "faspsolver_tpu_torch.io.readers",
                                    "faspsolver_tpu_torch.io.writers",
                                    "faspsolver_tpu_torch.testgen.fdm",
                                    "faspsolver_tpu_torch.testgen.fem",
                                    "faspsolver_tpu_torch.testgen.structural",
                                    "faspsolver_tpu_torch.utils.graphics",
                                    "faspsolver_tpu_torch.precond.amg"
                                    ".aggregation",
                                    "faspsolver_tpu_torch.precond.amg"
                                    ".coarsen_rs",
                                    "faspsolver_tpu_torch.precond.amg"
                                    ".interp"])
def test_copied_host_modules_match_reference(module):
    """The copied host modules keep the JAX package's public names."""
    import importlib
    ref = importlib.import_module(module.replace("faspsolver_tpu_torch",
                                                 "faspsolver_tpu"))
    port = importlib.import_module(module)
    names = {n for n in vars(ref) if not n.startswith("_")
             and getattr(getattr(ref, n), "__module__", ref.__name__)
             == ref.__name__}
    missing = names - set(vars(port))
    assert not missing, missing
