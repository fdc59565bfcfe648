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
    "faspsolver_tpu_torch.constants",
    "faspsolver_tpu_torch.convert",
    "faspsolver_tpu_torch.formats",
    "faspsolver_tpu_torch.krylov",
    "faspsolver_tpu_torch.krylov.common",
    "faspsolver_tpu_torch.krylov.pcg",
    "faspsolver_tpu_torch.native",
    "faspsolver_tpu_torch.ops",
    "faspsolver_tpu_torch.ops.blas1",
    "faspsolver_tpu_torch.ops.operators",
    "faspsolver_tpu_torch.ops.stencil2d",
    "faspsolver_tpu_torch.precond",
    "faspsolver_tpu_torch.precond.amg",
    "faspsolver_tpu_torch.precond.amg.band_algebra",
    "faspsolver_tpu_torch.precond.amg.coarsen_rs",
    "faspsolver_tpu_torch.precond.amg.cycles",
    "faspsolver_tpu_torch.precond.amg.hierarchy",
    "faspsolver_tpu_torch.precond.amg.interp",
    "faspsolver_tpu_torch.precond.amg.setup_rs",
    "faspsolver_tpu_torch.precond.amg.smoothers",
    "faspsolver_tpu_torch.precond.amg.structured",
    "faspsolver_tpu_torch.precond.amg.transfer",
    "faspsolver_tpu_torch.solvers",
    "faspsolver_tpu_torch.solvers.refine",
    "faspsolver_tpu_torch.testgen",
    "faspsolver_tpu_torch.testgen.fem",
    "faspsolver_tpu_torch.utils",
    "faspsolver_tpu_torch.utils.build",
    "faspsolver_tpu_torch.utils.params",
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


# public names of a copied module that the port leaves out, and why
NOT_COPIED = {
    "faspsolver_tpu_torch.testgen.fdm": {"block_poisson_3d"},     # BSR
    # waits in ROADMAP item 7
    "faspsolver_tpu_torch.precond.amg.interp": {"interp_energymin"},
    # FE extras outside the slice: refinement, errors, mass / heat
    "faspsolver_tpu_torch.testgen.fem": {
        "refine_uniform", "l2_error", "poisson_fe_manufactured",
        "assemble_mass", "heat_backward_euler_system"},
}


@pytest.mark.parametrize("module", ["faspsolver_tpu_torch.constants",
                                    "faspsolver_tpu_torch.utils.params",
                                    "faspsolver_tpu_torch.formats.csr",
                                    "faspsolver_tpu_torch.testgen.fdm",
                                    "faspsolver_tpu_torch.testgen.fem",
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
    missing = names - set(vars(port)) - NOT_COPIED.get(module, set())
    assert not missing, missing
