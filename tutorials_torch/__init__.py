"""The tutorials of ``tutorials/`` on the PyTorch port.

Each script makes the calls its JAX counterpart makes and prints the
same line.  Run them from the repository root:

    python -m tutorials_torch.poisson_pcg [DATA_DIR] [--device cpu]
    python -m tutorials_torch.fast_path [NX] [--device cpu]

They run on the CUDA device and raise where there is none, unless asked
for the CPU (``--device cpu``, or ``main(argv, device="cpu")``).  The
data directory defaults to ``FASP_REFDATA`` (else ``reference/data``),
as the port's regression runner reads it.
"""
from __future__ import annotations

from faspsolver_tpu_torch import default_device
from faspsolver_tpu_torch.regression.runner import REFDATA  # noqa: F401


def parse(argv, device=None):
    """``(positional arguments, device)``: ``--device D`` on the command
    line, else ``device``, else the CUDA device (an error where there is
    none)."""
    argv = list(argv)
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    return argv, device if device is not None else default_device()
