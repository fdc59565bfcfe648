"""The port's tutorials (tutorials_torch/) against the JAX package's
(tutorials/) on the CPU in float64: both run on the same files, written
by the port's writers (chip_smoke.write_tutorial_data: the 3,969-dof FE
pair and block_poisson_3d(8, nb=3) as the SPE01 pair), and print the
same rows.  Iteration counts are equal, relres agrees to 1e-6 relative
(GMG's error against the exact solution too); fast_path (f32 inner
solves) at NX = 63 has equal rounds and inner iterations, relres under
its tol."""
import contextlib
import io
import os
import runpy
import subprocess
import sys

import pytest
import torch
from native_parity import ensure_native

import chip_smoke

torch.set_num_threads(2)
ensure_native()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_NX = 63


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tutorial_data")
    chip_smoke.write_tutorial_data(str(d), small=True)
    return str(d)


def _jax_lines(script, arg, monkeypatch):
    monkeypatch.setattr(sys, "argv", [script, arg])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "tutorials", f"{script}.py"),
                       run_name="__main__")
    return buf.getvalue()


def _port_lines(mod, argv, **kw):
    import importlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(f"tutorials_torch.{mod}").main(argv, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mod,script", chip_smoke.TUTORIALS,
                         ids=[m for m, _ in chip_smoke.TUTORIALS])
def test_tutorial_prints_the_jax_rows(mod, script, datadir, monkeypatch):
    arg = str(FAST_NX) if mod == "fast_path" else datadir
    ref = chip_smoke.tutorial_lines(_jax_lines(script, arg, monkeypatch))
    got = chip_smoke.tutorial_lines(_port_lines(mod, [arg], device="cpu"))
    assert ref and got.keys() == ref.keys()
    for label, row in got.items():
        want = ref[label]
        assert row["iters"] == want["iters"], label
        assert row.get("rounds") == want.get("rounds"), label
        if mod == "fast_path":
            assert row["relres"] < chip_smoke.TUTORIAL_ROWS[label][0]
            continue
        assert abs(row["relres"] - want["relres"]) <= 1e-6 * want["relres"]
        if "err" in want:
            assert abs(row["err"] - want["err"]) <= 1e-6 * want["err"]


def test_command_line_device_flag_and_no_card(datadir, monkeypatch):
    """``--device cpu`` on the command line runs on the CPU; with neither
    the flag nor ``device=`` and no card, the tutorial raises before it
    prints a result."""
    from tutorials_torch import poisson_pcg
    out = _port_lines("poisson_pcg", [datadir, "--device", "cpu"])
    assert "AMG-PCG: 8 iterations" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="device"):
        poisson_pcg.main([datadir])
    assert buf.getvalue() == ""


def test_tutorials_import_no_jax():
    """In a fresh interpreter the six tutorials and chip_smoke.py import,
    and one tutorial runs, without loading jax or the JAX package."""
    mods = [f"tutorials_torch.{m}" for m, _ in chip_smoke.TUTORIALS]
    mods.append("chip_smoke")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "sys.modules['tutorials_torch.fast_path'].main("
            "['63', '--device', 'cpu'])\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'faspsolver_tpu' or m.startswith('faspsolver_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "refined solve: rounds=" in out.stdout
