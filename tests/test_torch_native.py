"""The port's native setup library is built from its own copies of the
C++ sources, byte-equal to the JAX package's, and no port module names a
path into the JAX package."""
import os
import re
import subprocess
import sys

import pytest
from native_parity import _check_same_build

import faspsolver_tpu.native as jax_native
from faspsolver_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "faspsolver_tpu_torch")


def test_sources_are_the_ports_own_copies_byte_equal_to_jax():
    csrc = os.path.join(PORT, "csrc")
    assert [os.path.dirname(s) for s in native._SOURCES] == [csrc, csrc]
    assert [os.path.basename(s) for s in native._SOURCES] == \
        [os.path.basename(jax_native._SRC), os.path.basename(jax_native._SRC2)]
    for port, ref in zip(native._SOURCES, (jax_native._SRC, jax_native._SRC2)):
        with open(port, "rb") as f, open(ref, "rb") as g:
            assert f.read() == g.read(), port


def test_parity_build_check_refuses_other_bytes_or_order(monkeypatch,
                                                         tmp_path):
    """``native_parity`` accepts the copies and refuses a source whose
    bytes differ, or the same two sources in the other order."""
    _check_same_build()
    edited = tmp_path / "fasp_native.cpp"
    edited.write_bytes(open(native._SOURCES[0], "rb").read() + b"\n")
    for srcs in ((str(edited), native._SOURCES[1]), native._SOURCES[::-1]):
        monkeypatch.setattr(native, "_SOURCES", srcs)
        with pytest.raises(RuntimeError, match="other sources"):
            _check_same_build()


def test_parity_build_check_refuses_other_gxx_argv(monkeypatch):
    monkeypatch.setattr(native, "_gxx", lambda srcs, out: [
        "g++", "-O2", *srcs, "-o", out])
    with pytest.raises(RuntimeError, match="g\\+\\+ argv differ"):
        _check_same_build()


def _port_py_files():
    for d, _, files in os.walk(PORT):
        if "_build" in d or "__pycache__" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_port_module_names_a_path_into_the_jax_package():
    """The quoted literal "faspsolver_tpu" (as in os.path.join(..,
    "faspsolver_tpu", ...)) appears in no .py file of the port;
    docstrings citing faspsolver_tpu/...:line stay allowed."""
    pat = re.compile(r"""["']faspsolver_tpu["']""")
    hits = [f for f in _port_py_files() if pat.search(open(f).read())]
    assert not hits, hits


def test_loading_the_native_library_loads_nothing_of_the_jax_package():
    code = ("import sys\n"
            "from faspsolver_tpu_torch import native\n"
            "native.available()\n"
            "bad = [m for m in sys.modules if m == 'faspsolver_tpu'"
            " or m.startswith('faspsolver_tpu.') or m == 'jax']\n"
            "assert not bad, bad\n"
            "print(native.available())\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"]
