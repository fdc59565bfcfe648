"""Both packages' native setup libraries, loaded without a build race.

The JAX package's loader (``faspsolver_tpu/native/__init__.py``) compiles
``_fasp_native.so`` with no lock: pytest-xdist workers that lose the race
to ``os.replace`` the same ``.tmp`` file mark the library unavailable for
the rest of their life.  The port's loader builds the same two sources
with the same g++ argv under an exclusive ``flock``.  :func:`ensure_native`
builds that one and points the JAX loader at it, so the JAX side loads an
already finished library and never runs g++ itself.

Not collected by pytest (no ``test_`` prefix); the port's parity files
call :func:`ensure_native` at import, so every worker that collects them
(every worker collects every file) has both libraries before any test
runs.
"""
from __future__ import annotations

import ast
import fcntl
import hashlib
import inspect
import os

import faspsolver_tpu.native as jax_native
from faspsolver_tpu_torch import native
from faspsolver_tpu_torch.utils.build import BUILD_DIR, BUILD_LOG


def _jax_gxx_flags():
    """The constant words of the g++ argv in the JAX loader's ``_build``."""
    tree = ast.parse(inspect.getsource(jax_native._build).lstrip())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.List)
                and any(isinstance(t, ast.Name) and t.id == "cmd"
                        for t in node.targets)):
            return [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)]
    raise RuntimeError("no g++ argv found in faspsolver_tpu.native._build")


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _check_same_build():
    """The port compiles sources byte-equal to the JAX loader's, in the
    same order, with its argv."""
    srcs = list(native._SOURCES)
    jax_srcs = [jax_native._SRC, jax_native._SRC2]
    if [_sha256(s) for s in srcs] != [_sha256(s) for s in jax_srcs]:
        raise RuntimeError(f"the port builds other sources: {srcs} "
                           f"differ from {jax_srcs}")
    port = [w for w in native._gxx(["SRC"] * len(srcs), "OUT")
            if w not in ("SRC", "OUT")]
    if port != _jax_gxx_flags():
        raise RuntimeError(f"g++ argv differ: port {port}, "
                           f"JAX {_jax_gxx_flags()}")


def ensure_native() -> None:
    """Both native libraries loaded, or RuntimeError with the build log."""
    if not native.available():
        raise RuntimeError("the port's native library does not build:\n"
                           f"{native.build_error}")
    if jax_native._lib is not None:
        return
    _check_same_build()
    lib = BUILD_LOG["fasp_native"][0]
    with open(os.path.join(BUILD_DIR, "jax_native.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            # the JAX loader reuses a library no older than its sources;
            # this one is keyed on their content, so it is theirs
            src_mtime = max(os.path.getmtime(jax_native._SRC),
                            os.path.getmtime(jax_native._SRC2))
            if os.path.getmtime(lib) < src_mtime:
                os.utime(lib)
            jax_native._SO = lib
            jax_native._tried = False
            ok = jax_native.available()
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    if not ok:
        raise RuntimeError(f"the JAX loader cannot load {lib}")
