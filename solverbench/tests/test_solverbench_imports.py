"""What a run loads: a tiny cell's harness and reference in a fresh
process load no module whose top-level name is jax, jaxlib, flax or
faspsolver_tpu (the port's name begins with the JAX package's, so names
are compared whole), and the reference alone loads nothing of the
port."""
import json
import subprocess
import sys
import textwrap

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "faspsolver_tpu"}


def _fresh(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    tops = _fresh(f"""
        import json, sys, time
        sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {ROOT!r} + "/solverbench/tests")
        from conftest import tiny_cell
        from solverbench import harness
        out = harness.run_cell(tiny_cell("poisson2d-1023-sa.host-rhs"), 5, 0.2,
                               False, "cpu", time.perf_counter(),
                               cache={str(tmp_path)!r})
        assert out["correct"], out
        assert harness.forbidden_modules() == []
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert "faspsolver_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    tops = _fresh(f"""
        import json, sys
        sys.path.insert(0, {ROOT!r})
        import torch
        from solverbench import check, reference, rhs, stats, roofline, tracing
        from solverbench.problems import poisson_2d, fe_p1_square
        p = fe_p1_square.build(16)
        A = reference.Ell(p, "cpu")
        b = rhs.pool(p, {{"rhs": {{"pool": 2, "perturb": 1e-3}}}}, 3, "cpu")[0]
        x = reference.cg(A, torch.as_tensor(b), 1e-10, 500)
        assert reference.relres(A, x, torch.as_tensor(b)) < 1e-9
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert "faspsolver_tpu_torch" not in tops
    assert not tops & FORBIDDEN


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    from solverbench import harness
    monkeypatch.setitem(sys.modules, "faspsolver_tpu_torchlike", sys)
    assert "faspsolver_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
