"""The port's regression runner (``faspsolver_tpu_torch/regression``)
against the JAX package's, on the CPU in float64.

The reference data is not in the repository: the problems are
``chip_smoke.regression_problems`` (the reference's conformance sizes,
generated, b = A sol for a seeded sol), the list phase 12 of
``chip_smoke.py`` and ``tests/small_grid_anchors.py regression`` use.
One config per family runs through both runners; the other rows of the
100- and 3,969-dof problems run through the port alone, against the
JAX rows recorded in ``chip_smoke.REGRESSION_ANCHORS``.  A row is held
to its JAX row in count (PERF.md section 2's allowance), verdict,
``extra``, and maxdiff under 1e-4 exactly where JAX's is (the verdict).
"""
import io
import re
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import chip_smoke
import small_grid_anchors as sga
from faspsolver_tpu.regression import runner as jr
from faspsolver_tpu_torch.regression import runner as tr

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (set, problem keys, config): one config per family of core_configs,
# the BSR rows, bsr_configs, matfree_configs, and a slice of mm_configs
# that holds a rescue-ladder row ("BiCGstab": rescued, diagscaled)
PARITY = [
    ("core", ("fe",), "AMG V direct-interp GS"),
    ("core", ("fd",), "FAMG V direct GS"),
    ("core", ("fd",), "AMG W-cycle GS"),
    ("core", ("fe",), "CG + diag"),
    ("core", ("fe",), "GMRES + diag"),
    ("core", ("fe",), "CG + SA-AMG"),
    ("core", ("fe",), "CG (BSR)"),
    ("core", ("fe",), "GCR + AMG"),
    ("core", ("fe",), "CG + ILU(0)"),
    ("core", ("fe",), "CG stop3"),
    ("core", ("fd",), "SafeMinRes + diag"),
    ("bsr", ("bsr",), "vFGMRES + SA-AMG"),
    ("matfree", ("fe",), "matfree CG"),
    ("mm", ("plate",), "BiCGstab"),
    ("mm", ("plate",), "CG + ILUt"),
    ("mm", ("shell",), "MinRes + diag"),
]


def _configs(runner, kind, names, device=None):
    fn = getattr(runner, chip_smoke.REGRESSION_SETS[kind][0])
    cfgs = fn() if device is None else fn(device)
    return [c for c in cfgs if c[0] in names]


@pytest.mark.parametrize("kind,keys,name", PARITY,
                         ids=[f"{k}-{n}" for k, _, n in PARITY])
def test_port_runner_matches_jax_row(kind, keys, name):
    jrows = jr.run_matrix(_configs(jr, kind, {name}),
                          sga.jax_regression_problems(keys))
    trows = tr.run_matrix(_configs(tr, kind, {name}, "cpu"),
                          chip_smoke.regression_problems(keys))
    assert len(jrows) == len(trows) == 1
    j, t = jrows[0], trows[0]
    assert (t.problem, t.name) == (j.problem, j.name)
    assert t.ok == j.ok and t.extra == j.extra
    assert abs(t.iters - j.iters) <= chip_smoke.regression_allowance(
        name, j.iters), (t.iters, j.iters)
    # the recorded anchor is this JAX row
    assert chip_smoke.REGRESSION_ANCHORS[j.problem][j.name] == (
        j.iters, j.ok, j.extra)


@pytest.mark.parametrize("keys", [("fd",), ("fe",)])
def test_other_core_rows_hold_their_jax_anchors(keys):
    """Every core row on the 100- and 3,969-dof problems, through the
    port alone, against the JAX runner's recorded row."""
    probs = chip_smoke.regression_problems(keys)
    cfgs = tr.core_configs("cpu")
    res = tr.run_matrix(cfgs, probs)
    assert chip_smoke.regression_misses(res, cfgs, probs) == []
    assert len(res) == 50


def test_core_configs_are_the_jax_configs():
    """The same 50 configs in the same order, with the same filters."""
    assert [c[0] for c in tr.core_configs("cpu")] == [
        c[0] for c in jr.core_configs()]
    assert len(tr.core_configs("cpu")) == 50
    for fn in ("mm_configs", "bsr_configs", "matfree_configs"):
        tc, jc = getattr(tr, fn)("cpu"), getattr(jr, fn)()
        assert [c[0] for c in tc] == [c[0] for c in jc]
        for t, j in zip(tc, jc):
            assert len(t) == len(j)
            if len(t) > 2:
                for p in ("nos7", "SPE01-bsr3", "blockpoisson-bsr3",
                          "watt__1", "lns__131", "gen-fe-poisson-3969"):
                    assert t[2](p) == j[2](p), (t[0], p)


def test_generated_names_trip_no_filter():
    """No generated problem name matches a config filter by accident:
    every filtered row runs exactly where the JAX runner's does on the
    reference's names."""
    names = [p[0] for p in chip_smoke.regression_problems(
        ("fd", "fe", "plate", "shell", "bsr"))]
    assert names[:2] == ["gen-fd-poisson-100", "gen-fe-poisson-3969"]
    for fn in ("core_configs", "mm_configs", "bsr_configs"):
        for c in getattr(tr, fn)("cpu"):
            if len(c) > 2:
                taken = {n for n in names if c[2](n)}
                if fn == "bsr_configs":
                    assert taken == ({"blockpoisson-bsr3"} if "SA" in c[0]
                                     else set()), c[0]
                elif fn == "mm_configs":
                    assert taken == set(), c[0]
                else:
                    assert taken == set(names), c[0]


def _write_refdata(d, writers):
    """The reference data directory's files, from small generated
    matrices, written with the given package's io.writers."""
    from faspsolver_tpu_torch.testgen import (block_poisson_3d, poisson_2d,
                                              poisson_3d)
    rng = np.random.default_rng(3)
    for tag, A in (("FD", poisson_2d(6)), ("FE", poisson_2d(7))):
        writers.write_csr(f"{d}/csrmat_{tag}.dat", A)
        writers.write_vec(f"{d}/rhs_{tag}.dat", rng.standard_normal(A.nrow))
        writers.write_vecind(f"{d}/sol_{tag}.dat",
                             rng.standard_normal(A.nrow))
    for i, name in enumerate(["e05r0500", "orsreg_1", "steam2", "jpwh_991",
                              "gre__115", "add32", "sherman1", "watt__1",
                              "lns__131", "nos7"]):
        writers.write_mtx(f"{d}/{name}.mtx", poisson_3d(3 + i % 3))
    writers.write_bsr(f"{d}/bsrmat_SPE01.dat", block_poisson_3d(3, nb=3))


def _same_problems(tp, jp):
    assert [p[0] for p in tp] == [p[0] for p in jp]
    for (_, A, b, sol), (_, Aj, bj, solj) in zip(tp, jp):
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(np.asarray(getattr(A, f)),
                                          np.asarray(getattr(Aj, f)))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(bj))
        np.testing.assert_array_equal(np.asarray(sol), np.asarray(solj))


def test_loaders_read_what_the_jax_loaders_read(tmp_path):
    from faspsolver_tpu_torch.io import writers
    d = str(tmp_path)
    _write_refdata(d, writers)
    _same_problems(tr._problems(d), jr._problems(d))
    _same_problems(tr.mm_problems(d), jr.mm_problems(d))
    _same_problems(tr.bsr_problems(d), jr.bsr_problems(d))


@pytest.mark.parametrize("loader", ["_problems", "mm_problems",
                                    "bsr_problems"])
def test_a_missing_file_raises(tmp_path, loader):
    with pytest.raises(FileNotFoundError):
        getattr(jr, loader)(str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path))):
        getattr(tr, loader)(str(tmp_path))


def test_print_tally_prints_the_jax_lines():
    rows = [("FD-Poisson-100", "CG + diag", 41, 2.88e-14, 7.9e-14, True,
             ""),
            ("blockpoisson-bsr3", "vFGMRES + UA-AMG", 25, 9.1e-15, 2e-13,
             True, "nlvl=4"),
            ("bcsstk16-syn", "CG", 100, 1.2e-3, 0.7, False, ""),
            ("nos7", "GMRES (BSR)", -1, float("inf"), float("inf"), False,
             "")]
    out = []
    for mod in (tr, jr):
        buf = io.StringIO()
        with redirect_stdout(buf):
            counts = mod.print_tally([mod.RegResult(*r) for r in rows])
        out.append((buf.getvalue(), counts))
    assert out[0] == out[1]
    assert out[0][1] == (2, 2)


def test_config_functions_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in ("core_configs", "mm_configs", "bsr_configs",
               "matfree_configs"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            getattr(tr, fn)()


def test_run_matrix_tallies_an_exception_as_attention():
    def boom(A, b):
        raise ValueError("no convergence")
    probs = chip_smoke.regression_problems(("fd",))
    res = tr.run_matrix([("boom", boom)], probs)
    assert len(res) == 1 and not res[0].ok and res[0].iters == -1


def _cli(args, extra_env):
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1", **extra_env)
    return subprocess.run([sys.executable, "-m",
                           "faspsolver_tpu_torch.regression", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_runs_on_the_card_and_without_one_raises(tmp_path):
    """The CLI takes no device argument and then runs on the CUDA
    device in float64; on a machine without one it fails with the error
    that names the CPU, printing no tally.  ``--device cpu`` runs the
    fast grid here, exit code 0 when every row passes (the JAX CLI's
    flags and exit code; it forces the CPU instead)."""
    from faspsolver_tpu_torch.io import writers
    from faspsolver_tpu_torch.testgen import poisson_2d
    d = str(tmp_path)
    A = poisson_2d(10)
    sol = np.random.default_rng(0).standard_normal(A.nrow)
    writers.write_csr(f"{d}/csrmat_FD.dat", A)
    writers.write_vec(f"{d}/rhs_FD.dat", A.matvec(sol))
    writers.write_vecind(f"{d}/sol_FD.dat", sol)
    writers.write_csr(f"{d}/csrmat_FE.dat", A)
    writers.write_vec(f"{d}/rhs_FE.dat", A.matvec(sol))
    writers.write_vecind(f"{d}/sol_FE.dat", sol)
    writers.write_mtx(f"{d}/nos7.mtx", A)
    out = _cli(["--fast"], {"FASP_REFDATA": d, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert 'device="cpu"' in out.stderr
    assert "Number of PASSED" not in out.stdout
    out = _cli(["--fast", "--device", "cpu"], {"FASP_REFDATA": d})
    assert out.returncode == 0, out.stderr
    assert "Number of PASSED tests    : 12" in out.stdout


def test_public_names_equal_jax():
    import faspsolver_tpu.regression as jp
    import faspsolver_tpu_torch.regression as tp
    assert tp.__all__ == jp.__all__
    names = {n for n, v in vars(jr).items() if not n.startswith("__")
             and (getattr(v, "__module__", None) == jr.__name__
                  or n in ("TOLERANCE", "REFDATA"))}
    assert names <= set(vars(tr)), names - set(vars(tr))
