"""The port's benchmark harness against the JAX package's
(``benchmark/harness.py``, ``benchmark/__main__.py``) on the CPU: the
same problems bit for bit, the JAX iteration counts in float64, the f32
refined mode and its two fallbacks within max(2, 5%) of JAX's total inner
iterations, ``.mtx`` directories, the CLI's device rule, and no global
dtype changed by any call."""
import jax
import numpy as np
import pytest
import scipy.io
import torch
from native_parity import ensure_native

import faspsolver_tpu.benchmark.harness as jax_harness
from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
import faspsolver_tpu_torch
import faspsolver_tpu_torch.solvers as solvers
from faspsolver_tpu_torch.benchmark import harness
from faspsolver_tpu_torch.benchmark.__main__ import main
from faspsolver_tpu_torch.testgen import jump_2d, poisson_2d

torch.set_num_threads(2)
ensure_native()


def _allowance(n):
    return max(2, int(0.05 * n))


def _jax(A):
    return JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)


def _jax_f32(fn):
    """``fn()`` with the JAX package in its f32 mode (x64 off), as its
    ``--tpu`` CLI runs it; x64 back on afterwards."""
    jax.config.update("jax_enable_x64", False)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", True)


def _same_problems(got, ref):
    assert [g[0] for g in got] == [r[0] for r in ref]
    for (_, A, b), (_, Aj, bj) in zip(got, ref):
        for key in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(A, key), getattr(Aj, key))
            assert getattr(A, key).dtype == getattr(Aj, key).dtype
        assert np.array_equal(b, bj)


def test_generated_and_corpus_problems_equal_jax():
    _same_problems(harness.generated_problems((24, 31), (7,)),
                   jax_harness.generated_problems((24, 31), (7,)))
    _same_problems(harness.corpus_problems(24),
                   jax_harness.corpus_problems(24))


F64_ROWS = [("poisson2d-24", "cg"), ("poisson2d-24", "amg"),
            ("poisson2d-24", "ilu"), ("aniso-x-1e2", "amg"),
            ("convdiff-strong", "amg"), ("convdiff-strong", "ilu")]


def _row(name):
    if name == "poisson2d-24":
        A = poisson_2d(24)
        return A, A.matvec(np.ones(A.nrow))
    return {n: (A, b) for n, A, b in harness.corpus_problems(24)}[name]


@pytest.mark.parametrize("name,kind", F64_ROWS,
                         ids=[f"{n}-{k}" for n, k in F64_ROWS])
def test_score_problem_f64_gives_the_jax_count(name, kind):
    A, b = _row(name)
    got = harness.score_problem(name, A, b, harness._solver_factory(
        kind, device="cpu"), 1e-9)
    ref = jax_harness.score_problem(name, _jax(A), b,
                                    jax_harness._solver_factory(kind), 1e-9)
    assert got.converged and ref.converged
    assert (got.name, got.n, got.nnz, got.iters) == \
        (ref.name, ref.n, ref.nnz, ref.iters)
    assert got.score == got.solve_s / A.nrow / 1e-9 > 0


def _refined(A, b):
    res = harness._refined_factory("amg", torch.float32, "cpu")(A, b)
    ref = _jax_f32(lambda: jax_harness._solver_factory("amg")(
        _jax(A), b))
    return res, ref


def _verified(A, b, x):
    return np.linalg.norm(b - A.matvec(np.asarray(x))) / np.linalg.norm(b)


F32_ROWS = ["poisson2d-24", "aniso-x-1e2", "convdiff-strong", "stretched-1e3"]


@pytest.mark.parametrize("name", F32_ROWS)
def test_refined_f32_mode_within_the_allowance_of_jax(name):
    A, b = _row(name)
    res, ref = _refined(A, b)
    assert res.converged and ref.converged
    assert res.relres < 1e-8 and _verified(A, b, res.x) < 1e-8
    assert abs(res.iters - ref.iters) <= _allowance(ref.iters)


def _stalled_f32(module, result_cls, zeros):
    """``module.vgmres`` with its f32 calls replaced by a solve that
    stalls (no correction, 7 iterations); f64 calls run as they are."""
    real = module.vgmres

    def vgmres(A, b, *args, **kw):
        if str(b.dtype).endswith("float32"):
            return result_cls(x=zeros(b), iters=7, relres=1.0,
                              converged=False, status=-1)
        return real(A, b, *args, **kw)
    return vgmres


@pytest.mark.parametrize("name", ["jump-1e2", "jump-1e4"])
def test_refined_f32_ladder_on_the_jump_rows_counts_as_jax(name,
                                                          monkeypatch):
    """On the jump rows the f32 inner vGMRES ends at its f32 floor in both
    packages (maxit at relres ~1.5e-5 on jump-1e2, the stagnation exit on
    jump-1e4), where f32 rounding decides the exit iteration: at 24^2 the
    totals are 485 / 34 in the port against 410 / 28 in JAX, and both
    converge.  With the f32 inner solve stalling in both packages the
    ladder is deterministic: two stalled rounds, two stalled rounds of
    the diagonal-scaled rescue, then the f64 escalation, whose total is
    held to JAX's within the allowance."""
    import jax.numpy as jnp

    import faspsolver_tpu.krylov as jax_krylov
    import faspsolver_tpu_torch.krylov as krylov
    from faspsolver_tpu.krylov.result import SolveResult as JaxResult
    from faspsolver_tpu_torch.krylov.result import SolveResult
    A, b = _row(name)
    res, ref = _refined(A, b)
    assert res.converged and ref.converged
    assert res.relres < 1e-8 and _verified(A, b, res.x) < 1e-8

    monkeypatch.setattr(krylov, "vgmres", _stalled_f32(
        krylov, SolveResult, torch.zeros_like))
    monkeypatch.setattr(jax_krylov, "vgmres", _stalled_f32(
        jax_krylov, JaxResult, jnp.zeros_like))
    res, ref = _refined(A, b)
    assert res.converged and ref.converged
    assert res.relres < 1e-8 and _verified(A, b, res.x) < 1e-8
    assert res.iters > 4 * 7 and ref.iters > 4 * 7
    assert abs(res.iters - ref.iters) <= _allowance(ref.iters)


@pytest.mark.parametrize("contrast,n,banner", [
    (1e6, 32, "diagscaled-inner f32 retry converged"),
    (3e6, 24, "-> f64 escalation")], ids=["rescue", "escalation"])
def test_refined_fallbacks_are_reached_as_in_jax(contrast, n, banner,
                                                 capsys):
    """jump_2d at a large contrast exhausts the f32 inner solve: at 32^2
    and 1e6 the diagonal-scaled rescue converges, at 24^2 and 3e6 only
    the f64 escalation does, in both packages, each announced once."""
    A = jump_2d(n, contrast)
    b = A.matvec(np.ones(A.nrow))
    run = harness._refined_factory("amg", torch.float32, "cpu")
    res = run(A, b)
    said = capsys.readouterr().out
    ref = _jax_f32(lambda: jax_harness._solver_factory("amg")(_jax(A), b))
    said_jax = capsys.readouterr().out
    assert banner in said and banner in said_jax
    assert res.converged and ref.converged
    assert _verified(A, b, res.x) < 1e-6
    assert abs(res.iters - ref.iters) <= _allowance(ref.iters)
    run(A, b)                                      # announced once
    assert banner not in capsys.readouterr().out


def test_run_benchmark_on_an_mtx_directory_matches_jax(tmp_path, capsys):
    for name, A in (("poisson", poisson_2d(16)), ("jump", jump_2d(12, 1e2))):
        scipy.io.mmwrite(str(tmp_path / f"{name}.mtx"), A.to_scipy())
    got = harness.run_benchmark(str(tmp_path), device="cpu")
    ref = jax_harness.run_benchmark(str(tmp_path))
    assert [(r.name, r.n, r.iters, r.converged) for r in got] == \
        [(r.name, r.n, r.iters, r.converged) for r in ref] and len(got) == 2
    out = capsys.readouterr().out
    assert "platform=cpu devices=1 dtype=float64" in out
    assert "2/2 solved" in out
    assert harness.run_benchmark(str(tmp_path / "absent"), device="cpu") \
        == []
    assert "nothing scored" in capsys.readouterr().out


def test_main_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    scipy.io.mmwrite(str(tmp_path / "p.mtx"), poisson_2d(16).to_scipy())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--data", str(tmp_path)], ["--gen"], ["--corpus"]):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main(argv)
    assert main(["--data", str(tmp_path), "--device", "cpu"]) == 0
    assert main(["--data", str(tmp_path), "--device", "cpu", "--solver",
                 "cg", "--f32"]) == 0
    assert main(["--data", str(tmp_path / "absent"), "--device", "cpu"]) == 1
    assert main(["--data", str(tmp_path)], device="cpu") == 0


def test_no_call_changes_a_global_dtype():
    """The f32 stages and the f64 escalation get their dtype as an
    argument; the default dtypes of torch, the port and JAX stay put."""
    before = (torch.get_default_dtype(), faspsolver_tpu_torch.default_dtype(),
              jax.config.jax_enable_x64)
    A = jump_2d(24, 3e6)
    b = A.matvec(np.ones(A.nrow))
    dtypes = []
    real = solvers.solve_refined

    def spy(*args, **kw):
        dtypes.append((kw["dtype"], torch.get_default_dtype()))
        return real(*args, **kw)

    solvers.solve_refined = spy
    try:
        harness._refined_factory("amg", torch.float32, "cpu")(A, b)
    finally:
        solvers.solve_refined = real
    assert [d for d, _ in dtypes] == [torch.float32, torch.float32,
                                      torch.float64]
    assert {g for _, g in dtypes} == {before[0]}
    assert harness.compute_lmvu(24, 5, dtype=torch.float32, device="cpu") > 0
    assert (torch.get_default_dtype(), faspsolver_tpu_torch.default_dtype(),
            jax.config.jax_enable_x64) == before


def test_reference_anomalies_are_flagged_never_matched(capsys):
    """chip_smoke flags an anchor row the JAX f32 ladder rescued or
    escalated, or that took over 10 x its family's median, prints it
    with both counts, and holds it to no count; other rows stay held."""
    import chip_smoke
    table = {"jump-1e2": (7, ""), "jump-1e6": (457, "rescue"),
             "jump-1e8": (9, "escalate"), "aniso-x-1e1": (5, ""),
             "aniso-x-1e2": (404, ""), "aniso-y-1e1": (5, ""),
             "aniso-y-1e2": (6, "")}
    assert set(chip_smoke.reference_anomalies(table)) == \
        {"jump-1e6", "jump-1e8", "aniso-x-1e2"}
    chip_smoke.hold_to_anchor("aniso-x-1e2", 5, table)
    out = capsys.readouterr().out
    assert "reference anomaly: aniso-x-1e2: JAX 404 iterations" in out
    assert "port 5" in out
    chip_smoke.hold_to_anchor("aniso-x-1e1", 7, table)
    with pytest.raises(RuntimeError, match="within 2 of JAX 5"):
        chip_smoke.hold_to_anchor("aniso-x-1e1", 8, table)
    assert chip_smoke.reference_anomalies(chip_smoke.HARNESS_CORPUS_F64) \
        == {}
