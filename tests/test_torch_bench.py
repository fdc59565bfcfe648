"""bench_torch.py, the port of bench.py, on the CPU at a small size:
``main(device="cpu", nx=63, nh=128, reps=2, tries=1)`` runs every stanza
(the SPE01 stanza on a block_poisson_3d(8, nb=3) pair written by the
port's writers, through FASP_REFDATA).

The headline (poisson_2d(63)), general and fe_auto (unit_square_mesh(64))
stanzas are held to the JAX package's same calls on the CPU with
jax_enable_x64 (f32 hierarchy, f64 refinement): equal rounds and inner
iterations, and x within 1e-6 relative (2-norm) of the JAX x.  The
JSON line's keys are bench.py's, listed here, with the port's renames
and additions."""
import contextlib
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from faspsolver_tpu.constants import SmootherType
from native_parity import ensure_native

import bench
import bench_torch
import chip_smoke

torch.set_num_threads(2)
ensure_native()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX = 63
X_RTOL = 1e-6

# every key bench.py's JSON line prints (fe_auto_warn only below its
# pin), under its own name
BENCH_KEYS = {
    "setup_s", "setup_warm_s", "solve_s", "refine_rounds", "inner_iters",
    "relres", "relres_verified_f64", "converged", "spmv_us", "stream_us",
    "chain_fixed_overhead_us", "spmv_gbs", "stream_onchip_gbs",
    "spmv_vs_stream", "stream_hbm_gbs", "spmv_hbm_gbs", "spmv_vs_hbm_sol",
    "hbm_probe_dof", "spmv_nnz_per_s", "n", "nnz", "platform", "dtype",
    "gen_s",
    "general_setup_s", "general_solve_s", "general_total_s",
    "general_vs_baseline", "general_rounds", "general_inner_iters",
    "general_relres_verified", "general_converged", "general_nnz",
    "general_packed_mb", "general_gen_s", "general_host_cores",
    "general_pack_s", "general_coarsen_s", "general_interp_s",
    "general_rap_s", "general_transfer_s", "general_smoother_s",
    "general_format_s", "general_upload_s",
    "fe_auto_setup_s", "fe_auto_solve_s", "fe_auto_total_s",
    "fe_auto_vs_baseline", "fe_auto_inner_iters",
    "fe_auto_relres_verified", "fe_auto_converged", "fe_auto_warn",
    "spe01_total_s", "spe01_inner_iters", "spe01_relres",
    "spe01_converged",
}
# the port's counterparts: the hierarchy's device bytes for the packed
# buffers' (packing is not ported, nor its setup phase); fe_auto_warn
# only from a full-size run on the card below its pin, never here
RENAMED = {"general_packed_mb": "general_device_mb"}
DROPPED = {"general_pack_s", "fe_auto_warn"}
COUNTERS = {"cold_solve_s", "host_syncs", "graph_captures", "graph_replays",
            "graph_nodes_replayed", "stencil_launches",
            "loop_control_launches"}
ADDED = ({"device_name", "power_limit_w", "chain_launches_per_rep",
          "spe01_inner_solves", "spe01_host_syncs", "spe01_graph_replays"}
         | COUNTERS | {f"{p}{k}" for p in ("general_", "fe_auto_")
                       for k in COUNTERS})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JSON object main returned, the lines it printed)."""
    data = str(tmp_path_factory.mktemp("spe01"))
    chip_smoke.write_spe01_data(data, 8)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(buf):
        mp.setenv("FASP_REFDATA", data)
        out = bench_torch.main(device="cpu", nx=NX, nh=128, reps=2, tries=1)
    return out, buf.getvalue().splitlines()


# bench.py's calls, written out here (not read from bench_torch)
HEADLINE_AMG = dict(smoother=int(SmootherType.CHEBYSHEV), polynomial_degree=2,
                    coarse_dof=800, tentative_smooth=0.67)
GENERAL_AMG = dict(smoother=int(SmootherType.CHEBYSHEV), polynomial_degree=3,
                   presmooth_iter=2, postsmooth_iter=2, coarse_dof=800,
                   aggressive_level=1)
HEADLINE_REFINE = dict(tol=1e-6, max_rounds=4, maxit_inner=40)
GENERAL_REFINE = dict(tol=1e-6, inner_tol=1e-4, inner_floor=1e-4,
                      max_rounds=6, maxit_inner=40)


def _jax_solve(stanza):
    """The JAX package's calls of the stanza: (A, b, RefinedResult)."""
    from faspsolver_tpu.precond.amg import setup_structured
    from faspsolver_tpu.precond.amg.setup_rs import setup_rs
    from faspsolver_tpu.solvers import solve_refined_resident
    from faspsolver_tpu.testgen import (assemble_poisson, poisson_2d,
                                        unit_square_mesh)
    from faspsolver_tpu.utils.params import AMGParam
    if stanza == "headline":
        A = poisson_2d(NX)
        b = A.matvec(np.ones(A.nrow))
    else:
        A, b, _ = assemble_poisson(unit_square_mesh(NX + 1),
                                   lambda p: np.ones(len(p)))
    if stanza == "general":
        hier = setup_rs(A, AMGParam(**GENERAL_AMG), dtype=jnp.float32,
                        keep_f64_fine=True, filter_smoother=True)
        refine = GENERAL_REFINE
    else:
        hier = setup_structured(A, AMGParam(**HEADLINE_AMG),
                                dtype=jnp.float32, smooth_p=True,
                                keep_f64_fine=True)
        refine = HEADLINE_REFINE
    return A, b, solve_refined_resident(hier, b, **refine)


def _port_x(stanza, A, b):
    """The stanza's timed solve through bench_torch's own functions."""
    cpu = torch.device("cpu")
    if stanza == "general":
        hier, _ = bench_torch.classical(A, cpu, {})
        refine = bench_torch.GENERAL_REFINE
    else:
        hier, _ = bench_torch.structured(A, cpu)
        refine = bench_torch.HEADLINE_REFINE
    with contextlib.redirect_stdout(io.StringIO()):
        _, x, _, _, _ = bench_torch.warm_and_time(
            cpu, bench_torch.refiner(hier, **refine), A, b, stanza)
    return x


@pytest.mark.parametrize("stanza", ["headline", "general", "fe_auto"])
def test_stanza_counts_and_x_match_jax(run, stanza):
    d = run[0]["detail"]
    pre = "" if stanza == "headline" else f"{stanza}_"
    A, b, ref = _jax_solve(stanza)
    assert ref.converged
    if stanza != "fe_auto":          # bench.py prints no fe_auto rounds
        key = "refine_rounds" if stanza == "headline" else "general_rounds"
        assert d[key] == ref.rounds
    assert d[f"{pre}inner_iters"] == ref.inner_iters
    verified = ("relres_verified_f64" if stanza == "headline"
                else f"{pre}relres_verified")
    assert d[verified] < bench_torch.TOL
    assert d["converged" if stanza == "headline" else f"{pre}converged"]
    x, xj = _port_x(stanza, A, b), np.asarray(ref.x)
    assert np.linalg.norm(x - xj) <= X_RTOL * np.linalg.norm(xj)


def test_spe01_stanza_reads_the_pair_and_converges(run):
    d = run[0]["detail"]
    assert "spe01_error" not in d
    assert d["spe01_converged"] and d["spe01_relres"] < 1e-6
    assert d["spe01_inner_iters"] > 0 and d["spe01_total_s"] > 0


def test_json_line_keys_and_values(run):
    out, lines = run
    assert json.loads(lines[-1]) == out
    d = out["detail"]
    want = {RENAMED.get(k, k) for k in BENCH_KEYS - DROPPED} | ADDED
    assert set(d) == want
    assert not [k for k in d if k.endswith("_error")]
    assert (out["metric"], out["unit"]) == ("amg_pcg_total_time_1M_poisson",
                                            "s")
    # value = setup_s + solve_s and vs_baseline = 2.9973 / value, each
    # rounded as bench.py rounds it
    assert abs(out["value"] - d["setup_s"] - d["solve_s"]) <= 2e-4
    speedup = bench_torch.REF_TOTAL_S / out["value"]
    assert abs(out["vs_baseline"] - speedup) <= 1e-3 * speedup + 1e-3
    assert (d["n"], d["platform"], d["dtype"]) == (NX * NX, "cpu", "float32")
    assert d["hbm_probe_dof"] == 128 * 128
    assert d["general_nnz"] > 0 and d["general_device_mb"] > 0
    # the raw best and spread of every chain, on earlier lines
    for label in chip_smoke.BENCH_CHAINS:
        for k in (1, 8):
            assert any(ln.startswith(f"chain {label} k={k}: best")
                       for ln in lines[:-1])


def test_marginal_time_is_bench_py_s():
    """The same chain times give bench.py's marginal and fixed times."""
    times = {1: [0.0031, 0.0030], 8: [0.0102, 0.0100]}

    def chain():
        seen = {1: iter(times[1]), 8: iter(times[8])}
        return lambda k, reps: next(seen[k])

    assert bench_torch._marginal_us(chain(), reps=10, tries=2) == \
        bench._marginal_us(chain(), reps=10, tries=2)


@pytest.mark.parametrize("above", [0.0, 0.001, 1.0, 100.0])
def test_fe_auto_warning_is_none_at_or_above_the_pin(above):
    assert bench_torch.fe_auto_warning(
        round(bench_torch.FE_AUTO_PIN + above, 3)) is None


@pytest.mark.parametrize("below", [0.001, 1.0])
def test_fe_auto_warning_below_the_pin_says_bench_py_s_message(below):
    """bench.py's form: the reading, the pin, the band it came from and
    what to do, with the card's name for STATUS's band."""
    pin, runs = bench_torch.FE_AUTO_PIN, bench_torch.PIN_RUNS
    reading = round(pin - below, 3)
    assert bench_torch.fe_auto_warning(reading) == (
        f"fe_auto_vs_baseline {reading} < {pin} pin "
        f"({bench_torch.PIN_CARD} band {min(runs)}-{max(runs)} over "
        f"{len(runs)} runs; investigate before shipping)")


def test_card_checks_name_each_fault(run):
    """Phase 15's rule on the card (chip_smoke.bench_misses): a detail
    that keeps it has no miss; each fault alone gives one."""
    good = dict(run[0]["detail"], refine_rounds=2, inner_iters=20,
                general_rounds=2, general_inner_iters=17,
                fe_auto_inner_iters=28, spe01_inner_iters=100,
                spe01_inner_solves=3, spe01_host_syncs=6,
                spe01_graph_replays=3,
                stencil_launches={"float32": 319, "float64": 2},
                chain_launches_per_rep={
                    c: {"1": 1, "8": 8} for c in chip_smoke.BENCH_CHAINS},
                **{f"{p}{k}": v for p in chip_smoke.BENCH_STANZAS
                   for k, v in (("graph_replays", 1), ("host_syncs", 1),
                                ("loop_control_launches", 43))})
    assert chip_smoke.bench_misses(good, spe01_anchor=100) == []
    faults = [dict(spe01_error="x"), dict(general_converged=False),
              dict(refine_rounds=3), dict(inner_iters=24),
              dict(general_rounds=4), dict(general_inner_iters=13),
              dict(fe_auto_inner_iters=32), dict(spe01_inner_iters=106),
              dict(fe_auto_graph_replays=0), dict(graph_captures=1),
              dict(spe01_graph_replays=2), dict(spe01_host_syncs=9),
              dict(graph_replays=44), dict(host_syncs=27),
              dict(general_loop_control_launches=0),
              dict(stencil_launches={"float32": 319, "float64": 0}),
              dict(chain_launches_per_rep={
                  c: {"1": 1, "8": 7 if c == "spmv" else 8}
                  for c in chip_smoke.BENCH_CHAINS})]
    for fault in faults:
        assert len(chip_smoke.bench_misses({**good, **fault},
                                           spe01_anchor=100)) == 1, fault


def test_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, bench_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'faspsolver_tpu' or m.startswith('faspsolver_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_card_raises_naming_the_cpu_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_torch.main()


def test_command_line_without_card_prints_no_result():
    """``python bench_torch.py`` with no device and no card exits non-zero
    before any JSON line; ``--device`` takes only cpu or cuda."""
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "--device cpu" in out.stderr
    assert "amg_pcg_total_time_1M_poisson" not in out.stdout
    bad = subprocess.run([sys.executable, "bench_torch.py", "--device",
                          "tpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert bad.returncode == 2 and "invalid choice" in bad.stderr
