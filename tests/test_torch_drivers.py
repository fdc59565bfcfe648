"""The port's drivers and ini CLI against the JAX package's (f64, CPU).

Every ported driver and every SolverType id through ``itsolver`` give
the JAX package's iterations and status with x within 1e-10; unknown
ids raise FaspError(-40) (the BSR, ILU, Schwarz, STR and BLC drivers
have their own files).  The two CLIs print the same iteration line
and exit with the same code on the repository's ini files.  Files
written by one package read back in the other.  The port's counts on
chip_smoke.py's small grid stay within the recorded JAX anchors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from native_parity import ensure_native
from small_grid_anchors import _to_jax, problem, run, run_fields

import chip_smoke
import faspsolver_tpu.io as jax_io
import faspsolver_tpu.solvers as jax_solvers
from faspsolver_tpu.__main__ import main as jax_main
from faspsolver_tpu.formats import CSRMatrix as JaxCSRMatrix
from faspsolver_tpu.precond import AMGPrecond as JaxAMGPrecond
from faspsolver_tpu.precond.amg import setup_rs as jax_setup_rs
from faspsolver_tpu.utils import params as jax_params
import faspsolver_tpu_torch.io as port_io
import faspsolver_tpu_torch.solvers as solvers
from faspsolver_tpu_torch.__main__ import main
from faspsolver_tpu_torch.constants import AMGType, SolverType
from faspsolver_tpu_torch.convert import from_jax
from faspsolver_tpu_torch.testgen import poisson_2d
from faspsolver_tpu_torch.utils import FaspError, messages
from faspsolver_tpu_torch.utils.params import AMGParam, ITSParam

torch.set_num_threads(2)
ensure_native()

_P = {}


def _poisson():
    if not _P:
        A = poisson_2d(31)
        Aj = JaxCSRMatrix(A.indptr, A.indices, A.data, A.shape)
        b = np.random.default_rng(3).standard_normal(A.nrow)
        hj = jax_setup_rs(Aj, jax_params.AMGParam(), dtype=jnp.float64)
        _P.update(A=A, Aj=Aj, b=b, hj=hj)
    return _P


def _assert_same(got, ref):
    got = got[0] if isinstance(got, tuple) else got
    ref = ref[0] if isinstance(ref, tuple) else ref
    assert (got.iters, got.status, got.converged) == \
        (int(ref.iters), int(ref.status), bool(ref.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)


SOLVER_IDS = [int(s) for s in SolverType]


@pytest.mark.parametrize("stype", SOLVER_IDS)
def test_every_solver_type_through_itsolver(stype):
    """Each id with an AMG V-cycle preconditioner: the Krylov ids match
    the JAX package, the rest raise FaspError(-40) in both."""
    p = _poisson()
    kw = dict(itsolver_type=stype, tol=1e-10, maxit=200, restart=20)
    M, jM = from_jax(JaxAMGPrecond(p["hj"])), JaxAMGPrecond(p["hj"])
    if stype in (1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 13, 14, 15, 16):
        got = solvers.itsolver(p["A"], p["b"], M=M, its=ITSParam(**kw),
                               device="cpu")
        ref = jax_solvers.itsolver(p["Aj"], p["b"], M=jM,
                                   its=jax_params.ITSParam(**kw))
        _assert_same(got, ref)
        assert got.converged and got.x.dtype == torch.float64
    else:
        with pytest.raises(FaspError) as e:
            solvers.itsolver(p["A"], p["b"], M=M, its=ITSParam(**kw),
                             device="cpu")
        assert e.value.code == -40
        with pytest.raises(RuntimeError, match="-40"):
            jax_solvers.itsolver(p["Aj"], p["b"], M=jM,
                                 its=jax_params.ITSParam(**kw))


DRIVERS = [
    ("krylov", dict(its=dict(tol=1e-8))),
    ("krylov_s", dict(its=dict(itsolver_type=4, tol=1e-8, restart=30))),
    ("itsolver_s", dict(its=dict(itsolver_type=1, tol=1e-8))),
    ("krylov_diag", dict(its=dict(itsolver_type=6, tol=1e-8))),
    ("krylov_amg", dict(its=dict(tol=1e-10), amg={})),
    ("krylov_amg", dict(its=dict(itsolver_type=5, tol=1e-10),
                        amg=dict(AMG_type=int(AMGType.SA)))),
    ("krylov_amg", dict(its=dict(tol=1e-10),
                        amg=dict(AMG_type=int(AMGType.UA), aggregation_type=2))),
    ("solve_amg", dict(amg=dict(maxit=30, tol=1e-10))),
    ("solve_amg", dict(amg=dict(maxit=30, tol=1e-10, cycle_type=3))),
    ("solve_famg", dict(amg=dict(maxit=30, tol=1e-10))),
    ("krylov_amg_nk", dict(its=dict(tol=1e-10), amg={}, nk=True)),
]


@pytest.mark.parametrize("driver,kw", DRIVERS,
                         ids=[f"{d}-{i}" for i, (d, _) in enumerate(DRIVERS)])
def test_ported_drivers_match_jax(driver, kw):
    p = _poisson()
    args, jargs = [p["A"], p["b"]], [p["Aj"], p["b"]]
    if kw.get("nk"):
        nk = np.ones((p["A"].nrow, 1))
        args.append(nk)
        jargs.append(nk)
    mine, theirs = {"device": "cpu"}, {}
    if "its" in kw:
        mine["its"] = ITSParam(**kw["its"])
        theirs["its"] = jax_params.ITSParam(**kw["its"])
    if "amg" in kw:
        mine["amg"] = AMGParam(**kw["amg"])
        theirs["amg"] = jax_params.AMGParam(**kw["amg"])
    if driver == "itsolver_s":
        args.insert(2, None)
        jargs.insert(2, None)
    got = getattr(solvers, driver)(*args, **mine)
    ref = getattr(jax_solvers, driver)(*jargs, **theirs)
    _assert_same(got, ref)


def test_drivers_take_dtype_and_device():
    """float32 on the CPU: the hierarchy and x in float32, on the CPU."""
    p = _poisson()
    res, hier = solvers.krylov_amg(p["A"], p["b"], its=ITSParam(tol=1e-5),
                                   dtype=torch.float32, device="cpu")
    assert res.converged and res.x.dtype == torch.float32
    assert res.x.device.type == "cpu"
    assert all(t.dtype != torch.float64 for t in hier.buffers())


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


NO_DEVICE_CALLS = [
    ("itsolver", {}), ("itsolver_s", {}), ("krylov", {}), ("krylov_s", {}),
    ("krylov_diag", {}), ("krylov_amg", {}), ("solve_amg", {}),
    ("solve_famg", {}), ("krylov_amg_nk", {"nk": True})]


@pytest.mark.parametrize("driver,kw", NO_DEVICE_CALLS,
                         ids=[d for d, _ in NO_DEVICE_CALLS])
def test_drivers_raise_without_a_cuda_device(driver, kw, monkeypatch):
    """device=None means the card: where there is none, every driver
    raises and names device="cpu"; none runs on the CPU unasked."""
    _no_cuda(monkeypatch)
    p = _poisson()
    args = [p["A"], p["b"]] + ([np.ones((p["A"].nrow, 1))] if kw else [])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(solvers, driver)(*args)


def test_cli_raises_without_a_cuda_device(monkeypatch, capsys):
    """The CLI without -device raises where there is no card, under
    FASP_TPU_F32=1 too; with -device cpu the same line solves."""
    _no_cuda(monkeypatch)
    argv = ["-ini", "ini/input.dat", "-problem", "poisson2d", "-size", "15"]
    with pytest.raises(RuntimeError, match="-device cpu"):
        main(argv)
    monkeypatch.setenv("FASP_TPU_F32", "1")
    with pytest.raises(RuntimeError, match="-device cpu"):
        main(argv)
    monkeypatch.delenv("FASP_TPU_F32")
    assert "Number of iterations" not in capsys.readouterr().out
    rc, iters, relres = _cli(main, argv + ["-device", "cpu"], capsys)
    assert rc == 0 and iters > 0 and relres < 1e-6
    assert _cli(lambda a: main(a, device="cpu"), argv, capsys)[1] == iters


def test_device_none_follows_what_is_already_placed(monkeypatch):
    """With an operator, or only a preconditioner, already on the CPU,
    device=None follows it (no CUDA device is asked for)."""
    _no_cuda(monkeypatch)
    from faspsolver_tpu_torch.krylov import JacobiPrecond
    from faspsolver_tpu_torch.ops.operators import device_operator
    p = _poisson()
    ref = solvers.krylov(p["A"], p["b"], its=ITSParam(tol=1e-8),
                         device="cpu")
    res = solvers.krylov(device_operator(p["A"]), p["b"],
                         its=ITSParam(tol=1e-8))
    assert res.x.device.type == "cpu" and res.iters == ref.iters
    M = JacobiPrecond.from_csr(p["A"])
    res = solvers.itsolver(p["A"], p["b"], M=M, its=ITSParam(tol=1e-8))
    assert res.x.device.type == "cpu" and res.converged


STR_BLC_CALLS = [("krylov_diag", "str", {}), ("krylov_ilu", "str", {}),
                 ("krylov_blockgs", "str", {}), ("krylov", "blc", {}),
                 ("krylov_block", "blc", {}), ("krylov_sweeping", "sweep", {})]


@pytest.mark.parametrize("driver,family,kw", STR_BLC_CALLS,
                         ids=[d for d, _, _ in STR_BLC_CALLS])
def test_str_and_blc_drivers_raise_without_a_cuda_device(driver, family, kw,
                                                         monkeypatch):
    """The STR and BLC drivers take device=None as the card, as every
    driver does: without one they raise and name device="cpu"; with it
    they solve on the CPU."""
    _no_cuda(monkeypatch)
    if family == "str":
        A, _, b = chip_smoke.str_problem(3)
    elif family == "blc":
        A, b = chip_smoke.blc_problem(3)
    else:
        A, b = chip_smoke.sweep_problem(6, 3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(solvers, driver)(A, b, **kw)
    res = getattr(solvers, driver)(A, b, device="cpu", **kw)
    assert res.x.device.type == "cpu" and res.converged


def _raise_not_implemented(*args, **kwargs):
    raise NotImplementedError("an unported option")


def test_solve_amg_falls_back_only_on_host_setup_errors(monkeypatch):
    """A setup ValueError (an unknown smoother id) and an STR matrix fall
    back to GMRES as in the JAX package; an unported option raises
    instead."""
    p = _poisson()
    warned = []
    monkeypatch.setattr(messages, "warn", warned.append)
    kw = dict(smoother=99, maxit=30, tol=1e-8)
    got = solvers.solve_amg(p["A"], p["b"], amg=AMGParam(**kw),
                            device="cpu")
    ref = jax_solvers.solve_amg(p["Aj"], p["b"],
                                amg=jax_params.AMGParam(**kw))
    _assert_same(got, ref)
    assert len(warned) == 1 and "falling back to GMRES" in warned[0]
    # an STR matrix, which no AMG setup takes, falls back too (the JAX
    # package's setup raises a TypeError for it and its except catches all)
    A, _, b = chip_smoke.str_problem(3)
    got = solvers.solve_amg(A, b, amg=AMGParam(**kw), device="cpu")
    _assert_same(got, jax_solvers.solve_amg(_to_jax(A), b,
                                            amg=jax_params.AMGParam(**kw)))
    assert len(warned) == 2 and "cannot build device operator" in warned[1]
    monkeypatch.setattr(solvers.drivers, "setup_rs", _raise_not_implemented)
    with pytest.raises(NotImplementedError, match="an unported option"):
        solvers.solve_amg(p["A"], p["b"], amg=AMGParam(), device="cpu")
    assert len(warned) == 2


def _cli(fn, argv, capsys):
    """(exit code, iterations, relres) of one CLI run."""
    rc = fn(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Number of iterations")]
    assert len(lines) == 1
    words = lines[0].rstrip(".").split()
    return rc, int(words[4]), float(words[-1])


@pytest.mark.parametrize("ini,size", [("input", 31), ("sa", 31), ("ua", 31),
                                      ("bamg", 31), ("its", 31),
                                      ("input", 63)])
def test_cli_matches_jax(ini, size, capsys):
    """Same exit code and iteration count; the verified relres to 6
    digits, or to 1e-13 where a direct coarse solve leaves it at
    rounding level (sa.dat at 31^2 converges in one iteration)."""
    argv = ["-ini", f"ini/{ini}.dat", "-problem", "poisson2d",
            "-size", str(size)]
    rc, iters, relres = _cli(main, argv + ["-device", "cpu"], capsys)
    jrc, jiters, jrelres = _cli(jax_main, argv, capsys)
    assert (rc, iters) == (jrc, jiters)
    assert np.isclose(relres, jrelres, rtol=1e-6, atol=1e-13)


def test_io_round_trip(tmp_path):
    """Matrices and vectors written by one package read back in the
    other."""
    p = _poisson()
    A, b = p["A"], p["b"]
    for write, read in ((jax_io, port_io), (port_io, jax_io)):
        d = tmp_path / write.__name__.split(".")[0]
        d.mkdir()
        write.write_csr(str(d / "A.dat"), A)
        write.write_mtx(str(d / "A.mtx"), A)
        write.write_vec(str(d / "b.dat"), b)
        for B in (read.read_csr(str(d / "A.dat")),
                  read.read_mtx(str(d / "A.mtx"))):
            assert (B.to_scipy() != A.to_scipy()).nnz == 0
        np.testing.assert_array_equal(read.read_vec(str(d / "b.dat")), b)


@pytest.mark.parametrize("cfg", chip_smoke.SMALL_GRID,
                         ids=[c[0] for c in chip_smoke.SMALL_GRID])
def test_small_grid_within_the_recorded_anchors(cfg):
    """The port on the CPU against chip_smoke's recorded JAX counts
    (tests/small_grid_anchors.py prints them)."""
    A, b = problem()
    res, x = run("port", cfg, A, b)
    name, _, _, _, anchor, bound = cfg
    assert res.converged and res.status == 0
    assert abs(res.iters - anchor) <= bound, (name, res.iters, anchor)
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) < 1e-9


@pytest.mark.parametrize("cfg", chip_smoke.LEFTOVER_GRID,
                         ids=[c[0] for c in chip_smoke.LEFTOVER_GRID])
def test_leftover_grid_within_the_recorded_anchors(cfg):
    """Phase 9d's configs (level smoothers, energy-min, CR, ILU
    variants, Schwarz) on the CPU against the recorded JAX counts."""
    A, b = problem()
    name, driver, fields, anchor, bound = cfg
    res, x = run_fields("port", driver, fields, A, b)
    assert res.converged and res.status == 0
    assert abs(res.iters - anchor) <= bound, (name, res.iters, anchor)
    assert np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b) < 1e-9
