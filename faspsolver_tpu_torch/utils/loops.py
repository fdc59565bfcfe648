"""The control of the resident solve loops: the CUDA kernel, its plain
PyTorch twin, the launch counter, and the state block they update.

The JAX package runs each solve loop as one jitted ``lax.while_loop``
whose stopping test and rare branches (``lax.cond``) stay on the device.
Here a loop is a CUDA graph with a WHILE conditional node around the
body and an IF node around the true-residual recompute
(``utils/graphs.py``); ``csrc/loop_control.cu`` is the scalar bookkeeping
between the body's vector work: from the reductions the body computed
it decides the safeguards, updates the scalar state and sets the
conditional handles.  One entry point per loop — :func:`pcg`,
:func:`bicgstab`, :func:`minres`, :func:`refine`, :func:`gmres`,
``mg`` (the multigrid solve loops: AMG as a solver, FAMG, GMG's
V-cycles and GMG-preconditioned CG) and :func:`gcr` (GCG and GCR) —
each with phases (``INIT``, ``CHECK``, ``DECIDE``; the refinement's
``INIT`` and ``ROUND``; ``mg``'s ``INIT`` and ``CHECK``; ``gcr``'s
``INIT``, ``CYCLE``, ``STEP`` and ``END``).

The state lives in a :class:`Block`: one byte tensor per loop program,
holding a :class:`Region` per loop (the refiner's and its inner PCG's),
each a vector of ``LoopF`` fields in the loop's dtype and one of
``LoopI`` int32 fields (counts, budgets, flags), as the kernel source
lays them out (this module reads the two enums from it).  The vector
work masks its restart and safe iterate with the flags, the eager loop
reads the whole block in one transfer, and a resident solve reads it
once at the end.

On a CPU tensor each entry point runs its plain twin (the same
arithmetic on 0-d tensors of the loop's dtype, bit for bit); on a CUDA
tensor it launches the kernel, with the region's handle (0 outside a
capture: the kernel then only updates the region).  There is no fallback
from one to the other.  The library is compiled with nvcc at the first
CUDA launch into the port's build directory; importing this module needs
neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import shutil
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import (ERROR_SOLVER_MISC, ERROR_SOLVER_SOLSTAG,
                         ERROR_SOLVER_STAG, ERROR_SOLVER_TOLSMALL,
                         STAG_RATIO, StopType)
from .build import build_shared

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "loop_control.cu")

SMALLREAL = 1e-20       # krylov/common.py's safeguard constants
SMALLREAL2 = 1e-40

INIT, CHECK, DECIDE = 0, 1, 2
ROUND = 1
CYCLE, ARNOLDI, SOLVE, RESTART = 1, 2, 3, 4       # GMRES's, after INIT
STEP, END = 2, 3                                  # GCR's, after CYCLE

# the GMRES family's restart and stagnation rules (krylov/gmres.py)
CR_MAX = 0.99     # cos(8 deg)  (reference: KryPvgmres.c:79)
CR_MIN = 0.174    # cos(80 deg) (reference: KryPvgmres.c:80)
RESTART_MIN = 3
RESTART_DEC = 3
STAG_FACTOR = 0.995
MAX_STAG_CYCLES = 4
HAPPY = SMALLREAL * 1e-8          # an Arnoldi step's happy breakdown

# the multigrid loops' forms of the stopping test (``I.FORM``): AMG's
# ~(relres < tol), GMG's relres >= tol
MG_FORMS = {"amg": 0, "gmg": 1}


def _fields(name: str) -> SimpleNamespace:
    """The names of enum ``name`` of the kernel source, by position, with
    the common prefix dropped: ``F.TOL``, ``I.IT``; ``COUNT`` is last."""
    with open(SOURCE) as f:
        m = re.search(r"enum %s \{([^}]*)\};" % name, f.read())
    names = [s.strip().split("_", 1)[1] for s in m.group(1).split(",")]
    return SimpleNamespace(**{n: k for k, n in enumerate(names)})


F = _fields("LoopF")
I = _fields("LoopI")

# kernel launches per entry point; incremented only where a launch is
# issued (a resident solve adds its device-counted executions)
launches = {"pcg": 0, "bicgstab": 0, "minres": 0, "refine": 0,
            "gmres": 0, "mg": 0, "gcr": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# the state block
# ---------------------------------------------------------------------------

class Region:
    """One loop's fields in a :class:`Block`: ``f`` (``F.COUNT`` values of
    ``dtype``) and ``i`` (``I.COUNT`` int32), 1-d views of the block.
    ``h_while`` / ``h_if`` are the conditional handles its control sets,
    0 except while a resident program is captured."""

    def __init__(self, name: str, dtype, f: torch.Tensor, i: torch.Tensor,
                 offsets: Tuple[int, int]):
        self.name, self.dtype = name, dtype
        self.f, self.i = f, i
        self.offsets = offsets
        self.h_while = self.h_if = 0

    def flag(self, k: int) -> torch.Tensor:
        """Field ``k`` of ``i`` as a 0-d bool tensor."""
        return self.i[k] != 0


class Block:
    """The state of one loop program: a byte tensor on ``device`` with a
    :class:`Region` per (name, dtype) of ``layout``, in that order."""

    def __init__(self, device, layout: Sequence[Tuple[str, torch.dtype]]):
        spans, off = [], 0
        for name, dt in layout:
            item = torch.empty((), dtype=dt).element_size()
            fo = off
            io = fo + F.COUNT * item
            io = (io + 7) // 8 * 8
            off = (io + I.COUNT * 4 + 7) // 8 * 8
            spans.append((name, dt, fo, io, item))
        self.bytes = torch.zeros(off, dtype=torch.uint8, device=device)
        self.regions: Dict[str, Region] = {}
        for name, dt, fo, io, item in spans:
            self.regions[name] = Region(
                name, dt, self.bytes[fo:fo + F.COUNT * item].view(dt),
                self.bytes[io:io + I.COUNT * 4].view(torch.int32), (fo, io))

    def __getitem__(self, name: str) -> Region:
        return self.regions[name]

    def decode(self, raw: np.ndarray) -> Dict[str, SimpleNamespace]:
        """The block's bytes read to the host -> per region ``f`` and
        ``i`` as NumPy arrays of the region's dtype and int32."""
        out = {}
        for name, reg in self.regions.items():
            fo, io = reg.offsets
            npdt = np.dtype(str(reg.dtype).replace("torch.", ""))
            out[name] = SimpleNamespace(
                f=raw[fo:fo + F.COUNT * npdt.itemsize].view(npdt),
                i=raw[io:io + I.COUNT * 4].view(np.int32))
        return out

    def upload(self, values: Dict[str, dict]) -> None:
        """Set the block in one host-to-device copy: every field 0 (the
        counters too) except ``values[region] = {("f" | "i", k): v}``,
        each rounded to its field's type.  The loop's init phase sets
        its state from these."""
        raw = np.zeros(self.bytes.numel(), dtype=np.uint8)
        host = self.decode(raw)
        for name, vals in values.items():
            for (kind, k), v in vals.items():
                getattr(host[name], kind)[k] = v
        src = torch.from_numpy(raw)
        if self.bytes.device.type == "cuda":
            src = src.pin_memory()
            self.bytes.copy_(src, non_blocking=True)
        else:
            self.bytes.copy_(src)


def krylov_values(tol, abstol, maxit, stop_type, safe, max_stag,
                  max_restart) -> dict:
    """A Krylov region's parameters for :meth:`Block.upload`."""
    return {("f", F.TOL): tol, ("f", F.ABSTOL): abstol,
            ("i", I.MAXIT): maxit, ("i", I.STOP): int(stop_type),
            ("i", I.SAFE): int(bool(safe)), ("i", I.MAX_STAG): max_stag,
            ("i", I.MAX_RESTART): max_restart}


def gmres_values(tol, abstol, maxit, stop_type, safe, adaptive) -> dict:
    """The GMRES outer region's parameters for :meth:`Block.upload`."""
    return {("f", F.TOL): tol, ("f", F.ABSTOL): abstol,
            ("i", I.MAXIT): maxit, ("i", I.STOP): int(stop_type),
            ("i", I.SAFE): int(bool(safe)),
            ("i", I.ADAPTIVE): int(bool(adaptive))}


def mg_values(tol, maxit, form: str) -> dict:
    """A multigrid loop's parameters for :meth:`Block.upload`: ``tol``
    (rounded to the region's dtype, as the JAX package's
    ``jnp.asarray(tol, b.dtype)``), ``maxit`` and the test's ``form``
    (a key of :data:`MG_FORMS`)."""
    return {("f", F.TOL): tol, ("i", I.MAXIT): maxit,
            ("i", I.FORM): MG_FORMS[form]}


def gcr_values(tol, abstol, maxit, stop_type) -> dict:
    """GCG / GCR's outer region's parameters for :meth:`Block.upload`."""
    return {("f", F.TOL): tol, ("f", F.ABSTOL): abstol,
            ("i", I.MAXIT): maxit, ("i", I.STOP): int(stop_type)}


def gmres_arrays(R: int) -> int:
    """The length of GMRES's array tensor for window R: H ((R + 1) x R,
    row-major), g (R + 1), cs, sn and y (R each), in that order."""
    return (R + 1) * R + (R + 1) + 3 * R


def gmres_views(arr: torch.Tensor, R: int):
    """(H, g, cs, sn, y): views of GMRES's array tensor for window R."""
    H = arr[:(R + 1) * R].view(R + 1, R)
    g = arr[(R + 1) * R:(R + 1) * (R + 1)]
    cs, sn, y = arr[(R + 1) * (R + 1):].view(3, R).unbind()
    return H, g, cs, sn, y


# ---------------------------------------------------------------------------
# the plain twins: the kernel's arithmetic on 0-d tensors, bit for bit
# ---------------------------------------------------------------------------

def _c(v, dt):
    return torch.tensor(v, dtype=dt)


def _sqrt(v):
    """The correctly rounded square root of a 0-d tensor, as the kernel's
    ``sqrt_rn`` and NumPy take it: ``torch.sqrt`` on the CPU misrounds
    about 1% of its results in the last bit (AVX-512 builds), so it is
    taken in f64 on the host (exact for an f32 input once rounded)."""
    x = float(v)
    root = math.sqrt(x) if x >= 0 else math.nan
    return torch.tensor(root, dtype=v.dtype, device=v.device)


def _pymax(a, b):
    """Python's max(a, b): a unless b is strictly greater."""
    return torch.where(b > a, b, a)


def _pymin(a, b):
    return torch.where(b < a, b, a)


def _init_norms(absres0, xx, f, i, extra_done):
    dt = f.dtype
    small = _c(SMALLREAL, dt)
    mod = int(i[I.STOP]) == StopType.MOD_REL_RES
    f[F.MAXDIFF] = f[F.TOL] * _c(STAG_RATIO, dt)
    f[F.NORMR0] = _pymax(small, absres0)
    f[F.NORMU] = _pymax(small, _sqrt(xx))
    f[F.ABSRES0] = absres0
    f[F.ABSRES] = absres0
    f[F.RELRES] = absres0 / (f[F.NORMU] if mod else f[F.NORMR0])
    f[F.BEST] = absres0
    i[I.IT] = 0
    i[I.STAG] = 1
    i[I.MORE] = 1
    i[I.STATUS] = 0
    for k in (I.NEED, I.CONV, I.RESTART, I.BETTER):
        i[k] = 0
    i[I.NINIT] += 1
    done = (f[F.RELRES] < f[F.TOL]) | (absres0 < f[F.ABSTOL]) | extra_done
    i[I.CONT] = ~done & (0 < i[I.MAXIT])


def _provisional(i, done, status):
    i[I.STATUS] = status
    i[I.CONT] = ~done & (i[I.IT] < i[I.MAXIT])


def _status(breakdown, zero_sol, stag_fail, tol_fail):
    return torch.where(breakdown, ERROR_SOLVER_MISC, torch.where(
        zero_sol, ERROR_SOLVER_SOLSTAG, torch.where(
            stag_fail, ERROR_SOLVER_STAG, torch.where(
                tol_fail, ERROR_SOLVER_TOLSMALL, 0))))


def _krylov_decide(absres_true, f, i):
    mod = int(i[I.STOP]) == StopType.MOD_REL_RES
    need, stagnated, claim = (i[k] != 0 for k in (I.NEED, I.STAGNATED,
                                                  I.CLAIM))
    breakdown, zero_sol = i[I.BREAKDOWN] != 0, i[I.ZERO_SOL] != 0
    absres = torch.where(need, absres_true, f[F.ABSRES])
    relres = torch.where(need, absres_true / (
        f[F.NORMU_NEW] if mod else f[F.NORMR0]), f[F.RELRES])
    conv = need & (relres < f[F.TOL])
    stag_fail = stagnated & ~conv & (i[I.STAG] >= i[I.MAX_STAG])
    tol_fail = claim & ~conv & (i[I.MORE] >= i[I.MAX_RESTART])
    restart = need & ~conv & ~stag_fail & ~tol_fail
    i[I.STAG] += (restart & stagnated).int()
    i[I.MORE] += (restart & claim).int()
    done = breakdown | zero_sol | stag_fail | tol_fail | conv
    i[I.STATUS] = _status(breakdown, zero_sol, stag_fail, tol_fail)
    f[F.ABSRES] = absres
    f[F.RELRES] = relres
    f[F.ABSRES0] = absres
    if mod:
        f[F.NORMU] = f[F.NORMU_NEW]
    better = (i[I.SAFE] != 0) & (absres < f[F.BEST])
    f[F.BEST] = torch.where(better, absres, f[F.BEST])
    i[I.CONV] = conv
    i[I.RESTART] = restart
    i[I.BETTER] = better
    i[I.CONT] = ~done & (i[I.IT] < i[I.MAXIT])


def pcg_plain(phase: int, inp: torch.Tensor, reg: Region) -> None:
    """PCG's control on a CPU region (``csrc/loop_control.cu``,
    ``pcg_phase``)."""
    f, i = reg.f, reg.i
    dt = f.dtype
    if phase == INIT:
        return _init_norms(inp[0], inp[1], f, i, False)
    if phase == DECIDE:
        return _krylov_decide(inp[0], f, i)
    small, small2, slow = (_c(v, dt) for v in (SMALLREAL, SMALLREAL2, 0.9))
    mod = int(i[I.STOP]) == StopType.MOD_REL_RES
    i[I.IT] += 1
    i[I.NBODY] += 1
    temp2, alpha, absres, normuinf, xx, pp = inp.unbind()
    relres = absres / (f[F.NORMU] if mod else f[F.NORMR0])
    breakdown = temp2.abs() <= small2
    factor = absres / f[F.ABSRES0]
    zero_sol = (factor > slow) & (normuinf <= small)
    normu_new = _pymax(small, _sqrt(xx))
    reldiff = alpha.abs() * _sqrt(pp) / normu_new
    stagnated = ((factor > slow) & ~zero_sol & (i[I.STAG] <= i[I.MAX_STAG])
                 & (reldiff < f[F.MAXDIFF]))
    claim = (relres < f[F.TOL]) & ~stagnated & ~zero_sol
    need = stagnated | claim
    f[F.ABSRES] = absres
    f[F.RELRES] = relres
    f[F.NORMU_NEW] = normu_new
    i[I.BREAKDOWN] = breakdown
    i[I.ZERO_SOL] = zero_sol
    i[I.STAGNATED] = stagnated
    i[I.CLAIM] = claim
    i[I.NEED] = need
    i[I.NIF] += need.int()
    _provisional(i, breakdown | zero_sol,
                 torch.where(breakdown, ERROR_SOLVER_MISC,
                             torch.where(zero_sol, ERROR_SOLVER_SOLSTAG, 0)))


def bicgstab_plain(phase: int, inp: torch.Tensor, reg: Region) -> None:
    """BiCGstab's control on a CPU region (``bicgstab_phase``)."""
    f, i = reg.f, reg.i
    dt = f.dtype
    if phase == INIT:
        return _init_norms(inp[0], inp[1], f, i, False)
    if phase == DECIDE:
        return _krylov_decide(inp[0], f, i)
    small, small2, slow = (_c(v, dt) for v in (SMALLREAL, SMALLREAL2, 0.9))
    mod = int(i[I.STOP]) == StopType.MOD_REL_RES
    i[I.IT] += 1
    i[I.NBODY] += 1
    sigma, tt, absres, xx, ss = inp.unbind()
    relres = absres / (f[F.NORMU] if mod else f[F.NORMR0])
    breakdown = (sigma.abs() <= small2) | (tt <= small2)
    factor = absres / f[F.ABSRES0]
    normu_new = _pymax(small, _sqrt(xx))
    stagnated = ((factor > slow) & (i[I.STAG] <= i[I.MAX_STAG])
                 & (_sqrt(ss) / normu_new < f[F.MAXDIFF]))
    claim = (relres < f[F.TOL]) & ~stagnated
    need = stagnated | claim
    f[F.ABSRES] = absres
    f[F.RELRES] = relres
    f[F.NORMU_NEW] = normu_new
    i[I.BREAKDOWN] = breakdown
    i[I.ZERO_SOL] = 0
    i[I.STAGNATED] = stagnated
    i[I.CLAIM] = claim
    i[I.NEED] = need
    i[I.NIF] += need.int()
    _provisional(i, breakdown, torch.where(breakdown, ERROR_SOLVER_MISC, 0))


def minres_plain(phase: int, inp: torch.Tensor, reg: Region) -> None:
    """MINRES's control on a CPU region (``minres_phase``)."""
    f, i = reg.f, reg.i
    small = _c(SMALLREAL, f.dtype)
    mod = int(i[I.STOP]) == StopType.MOD_REL_RES
    if phase == INIT:
        _init_norms(inp[0], inp[1], f, i, inp[2] <= small)
        f[F.BEST] = f[F.RELRES]
        return
    if phase == CHECK:
        i[I.IT] += 1
        i[I.NBODY] += 1
        relres = inp[0].abs() / f[F.NORMR0]
        claim = relres < f[F.TOL]
        breakdown = inp[1] <= small
        f[F.RELRES] = relres
        i[I.BREAKDOWN] = breakdown
        i[I.CLAIM] = claim
        i[I.NEED] = claim
        i[I.NIF] += claim.int()
        _provisional(i, breakdown, 0)
        return
    relres = f[F.RELRES]
    if int(i[I.NEED]):
        f[F.NORMU_NEW] = _pymax(small, _sqrt(inp[1]))
        f[F.ABSRES] = inp[0]
        relres = inp[0] / (f[F.NORMU_NEW] if mod else f[F.NORMR0])
    done = ((i[I.CLAIM] != 0) & (relres < f[F.TOL])) | (i[I.BREAKDOWN] != 0)
    f[F.RELRES] = relres
    better = (i[I.SAFE] != 0) & (relres < f[F.BEST])
    f[F.BEST] = torch.where(better, relres, f[F.BEST])
    i[I.BETTER] = better
    i[I.STATUS] = 0
    i[I.CONT] = ~done & (i[I.IT] < i[I.MAXIT])


def refine_plain(phase: int, inp: torch.Tensor, reg: Region,
                 inner: Region) -> None:
    """The refinement's control on a CPU region (``refine_control``):
    the round count, the entry / continue test, and the next round's
    inner tolerance written into ``inner``'s ``F.TOL``."""
    f, i = reg.f, reg.i
    if phase == INIT:
        relres = _c(1.0, torch.float64)
        i[I.IT] = 0
        i[I.NINIT] += 1
    else:
        relres = inp[0]
        i[I.IT] += 1
        i[I.NBODY] += 1
    f[F.RELRES] = relres
    i[I.CONT] = (relres >= f[F.TOL]) & (i[I.IT] < i[I.MAXIT])
    need = _pymin(_pymax(_c(0.3, torch.float64) * f[F.TOL]
                         / _pymax(relres, _c(1e-300, torch.float64)),
                         f[F.INNER_FLOOR]), f[F.INNER_TOL])
    inner.f[F.TOL] = need.to(inner.dtype)


def mg_plain(phase: int, inp: torch.Tensor, reg: Region) -> None:
    """The multigrid loops' control on a CPU region (``mg_control``):
    the relres ``inp[0]`` stored, the count, and the continue test in
    the region's form."""
    f, i = reg.f, reg.i
    relres = inp[0]
    if phase == INIT:
        i[I.IT] = 0
        i[I.NINIT] += 1
    else:
        i[I.IT] += 1
        i[I.NBODY] += 1
    more = (relres >= f[F.TOL] if int(i[I.FORM]) == MG_FORMS["gmg"]
            else ~(relres < f[F.TOL]))
    f[F.RELRES] = relres
    i[I.CONT] = more & (i[I.IT] < i[I.MAXIT])


def gcr_plain(phase: int, inp: torch.Tensor, reg: Region, inner: Region,
              R: int) -> None:
    """GCG / GCR's control on CPU regions (``gcr_control``): ``reg`` the
    restart cycles' (j in ``I.J``), ``inner`` the descent steps', R the
    window."""
    f, i = reg.f, reg.i
    small = _c(SMALLREAL, f.dtype)
    if phase == INIT:
        _init_norms(inp[0], inp[1], f, i, False)
        i[I.J] = 0
        return
    if phase == CYCLE:
        i[I.J] = 0
        inner.i[I.CONT] = 0 < R and bool(i[I.IT] < i[I.MAXIT])
        return
    if phase == STEP:
        j = int(i[I.J]) + 1
        brk = bool(inp[0] <= small) or bool(inp[1] / f[F.NORMR0] < f[F.TOL])
        i[I.J] = j
        inner.i[I.NBODY] += 1
        inner.i[I.CONT] = (j < R and bool(i[I.IT] + j < i[I.MAXIT])
                           and not brk)
        return
    mod = int(i[I.STOP]) == StopType.MOD_REL_RES
    j = int(i[I.J])
    i[I.IT] += j
    normu = _pymax(small, _sqrt(inp[1]))
    relres = inp[0] / (normu if mod else f[F.NORMR0])
    done = bool(relres < f[F.TOL]) or j == 0
    f[F.ABSRES] = inp[0]
    f[F.RELRES] = relres
    f[F.NORMU_NEW] = normu
    i[I.STATUS] = 0
    i[I.NBODY] += 1
    i[I.CONT] = not done and bool(i[I.IT] < i[I.MAXIT])


PLAIN = {"pcg": pcg_plain, "bicgstab": bicgstab_plain,
         "minres": minres_plain, "mg": mg_plain}


def solve_columns(H, g, y, j: int) -> None:
    """y (length R) from the j x j upper-triangular system H[:j, :j] y =
    g[:j] by columns, the control's order (the reference BLAS dtrsm's,
    without its test for a zero): y[k] = g[k] / H[k, k], then g[m] -=
    H[m, k] y[k] for every m < k, k from j - 1 down; each product and
    difference rounded to H's dtype; y zero past j, g left as it was."""
    y.zero_()
    gw = g[:j].clone()
    for k in range(j - 1, -1, -1):
        y[k] = gw[k] / H[k, k]
        gw[:k] = gw[:k] - H[:k, k] * y[k]


def gmres_plain(phase: int, inp: torch.Tensor, reg: Region, inner: Region,
                arr: torch.Tensor, R: int) -> None:
    """GMRES's control on CPU regions (``gmres_entry``): ``reg`` the
    restart cycles', ``inner`` the Arnoldi steps', ``arr`` the window's
    arrays (:func:`gmres_arrays`), R the window."""
    f, i = reg.f, reg.i
    dt = f.dtype
    small = _c(SMALLREAL, dt)
    H, g, cs, sn, y = gmres_views(arr, R)
    if phase == CYCLE:
        arr.zero_()
        g[0] = f[F.R_NORM]
        f[F.SCALE] = torch.where(f[F.R_NORM] > small,
                                 _c(1.0, dt) / f[F.R_NORM], _c(0.0, dt))
        i[I.J] = 0
        inner.i[I.CONT] = (0 < i[I.CUR_RESTART]) & (i[I.IT] < i[I.MAXIT])
        return
    if phase == SOLVE:
        solve_columns(H, g, y, int(i[I.J]))
        return
    mod = int(i[I.STOP]) == StopType.MOD_REL_RES
    if phase == INIT:
        _init_norms(inp[0], inp[1], f, i, False)
        f[F.BEST] = f[F.RELRES]
        f[F.STAG_BEST] = f[F.RELRES]
        f[F.R_NORM] = inp[2]
        f[F.R_NORM_OLD] = inp[2]
        i[I.STAG] = 0
        i[I.CYCLES] = 0
        i[I.CUR_RESTART] = R
        i[I.J] = 0
        return
    if phase == ARNOLDI:
        j = int(i[I.J])
        hn = inp[R + 1]
        H[:, j] = inp[:R + 1]
        H[j + 1, j] = hn
        for k in range(j):
            hk, hk1 = H[k, j].clone(), H[k + 1, j].clone()
            H[k, j] = cs[k] * hk + sn[k] * hk1
            H[k + 1, j] = -sn[k] * hk + cs[k] * hk1
        a, b = H[j, j].clone(), H[j + 1, j].clone()
        den = _sqrt(a * a + b * b)
        den_ok = den > small
        c = torch.where(den_ok, a / den, _c(1.0, dt))
        s = torch.where(den_ok, b / den, _c(0.0, dt))
        H[j, j] = c * a + s * b
        H[j + 1, j] = 0
        gj = g[j].clone()
        g[j] = c * gj
        g[j + 1] = -s * gj
        cs[j] = c
        sn[j] = s
        happy = hn <= _c(HAPPY, dt)
        conv = g[j + 1].abs() / f[F.NORMR0] < f[F.TOL]
        i[I.J] = j + 1
        inner.i[I.NBODY] += 1
        inner.i[I.CONT] = ((j + 1 < i[I.CUR_RESTART])
                           & (i[I.IT] + j + 1 < i[I.MAXIT]) & ~happy & ~conv)
        return
    j = int(i[I.J])
    i[I.IT] += j
    r_norm, absres = inp[0], inp[1]
    normu = _pymax(small, _sqrt(inp[2]))
    relres = absres / (normu if mod else f[F.NORMR0])
    cur = int(i[I.CUR_RESTART])
    if int(i[I.ADAPTIVE]):
        # the reference's rule (KryPvgmres.c:200-210)
        cr = r_norm / _pymax(f[F.R_NORM], small)
        shrunk = cur - RESTART_DEC if cur - RESTART_DEC > RESTART_MIN else R
        cur = (R if bool(cr > _c(CR_MAX, dt)) or int(i[I.CYCLES]) == 0
               else cur if bool(cr < _c(CR_MIN, dt)) else shrunk)
    stag = (int(i[I.STAG]) + 1
            if bool(relres > _c(STAG_FACTOR, dt) * f[F.STAG_BEST]) else 0)
    stalled = stag >= MAX_STAG_CYCLES and bool(relres > _c(4.0, dt)
                                               * f[F.TOL])
    done = bool(relres < f[F.TOL]) or j == 0 or stalled
    f[F.STAG_BEST] = _pymin(f[F.STAG_BEST], relres)
    f[F.R_NORM_OLD] = f[F.R_NORM]
    f[F.R_NORM] = r_norm
    f[F.ABSRES] = absres
    f[F.RELRES] = relres
    f[F.NORMU_NEW] = normu
    better = (i[I.SAFE] != 0) & (relres < f[F.BEST])
    f[F.BEST] = torch.where(better, relres, f[F.BEST])
    i[I.BETTER] = better
    i[I.CUR_RESTART] = cur
    i[I.STAG] = stag
    i[I.CYCLES] += 1
    i[I.STATUS] = ERROR_SOLVER_STAG if stalled else 0
    i[I.NBODY] += 1
    i[I.CONT] = not done and bool(i[I.IT] < i[I.MAXIT])


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _nvcc(sources, out):
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    consts = {"SMALLREAL": repr(SMALLREAL), "SMALLREAL2": repr(SMALLREAL2),
              "STAG_RATIO": repr(STAG_RATIO),
              "MOD_REL_RES": int(StopType.MOD_REL_RES),
              "ERR_MISC": ERROR_SOLVER_MISC,
              "ERR_SOLSTAG": ERROR_SOLVER_SOLSTAG,
              "ERR_STAG": ERROR_SOLVER_STAG,
              "ERR_TOLSMALL": ERROR_SOLVER_TOLSMALL,
              "HAPPY": repr(HAPPY), "CR_MAX": repr(CR_MAX),
              "CR_MIN": repr(CR_MIN), "RESTART_MIN": RESTART_MIN,
              "RESTART_DEC": RESTART_DEC, "STAG_FACTOR": repr(STAG_FACTOR),
              "MAX_STAG_CYCLES": MAX_STAG_CYCLES}
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
            "-ftz=false", "-Xptxas", "-v",
            *[f"-DFASP_{k}=({v})" for k, v in consts.items()],
            "-shared", "-Xcompiler", "-fPIC", "-o", out, *sources, "-ldl"]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' signatures on a loaded loop-control
    library."""
    p, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    for kind in ("pcg", "bicgstab", "minres", "mg"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"fasp_loop_{kind}_{dt}")
            fn.restype, fn.argtypes = i32, [i32, p, p, p, u64, p]
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"fasp_loop_refine_{dt}")
        fn.restype, fn.argtypes = i32, [i32, p, p, p, p, u64, p]
        fn = getattr(lib, f"fasp_loop_gmres_{dt}")
        fn.restype, fn.argtypes = i32, [i32, p, p, p, p, p, i32, u64, p]
        fn = getattr(lib, f"fasp_loop_gcr_{dt}")
        fn.restype, fn.argtypes = i32, [i32, p, p, p, p, i32, u64, p]
    sig = {"fasp_loop_empty": [p],
           "fasp_graph_create": [p], "fasp_graph_destroy": [p],
           "fasp_graph_handle": [p, p],
           "fasp_graph_add_conditional": [p, p, u64, i32, p, p],
           "fasp_graph_add_child": [p, p, p, p],
           "fasp_graph_node_kinds": [p, p, p],
           "fasp_graph_instantiate": [p, p, p, p],
           "fasp_graph_launch": [p, p],
           "fasp_graph_exec_destroy": [p],
           "fasp_loop_chain_probe": [i32, i32, p, p]}
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = i32, args
    for name in ("fasp_loop_error_string", "fasp_graph_error_string"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_char_p, [i32]
    return lib


def library() -> ctypes.CDLL:
    """Build (first use) and load the loop-control library."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build_shared("loop_control", [SOURCE],
                                             _nvcc)))
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a kernel launch."""
    if err:
        raise RuntimeError(f"{what} failed: "
                           + library().fasp_loop_error_string(err).decode())


def check_graph(err: int, what: str) -> None:
    """Raise on a nonzero CUresult from a graph call (``fasp_graph_*``,
    the driver API)."""
    if err:
        raise RuntimeError(f"{what} failed: "
                           + library().fasp_graph_error_string(err).decode())


def local(t: torch.Tensor) -> torch.Tensor:
    """t's whole value as a plain tensor (a replicated DTensor's)."""
    from .. import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _device_args(inp: torch.Tensor, reg: Region):
    inp = local(inp)
    if inp.device != reg.f.device or inp.dtype != reg.dtype:
        raise ValueError(f"control input on {inp.device}/{inp.dtype}, "
                         f"region on {reg.f.device}/{reg.dtype}")
    return inp.contiguous()


def _launch(kind: str, phase: int, inp: torch.Tensor, reg: Region,
            h: int) -> None:
    if reg.f.device.type != "cuda":
        raise ValueError(f"no loop-control kernel for device {reg.f.device}")
    if reg.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"loop control takes f32/f64, got {reg.dtype}")
    lib = library()
    fn = getattr(lib, f"fasp_loop_{kind}_"
                 f"{'f32' if reg.dtype == torch.float32 else 'f64'}")
    err = fn(phase, inp.data_ptr(), reg.f.data_ptr(), reg.i.data_ptr(), h,
             torch.cuda.current_stream(reg.f.device).cuda_stream)
    check(err, f"loop_control {kind} launch")
    launches[kind] += 1


def control(kind: str, phase: int, inp: torch.Tensor, reg: Region) -> None:
    """Loop ``kind`` ("pcg", "bicgstab", "minres", "mg"), phase
    ``phase`` on ``reg`` with the body's scalars ``inp`` (1-d, the
    region's dtype): the twin on the CPU, else the kernel, setting the
    IF handle at a Krylov ``CHECK`` and the WHILE handle otherwise."""
    inp = _device_args(inp, reg)
    if reg.f.device.type == "cpu":
        return PLAIN[kind](phase, inp, reg)
    _launch(kind, phase, inp, reg, reg.h_if if phase == CHECK
            and kind != "mg" else reg.h_while)


def refine(phase: int, inp: torch.Tensor, reg: Region,
           inner: Region) -> None:
    """The refinement's control (``INIT`` or ``ROUND`` with the round's
    f64 relative residual ``inp``), writing ``inner``'s tolerance."""
    inp = local(inp)
    if reg.f.device.type == "cpu":
        return refine_plain(phase, inp, reg, inner)
    if reg.f.device.type != "cuda" or inner.f.device != reg.f.device:
        raise ValueError(f"no loop-control kernel for {reg.f.device} / "
                         f"{inner.f.device}")
    lib = library()
    fn = (lib.fasp_loop_refine_f32 if inner.dtype == torch.float32
          else lib.fasp_loop_refine_f64)
    inp = inp.to(torch.float64).contiguous()
    err = fn(phase, inp.data_ptr(), reg.f.data_ptr(), reg.i.data_ptr(),
             inner.f.data_ptr(), reg.h_while,
             torch.cuda.current_stream(reg.f.device).cuda_stream)
    check(err, "loop_control refine launch")
    launches["refine"] += 1


def gmres(phase: int, inp: torch.Tensor, reg: Region, inner: Region,
          arr: torch.Tensor, R: int) -> None:
    """GMRES's control, phase ``phase`` (``INIT``, ``CYCLE``, ``ARNOLDI``,
    ``SOLVE``, ``RESTART``) over the restart cycles' region ``reg``, the
    Arnoldi steps' ``inner``, the window's arrays ``arr`` (window R) and
    the body's values ``inp`` (1-d, the regions' dtype; read by
    ``INIT``, ``ARNOLDI`` and ``RESTART`` only): the twin on the CPU, else
    the kernel, setting the outer WHILE handle at ``INIT`` and
    ``RESTART`` and the inner one at ``CYCLE`` and ``ARNOLDI``."""
    inp = _device_args(inp, reg)
    if (inner.f.device != reg.f.device or arr.device != reg.f.device
            or inner.dtype != reg.dtype or arr.dtype != reg.dtype
            or arr.numel() != gmres_arrays(R) or not arr.is_contiguous()):
        raise ValueError("GMRES control: regions and arrays differ in "
                         "device, dtype or window")
    if reg.f.device.type == "cpu":
        return gmres_plain(phase, inp, reg, inner, arr, R)
    if reg.f.device.type != "cuda":
        raise ValueError(f"no loop-control kernel for device {reg.f.device}")
    if reg.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"loop control takes f32/f64, got {reg.dtype}")
    lib = library()
    fn = (lib.fasp_loop_gmres_f32 if reg.dtype == torch.float32
          else lib.fasp_loop_gmres_f64)
    h = (reg.h_while if phase in (INIT, RESTART)
         else inner.h_while if phase in (CYCLE, ARNOLDI) else 0)
    err = fn(phase, inp.data_ptr(), reg.f.data_ptr(), reg.i.data_ptr(),
             inner.i.data_ptr(), arr.data_ptr(), R, h,
             torch.cuda.current_stream(reg.f.device).cuda_stream)
    check(err, "loop_control gmres launch")
    launches["gmres"] += 1


def gcr(phase: int, inp: torch.Tensor, reg: Region, inner: Region,
        R: int) -> None:
    """GCG / GCR's control, phase ``phase`` (``INIT``, ``CYCLE``,
    ``STEP``, ``END``) over the restart cycles' region ``reg``, the
    descent steps' ``inner`` (window R) and the body's values ``inp``
    (1-d, the regions' dtype; read by ``INIT``, ``STEP`` and ``END``):
    the twin on the CPU, else the kernel, setting the outer WHILE handle
    at ``INIT`` and ``END`` and the inner one at ``CYCLE`` and ``STEP``."""
    inp = _device_args(inp, reg)
    if inner.f.device != reg.f.device or inner.dtype != reg.dtype:
        raise ValueError("GCR control: regions differ in device or dtype")
    if reg.f.device.type == "cpu":
        return gcr_plain(phase, inp, reg, inner, R)
    if reg.f.device.type != "cuda":
        raise ValueError(f"no loop-control kernel for device {reg.f.device}")
    if reg.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"loop control takes f32/f64, got {reg.dtype}")
    lib = library()
    fn = (lib.fasp_loop_gcr_f32 if reg.dtype == torch.float32
          else lib.fasp_loop_gcr_f64)
    h = reg.h_while if phase in (INIT, END) else inner.h_while
    err = fn(phase, inp.data_ptr(), reg.f.data_ptr(), reg.i.data_ptr(),
             inner.i.data_ptr(), R, h,
             torch.cuda.current_stream(reg.f.device).cuda_stream)
    check(err, "loop_control gcr launch")
    launches["gcr"] += 1


def launch_empty(device) -> None:
    """One launch of an empty one-thread kernel: the floor a control
    launch sits on (a measurement aid, not counted)."""
    check(library().fasp_loop_empty(
        torch.cuda.current_stream(device).cuda_stream), "empty launch")


def chain_probe(kind: int, n: int, v: torch.Tensor) -> None:
    """One launch of the kernel source's ``chain_probe`` on a warp: ``n``
    dependent links of the arnoldi phase's rotation chain (kind 0) or of
    the solve's step (kind 1) on v = {x, c, s, d, out} (five float64 on
    the card).  A measurement aid, not counted: its time against n = 0
    is the card's latency per link."""
    if v.device.type != "cuda" or v.dtype != torch.float64 or v.numel() < 5:
        raise ValueError("chain_probe takes five float64 on the card")
    stream = torch.cuda.current_stream(v.device).cuda_stream
    check(library().fasp_loop_chain_probe(kind, n, v.data_ptr(), stream),
          "chain probe launch")
