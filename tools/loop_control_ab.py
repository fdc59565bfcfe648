#!/usr/bin/env python3
"""Time the loop-control kernels built from this checkout against those
built from another tree's ``csrc/loop_control.cu`` (an earlier commit
unpacked with ``git archive``), in one process on one GPU, and count the
global-memory round trips in each build's SASS.

    python3 tools/loop_control_ab.py --other DIR [--sass-out DIR]

Both libraries are built with the same nvcc command (``utils/loops.py``)
and swapped in turn under the same wrappers.  Timed, each as a CUDA graph
of 200 launches (CUDA events, best of 5), in turns other, this, this,
other, twice (the card's times drift within a process): PCG's check
(f32, the phase-3 case of ``chip_smoke.py``), GMRES's arnoldi phase at
j = R - 1 (less the graph's j reset) and its solve at j = R for R = 30
and 60 in f64; beside them an empty one-thread kernel and
``torch.linalg.solve_triangular`` on the same R x R triangle.  The
arnoldi phase's column and g must come out bit-equal in both builds (its
arithmetic is the same); the solves' y within 1e-12 of each other
(their orders differ).

The SASS of each build (``cuobjdump --dump-sass``) is written under
``--sass-out`` (default ``chiprun_out/``) and summarised per kernel: its
global loads (LDG) and stores (STG), and its round trips: the places
where an instruction reads a register that a global load still in flight
writes, counted down the listing (every earlier load taken as done
there).  Phases that are branches of one kernel add up.  Prints one JSON
line last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

LOAD = re.compile(r"^(LDG|LD)\b")
REG = re.compile(r"\bR(\d+)\b")


def sass_summary(text: str) -> dict:
    """Per kernel of a ``cuobjdump --dump-sass`` listing: LDG, STG and
    round trips, as the module docstring counts them."""
    out, name, rows = {}, None, []

    def close():
        if name is not None:
            out[name] = _count(rows)

    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, rows = chip_smoke.demangle(m.group(1)), []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            rows.append(re.sub(r"^@!?U?P\w+\s+", "", m.group(1)))
    close()
    return out


def _regs(operand: str, wide: bool):
    """The registers an operand names (a 64-bit one names two)."""
    regs = {int(r) for r in REG.findall(operand)}
    return regs | {r + 1 for r in regs} if wide else regs


def _count(rows) -> dict:
    loads = stores = trips = 0
    pending = set()
    for ins in rows:
        op, _, rest = ins.partition(" ")
        args = [a.strip() for a in rest.split(",")] if rest else []
        wide = ".64" in op or ".128" in op
        if LOAD.match(op):
            loads += op.startswith("LDG")
            if pending & set().union(*(_regs(a, False) for a in args[1:])):
                trips, pending = trips + 1, set()     # an address it waits for
            if op.startswith("LDG") and args:
                pending |= _regs(args[0], wide)
            continue
        stores += op.startswith("STG")
        used = set().union(*(_regs(a, False) for a in args)) if args else set()
        if pending & used:
            trips, pending = trips + 1, set()
    return {"LDG": loads, "STG": stores, "round_trips": trips}


def sass(lib_path: str, tag: str, out_dir: str) -> dict:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(cuda, "bin", "cuobjdump")
    text = subprocess.run([tool, "--dump-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"loop_control_{tag}.sass"), "w") as f:
        f.write(text)
    return sass_summary(text)


class _Present:
    """A loaded library as ``loops.bind`` sees it: an entry point the
    build lacks (an older source) takes its declaration into a throwaway
    namespace, and is never called."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return types.SimpleNamespace()


def builds(other_dir: str):
    """(this build, the other tree's build), each a bound library."""
    from faspsolver_tpu_torch.utils import loops
    from faspsolver_tpu_torch.utils.build import BUILD_LOG, build_shared
    src = os.path.join(other_dir, "faspsolver_tpu_torch", "csrc",
                       "loop_control.cu")
    other = build_shared("loop_control_other", [src], loops._nvcc)
    this = loops.library()
    return ((this, BUILD_LOG["loop_control"][0]),
            (loops.bind(_Present(ctypes.CDLL(other))), other))


def times(torch, device) -> dict:
    """The timed launches through whatever library ``loops`` holds, and
    the arnoldi and solve outputs."""
    from faspsolver_tpu_torch.utils import loops
    row, outs = {}, {}
    blk = loops.Block(device, [("pcg", torch.float32)])
    blk.upload({"pcg": loops.krylov_values(**{**chip_smoke.LOOP_KRYLOV,
                                              "maxit": 10 ** 9})})
    inp = torch.tensor([2.0, 0.5, 0.3, 0.1, 0.04, 1.0], device=device)
    row["pcg_check_ms"] = chip_smoke.time_ms(
        torch, lambda x: loops.control("pcg", loops.CHECK, x, blk["pcg"]),
        inp, graph=True)
    for R in (30, 60):
        name = f"gmres window {R}"
        _, reg, inner, arr, R = chip_smoke.gmres_case_state(
            torch, name, torch.float64, device)
        seq = chip_smoke.GMRES_CASES[name][1]
        for phase, vals in seq[:R + 1]:
            loops.gmres(phase, torch.tensor(vals or [0.0], device=device,
                                            dtype=torch.float64),
                        reg, inner, arr, R)
        col = torch.tensor(seq[R + 1][1], dtype=torch.float64, device=device)
        j = reg.i[loops.I.J:loops.I.J + 1]
        j0 = j.clone()

        def arnoldi(x, reg=reg, inner=inner, arr=arr, R=R, j=j, j0=j0):
            j.copy_(j0)
            loops.gmres(loops.ARNOLDI, x, reg, inner, arr, R)

        reset = chip_smoke.time_ms(torch, lambda x: j.copy_(j0), col,
                                   graph=True)
        row[f"arnoldi_{R}_ms"] = chip_smoke.time_ms(
            torch, arnoldi, col, graph=True) - reset
        arnoldi(col)                                   # j = R
        outs[f"arnoldi_{R}"] = arr[:(R + 1) * (R + 1)].clone()
        row[f"solve_{R}_ms"] = chip_smoke.time_ms(
            torch, lambda x: loops.gmres(loops.SOLVE, x, reg, inner, arr, R),
            col, graph=True)
        outs[f"solve_{R}"] = arr[-R:].clone()
        H, g, *_ = loops.gmres_views(arr, R)
        Ht, gt = H[:R, :R].contiguous(), g[:R, None].contiguous()
        row[f"solve_{R}_library_ms"] = chip_smoke.time_ms(
            torch, lambda x: torch.linalg.solve_triangular(Ht, gt, upper=True),
            None, graph=True)
    return row, outs


def main(argv) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="a tree holding faspsolver_tpu_torch/csrc/"
                         "loop_control.cu")
    ap.add_argument("--sass-out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("loop_control_ab: no CUDA device available", file=sys.stderr)
        return 1
    from faspsolver_tpu_torch.utils import loops
    device = torch.device("cuda")
    smi = chip_smoke.card_info(torch)
    (this, this_path), (other, other_path) = builds(args.other)
    summary = {"this": sass(this_path, "this", args.sass_out),
               "other": sass(other_path, "other", args.sass_out)}
    for tag in ("other", "this"):
        for kernel, c in sorted(summary[tag].items()):
            print(f"  SASS {tag}: {kernel}: {c}")
    runs, outs = {"other": [], "this": []}, {}
    for tag in ("other", "this", "this", "other") * 2:
        loops._lib = this if tag == "this" else other
        r, outs[tag] = times(torch, device)
        runs[tag].append(r)
    loops._lib = this
    best = {tag: {k: min(r[k] for r in rs) for k in rs[0]}
            for tag, rs in runs.items()}
    for R in (30, 60):
        chip_smoke.check(torch.equal(outs["this"][f"arnoldi_{R}"],
                                     outs["other"][f"arnoldi_{R}"]),
                         f"arnoldi R = {R}: both builds bit-equal")
        diff = float((outs["this"][f"solve_{R}"] - outs["other"][f"solve_{R}"]
                      ).abs().max())
        chip_smoke.check(diff <= 1e-12, f"solve R = {R}: |dy| {diff}")
    best["this"]["empty_ms"] = chip_smoke.time_ms(
        torch, lambda x: loops.launch_empty(device), None, graph=True)
    for k in best["other"]:
        print(f"  {k}: other {best['other'][k] * 1e3:.3f} us, this "
              f"{best['this'][k] * 1e3:.3f} us")
    print(f"  empty one-thread kernel {best['this']['empty_ms'] * 1e3:.3f} us;"
          f" {smi}")
    print(json.dumps({"card": smi, "best": best, "runs": runs,
                      "sass": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
