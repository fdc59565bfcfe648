"""Print-level-gated logging, iteration traces, and timing.

Reference: base/src/AuxMessage.c (fasp_itinfo, fasp_cputime,
fasp_amgcomplexity, fasp_message) and base/src/AuxTiming.c (fasp_gettime).
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager

from ..constants import PrintLevel

_out = sys.stdout


def set_output(stream) -> None:
    """Redirect all library output (reference: output_type, test/main/test.c:54)."""
    global _out
    _out = stream


def gettime() -> float:
    """Wall-clock seconds (reference: fasp_gettime)."""
    return time.perf_counter()


def message(print_level: int, msg: str, level_needed: int = PrintLevel.MIN) -> None:
    if print_level >= level_needed:
        print(msg, file=_out)


def warn(msg: str) -> None:
    print(f"### WARNING: {msg}", file=_out)


def error_msg(msg: str) -> None:
    print(f"### ERROR: {msg}", file=_out)


def itinfo(print_level: int, stop_type: int, iteration: int,
           relres: float, absres: float, factor: float) -> None:
    """Per-iteration convergence table (reference: AuxMessage.c fasp_itinfo)."""
    if print_level < PrintLevel.SOME:
        return
    if iteration == 0:
        hdr = {1: "||r||/||b||", 2: "||r||_B/||b||_B", 3: "||r||/||x||"}
        print("-----------------------------------------------------------",
              file=_out)
        print(f"It Num | {hdr.get(stop_type, '||r||/||b||'):>15s} | "
              f"||r||      | Conv. Factor", file=_out)
        print("-----------------------------------------------------------",
              file=_out)
        print(f"{iteration:6d} | {relres:15.6e} | {absres:10.4e} |      -.--",
              file=_out)
    else:
        print(f"{iteration:6d} | {relres:15.6e} | {absres:10.4e} | {factor:10.4f}",
              file=_out)


def cputime(label: str, seconds: float) -> None:
    """Labeled timing report (reference: AuxMessage.c fasp_cputime)."""
    print(f"{label} costs {seconds:.4f} seconds.", file=_out)


def amg_complexity(print_level: int, num_rows, num_nnz) -> None:
    """Grid/operator complexity report (reference: fasp_amgcomplexity)."""
    if print_level < PrintLevel.SOME:
        return
    gc = sum(num_rows) / num_rows[0]
    oc = sum(num_nnz) / num_nnz[0]
    print("-----------------------------------------------------------",
          file=_out)
    print("  Level     Num of rows      Num of nonzeros", file=_out)
    print("-----------------------------------------------------------",
          file=_out)
    for lvl, (n, nnz) in enumerate(zip(num_rows, num_nnz)):
        print(f"{lvl:7d} {n:15d} {nnz:20d}", file=_out)
    print("-----------------------------------------------------------",
          file=_out)
    print(f"  Grid complexity = {gc:.3f}  |", f"Operator complexity = {oc:.3f}",
          file=_out)
    print("-----------------------------------------------------------",
          file=_out)


@contextmanager
def timed(label: str, print_level: int = 0):
    """Context manager: times a phase, prints if print_level > NONE."""
    t0 = gettime()
    box = {}
    try:
        yield box
    finally:
        box["seconds"] = gettime() - t0
        if print_level > PrintLevel.NONE:
            cputime(label, box["seconds"])
