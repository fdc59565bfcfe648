#!/usr/bin/env python3
"""Sweep the tile constants of the port's CUDA stencil kernel on one GPU.

    python3 tools/stencil2d_tune.py                     # the built-in list
    python3 tools/stencil2d_tune.py 128,8,2,4,2,2 64,8,4,4,4,2
                  # TX,R,NTY,BLOCKS_PER_SM,MIN_BLOCKS f32,MIN_BLOCKS f64

For each set of constants it rebuilds ``faspsolver_tpu_torch/csrc/stencil2d.cu``
with those constants (``ops/stencil2d.py`` hands them to nvcc as -D
flags), prints what ptxas reports, holds the kernel against the plain
version on a ragged grid and the main paths' shapes, and times one apply
(CUDA-graph replay, CUDA events) of: the 1023^2 5-point operator in the
factored form the solver's fine level carries, f32 and f64; the 341^2
9-point factored f32 operator; the 1023^2 5-point full-band and scalar
f32 operators; and the 8192^2 scalar 5-point f32 stencil beside the 1-band stream probe.
All geometries run in one process on one card, so their times compare.
The constants in ``ops/stencil2d.py`` are the winner of this sweep.
"""
from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

GEOMS = [(128, 8, 2, 4, 1, 1), (128, 8, 2, 4, 2, 2), (128, 8, 2, 4, 4, 2),
         (128, 8, 2, 4, 4, 3), (128, 8, 2, 4, 3, 3), (128, 8, 2, 4, 3, 2),
         (128, 8, 2, 2, 2, 2), (128, 4, 2, 4, 4, 3), (128, 16, 1, 4, 4, 3),
         (64, 8, 4, 4, 4, 3)]


def main(argv) -> int:
    import numpy as np
    import torch
    from faspsolver_tpu_torch.ops import stencil2d
    from faspsolver_tpu_torch.utils.build import BUILD_LOG
    if not torch.cuda.is_available():
        print("stencil2d_tune: no CUDA device available", file=sys.stderr)
        return 1
    geoms = [tuple(int(v) for v in a.split(",")) for a in argv] or GEOMS
    smi = chip_smoke.card_info(torch)
    coefs5 = (-0.2499, -0.2499, 0.99999, -0.2499, -0.2499)
    c5 = chip_smoke.coords_5pt()
    table = []
    for tx, r, nty, bps, mb32, mb64 in geoms:
        (stencil2d.TX, stencil2d.R, stencil2d.NTY,
         stencil2d.BLOCKS_PER_SM) = tx, r, nty, bps
        stencil2d.MIN_BLOCKS = {4: mb32, 8: mb64}
        stencil2d._lib = None
        print(f"== TX {tx}, R {r}, NTY {nty} (tile {r * nty} x {tx}, "
              f"{tx * nty} threads), grid of {bps} blocks per SM, register "
              f"cap for {mb32} (f32) / {mb64} (f64) blocks per SM")
        stencil2d.library()
        log = BUILD_LOG["stencil2d"][2]
        chip_smoke.print_ptxas(log, fail_on_spill=False)
        spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                               log))
        chip_smoke.check_kernel(torch, "cuda")
        rng = np.random.default_rng(chip_smoke.SEED)
        ops = [(f"1023^2 {dt} factored 5-pt",
                chip_smoke.make_op("factored", (1023, 1023), c5, dt,
                                   rng).to("cuda")) for dt in ("f32", "f64")]
        ops.append(("341^2 f32 factored 9-pt", chip_smoke.make_op(
            "factored", (341, 341), chip_smoke.coords_9pt(), "f32",
            rng).to("cuda")))
        ops.append(("1023^2 f32 full 5-pt", chip_smoke.make_op(
            "full", (1023, 1023), c5, "f32", rng).to("cuda")))
        ops.append(("1023^2 f32 scalar 5-pt", chip_smoke.scalar_op(
            torch, (1023, 1023), c5, coefs5, torch.float32)))
        rows = chip_smoke.apply_times(torch, ops, smi, eager=False)
        del ops
        rows.update(chip_smoke.apply_times(torch, [
            ("8192^2 f32 scalar 5-pt", chip_smoke.scalar_op(
                torch, (8192, 8192), c5, coefs5, torch.float32)),
            ("8192^2 f32 stream probe", chip_smoke.scalar_op(
                torch, (8192, 8192), ((0, 1),), (0.9995,), torch.float32))],
            smi, reps=10, tries=3, eager=False))
        torch.cuda.empty_cache()
        table.append(((tx, r, nty, bps, mb32, mb64), spill, rows))
    print(f"== kernel us per apply by (TX, R, NTY, BLOCKS_PER_SM, MIN_BLOCKS "
          f"f32, f64), with the bytes ptxas spilled; {smi}")
    for g, spill, rows in table:
        print(f"  {g} spill {spill}: " + ", ".join(f"{label} {row['ms'] * 1e3:.2f}"
                                     for label, row in rows.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
