"""Locate where the f32 refined mode's first round differs between the
card and the host on the harness's fdm2d row.

The harness's f32 mode (``benchmark/harness.py:_refined_factory``) runs
f64 refinement around f32 RS-AMG-preconditioned vGMRES(60).  This script
runs the first refinement round with chosen parts of the inner solve on
the CPU and the rest on the card, then judges the first-round iterate by
the round that follows it (pure card, ``maxit`` 100): how many inner
iterations it needs and where its true f32 residual ends.

    python3 tools/f32_refine_probe.py [n] [--out DIR]

Parts: ``op`` (the Krylov operator), ``M`` (the whole preconditioner),
``krylov`` (the Krylov vectors, dots and updates), and inside the
preconditioner ``smoother``, ``levels`` (the level operators),
``transfers``, ``coo`` (the COO transfers only) and ``coarse``;
``deterministic`` runs it all on the card under
``torch.use_deterministic_algorithms``.  ``--compare`` holds the card's
hierarchy to its host twin part by part; ``--orders`` (any ``--device``)
runs rounds 1 and 2 with the GS row sums added in several orders;
``--widths [--3d]`` prints the GS colors' row widths per level and the
adds a left-to-right row sum costs (CPU only).  Prints
one line per variant and writes the first-round corrections of the
all-card and all-CPU variants as ``.npy`` files under ``--out``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from faspsolver_tpu_torch.krylov import vgmres                  # noqa: E402
from faspsolver_tpu_torch.ops import device_operator            # noqa: E402
from faspsolver_tpu_torch.precond import AMGPrecond             # noqa: E402
from faspsolver_tpu_torch.precond.amg import cycles, setup_rs   # noqa: E402
from faspsolver_tpu_torch.precond.amg.transfer import (         # noqa: E402
    BandedProlong, BandedRestrict, CooProlong, CooRestrict)
from faspsolver_tpu_torch.precond.amg.hierarchy import (        # noqa: E402
    CoarseSolver, IterativeCoarseSolver)
from faspsolver_tpu_torch.testgen import poisson_2d             # noqa: E402
from faspsolver_tpu_torch.utils.params import AMGParam          # noqa: E402

F32 = torch.float32


class Routed:
    """``fn`` called with its arguments moved to ``src`` and its result
    moved to ``dst``; keeps ``fn``'s shape for the Krylov loop."""

    def __init__(self, fn, src, dst, shape=None):
        self.fn, self.src, self.dst = fn, src, dst
        self.shape = shape if shape is not None else getattr(fn, "shape",
                                                              None)

    def __call__(self, *args):
        return self.fn(*[a.to(self.src) for a in args]).to(self.dst)


class Hybrid:
    """The card's inner solve with chosen parts routed to host twins."""

    def __init__(self, A, dev):
        self.dev = dev
        self.h_dev = setup_rs(A, AMGParam(), dtype=F32, device=dev)
        self.h_cpu = setup_rs(A, AMGParam(), dtype=F32, device="cpu")
        self.op_dev = device_operator(A, dtype=F32).to(dev)
        self.op_cpu = device_operator(A, dtype=F32)
        mods_d = list(self.h_dev.modules())
        mods_c = list(self.h_cpu.modules())
        assert [type(m) for m in mods_d] == [type(m) for m in mods_c]
        self.twin = {id(d): c for d, c in zip(mods_d, mods_c)}
        self.M_dev, self.M_cpu = AMGPrecond(self.h_dev), AMGPrecond(self.h_cpu)
        self._smooth = cycles.smooth

    def _on_cpu(self, fn):
        return Routed(fn, "cpu", self.dev)

    def route(self, parts):
        """Patch the card hierarchy so that ``parts`` run on the host."""
        kinds = {"levels": (type(self.h_dev.levels[0].A),
                            type(self.h_dev.levels[1].A)),
                 "transfers": (BandedProlong, BandedRestrict, CooProlong,
                               CooRestrict),
                 "coo": (CooProlong, CooRestrict),
                 "coarse": (CoarseSolver, IterativeCoarseSolver)}
        for m in self.h_dev.modules():
            m.__dict__.pop("forward", None)
            if any(isinstance(m, kinds[p]) for p in parts if p in kinds):
                m.forward = self._on_cpu(self.twin[id(m)])
        cycles.smooth = self._smooth
        if "smoother" in parts:
            twin, orig, dev = self.twin, self._smooth, self.dev

            def smooth(sm, A, x, b, n, forward):
                return orig(twin[id(sm)], twin.get(id(A), A), x.cpu(),
                            b.cpu(), n, forward).to(dev)
            cycles.smooth = smooth

    def inner(self, parts):
        """(op, M, vector device) of the first round's solve."""
        torch.use_deterministic_algorithms("deterministic" in parts,
                                           warn_only=True)
        if "all" in parts:
            return self.op_cpu, self.M_cpu, "cpu"
        self.route(parts)
        op = self._on_cpu(self.op_cpu) if "op" in parts else self.op_dev
        M = self._on_cpu(self.M_cpu) if "M" in parts else self.M_dev
        if "krylov" in parts:
            return (Routed(op, self.dev, "cpu", self.op_dev.shape),
                    Routed(M, self.dev, "cpu"), "cpu")
        return op, M, self.dev


def compare(A, dev):
    """Hold the card's hierarchy to its host twin part by part: the
    buffers, one smoothing call per level and direction, and M."""
    from faspsolver_tpu_torch.precond.amg.smoothers import smooth
    h1 = setup_rs(A, AMGParam(), dtype=F32, device="cpu")
    h2 = setup_rs(A, AMGParam(), dtype=F32, device="cpu")
    hd = setup_rs(A, AMGParam(), dtype=F32, device=dev)
    same_setup = all(torch.equal(a, b) for a, b in
                     zip(h1.buffers(), h2.buffers()))
    same_move = all(torch.equal(a.cpu(), b) for a, b in
                    zip(hd.buffers(), h1.buffers()))
    print(f"setup repeatable {same_setup}, card buffers equal {same_move}, "
          f"{sum(1 for _ in h1.buffers())} buffers")
    rng = np.random.default_rng(0)

    def rel(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    for li, (lc, ld) in enumerate(zip(h1.levels, hd.levels)):
        if lc.smoother is None:
            continue
        n = lc.A.shape[0]
        x = torch.as_tensor(rng.standard_normal(n), dtype=F32)
        b = torch.as_tensor(rng.standard_normal(n), dtype=F32)
        out = []
        for fw in (True, False):
            yc = smooth(lc.smoother, lc.A, x, b, 1, fw)
            yd = smooth(ld.smoother, ld.A, x.to(dev), b.to(dev), 1, fw)
            out.append(rel(yd, yc))
        for ci, (cc, cd) in enumerate(zip(lc.smoother.colors,
                                          ld.smoother.colors)):
            e = rel(cd.offdiag(x.to(dev)), cc.offdiag(x))
            if e > 1e-5:
                out.append((ci, e))
        print(f"  level {li} {type(lc.A).__name__}({n}) smooth fwd / bwd "
              f"rel diff {out}")
    Mc, Md = AMGPrecond(h1), AMGPrecond(hd)
    n = A.nrow
    g = np.arange(n, dtype=np.float64)
    for name, v in (("random", rng.standard_normal(n)),
                    ("smooth", np.sin(np.pi * (g % 1023 + 1) / 1024)
                     * np.sin(np.pi * (g // 1023 + 1) / 1024))):
        v = torch.as_tensor(v, dtype=F32)
        print(f"  M({name}) rel diff {rel(Md(v.to(dev)), Mc(v)):.3e}")


def _orders():
    """Row-sum orders for the GS sweeps' ``ColorBlock.offdiag``."""
    from faspsolver_tpu_torch.precond.amg import smoothers

    def products(blk, x):
        g = x.index_select(0, blk.cols.reshape(-1)).reshape(blk.cols.shape)
        return blk.vals * g

    def halves(blk, x):      # (p0 + p2) + (p1 + p3): CUDA's sum of 4
        p = products(blk, x)
        while p.shape[1] > 1:
            if p.shape[1] % 2:
                p = torch.cat([p, torch.zeros_like(p[:, :1])], 1)
            h = p.shape[1] // 2
            p = p[:, :h] + p[:, h:]
        return p[:, 0]

    return {"row_sum": lambda blk, x: smoothers.row_sum(products(blk, x)),
            "torch.sum": lambda blk, x: products(blk, x).sum(dim=1),
            "halves": halves,
            "f64 accumulation": lambda blk, x: products(
                blk, x.double()).sum(dim=1).to(x.dtype)}


def orders(A, dev):
    """Rounds 1 and 2 of the f32 mode with the GS row sums in each of
    :func:`_orders`, all on ``dev``."""
    from faspsolver_tpu_torch.precond.amg import smoothers
    b = A.matvec(np.ones(A.nrow))
    bnorm = float(np.linalg.norm(b))
    h = setup_rs(A, AMGParam(), dtype=F32, device=dev)
    op, M = device_operator(A, dtype=F32).to(dev), AMGPrecond(h)
    real = smoothers.ColorBlock.offdiag
    scale = float(np.abs(b).max())
    try:
        for name, fn in _orders().items():
            smoothers.ColorBlock.offdiag = fn
            out1 = vgmres(op, torch.as_tensor(b / scale).to(dev, F32), M=M,
                          tol=5e-6, maxit=400, restart=60)
            x1 = scale * out1.x.cpu().to(torch.float64).numpy()
            r2 = b - A.matvec(x1)
            s2 = float(np.abs(r2).max())
            out2 = vgmres(op, torch.as_tensor(r2 / s2).to(dev, F32), M=M,
                          tol=1e-5, maxit=100, restart=60)
            print(f"{name:18s} r1 {out1.iters} its f64 "
                  f"{np.linalg.norm(r2) / bnorm:.4e} |e1| "
                  f"{np.linalg.norm(1.0 - x1):.4e} | r2 {out2.iters} its "
                  f"f32 {out2.relres:.4e}", flush=True)
    finally:
        smoothers.ColorBlock.offdiag = real


def widths(A):
    """Per level of the f32 RS hierarchy: GS colors, their widest row,
    and the elementwise adds per V-cycle (one sweep before, one after) a
    left-to-right row sum costs beyond ``sum(dim=1)``, over every row and
    with ``row_sum``'s cut."""
    from faspsolver_tpu_torch.precond.amg import smoothers
    h = setup_rs(A, AMGParam(), dtype=F32, device="cpu")
    every = cut = 0
    for li, lvl in enumerate(h.levels):
        if lvl.smoother is None:
            continue
        ks = [c.cols.shape[1] for c in lvl.smoother.colors]
        every += 2 * sum(k - 2 for k in ks if k > 2)
        cut += 2 * sum(k - 2 for k in ks
                       if 2 < k <= smoothers._ORDERED_WIDTH)
        print(f"  level {li} {lvl.A.shape[0]:8d} rows: {len(ks)} colors, "
              f"widest row {max(ks)}")
    print(f"adds per V-cycle beyond sum(dim=1): every row {every}, "
          f"row_sum {cut}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=1023)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", action="store_true",
                    help="hold the card's hierarchy to its host twin part "
                         "by part, then stop")
    ap.add_argument("--orders", action="store_true",
                    help="rounds 1 and 2 with the GS row sums in several "
                         "orders, all on --device, then stop")
    ap.add_argument("--widths", action="store_true",
                    help="GS color widths per level and the adds a "
                         "left-to-right row sum costs, then stop")
    ap.add_argument("--3d", dest="three_d", action="store_true",
                    help="with --widths: poisson_3d(n) in place of "
                         "poisson_2d(n)")
    args = ap.parse_args(argv)
    if args.widths:
        from faspsolver_tpu_torch.testgen import poisson_3d
        widths(poisson_3d(args.n) if args.three_d else poisson_2d(args.n))
        return 0
    dev = torch.device(args.device)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu")
    A = poisson_2d(args.n)
    b = A.matvec(np.ones(A.nrow))
    bnorm = float(np.linalg.norm(b))
    if args.compare:
        compare(A, dev)
        return 0
    if args.orders:
        orders(A, dev)
        return 0
    t0 = time.perf_counter()
    hy = Hybrid(A, dev)
    print(f"two hierarchies {time.perf_counter() - t0:.1f} s")
    scale = float(np.abs(b).max())
    rhs = b / scale

    variants = [("card",), ("card",), ("card",), ("all",), ("M",), ("op",),
                ("krylov",), ("smoother",), ("levels",), ("transfers",),
                ("coo",), ("coarse",), ("op", "M"), ("smoother", "levels"),
                ("smoother", "levels", "transfers", "coarse"),
                ("deterministic",)]
    lam = 2.0 * float(np.abs(A.diagonal()).max())     # >= lambda_max
    os.makedirs(args.out, exist_ok=True)
    for parts in variants:
        op, M, vdev = hy.inner(parts)
        r1 = torch.as_tensor(rhs).to(device=vdev, dtype=F32)
        t0 = time.perf_counter()
        out1 = vgmres(op, r1, M=M, tol=5e-6, maxit=400, restart=60)
        d1 = out1.x.cpu().to(torch.float64).numpy()
        x1 = scale * d1
        r2 = b - A.matvec(x1)
        rel1 = float(np.linalg.norm(r2)) / bnorm
        hy.route(())
        torch.use_deterministic_algorithms(False)
        s2 = float(np.abs(r2).max())
        out2 = vgmres(hy.op_dev, torch.as_tensor(r2 / s2).to(dev, F32),
                      M=hy.M_dev, tol=1e-5, maxit=100, restart=60)
        x2 = x1 + s2 * out2.x.cpu().to(torch.float64).numpy()
        rel2 = float(np.linalg.norm(b - A.matvec(x2))) / bnorm
        e1 = 1.0 - x1
        # how smooth the round-1 error is: its Rayleigh quotient
        # e'Ae / e'e over lambda_max (small = smooth)
        rq = float(e1 @ A.matvec(e1)) / max(float(e1 @ e1), 1e-300) / lam
        print(f"{'+'.join(parts):32s} r1 {out1.iters} its f32 "
              f"{out1.relres:.4e} f64 {rel1:.4e} |e1| "
              f"{np.linalg.norm(e1):.4e} RQ {rq:.4e} | r2 {out2.iters} its "
              f"f32 {out2.relres:.4e} f64 {rel2:.4e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if parts in (("card",), ("all",)):
            np.save(os.path.join(args.out, f"f32probe_d1_{parts[0]}.npy"),
                    out1.x.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
