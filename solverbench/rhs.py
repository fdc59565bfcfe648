"""The one traffic generator: a pool of right-hand sides from ``--seed``,
made on the run's device with a ``torch.Generator``, one call per b.

Each right-hand side is the source problem's own b (``Problem.rhs``: the
FD Poisson's b = A 1, the FE Poisson's load vector of f = 1) plus white
noise of ``perturb`` times that b's root mean square, drawn from
``--seed``.  The noise makes every b of the pool, and of every seed,
distinct; it is small enough that each takes the rounds and inner
iterations of the source's own b, so the work does not change with
``--seed`` (``readings.py`` prints both)."""
from __future__ import annotations

import numpy as np
import torch

SEED_MOD = 1 << 63              # torch.Generator takes 64 bits


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MOD)
    return g


def pool(problem, mix: dict, seed: int, device) -> list:
    """The traffic's right-hand sides as host float64 arrays."""
    spec = mix["rhs"]
    f64 = torch.float64
    base = torch.as_tensor(problem.rhs, dtype=f64, device=device)
    scale = float(spec["perturb"]) * float(torch.sqrt(torch.mean(base * base)))
    g = generator(seed, device)
    out = []
    for _ in range(int(spec["pool"])):
        noise = torch.randn(base.shape, generator=g, dtype=f64, device=device)
        out.append(np.ascontiguousarray((base + scale * noise).cpu().numpy()))
    return out
