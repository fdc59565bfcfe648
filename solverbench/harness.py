"""One run of one cell: set-up, the measured window, the traced stretch,
the per-layer readers and the check.

Set-up, in order: the matrix from the frozen generator (cached inside
the checkout), the program's setup, the pool of right-hand sides, one
cold solve (the graphs' capture) and one warm solve.  The window is a
closed loop with one caller and no think time: each request is the next
b of the pool, solved by the program with b and x on the host.  With
``traced`` the last ``trace_seconds`` of the window run under the
profiler and the per-layer metrics are read; otherwise the end-to-end
metrics are.  The device's memory peak is the program's from the cold
solve to the window's end: the peak is reset once the pool is made."""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from solverbench import catalog, check, reference, rhs, tracing

CACHE = os.path.join(catalog.HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "faspsolver_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def problem(config: dict, here: str = catalog.HERE, cache: str = CACHE):
    """The configuration's matrix, from its generator or from the cache
    kept under the configuration's name and a hash of the generator's
    source and parameters."""
    from solverbench.problems import FIELDS, Problem
    spec = config["problem"]
    gen = catalog.module("problems", spec["generator"], here)
    with open(gen.__file__, "rb") as f:
        key = hashlib.sha256(f.read() + json.dumps(
            spec["params"], sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(cache, f"{config['name']}-{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return Problem(*(z[k] for k in FIELDS))
    p = gen.build(**spec["params"])
    os.makedirs(cache, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **{k: getattr(p, k) for k in FIELDS})
    os.replace(tmp, path)
    return p


class Run:
    """What one run measured: the record the metric readers read."""

    def __init__(self, device, kind: str, card: str):
        self.device, self.kind, self.card = device, kind, card
        self.setup_s = self.amg_setup_s = self.capture_s = None
        self.latencies, self.rounds, self.iters = [], [], []
        self.untraced = None        # solves before the profiler started
        self.window_s = 0.0
        self.unconverged = 0
        self.window_counters = {}
        self.trace: Optional[tracing.Summary] = None
        self.system = self.sample = None
        self.extra = {}

    def sample_x(self) -> np.ndarray:
        """One x the window produced (the first kept)."""
        return self.sample.kept[0][1]


def smi(device, fields: str) -> str:
    """nvidia-smi's reading of ``fields`` for the card, or "" where it
    does not answer."""
    import shutil
    import subprocess
    exe = shutil.which("nvidia-smi")
    if device.type != "cuda" or not exe:
        return ""
    try:
        return subprocess.run(
            [exe, f"--query-gpu={fields}", "--format=csv,noheader", "-i",
             str(device.index or 0)], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def card_line(device) -> tuple:
    """(the device's name, nvidia-smi's name and power limit, or the name
    alone where it does not answer)."""
    if device.type != "cuda":
        return "cpu", "cpu"
    kind = torch.cuda.get_device_name(device)
    return kind, smi(device, "name,power.limit") or kind


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stretch:
    """The traced stretch: the profiler running, with the window's span
    open, until :meth:`stop` hands back its records."""

    def __init__(self, device, spans):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device, self.spans = device, spans
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.region = torch.profiler.record_function(tracing.WINDOW)
        self.region.__enter__()
        spans.tracing = True
        self.t0 = time.perf_counter()

    def stop(self) -> list:
        self.region.__exit__(None, None, None)
        _sync(self.device)
        self.prof.stop()
        self.spans.tracing = False
        return tracing.events(self.prof)


def window(run, spans, pool, seconds: float, trace_seconds: float) -> None:
    """The closed loop: solve the pool's b's in turn until ``seconds``
    have passed; with ``trace_seconds`` above 0, the profiler starts at
    the first solve after ``seconds - trace_seconds`` and the window
    runs on until it has traced ``trace_seconds`` (starting the profiler
    takes seconds on the card: a traced run's window is that longer)."""
    trace_from = seconds - trace_seconds if trace_seconds > 0 else None
    stretch = None
    run.system.reset_counters()
    i = 0
    t_start = end = time.perf_counter()
    while end - t_start < seconds or (
            stretch is not None and end - stretch.t0 < trace_seconds):
        if trace_from is not None and end - t_start >= trace_from:
            run.untraced = len(run.latencies)
            stretch, trace_from = Stretch(run.device, spans), None
        with spans.span("pick_b"):
            b = pool[i % len(pool)]
        with spans.span("solve"):
            t0 = time.perf_counter()
            ans = run.system.solve(b)
            end = time.perf_counter()
        run.latencies.append(end - t0)
        run.rounds.append(ans.rounds)
        run.iters.append(ans.iters)
        run.unconverged += not ans.converged
        run.sample.offer((b, ans.x))
        i += 1
    run.window_s = end - t_start
    run.window_counters = run.system.counters()
    if stretch is not None:
        run.extra["trace_events"] = stretch.stop()


def run_cell(cell: "catalog.Cell", seed: int, seconds: float, traced: bool,
             device, t_process: float, here: str = catalog.HERE,
             cache: str = CACHE) -> dict:
    """Run ``cell`` once on ``device`` and return the result line's
    object.  ``t_process`` is the host clock at the process's start."""
    device = torch.device(device)
    config, mix = cell.config, cell.traffic
    if mix.get("loop") != "closed" or int(mix.get("callers", 1)) != 1:
        raise ValueError("the harness drives a closed loop of one caller")
    kind, card = card_line(device)
    run = Run(device, kind, card)
    spans = tracing.Spans()
    entry = catalog.module("entries", config["solver"]["entry"], here)

    with spans.span("generate"):
        prob = problem(config, here, cache)
    with spans.span("setup"):
        run.system = entry.setup(prob, config["solver"], device)
    run.amg_setup_s = run.system.setup_s
    with spans.span("generate"):
        pool = rhs.pool(prob, mix, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    with spans.span("capture"):
        run.system.reset_counters()
        run.system.solve(pool[0])
        _sync(device)
        run.capture_s = run.system.counters()["capture_s"]
    with spans.span("warm"):
        run.system.solve(pool[1 % len(pool)])
        _sync(device)
    run.sample = check.Sample(int(mix["check_sample"]), seed)
    run.setup_s = time.perf_counter() - t_process

    window(run, spans, pool, seconds,
           float(mix["trace_seconds"]) if traced else 0.0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    metrics_mods = [(m, catalog.module("metrics", m["name"], here))
                    for m in cell.metrics]
    if traced:
        evs = run.extra.pop("trace_events", [])
        log(f"trace: {len(evs)} records, "
            f"{sum(e.device for e in evs)} of the device")
        run.trace = tracing.summarize(evs)
        for _, mod in metrics_mods:
            if hasattr(mod, "measure"):
                mod.measure(run)

    xs = [x for _, x in run.sample.kept]
    outputs = check.operator_outputs(run.system, xs, device)
    run.system.close()
    run.system = None
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        correct, checks = check.judge(config, reference.Ell(prob, device),
                                      run.sample.kept, outputs,
                                      run.unconverged)
    metrics = {}
    for m, mod in metrics_mods:
        v = mod.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(run.latencies),
           "failed": run.unconverged, "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    lat = sorted(run.latencies)
    quarter = max(1, len(run.latencies) // 4)
    log(f"card: {card}; after the window "
        f"{smi(device, 'clocks.sm,clocks.mem,power.draw,temperature.gpu')}")
    log(f"latency ms: min {1e3 * lat[0]:.3f}, median "
        f"{1e3 * lat[len(lat) // 2]:.3f}, max {1e3 * lat[-1]:.3f}; mean "
        "by quarter of the window "
        + ", ".join(f"{1e3 * sum(q) / len(q):.3f}" for q in (
            run.latencies[i:i + quarter]
            for i in range(0, len(run.latencies), quarter)) if q)
        + f"; graph nodes {run.window_counters.get('nodes_replayed')}")
    log(f"set-up {run.setup_s:.4f} s (program setup "
        f"{run.amg_setup_s:.4f} s, capture {run.capture_s:.4f} s); window "
        f"{run.window_s:.4f} s, {len(run.latencies)} solves, rounds "
        f"{sorted(set(run.rounds))}, inner iterations "
        f"{min(run.iters)}-{max(run.iters)}; spans "
        + ", ".join(f"{n} {spans.total(n):.4f} s" for n in
                    ("generate", "setup", "capture", "warm", "pick_b",
                     "solve")))
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, its libraries'
    or the JAX package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
