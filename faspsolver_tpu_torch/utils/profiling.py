"""Profiling and memory accounting (port of
``faspsolver_tpu/utils/profiling.py``).

Reference: wall-clock phase timers (AuxTiming.c / fasp_cputime) and
DEBUG-mode memory accounting (AuxMemory.c fasp_mem_usage).  Here:
``torch.profiler`` traces (Chrome trace JSON, viewable in Perfetto or
chrome://tracing) plus byte counts of the tensors a module tree holds.

Eager torch returns before the device finishes, so :func:`timed_phase`
synchronises the current CUDA device at both ends once CUDA is in use:
a phase time that left out the device work would be wrong.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch import nn


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace of the enclosed block (CPU activity, plus the CUDA
    device's when CUDA is in use) and write it into ``logdir`` as a
    Chrome trace, ``<host>_<pid>.<ms>.pt.trace.json``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _cuda_in_use():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (fasp_cputime-style labeled phases)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def timed_phase(label: str, results: dict = None) -> Iterator[None]:
    """Wall-clock phase timing (reference: fasp_gettime bracketing),
    added to ``results[label]``; the device's queued work is waited for
    at both ends."""
    if _cuda_in_use():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _cuda_in_use():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = results.get(label, 0.0) + dt


def _storages(tree) -> dict:
    """{(device, address): bytes} of every tensor storage reachable from
    ``tree`` through dicts, lists, tuples and modules (their parameters,
    buffers, submodules and other attributes): a storage that several
    tensors share (the transfers of a hierarchy reuse the level's A)
    appears once."""
    found, seen, todo = {}, set(), [tree]
    while todo:
        obj = todo.pop()
        if isinstance(obj, torch.Tensor):
            st = obj.untyped_storage()
            found[(str(obj.device), st.data_ptr())] = st.nbytes()
            continue
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, dict):
            todo.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            todo.extend(obj)
        elif isinstance(obj, nn.Module):
            todo.extend(obj.parameters(recurse=False))
            todo.extend(obj.buffers(recurse=False))
            todo.extend(obj.children())
            todo.extend(v for k, v in vars(obj).items()
                        if k not in ("_parameters", "_buffers", "_modules"))
    return found


def tree_nbytes(tree) -> int:
    """Total bytes of the distinct tensor storages in a module tree
    (reference: fasp_mem_usage accounting), e.g. the device footprint of
    an AMG hierarchy."""
    return sum(_storages(tree).values())


def memory_report(tree, label: str = "pytree") -> str:
    found = _storages(tree)
    return f"{label}: {sum(found.values()) / 1e6:.2f} MB across " \
           f"{len(found)} arrays"
