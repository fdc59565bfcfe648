"""The port's profiling helpers against the JAX package's
(``utils/profiling.py``): phase timing, byte counts, the memory report's
format, and a trace that holds an annotated region."""
import glob
import json
import time

import jax.numpy as jnp
import numpy as np
import torch

import faspsolver_tpu.utils.profiling as jax_profiling
from faspsolver_tpu_torch.precond.amg import setup_structured
from faspsolver_tpu_torch.testgen import poisson_2d
from faspsolver_tpu_torch.utils import profiling
from faspsolver_tpu_torch.utils.params import AMGParam

torch.set_num_threads(2)


def _phases(mod):
    results = {}
    for label in ("setup", "solve", "setup"):
        with mod.timed_phase(label, results):
            time.sleep(0.01)
    with mod.timed_phase("unrecorded"):
        pass
    return results


def test_timed_phase_accumulates_as_jax_does():
    got, ref = _phases(profiling), _phases(jax_profiling)
    assert list(got) == list(ref) == ["setup", "solve"]
    assert got["setup"] >= 0.02 and 0.01 <= got["solve"] < got["setup"]


def test_tree_nbytes_counts_each_storage_of_a_hierarchy_once():
    hier = setup_structured(poisson_2d(24), AMGParam(coarse_dof=60),
                            dtype=torch.float64, smooth_p=True)
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in hier.buffers()}
    assert profiling.tree_nbytes(hier) == sum(storages.values()) > 0
    # a tree that holds the hierarchy twice, beside a view of one of its
    # tensors, holds no more storage
    b0 = next(hier.buffers())
    assert profiling.tree_nbytes([hier, {"again": hier, "view": b0[1:]}]) \
        == profiling.tree_nbytes(hier)


def test_tree_nbytes_counts_a_shared_tensor_once():
    t = torch.zeros(100, dtype=torch.float64)
    mod = torch.nn.Module()
    mod.register_buffer("t", t)
    mod.alias = t[10:]                     # a tensor attribute, same storage
    mod.own = torch.zeros(5, dtype=torch.float32)
    tree = {"a": t, "b": (t, [mod])}
    assert profiling.tree_nbytes(tree) == 800 + 20
    assert profiling.memory_report(tree, "x") == \
        "x: 0.00 MB across 2 arrays"


def test_memory_report_has_the_jax_format():
    port = {"a": torch.zeros(250_000, dtype=torch.float64),
            "b": [torch.zeros((300, 300), dtype=torch.float32)]}
    ref = {"a": jnp.zeros(250_000, dtype=jnp.float64),
           "b": [jnp.zeros((300, 300), dtype=jnp.float32)]}
    assert profiling.memory_report(port, "hier") == \
        jax_profiling.memory_report(ref, "hier") == \
        "hier: 2.36 MB across 2 arrays"
    assert profiling.memory_report(port) == jax_profiling.memory_report(ref)


def test_trace_writes_a_trace_holding_the_annotated_region(tmp_path):
    x = torch.from_numpy(np.arange(1000.0))
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("fasp_setup_phase"):
            y = (x * 2).sum()
    assert float(y) == 999_000.0
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "fasp_setup_phase" for e in events)
