"""The lMVU benchmark harness (port of ``faspsolver_tpu/benchmark``)."""
from .harness import BenchResult, compute_lmvu, run_benchmark, score_problem

__all__ = ["BenchResult", "compute_lmvu", "run_benchmark", "score_problem"]
