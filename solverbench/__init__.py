"""The benchmark of the PyTorch/CUDA port ``faspsolver_tpu_torch``.

``python3 solverbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA device and
prints one JSON line.  See ``README.md`` for the layout of the files the
harness finds by name.
"""
