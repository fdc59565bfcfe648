"""Run one cell of the port's benchmark on the CUDA device and print its
result as the last line of standard output:

    python3 solverbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

It runs from the root of a checkout, exits with code 1 and prints no
result where there is no CUDA device, fewer devices than the cell asks
for, or the program is missing; and where, once the window has closed,
JAX, its libraries or the JAX package are loaded in this process."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache a library could write lives inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(HERE, ".cache", sub))
    sys.path.insert(0, ROOT)
    from solverbench import catalog
    cell = catalog.cell(catalog.benchmark(ROOT), args.workload,
                        bool(args.trace))
    import torch
    if not torch.cuda.is_available():
        print("solverbench: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"solverbench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    from solverbench import harness
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"solverbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
