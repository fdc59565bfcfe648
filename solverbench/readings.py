"""The readings that the limits of ``check.py`` are set from, on the
CUDA device at a cell's own size, in one process per cell:

    python3 solverbench/readings.py --workload <cell> --seconds <s> \\
        --seeds <n,n,...> --control-seeds <n,n,n>

First the source problem's own b, unperturbed, through the program (set
up once): its rounds and inner iterations, which every b of the traffic
should take too.  For each seed of ``--seeds``: a pool, a window of
``--seconds`` through the program, the rounds and inner iterations of
its solves, and the numbers ``check.judge`` compares.
For each seed of ``--control-seeds``: the control, the reference put in
the program's place one precision below the configuration's: a plain
conjugate-gradient solve in float32 (``CONTROL_RHS`` b's of the pool)
in place of the float64 solve, and the reference's products in float32
and bfloat16 in place of the program's float64 and float32 fine
operators, each read by the same comparison.  Prints one JSON line per
seed."""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
CONTROL_RHS = 4                 # b's of each control seed's pool solved
CONTROL_MAXIT = 20000           # steps of the f32 conjugate gradients


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    from solverbench import catalog, check, harness, reference, rhs, tracing
    device = torch.device("cuda", 0)
    cell = catalog.cell(catalog.benchmark(), args.workload, False)
    config, mix = cell.config, cell.traffic
    prob = harness.problem(config)
    A = reference.Ell(prob, device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if seeds:
        kind, card = harness.card_line(device)
        entry = catalog.module("entries", config["solver"]["entry"])
        system = entry.setup(prob, config["solver"], device)
        ans = system.solve(prob.rhs)
        print(json.dumps({"side": "source_b", "rounds": ans.rounds,
                          "iters": ans.iters, "converged": ans.converged}),
              flush=True)
        for seed in seeds:
            run = harness.Run(device, kind, card)
            run.system = system
            run.sample = check.Sample(int(mix["check_sample"]), seed)
            pool = rhs.pool(prob, mix, seed, device)
            system.solve(pool[0])
            harness.window(run, tracing.Spans(), pool, args.seconds, 0.0)
            xs = [x for _, x in run.sample.kept]
            outs = check.operator_outputs(system, xs, device)
            with torch.no_grad():
                ok, checks = check.judge(config, A, run.sample.kept, outs,
                                         run.unconverged)
            print(json.dumps({"side": "program", "seed": seed,
                              "correct": ok, "solves": len(run.latencies),
                              "rounds": sorted(set(run.rounds)),
                              "iters": {i: run.iters.count(i)
                                        for i in sorted(set(run.iters))},
                              "checks": {k: v["value"]
                                         for k, v in checks.items()}}),
                  flush=True)
        system.close()
    lower = {"fine64": torch.float32, "fine32": torch.bfloat16}
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        pool = rhs.pool(prob, mix, seed, device)
        A32 = A.to(torch.float32)
        solved, t0 = [], time.perf_counter()
        for b in pool[:CONTROL_RHS]:
            bd = torch.as_tensor(b, device=device)
            x = reference.cg(A32, bd, config["solver"]["solve_kwargs"]["tol"],
                             CONTROL_MAXIT)
            solved.append((b, x.to(torch.float64).cpu().numpy()))
        cg_s = time.perf_counter() - t0
        outs = {}
        for name, dt in lower.items():
            op_dt = torch.float64 if name == "fine64" else torch.float32
            Alow = A.to(dt)
            outs[name] = []
            for x in check.operator_inputs([x for _, x in solved]):
                xin = torch.as_tensor(x, device=device).to(op_dt)
                outs[name].append((xin.cpu(), Alow.matvec(xin).cpu()))
        with torch.no_grad():
            ok, checks = check.judge(config, A, solved, outs, 0)
        print(json.dumps({"side": "control", "seed": seed, "correct": ok,
                          "cg_s": cg_s,
                          "checks": {k: v["value"]
                                     for k, v in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
