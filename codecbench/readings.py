"""The readings a cell's limits are set from: the numbers its check
compares, over many seeds, for the program and for its control, read in
one process so that set-up is paid once.

    python3 codecbench/readings.py --workload <cell> --seeds 11,12 \
        --control-seeds 21,22 [--jobs 1]

run from the root of a checkout on a machine with a GPU. For each seed
it makes the cell's input, runs `--jobs` jobs of the cell's entry (the
program at the configuration's `control_qp` for a control seed), judges them
as a run of the benchmark does, and prints one JSON line: the seed,
whether it was the control, each compared number with its limit, and
`correct`.
"""
import argparse
import json
import sys
import time


def main(argv=None):
    import run      # here, not at the top: worker processes re-import this file
    run.setup_env()
    import torch
    from codecbench import harness
    ap = argparse.ArgumentParser(prog="codecbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("codecbench: no GPU visible", file=sys.stderr)
        return 2
    bench = harness.Bench(run.ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(cell["name"])
    entry = bench.entry(traffic["entry"])
    device = torch.device("cuda")
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + [
        (int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        drv = entry.Driver(cfg, traffic, seed, device, control=control)
        outputs = [drv.job() for _ in range(args.jobs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checks, failed, info = drv.check(outputs, seed)
        info["check_s"] = time.perf_counter() - t0
        correct = failed == 0 and all(v <= limits[k]
                                      for k, v in checks.items())
        print(json.dumps(dict(
            workload=cell["name"], seed=seed, control=control,
            correct=correct, checks={k: {"value": v, "limit": limits[k]}
                                     for k, v in checks.items()},
            info=info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
