"""Readings that the limits of ``perfbench/limits/<cell>.json`` are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> \
        --control-seeds <m> --first-seed <s> --seconds <w> \
        --loose 10,100 --loose-seeds <k>

In one process on the card: ``n`` sound runs of the cell as ``run.py``
makes them (set-up, a ``w``-second window, the check), each printing the
numbers compared; then the control on ``m`` seeds, put in the program's
place on the same inputs: the reference computed in the precision below
the configuration's (float32 for float64, bfloat16 for float32), stage by
stage from the float64 stage before, with the total volume of both
precisions' capacities against the exact one (``volume_gap``); then, for
each factor of ``--loose``, ``k`` runs of the program with its CG
tolerance that many times the configuration's, a fault that the check has
to catch.  Ends with one JSON line: the largest reading of the sound runs
(the lower reading) and the smallest of the control (the upper reading)
for each number.  The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=7_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--loose", default="",
                    help="comma-separated factors of the CG tolerance")
    ap.add_argument("--loose-seeds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from perfbench import traffic as generator
    from perfbench.harness import Bench, run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.data("workloads", cell["traffic"])
    ref = bench.module("reference", config["reference"])

    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        result, check = run_cell(bench, args.workload, seed, args.seconds,
                                 False, device, t)
        numbers = {k: c["value"] for k, c in check.items()}
        for k, v in numbers.items():
            lower[k] = max(lower.get(k, -math.inf), v)
        print(json.dumps(dict(kind="program", seed=seed, numbers=numbers,
                              correct=result["correct"],
                              attempted=result["attempted"],
                              failed=result["failed"],
                              seconds=time.perf_counter() - t)), flush=True)
    for i in range(args.control_seeds):
        seed = args.first_seed + 7919 * (args.seeds + i)
        t = time.perf_counter()
        inputs = generator.make_inputs(config, traffic, seed, device)
        exact = ref.reference(config, traffic, inputs, device)
        low = ref.reference(config, traffic, inputs, device,
                            precision=ref.CONTROL[getattr(torch,
                                                          config["dtype"])])
        low["fields"] = [low["field"]]
        numbers = ref.compare(low, exact, config)
        for k, v in numbers.items():
            v = v if math.isfinite(v) else math.inf
            upper[k] = min(upper.get(k, math.inf), v)
        volume = {str(k["V"].dtype): ref.volume_gap(k["V"], config)
                  for k in (exact["capacity"], low["capacity"])}
        print(json.dumps(dict(kind="control", seed=seed, numbers=numbers,
                              volume=volume,
                              seconds=time.perf_counter() - t)), flush=True)
        del exact, low
        gc.collect()
        torch.cuda.empty_cache()
    path = bench.module("paths", config["path"])
    sound = path.Entry
    for factor in [float(f) for f in args.loose.split(",") if f]:

        class Loose(sound):
            def __init__(self, config, *rest):
                super().__init__({**config, "cg_tol": factor
                                  * float(config["cg_tol"])}, *rest)

        path.Entry = Loose
        for i in range(args.loose_seeds):
            seed = args.first_seed + 7919 * (args.seeds + args.control_seeds
                                             + i)
            t = time.perf_counter()
            result, check = run_cell(bench, args.workload, seed,
                                     args.seconds, False, device, t)
            print(json.dumps(dict(
                kind="loose", factor=factor, seed=seed,
                numbers={k: c["value"] for k, c in check.items()},
                correct=result["correct"],
                seconds=time.perf_counter() - t)), flush=True)
        path.Entry = sound
    print(json.dumps(dict(kind="summary", workload=args.workload,
                          lower=lower, upper=upper)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
