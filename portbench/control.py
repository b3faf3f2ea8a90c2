#!/usr/bin/env python3
"""The control of a cell's comparison: the cell run as ``run.py`` runs it,
but with the port's own path one precision below the configuration's
(``--dtype``, float32 for a float64 configuration), judged by the same
float64 reference.  Its numbers have to come out above the limits.

    python portbench/control.py --workload <name> --seeds 1,2,3 --seconds 5

One process runs the seeds one after another, each with its own set-up,
window and reference, and prints one JSON line a seed.  The benchmark's
own runs never run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import run  # noqa: E402

if __name__ == "__main__":
    run.cache_bytecode()  # before torch is imported


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)
    import torch

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = dict(run.load_json(run.ROOT / entry["file"]), dtype=args.dtype)
    mix = run.load_json(run.PB / "traffic" / f"{cell['traffic']}.json")
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, lines = run.run_cell(bench, cell, config, mix, seed, args.seconds, False,
                                     torch.device("cuda", 0), t0)
        print(json.dumps({"control": args.dtype, "workload": args.workload, "seed": seed,
                          "correct": result["correct"], "failed": result["failed"],
                          "attempted": result["attempted"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
