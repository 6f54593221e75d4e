# SPDX-License-Identifier: Apache-2.0
"""Readings for the limits of ``correct`` (never part of a benchmark run):
the port's numbers on many seeds, or the control's (the reference in
bfloat16, summed in float32, in the port's place), in one process:

    python3 bench_port/readings.py --workload <cell> --mode program \\
        --seeds 1,2,3 --seconds 2 [--out FILE]

Each seed is a whole run at the cell's sizes (set-up, a short window,
the sampled call against the float64 reference); one JSON line a seed.
PERF.md gives the readings each limit was set from.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("program", "control"), required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        harness.log("readings are taken on a CUDA card, at the cell's sizes")
        return 2
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run(args.workload, seed, args.seconds, False, device,
                        mode=args.mode)
        line = {"workload": args.workload, "mode": args.mode, "seed": seed,
                "correct": r["correct"], "seconds": time.perf_counter() - t,
                "compared": {k: v["value"] for k, v in r["compared"].items()},
                "card": harness.card_line(device)}
        text = harness.finite_json(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
