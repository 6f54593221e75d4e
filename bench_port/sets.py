# SPDX-License-Identifier: Apache-2.0
"""Measure a cell's run-to-run spread (never part of a benchmark run):
``sets`` sets of runs of ``run.py``, one process a run, the same seeds in
every set, and for each end-to-end metric each set's median and spread
(the distance between the quartiles over the median,
``statistics.quantiles``):

    python3 bench_port/sets.py --workload <cell> --seeds 1,2,3,4,5,6 \\
        --sets 2 --seconds 30 --out FILE

Every result line goes to ``FILE`` (JSON lines) with its set and seed.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_port.stats import spread  # noqa: E402


def summarize(rows):
    """``{metric: [(median, spread) per set]}`` of result rows."""
    sets = sorted({r["set"] for r in rows})
    out = {}
    for name in rows[0]["result"]["metrics"]:
        per = []
        for s in sets:
            v = [r["result"]["metrics"][name]["value"] for r in rows
                 if r["set"] == s]
            per.append((statistics.median(v), spread(v)))
        out[name] = per
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    rows = []
    for s in range(args.sets):
        for seed in args.seeds.split(","):
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, "bench_port", "run.py"),
                 "--workload", args.workload, "--seed", seed, "--seconds",
                 str(args.seconds), "--trace", "0"], cwd=ROOT,
                capture_output=True, text=True, check=False)
            line = proc.stdout.strip().splitlines()[-1:] or ["null"]
            row = {"set": s, "seed": int(seed), "rc": proc.returncode,
                   "result": json.loads(line[0]),
                   "stderr_tail": proc.stderr[-1500:]}
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(f"set {s} seed {seed} rc {proc.returncode}: "
                  f"{line[0][:300]}", flush=True)
            if row["result"] is not None:
                rows.append(row)
    if len(rows) == args.sets * len(args.seeds.split(",")):
        for name, per in summarize(rows).items():
            print(name, " ".join(f"set {i}: median {m!r} spread {s:.4%}"
                                 for i, (m, s) in enumerate(per)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
