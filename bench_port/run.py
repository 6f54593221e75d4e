# SPDX-License-Identifier: Apache-2.0
"""Run one cell of the port's benchmark once on this machine's card:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); standard error ends with each number compared beside its
limit.  Exits non-zero and prints no result when the machine has fewer
CUDA cards than the cell asks for, when the port cannot be imported, or
when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # CUDA's kernel cache at a fixed place in the checkout
    os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "cuda_cache")
    # one host thread for the CPU math libraries: the runs are one process
    # on a host whose cores other machines share, and the timed path's host
    # work is dispatch, not CPU math
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)

    from bench_port import harness

    chips = int(harness.Layout().cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA card(s); this "
                    f"machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0),
                         t_start=T_START)
    if result is None:
        return 3
    sys.stdout.write(harness.finite_json(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
