# SPDX-License-Identifier: Apache-2.0
"""Benchmark of the PyTorch and CUDA port (``nvalchemiops_torch``) on one
NVIDIA H100: ``python3 bench_port/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``BENCHMARK.json`` and ``PERF.md``."""
