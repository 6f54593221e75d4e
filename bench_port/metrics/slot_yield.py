# SPDX-License-Identifier: Apache-2.0
"""Kernel 1's slot yield in the D3 CN pass (%): the atom pairs inside the
cutoff (the work count of each ``window_sweep[cn]`` launch, its operations
over those of one pair) over the slot pairs the launches tested for
distance (the port's ``slot_pairs.window_sweep_cn`` counter), over the
traced window's calls."""

from bench_port.work import DIST_FLOPS, PAIR_FLOPS

KEY = "window_sweep[cn]"
COUNTER = "slot_pairs.window_sweep_cn"


def read(ctx):
    tested = ctx.launch_counts.get(COUNTER)
    flops = [f for _, key, _, f in ctx.works if key == KEY]
    if not tested or not flops:
        return None
    return 100.0 * sum(flops) / (DIST_FLOPS + PAIR_FLOPS["cn"]) / tested
