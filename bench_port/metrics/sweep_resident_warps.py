# SPDX-License-Identifier: Apache-2.0
"""Kernel 1's resident warps an SM (warps), weighted by slot pairs: the
port's ``resident_warps.window_sweep_*`` counters (each launch's slot
pairs times the warps an SM holds of the launched instantiation at its
shared memory) over its ``slot_pairs.window_sweep_*`` counters of the
same bodies, over the traced window's kernel 1 launches.  None where the
port has no such counter or kernel 1 did not run."""

FAMILY = "resident_warps."
KERNEL = "window_sweep_"


def read(ctx):
    keys = [k[len(FAMILY):] for k in ctx.launch_counts
            if k.startswith(FAMILY + KERNEL)]
    pairs = sum(ctx.launch_counts.get("slot_pairs." + k, 0) for k in keys)
    if not pairs:
        return None
    return sum(ctx.launch_counts[FAMILY + k] for k in keys) / pairs
