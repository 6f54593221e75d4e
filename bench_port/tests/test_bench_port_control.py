# SPDX-License-Identifier: Apache-2.0
"""The control of the limits at a size a CPU test holds: the reference
computed in bfloat16 (summed in float32) in the program's place fails the
cells' limits, and the port's float32 plain path passes them."""

import pytest

from bench_port.harness import run

CELLS = ("cscl-md.524k", "d3-batch.dense")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(tiny_layout, cell):
    r = run(cell, 2 ** 31 + 77, 0.0, False, "cpu", layout=tiny_layout,
            mode="control")
    assert r["correct"] is False
    over = [k for k, v in r["compared"].items() if v["value"] > v["limit"]]
    assert over


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_passes_the_limits(tiny_layout, cell):
    r = run(cell, 2 ** 31 + 77, 0.0, False, "cpu", layout=tiny_layout)
    assert r["correct"] is True, r["compared"]
    assert list(r)[-1] == "compared"
