# SPDX-License-Identifier: Apache-2.0
"""A run with the timed path broken underneath comes out not correct: an
answer altered where it is produced, and half of the batch left out.
(The cells hold no training state and no exchange between chips, so the
other faults of a run cannot occur.)  The harness's look for a card is
skipped: the run drives the port's plain path on the CPU."""

import pytest
import torch

from bench_port.harness import run


def _altered(orig, key):
    def wrapper(*args, **kwargs):
        out = list(orig(*args, **kwargs))
        t = out[key].clone()
        # one answer of one atom off by a tenth of the output's scale
        t.view(-1)[t.numel() // 3] += 0.1 * t.abs().max()
        out[key] = t
        return tuple(out)
    return wrapper


@pytest.mark.parametrize("module,name,key", [
    ("nvalchemiops_torch.interactions.dispersion.grid_d3", "grid_dftd3", 1),
    ("nvalchemiops_torch.interactions.dispersion.grid_d3", "grid_dftd3", 2),
    ("nvalchemiops_torch.grid", "grid_coulomb_energy_forces", 1),
    ("nvalchemiops_torch.interactions.electrostatics.pme",
     "pme_reciprocal_space", 0),
])
def test_an_altered_answer_fails(tiny_layout, monkeypatch, module, name, key):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, _altered(getattr(mod, name), key))
    r = run("cscl-md.524k", 5, 0.0, False, "cpu", layout=tiny_layout)
    assert r["correct"] is False


@pytest.mark.parametrize("key", [0, 1, 2])
def test_an_altered_batch_answer_fails(tiny_layout, monkeypatch, key):
    from nvalchemiops_torch.interactions.dispersion import dense_d3

    monkeypatch.setattr(dense_d3, "batch_dftd3",
                        _altered(dense_d3.batch_dftd3, key))
    r = run("d3-batch.dense", 5, 0.0, False, "cpu", layout=tiny_layout)
    assert r["correct"] is False


def test_half_the_batch_left_out_fails(tiny_layout, monkeypatch):
    from nvalchemiops_torch.interactions.dispersion import dense_d3

    orig = dense_d3.batch_dftd3

    def half(positions, numbers, *args, **kwargs):
        b = positions.shape[0] // 2
        e, f, cn = orig(positions[:b], numbers[:b], *args, **kwargs)
        # the left-out systems read as the mean of the rest
        fill = (lambda t: torch.cat([t, t.mean(0, keepdim=True).expand(
            (positions.shape[0] - b,) + t.shape[1:])]))
        return fill(e), fill(f), fill(cn)

    monkeypatch.setattr(dense_d3, "batch_dftd3", half)
    r = run("d3-batch.dense", 5, 0.0, False, "cpu", layout=tiny_layout)
    assert r["correct"] is False
