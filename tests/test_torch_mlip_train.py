# SPDX-License-Identifier: Apache-2.0
"""The port's MLIP training step (``parallel.mlip.loss_fn`` and
``train_step``) against the JAX package's, on the CPU.

Inputs are numpy draws from a seed: 2 systems x 16 atoms in 4.5 A boxes
(``[B, 3, 3]`` cells) with every fifth atom a padding atom (``numbers ==
0``), cutoff 2.1 A, energy and force targets.  The JAX weights are carried
over by ``interop``.  In f64 the loss and the new parameters match JAX's
within rtol 1e-9 of each field's scale; in f32 the port's errors against
JAX's f64 step are at most 1.25x JAX's own f32 errors.  The graph-keeping
forward (energies and forces as functions of the parameters) passes
``torch.autograd.gradcheck`` and ``gradgradcheck`` in f64 at 1 x 8 atoms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvalchemiops_torch import interop
from nvalchemiops_torch import parallel as tpar
from nvalchemiops_torch.parallel import mlip as tmlip
from nvalchemiops_tpu import parallel as jpar
from nvalchemiops_tpu.parallel import mlip as jmlip

from tests._torch_port import assert_close

ZMAX = 4
CUTOFF = 2.1
RTOL = 1e-9
F32_FACTOR = 1.25
DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _batch_np(seed=5, b=2, n=16, box=4.5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, (b, n, 3))
    numbers = rng.integers(1, ZMAX + 1, (b, n)).astype(np.int32)
    numbers[:, ::5] = 0
    cell = np.stack([np.eye(3) * box] * b)
    return (pos, numbers, cell, rng.normal(size=b),
            rng.normal(size=(b, n, 3)) * 0.01)


@functools.lru_cache(maxsize=None)
def _weights(name):
    tdt, jdt = DTYPES[name]
    params = jpar.init_mlip_params(ZMAX, jdt)
    tables = jpar.default_d3_tables(ZMAX, dtype=jdt)
    return (params, tables,
            interop.mlip_params_from_numpy(_fields(params), dtype=tdt,
                                           device="cpu"),
            interop.mlip_tables_from_numpy(_fields(tables), dtype=tdt,
                                           device="cpu"))


def _jax_batch(name):
    jdt = DTYPES[name][1]
    pos, numbers, cell, te, tf = _batch_np()
    return (jnp.asarray(pos, jdt), jnp.asarray(numbers), jnp.asarray(cell, jdt),
            jnp.asarray(te, jdt), jnp.asarray(tf, jdt))


def _port_batch(name):
    tdt = DTYPES[name][0]
    pos, numbers, cell, te, tf = _batch_np()
    return (torch.as_tensor(pos, dtype=tdt), torch.as_tensor(numbers),
            torch.as_tensor(cell, dtype=tdt), torch.as_tensor(te, dtype=tdt),
            torch.as_tensor(tf, dtype=tdt))


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """JAX ``train_step`` (jitted: one compile per dtype): the loss and the
    new parameters, as float64 numpy."""
    jparams, jtables, _, _ = _weights(name)
    new, loss = jax.jit(jpar.train_step, static_argnums=(3, 4))(
        jparams, jtables, _jax_batch(name), CUTOFF, 1e-3)
    return float(loss), {f: np.asarray(v, np.float64)
                         for f, v in _fields(new).items()}


def _port_step(name):
    _, _, params, tables = _weights(name)
    new, loss = tpar.train_step(params, tables, _port_batch(name), CUTOFF)
    return float(loss), {f: getattr(new, f).double().numpy()
                         for f in new._fields}


def test_loss_fn_matches_jax():
    jparams, jtables, params, tables = _weights("f64")
    want = jax.jit(jmlip.loss_fn, static_argnums=3)(
        jparams, jtables, _jax_batch("f64"), CUTOFF)
    got = tmlip.loss_fn(params, tables, _port_batch("f64"), CUTOFF)
    assert got.dtype == torch.float64 and got.dim() == 0
    assert_close(got, float(want), RTOL)


def test_train_step_matches_jax():
    """New parameters (each field a detached tensor of the parameters'
    dtype) and loss within rtol 1e-9; the padding element's charge does
    not move."""
    _, _, params, tables = _weights("f64")
    new, loss = tpar.train_step(params, tables, _port_batch("f64"), CUTOFF)
    assert isinstance(new, tpar.MLIPParams)
    want_loss, want = _jax_step("f64")
    assert_close(loss, want_loss, RTOL)
    for f in new._fields:
        got = getattr(new, f)
        assert got.dtype == torch.float64 and not got.requires_grad, f
        assert got.shape == getattr(params, f).shape, f
        assert_close(got, want[f], RTOL, err_msg=f)
    assert new.charge[0] == params.charge[0]
    assert not any(getattr(params, f).requires_grad for f in params._fields)


def test_train_step_lr_and_inputs_as_numpy():
    """``lr`` scales the step as JAX's does; a batch whose other arrays are
    numpy runs on the positions' device and gives the tensor batch's
    bits."""
    _, _, params, tables = _weights("f64")
    batch = _port_batch("f64")
    new1, loss1 = tpar.train_step(params, tables, batch, CUTOFF, lr=1e-3)
    new2, loss2 = tpar.train_step(params, tables, batch, CUTOFF, lr=2e-3)
    assert torch.equal(loss1, loss2)
    for f in new1._fields:
        p = getattr(params, f)
        assert_close(getattr(new2, f), p - 2.0 * (p - getattr(new1, f)),
                     1e-14, err_msg=f)
    as_np = (batch[0],) + tuple(a.numpy() for a in batch[1:])
    new3, loss3 = tpar.train_step(params, tables, as_np, CUTOFF)
    assert torch.equal(loss3, loss1)
    assert all(torch.equal(getattr(new3, f), getattr(new1, f))
               for f in new1._fields)


def test_f32_step_within_jax_f32_error():
    """f32 loss, new parameters and update ``params - new`` against JAX's
    f64 step: each error (max over fields of max |diff| / the f64 field's
    scale) at most 1.25x the JAX f32 step's error."""
    errors = {}
    ref_loss, ref = _jax_step("f64")
    p64 = {f: np.asarray(v, np.float64)
           for f, v in _fields(_weights("f64")[0]).items()}
    p32 = {f: np.asarray(v, np.float64)
           for f, v in _fields(_weights("f32")[0]).items()}
    for who, (loss, new) in (("jax", _jax_step("f32")),
                             ("port", _port_step("f32"))):
        errors[who] = (
            abs(loss - ref_loss) / abs(ref_loss),
            max(np.abs(new[f] - ref[f]).max() / np.abs(ref[f]).max()
                for f in ref),
            max(np.abs((p32[f] - new[f]) - (p64[f] - ref[f])).max()
                / np.abs(p64[f] - ref[f]).max() for f in ref))
    for k, what in enumerate(("loss", "new parameters", "update")):
        assert errors["port"][k] <= F32_FACTOR * errors["jax"][k], (
            what, errors)


def test_graph_keeping_forward_second_derivatives():
    """``gradcheck`` and ``gradgradcheck`` of the energies and forces as
    functions of every parameter field, in f64 at 1 system x 8 atoms (one
    a padding atom, a few pairs within the cutoff): the double backward of
    the training step through the CNs, ``_c6_interpolate`` and the
    cutoff masks is finite and equals finite differences."""
    rng = np.random.default_rng(8)
    box, cutoff = 4.0, 1.95
    pos = torch.as_tensor(rng.uniform(0, box, (1, 8, 3)))
    numbers = torch.as_tensor(rng.integers(1, ZMAX + 1, (1, 8)))
    numbers[0, 3] = 0
    cell = torch.as_tensor(np.eye(3)[None] * box)
    d = torch.cdist(pos[0], pos[0])
    assert int(((d < cutoff) & (d > 0)).sum()) // 2 >= 3
    params = tpar.init_mlip_params(ZMAX, torch.float64, device="cpu")
    tables = tpar.default_d3_tables(ZMAX, dtype=torch.float64, device="cpu")

    def forward(*fields):
        return tmlip._energies_forces(tpar.MLIPParams(*fields), tables, pos,
                                      numbers, cell, cutoff,
                                      create_graph=True)

    inputs = tuple(p.clone().requires_grad_(True) for p in params)
    assert torch.autograd.gradcheck(forward, inputs)
    assert torch.autograd.gradgradcheck(forward, inputs)


def test_batched_energy_forces_is_the_graph_keeping_forward_detached():
    _, _, params, tables = _weights("f64")
    pos, numbers, cell, _, _ = _port_batch("f64")
    e, f = tpar.batched_energy_forces(params, tables, pos, numbers, cell,
                                      CUTOFF)
    e2, f2 = tmlip._energies_forces(params, tables, pos, numbers, cell,
                                    CUTOFF, create_graph=True)
    assert not e.requires_grad and not f.requires_grad
    assert torch.equal(e, e2.detach()) and torch.equal(f, f2.detach())
