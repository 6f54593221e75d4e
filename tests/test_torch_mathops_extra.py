# SPDX-License-Identifier: Apache-2.0
"""The port's GTO basis and real spherical harmonics (``mathops.gto``,
``mathops.spherical_harmonics``) against the JAX package on the CPU.

Every public function of the two modules, the generated per-component
accessors included, meets its JAX namesake in f64 at rtol 1e-12 on the
same seeded inputs; the closed-form gradients meet central finite
differences; ``l_max`` outside 0-2 raises in both packages; inputs stay
on their device or go to the one named.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import assert_close

# the packages' ``spherical_harmonics`` attribute is the function of that
# name, so the modules are taken from the import system
tgto, tsh, jgto, jsh = (importlib.import_module(f"{pkg}.mathops.{mod}")
                        for pkg in ("nvalchemiops_torch", "nvalchemiops_tpu")
                        for mod in ("gto", "spherical_harmonics"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread: Tier-1 runs six test workers on the CPU, and a
    torch thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-12
SIGMA = 0.7
RNG = np.random.default_rng(71)
# positions (or k-vectors) in a batch of 4 x 5, one of them at the origin
POINTS = RNG.normal(size=(4, 5, 3)) * 1.5
POINTS[0, 0] = 0.0


def _call(module, name, points, **kw):
    """``module.name`` on ``points``: each function with its own argument
    list (sigma, l, r^2 or positions only)."""
    fn = getattr(module, name)
    if name == "gto_self_overlap":
        return fn(1, SIGMA, **kw)
    if name in ("gto_normalization", "gto_integral_l0"):
        return fn(SIGMA, **kw)
    if name == "gto_gaussian_factor":
        return fn((points * points).sum(-1), SIGMA, **kw)
    if name.startswith(("gto", "eval_gto")):
        return fn(points, SIGMA, **kw)
    return fn(points, **kw)


@pytest.mark.parametrize("module,name", [
    (mod, name) for mod in ("gto", "spherical_harmonics")
    for name in (tgto if mod == "gto" else tsh).__all__])
def test_matches_jax(module, name):
    port = tgto if module == "gto" else tsh
    ref = jgto if module == "gto" else jsh
    out = _call(port, name, torch.as_tensor(POINTS), device="cpu")
    want = _call(ref, name, jnp.asarray(POINTS))
    out = out if isinstance(out, tuple) else (out,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(out) == len(want)
    for a, r in zip(out, want):
        assert a.dtype == torch.float64
        assert tuple(a.shape) == tuple(np.shape(r))
        assert_close(a, r, rtol=RTOL)


def test_per_l_evaluators_and_accessors_slice_the_full_set():
    """The per-l evaluators tile the nine harmonics; each accessor is one
    harmonic (or its gradient) of the full evaluation."""
    r = torch.as_tensor(POINTS)
    full = tsh.eval_all_spherical_harmonics(r)
    grad = tsh.spherical_harmonics_gradient(r)
    per_l = [getattr(tsh, f"eval_spherical_harmonics_l{l}")(r)
             for l in range(3)]
    assert torch.equal(torch.cat(per_l, dim=-1), full)
    for idx, name in enumerate(tsh._COMPONENT_NAMES):
        assert torch.equal(getattr(tsh, f"spherical_harmonic_{name}")(r),
                           full[..., idx])
        assert torch.equal(
            getattr(tsh, f"spherical_harmonic_{name}_gradient")(r),
            grad[..., idx, :])


def _central_difference(fn, points, h=1e-5):
    """d fn / d points by central differences: ``[..., comp, 3]``."""
    cols = []
    for a in range(3):
        step = torch.zeros(3, dtype=torch.float64)
        step[a] = h
        cols.append((fn(points + step) - fn(points - step)) / (2.0 * h))
    return torch.stack(cols, dim=-1)


@pytest.mark.parametrize("l_max", [0, 1, 2])
def test_harmonic_gradients_match_finite_differences(l_max):
    r = torch.as_tensor(POINTS[1:])            # off the origin
    grad = tsh.spherical_harmonics_gradient(r, l_max)
    fd = _central_difference(lambda p: tsh.spherical_harmonics(p, l_max), r)
    assert grad.shape == fd.shape == r.shape[:-1] + ((l_max + 1) ** 2, 3)
    assert_close(grad, fd, rtol=1e-8)


def test_gto_gradient_matches_finite_differences():
    r = torch.as_tensor(POINTS)
    grad = tgto.gto_density_l0_gradient(r, SIGMA)
    fd = _central_difference(
        lambda p: tgto.gto_density_l0(p, SIGMA)[..., None], r)[..., 0, :]
    assert_close(grad, fd, rtol=1e-8)


@pytest.mark.parametrize("call", ["spherical_harmonics",
                                  "spherical_harmonics_gradient",
                                  "eval_gto_density", "eval_gto_fourier"])
def test_l_max_outside_0_to_2_raises_in_both(call):
    for module, pts in ((tsh if "harm" in call else tgto,
                         torch.as_tensor(POINTS)),
                        (jsh if "harm" in call else jgto,
                         jnp.asarray(POINTS))):
        fn = getattr(module, call)
        with pytest.raises(ValueError, match="l_max"):
            fn(pts, 3) if "harm" in call else fn(pts, SIGMA, 3)


def test_inputs_stay_on_their_device_or_go_to_the_named_one():
    """A tensor stays where it is; numpy inputs and a Python ``sigma`` go
    to ``device`` in numpy's dtype (float64), as JAX's with x64."""
    pts32 = torch.as_tensor(POINTS, dtype=torch.float32)
    assert tgto.gto_density_all(pts32, SIGMA).dtype == torch.float32
    from_numpy = tgto.gto_density_all(POINTS, SIGMA, device="cpu")
    assert from_numpy.device.type == "cpu"
    assert torch.equal(from_numpy,
                       tgto.gto_density_all(torch.as_tensor(POINTS), SIGMA))
    norm = tgto.gto_normalization(SIGMA, device="cpu")
    assert norm.dtype == torch.float64
    np.testing.assert_allclose(float(norm),
                               float(jgto.gto_normalization(SIGMA)),
                               rtol=RTOL)
    assert torch.equal(
        tsh.spherical_harmonics(POINTS.tolist(), device="cpu"),
        tsh.spherical_harmonics(torch.as_tensor(POINTS)))
