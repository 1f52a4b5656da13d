"""The port's masked losses against the JAX package (CPU).

Same inputs from a seed, ragged ``frame_nums`` (one row fully valid, one
half, one a single frame).  Values to rtol 1e-6; the gradients of the two
losses the DDPM trainer differentiates (``com_mse_loss``,
``com_mse_sigma_loss``) to rtol 1e-5 of ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu import losses as jl
from prior_diffuse_tpu_torch import losses as tl

B, T, F = 3, 17, 161
FRAMES = np.array([17, 8, 1], np.int32)
COMPLEX = ["com_mse_loss", "com_mag_mse_loss"]
MAG = ["mag_mse_loss", "mag_mae_loss"]


def _inputs(rng, shape):
    esti = rng.standard_normal(shape).astype(np.float32)
    label = rng.standard_normal(shape).astype(np.float32)
    return esti, label


def _sigma(rng):
    return rng.uniform(0.5, 1.0, (B, T, F, 2)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", COMPLEX + MAG)
def test_loss_equals_jax(rng, name):
    esti, label = _inputs(rng, (B, T, F, 2) if name in COMPLEX else (B, T, F))
    want = float(getattr(jl, name)(jnp.asarray(esti), jnp.asarray(label), jnp.asarray(FRAMES)))
    got = float(getattr(tl, name)(*_t(esti, label), torch.from_numpy(FRAMES).long()))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sigma_loss_equals_jax(rng):
    esti, label = _inputs(rng, (B, T, F, 2))
    sig = _sigma(rng)
    want = float(jl.com_mse_sigma_loss(*map(jnp.asarray, (esti, label, FRAMES, sig))))
    got = float(tl.com_mse_sigma_loss(*_t(esti, label, FRAMES, sig)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_l1_equals_jax(rng):
    esti, label = _inputs(rng, (B, T, F, 2))
    np.testing.assert_allclose(float(tl.l1_loss(*_t(esti, label))),
                               float(jl.l1_loss(jnp.asarray(esti), jnp.asarray(label))),
                               rtol=1e-6)


def test_frames_past_the_mask_do_not_count(rng):
    esti, label = _inputs(rng, (B, T, F, 2))
    moved = esti.copy()
    moved[1, 8:] += 100.0  # row 1 has 8 valid frames
    frames = torch.from_numpy(FRAMES)
    assert float(tl.com_mse_loss(*_t(moved, label), frames)) == \
        float(tl.com_mse_loss(*_t(esti, label), frames))


@pytest.mark.parametrize("sigma", [False, True], ids=["com_mse", "com_mse_sigma"])
def test_gradients_equal_jax(rng, sigma):
    esti, label = _inputs(rng, (B, T, F, 2))
    sig = _sigma(rng)
    if sigma:
        jfn = lambda e: jl.com_mse_sigma_loss(e, jnp.asarray(label), jnp.asarray(FRAMES),
                                              jnp.asarray(sig))
        tfn = lambda e: tl.com_mse_sigma_loss(e, *_t(label, FRAMES, sig))
    else:
        jfn = lambda e: jl.com_mse_loss(e, jnp.asarray(label), jnp.asarray(FRAMES))
        tfn = lambda e: tl.com_mse_loss(e, *_t(label, FRAMES))
    want = np.asarray(jax.grad(jfn)(jnp.asarray(esti)))
    e = torch.from_numpy(esti).requires_grad_(True)
    tfn(e).backward()
    np.testing.assert_allclose(e.grad.numpy(), want, rtol=1e-5, atol=1e-12)
    assert not e.grad.numpy()[1, 8:].any()  # masked frames get no gradient


def test_pesq_loss_needs_a_backend(rng, monkeypatch):
    from prior_diffuse_tpu_torch.metrics import pesq

    monkeypatch.delenv("PDT_APPROX_PESQ", raising=False)
    monkeypatch.setattr(pesq, "HAVE_PESQ", False)
    esti, label = _inputs(rng, (B, T, F, 2))
    with pytest.raises(ImportError):
        tl.pesq_loss(*_t(esti, label), FRAMES)


def test_registry_names_equal_jax():
    from prior_diffuse_tpu.registry import LOSSES

    assert sorted(tl.LOSSES) == sorted(LOSSES.names())
