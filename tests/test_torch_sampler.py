"""Port schedule, sigma mask and reverse chain against the JAX package (CPU).

The chain's random numbers are JAX's own: ``x_T`` is recomputed from the
key as ``reverse_sample`` draws it (``jax.random.split(rng)[0]``, one key
per chain from ``split(rng, n_avg)``) and handed to the port.  The model
is closed-form and linear in ``x`` and ``t`` (as in
``tests/test_schedule.py``).  Bound: 1e-5 * max|ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.config import DiffusionConfig as JDiffusionConfig
from prior_diffuse_tpu.diffusion import inference_schedule as j_inference_schedule
from prior_diffuse_tpu.diffusion import reverse_sample as j_reverse_sample
from prior_diffuse_tpu.diffusion import sigma_mask as j_sigma_mask
from prior_diffuse_tpu_torch.config import DiffusionConfig
from prior_diffuse_tpu_torch.diffusion.qsample import sigma_mask
from prior_diffuse_tpu_torch.diffusion.sampler import is_noiseless, reverse_sample
from prior_diffuse_tpu_torch.diffusion.schedule import inference_schedule

SHAPE = (2, 5, 161, 2)
CDIFFUSE = dict(noise_schedule=np.linspace(1e-4, 0.035, 50).tolist(),
                inference_noise_schedule=[1e-4, 1e-3, 1e-2, 0.05, 0.2, 0.35])
FAST2 = dict(inference_noise_schedule=[1e-2, 0.5])


def _close_rel(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, bound = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def test_config_defaults_equal_jax():
    port, ref = DiffusionConfig(), JDiffusionConfig()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.num_steps == ref.num_steps == 50


@pytest.mark.parametrize("overrides", [{}, CDIFFUSE, FAST2], ids=["diff", "cdiffuse", "fast2"])
@pytest.mark.parametrize("fast", [True, False])
def test_inference_schedule_equals_jax(overrides, fast):
    got = inference_schedule(DiffusionConfig(**overrides), fast_sampling=fast)
    want = j_inference_schedule(JDiffusionConfig(**overrides), fast_sampling=fast)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                      err_msg=f.name)
    assert got.T.dtype == want.T.dtype == np.float32
    assert is_noiseless(got)


def test_sigma_mask_matches_jax(rng):
    x = rng.standard_normal(SHAPE).astype(np.float32)
    x[1] = 0.0  # an all-zero (padded) row takes the 1e-12 floor
    want = np.asarray(j_sigma_mask(jnp.asarray(x)))
    got = sigma_mask(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.all(got[1] == 0.5)


def _linear(x, t):
    # t-dependent linear model (jax or torch arrays), so every step transforms x
    return 0.1 * x + 0.01 * t[:, None, None, None]


def _chains(key, n_avg):
    keys = [key] if n_avg == 1 else list(jax.random.split(key, n_avg))
    return np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], SHAPE))
                     for k in keys])


@pytest.mark.parametrize("predict", ["eps", "x0"])
@pytest.mark.parametrize("sigma", [False, True], ids=["plain", "sigma"])
@pytest.mark.parametrize("n_avg", [1, 3])
def test_reverse_sample_matches_jax(rng, predict, sigma, n_avg):
    sched_j = j_inference_schedule(JDiffusionConfig())
    sched = inference_schedule(DiffusionConfig())
    x_init = rng.standard_normal(SHAPE).astype(np.float32)
    sig = sigma_mask(torch.from_numpy(x_init)) if sigma else None
    key = jax.random.PRNGKey(7)
    want = j_reverse_sample(
        _linear, key, jnp.asarray(x_init), SHAPE, sched_j,
        sig_mask=None if sig is None else jnp.asarray(sig.numpy()),
        n_avg=n_avg, predict=predict)
    got = reverse_sample(_linear, torch.from_numpy(x_init),
                         torch.from_numpy(_chains(key, n_avg)), sched,
                         sig_mask=sig, predict=predict)
    _close_rel(got.numpy(), want)


def test_reverse_sample_zero_init_matches_jax(rng):
    x_init = rng.standard_normal(SHAPE).astype(np.float32)
    want = j_reverse_sample(_linear, jax.random.PRNGKey(3),
                            jnp.asarray(x_init), SHAPE,
                            j_inference_schedule(JDiffusionConfig()),
                            n_avg=4, zero_init=True)
    got = reverse_sample(_linear, torch.from_numpy(x_init), None,
                         inference_schedule(DiffusionConfig()), zero_init=True)
    _close_rel(got.numpy(), want)


def test_reverse_sample_with_step_noise_matches_jax(rng):
    """A schedule whose steps add noise (new_sigma != 0 is not reachable
    from a beta schedule, so it is set by hand): the port takes JAX's
    per-step draws, ``split(split(rng)[1], N)``, in loop order."""
    sched_j = j_inference_schedule(JDiffusionConfig())
    new_sigma = np.linspace(0.05, 0.3, sched_j.num_steps)
    sched_j = dataclasses.replace(sched_j, new_sigma=new_sigma)
    sched = dataclasses.replace(inference_schedule(DiffusionConfig()),
                                new_sigma=new_sigma)
    assert not is_noiseless(sched)
    x_init = rng.standard_normal(SHAPE).astype(np.float32)
    sig = sigma_mask(torch.from_numpy(x_init))
    key = jax.random.PRNGKey(9)
    want = j_reverse_sample(_linear, key, jnp.asarray(x_init), SHAPE,
                            sched_j, sig_mask=jnp.asarray(sig.numpy()))
    step_keys = jax.random.split(jax.random.split(key)[1], sched.num_steps)
    noise = np.stack([np.asarray(jax.random.normal(k, SHAPE)) for k in step_keys])
    got = reverse_sample(_linear, torch.from_numpy(x_init),
                         torch.from_numpy(_chains(key, 1)), sched, sig_mask=sig,
                         noise=torch.from_numpy(noise[None]))
    _close_rel(got.numpy(), want)
    with pytest.raises(ValueError):
        reverse_sample(_linear, torch.from_numpy(x_init),
                       torch.from_numpy(_chains(key, 1)), sched)
