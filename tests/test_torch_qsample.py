"""The port's q-sample against the JAX package (CPU).

``prior_diffuse_tpu.diffusion.q_sample`` draws from a JAX key, split 3
ways with ``leak_drop > 0`` and 2 ways otherwise (timestep indices,
the normal draw, the drop mask).  The test recomputes those draws from the
key and hands them to the port as :class:`Draws`; then ``x_t``, the
noise and ``t`` must agree to rtol 1e-6 in all three modes, with and
without the sigma mask, on the full and the fast (``t_grid``) schedule,
with and without ``leak_drop``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.diffusion import qsample as jq
from prior_diffuse_tpu.diffusion.schedule import inference_schedule as j_inference_schedule
from prior_diffuse_tpu_torch.config import DiffusionConfig
from prior_diffuse_tpu_torch.diffusion import qsample as tq

B, T, F = 4, 9, 161
DIFF = DiffusionConfig()
ALPHA_BAR = np.cumprod(1.0 - np.asarray(DIFF.noise_schedule, np.float64)).astype(np.float32)


def _grids():
    inf = j_inference_schedule(DIFF, fast_sampling=True)
    return np.asarray(inf.T, np.float32), np.asarray(inf.alpha_cum, np.float32)


def jax_draws(key, shape, n_t, leak_drop):
    """The draws of the JAX ``q_sample`` for ``key``, as the port's Draws."""
    keys = jax.random.split(key, 3 if leak_drop > 0 else 2)
    idx = jax.random.randint(keys[0], (shape[0],), 0, n_t)
    normal = jax.random.normal(keys[1], shape, jnp.float32)
    dropped = (jax.random.bernoulli(keys[2], leak_drop, (shape[0],))
               if leak_drop > 0 else None)
    as_t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return tq.Draws(as_t(idx).long(), as_t(normal), as_t(dropped))


CASES = [
    # mode, sigma, fast grid, leak_drop
    ("pirorgrad", False, False, 0.0),
    ("pirorgrad", True, False, 0.0),
    ("pirorgrad", False, True, 0.0),
    ("pirorgrad", True, True, 0.5),
    ("pirorgrad", False, False, 1.0),
    ("deltamu", False, False, 0.0),
    ("deltamu", True, True, 0.0),
    ("conditional", False, False, 0.0),
    ("conditional", True, True, 0.5),
]


@pytest.mark.parametrize("mode,sigma,fast,leak", CASES)
def test_q_sample_equals_jax(rng, mode, sigma, fast, leak):
    clean = rng.standard_normal((B, T, F, 2)).astype(np.float32)
    x_init = rng.standard_normal((B, T, F, 2)).astype(np.float32)
    sig = (0.5 + 0.5 * rng.uniform(size=(B, T, F, 2))).astype(np.float32) if sigma else None
    t_grid, ab_grid = _grids() if fast else (None, None)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    j = lambda a: None if a is None else jnp.asarray(a)
    want = jq.q_sample(key, j(clean), j(x_init), j(ALPHA_BAR), DIFF.num_steps, mode, j(sig),
                       t_grid=j(t_grid), ab_grid=j(ab_grid), leak_drop=leak)
    n_t = len(t_grid) if fast else DIFF.num_steps
    draws = jax_draws(key, clean.shape, n_t, leak)
    tt = lambda a: None if a is None else torch.from_numpy(a)
    got = tq.q_sample(tt(clean), tt(x_init), tt(ALPHA_BAR), DIFF.num_steps, mode, tt(sig),
                      t_grid=tt(t_grid), ab_grid=tt(ab_grid), leak_drop=leak, draws=draws)
    for name, g, w in zip(("x_t", "noise", "t"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert (g.dtype == torch.float32) == (w.dtype == np.float32), name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)
    if leak == 1.0:
        # every signal term dropped: x_t is the noise term alone
        ab = ALPHA_BAR[draws.idx.numpy()].reshape(B, 1, 1, 1)
        np.testing.assert_allclose(got[0].numpy(), np.sqrt(1 - ab) * got[1].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_generator_draws(rng):
    clean = torch.zeros(3, T, F, 2)
    draws = [tq.draw(clean, 6, 0.5, torch.Generator().manual_seed(7)) for _ in range(2)]
    for a, b in zip(*draws):
        assert torch.equal(a, b)  # the same seed, the same draws
    idx, normal, dropped = draws[0]
    assert idx.dtype == torch.int64 and ((idx >= 0) & (idx < 6)).all()
    assert normal.shape == clean.shape and normal.dtype == torch.float32
    assert dropped.dtype == torch.bool and dropped.shape == (3,)
    assert tq.draw(clean, 6, 0.0, torch.Generator()).dropped is None
    assert tq.draw(clean, 6, 1.0, torch.Generator()).dropped.all()


def test_q_sample_from_a_generator_is_reproducible():
    clean, x_init = torch.randn(2, T, F, 2), torch.randn(2, T, F, 2)
    ab = torch.from_numpy(ALPHA_BAR)
    runs = [tq.q_sample(clean, x_init, ab, 50, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kwargs", [
    dict(mode="nope"),
    dict(mode="deltamu", leak_drop=0.5),
    dict(),  # no generator and no draws
])
def test_q_sample_refuses(kwargs):
    clean = torch.zeros(1, T, F, 2)
    with pytest.raises(ValueError):
        tq.q_sample(clean, clean, torch.from_numpy(ALPHA_BAR), 50, **kwargs)


def test_sigma_mask_equals_jax(rng):
    x = rng.standard_normal((B, T, F, 2)).astype(np.float32)
    x[1] = 0.0  # an all-zero row: the 1e-12 floor
    np.testing.assert_allclose(tq.sigma_mask(torch.from_numpy(x)).numpy(),
                               np.asarray(jq.sigma_mask(jnp.asarray(x))), rtol=1e-7)
