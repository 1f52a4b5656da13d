"""The port's DiffWave against the JAX package's (CPU).

DiffWave is registered in the JAX package's model table and used by none
of its trainers, so the port carries the model and its weight bridge: flax
variables (their own init, constant leaves moved off their value as
``test_torch_priors.py`` does) carried in by ``convert.py``, the same
seeded numpy waveforms and steps into both:

* the forward at a narrow width (8 channels, 4 layers, cycle 2) and at the
  default width (64 channels, 30 layers, cycle 10, 50 steps), B = 2 and
  L = 400 samples, for integer steps and for fractional ones (the time
  embedding's interpolation): within 1e-5 relative L2;
* the ``convert.py`` round trip (flax -> port -> flax is the identity) at
  both widths;
* the input projection is shared by the audio and ``audio_init``, and the
  skip sum is divided by ``sqrt(layers)``: a port whose conditioner had its
  own projection, or that skipped the division, would miss JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.models import diffwave as jdw
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.models import diffwave, model_class
from test_torch_priors import perturb

torch.set_num_threads(min(2, torch.get_num_threads()))

LENGTH = 400
REL_L2 = 1e-5
WIDTHS = {"narrow": dict(residual_channels=8, residual_layers=4, dilation_cycle_length=2),
          "default": dict()}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(seed, fractional):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((2, LENGTH)).astype(np.float32)
    audio_init = (0.5 * rng.standard_normal((2, LENGTH))).astype(np.float32)
    t = (np.array([3.25, 41.5], np.float32) if fractional else np.array([3, 41], np.int32))
    return audio, audio_init, t


@pytest.fixture(scope="module", params=list(WIDTHS))
def pair(request):
    kw = WIDTHS[request.param]
    jm = jdw.DiffWave(**kw)
    audio, audio_init, t = _inputs(0, False)
    variables = perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(audio),
                                jnp.asarray(audio_init), jnp.asarray(t)),
                        np.random.default_rng(1))
    tm = diffwave.DiffWave(**kw)
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    return jm, variables, tm.eval()


def test_registered_with_the_default_width():
    net = model_class("DiffWave")()
    assert isinstance(net, diffwave.DiffWave) and net.residual_layers == 30
    assert net.res9.dilated_conv.dilation == (512,) and net.res10.dilated_conv.dilation == (1,)


@pytest.mark.parametrize("fractional", [False, True], ids=["int_t", "float_t"])
def test_forward_matches_flax(pair, fractional):
    jm, variables, tm = pair
    audio, audio_init, t = _inputs(2, fractional)
    want = jm.apply(variables, jnp.asarray(audio), jnp.asarray(audio_init), jnp.asarray(t))
    with torch.no_grad():
        got = tm(torch.from_numpy(audio), torch.from_numpy(audio_init), torch.from_numpy(t))
    assert got.shape == (2, LENGTH)
    assert rel_l2(got.numpy(), want) <= REL_L2


def test_convert_round_trip_is_identity(pair):
    _, variables, tm = pair
    back = state_dict_to_flax(tm, tm.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_shared_projection_and_skip_scale(pair):
    """Each control changes what the JAX model computes and must miss it."""
    jm, variables, tm = pair
    audio, audio_init, t = _inputs(3, False)
    want = jm.apply(variables, jnp.asarray(audio), jnp.asarray(audio_init), jnp.asarray(t))
    args = torch.from_numpy(audio), torch.from_numpy(audio_init), torch.from_numpy(t)
    own = torch.nn.Conv1d(1, tm.input_projection.out_channels, 1)  # an unshared projection
    calls = []
    hook = tm.input_projection.register_forward_hook(
        lambda m, a, out: calls.append(1) or (own(a[0]) if len(calls) == 2 else out))
    with torch.no_grad():
        unshared = tm(*args)
    hook.remove()
    hook = tm.skip_projection.register_forward_pre_hook(
        lambda m, a: (a[0] * np.sqrt(tm.residual_layers),))
    with torch.no_grad():
        unscaled = tm(*args)
    hook.remove()
    for got in (unshared, unscaled):
        assert rel_l2(got.numpy(), want) > 100 * REL_L2
