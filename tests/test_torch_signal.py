"""Port STFT/ISTFT and compression against the JAX package (CPU).

The port's plain framed-matmul STFT/ISTFT (the plain versions of the K1/K2
kernels) must equal the JAX ``stft_xla``/``istft_xla`` and the Pallas
kernels run in interpret mode.  Bounds: spectra <= 1e-5 * max|ref|,
waveforms <= 1e-5 absolute (float32 products of length 320/322 summed in
another order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.ops.pallas.stft_kernel import istft_pallas, stft_pallas
from prior_diffuse_tpu.signal import compress as jcompress
from prior_diffuse_tpu.signal import normalize as jnormalize
from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
from prior_diffuse_tpu_torch.signal import compress, normalize
from prior_diffuse_tpu_torch.signal import stft as pstft

# the JAX signal package re-exports a function named ``stft``
jstft = importlib.import_module("prior_diffuse_tpu.signal.stft")

LENGTHS = [161, 1600, 2017, 4999]


def _close_rel(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bound = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def test_window_and_dft_matrices_equal_jax():
    np.testing.assert_array_equal(pstft.hann_window(320), jstft.hann_window(320))
    for a, b in zip(pstft.dft_matrices_np(320), jstft._dft_matrices_np(320)):
        np.testing.assert_array_equal(a, b)
    assert pstft.frame_count(48000) == jstft.frame_count(48000) == 301


@pytest.mark.parametrize("length", LENGTHS)
def test_stft_matches_jax(rng, length):
    x = rng.standard_normal((2, length)).astype(np.float32)
    want = np.asarray(jstft.stft_xla(jnp.asarray(x)))
    got = pstft.stft_plain(torch.from_numpy(x)).numpy()
    _close_rel(got, want, 1e-5)


def test_stft_matches_pallas_interpret(rng):
    x = rng.standard_normal((2, 2017)).astype(np.float32)
    want = np.asarray(stft_pallas(jnp.asarray(x), interpret=True))
    _close_rel(kstft.stft(torch.from_numpy(x)).numpy(), want, 1e-5)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("out_delta", [0, -300, 500])
def test_istft_matches_jax(rng, length, out_delta):
    x = rng.standard_normal((2, length)).astype(np.float32)
    spec = np.array(jstft.stft_xla(jnp.asarray(x)))
    out_len = max(length + out_delta, 1)
    want = np.asarray(jstft.istft_xla(jnp.asarray(spec), length=out_len))
    got = pstft.istft_plain(torch.from_numpy(spec), length=out_len).numpy()
    assert got.shape == want.shape == (2, out_len)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_istft_matches_pallas_interpret(rng):
    x = rng.standard_normal((2, 2017)).astype(np.float32)
    spec = np.array(jstft.stft_xla(jnp.asarray(x)))
    want = np.asarray(istft_pallas(jnp.asarray(spec), length=2017, interpret=True))
    got = kstft.istft(torch.from_numpy(spec), 2017).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, x, rtol=0, atol=1e-4)  # round trip


def test_stft_rejects_short_signal():
    with pytest.raises(ValueError):
        pstft.stft_plain(torch.zeros(1, 160))
    with pytest.raises(ValueError):
        kstft.stft(torch.zeros(1, 160))


def test_wrappers_take_plain_path_on_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((2, 1700)).astype(np.float32))
    before = (kstft.stft.launches, kstft.istft.launches)
    spec = kstft.stft(x)
    y = kstft.istft(spec, 1700)
    assert torch.equal(spec, pstft.stft_plain(x))
    assert torch.equal(y, pstft.istft_plain(spec, length=1700))
    assert (kstft.stft.launches, kstft.istft.launches) == before


@pytest.mark.parametrize("length", [161, 2017])
def test_kernel_operands_reproduce_plain(rng, length):
    """K1/K2 formulations, emulated in numpy with the kernels' own operands
    and index arithmetic (reflect-mirrored frame reads; output row q =
    [spec_{q+1} | spec_q] @ stacked inverse / envelope), equal the plain
    versions."""
    x = rng.standard_normal((1, length)).astype(np.float32)
    t_frames = length // 160 + 1
    idx = np.arange(t_frames)[:, None] * 160 + np.arange(320)[None, :] - 160
    idx = np.abs(idx)
    idx = np.where(idx >= length, 2 * (length - 1) - idx, idx)
    spec_k1 = (x[0][idx].astype(np.float64) @ kstft.stft_matrix_np()).reshape(
        1, t_frames, 161, 2)
    want = pstft.stft_plain(torch.from_numpy(x)).numpy()
    _close_rel(spec_k1, want, 1e-5)

    inv, env = kstft.istft_operands_np()
    packed = want[0].reshape(t_frames, 322).astype(np.float64)
    out_len = length + 250
    rows = -(-out_len // 160)
    out = np.zeros(rows * 160)
    env_s = np.ones(rows * 160)
    for q in range(rows):
        r = q + 1
        if r > t_frames:
            continue
        a = np.concatenate([packed[r] if r < t_frames else np.zeros(322),
                            packed[r - 1]])
        env_s[q * 160:(q + 1) * 160] = env[int(r == t_frames)]
        out[q * 160:(q + 1) * 160] = (a @ inv) / env_s[q * 160:(q + 1) * 160]
    got = pstft.istft_plain(torch.from_numpy(want), length=out_len).numpy()[0]
    # the last frame's tail is divided by an envelope down to ~1e-8, which
    # scales float32 rounding by 1/env: compare numerators
    np.testing.assert_allclose(out[:out_len] * env_s[:out_len],
                               got * env_s[:out_len], rtol=0, atol=1e-5)


@pytest.mark.parametrize("feat_type", ["normal", "sqrt", "cubic", "log_1x", "none"])
def test_compress_matches_jax(rng, feat_type):
    spec = rng.standard_normal((2, 7, 161, 2)).astype(np.float32)
    want_c = np.asarray(jcompress.compress_spec(jnp.asarray(spec), feat_type))
    got_c = compress.compress_spec(torch.from_numpy(spec), feat_type).numpy()
    _close_rel(got_c, want_c, 1e-5)
    want_d = np.asarray(jcompress.decompress_spec(jnp.asarray(want_c), feat_type))
    got_d = compress.decompress_spec(torch.from_numpy(want_c), feat_type).numpy()
    _close_rel(got_d, want_d, 1e-5)


def test_rms_scale_matches_jax(rng):
    x = rng.standard_normal((3, 1234)).astype(np.float32) * 0.2
    np.testing.assert_array_equal(normalize.rms_scale(x), jnormalize.rms_scale(x))


def test_stft_refuses_an_input_that_needs_a_gradient():
    """K1 has no backward: the wrapper refuses an input that requires grad
    while grad mode is on, on every device (here through the same check
    on a CPU tensor), and takes it under ``torch.no_grad()``."""
    x = torch.randn(2, 1600, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        kstft.stft(x)
    with pytest.raises(ValueError, match="no backward"):
        kstft.check_no_grad(x)
    with torch.no_grad():
        assert kstft.stft(x).shape == (2, 11, 161, 2)
    kstft.check_no_grad(x.detach())
