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
    """K2's formulation, emulated in numpy with the kernel's own operands
    and index arithmetic (output row q = [spec_{q+1} | spec_q] @ stacked
    inverse / envelope), equals the plain version."""
    x = rng.standard_normal((1, length)).astype(np.float32)
    t_frames = length // 160 + 1
    want = pstft.stft_plain(torch.from_numpy(x)).numpy()
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


def _k1_emulate(x: np.ndarray, tab=None) -> np.ndarray:
    """K1 (``csrc/stft.cu::stft_kernel``) in numpy, in complex64, step by
    step as one warp computes a frame: the reflect-mirrored hop rows, the
    window, z[n] = xw[2n] + i xw[2n+1], a 5-point DFT in each lane n2 over
    z[32 n1 + n2] and the twiddle W160^(n2 k1), radix-2 butterflies across
    the 32 lanes (decimation in frequency, lane l ends with k2 =
    bitrev5(l)), then the real split of Z into 161 bins; all constants
    from ``tab`` (default ``fft_table_np``)."""
    tab = kstft.fft_table_np() if tab is None else tab
    win = tab[:320]
    tw = (tab[320:640:2] + 1j * tab[321:640:2]).astype(np.complex64)
    w320 = (tab[640::2] + 1j * tab[641::2]).astype(np.complex64)
    length = x.shape[-1]
    t_frames = length // 160 + 1
    idx = np.abs(np.arange((t_frames + 1) * 160) - 160)
    idx = np.where(idx >= length, 2 * (length - 1) - idx, idx)
    rows = x[..., idx].reshape(*x.shape[:-1], t_frames + 1, 160)
    frames = np.concatenate([rows[..., :-1, :], rows[..., 1:, :]], axis=-1) * win
    z = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    u = z.reshape(*z.shape[:-1], 5, 32)  # [.., n1, lane]
    lane = np.arange(32)
    v = []
    for k1 in range(5):
        acc = u[..., 0, :]
        for n1 in range(1, 5):
            acc = acc + u[..., n1, :] * tw[32 * ((n1 * k1) % 5)]
        v.append(acc * tw[lane * k1] if k1 else acc)
    v = np.stack(v, axis=-2)  # [.., k1, lane]
    for h in (16, 8, 4, 2, 1):
        other = v[..., lane ^ h]
        wt = tw[5 * (lane & (h - 1)) * (16 // h)]
        v = np.where((lane & h) != 0, (other - v) * wt, v + other).astype(np.complex64)
    k2 = np.array([int(f"{i:05b}"[::-1], 2) for i in range(32)])
    big_z = np.empty(v.shape[:-2] + (160,), np.complex64)
    for k1 in range(5):
        big_z[..., k1 + 5 * k2] = v[..., k1, :]
    k = np.arange(161)
    zk, zm = big_z[..., k % 160], big_z[..., (160 - k) % 160]
    even = 0.5 * (zk + np.conj(zm))
    odd = (zk - np.conj(zm)) / 2j
    spec = even + w320 * odd
    return np.stack([spec.real, spec.imag], axis=-1).astype(np.float32)


@pytest.mark.parametrize("length", [161, 2017, 48000])
def test_fft_factorization_reproduces_plain(rng, length):
    """K1's FFT factorization with its host twiddle table (float64 built,
    float32 stored) equals the plain framed-matmul STFT."""
    x = rng.standard_normal((2, length)).astype(np.float32)
    _close_rel(_k1_emulate(x), pstft.stft_plain(torch.from_numpy(x)).numpy(), 1e-5)


def test_fft_emulation_sees_a_wrong_window(rng):
    """The emulation above can fail: with the symmetric Hann window (the
    classic off-by-one of ``torch.hann_window(320, periodic=False)``) in
    K1's table it misses the plain STFT by far more than 1e-5."""
    x = rng.standard_normal((1, 2017)).astype(np.float32)
    tab = kstft.fft_table_np()
    tab[:320] = torch.hann_window(320, periodic=False).numpy()
    got = _k1_emulate(x, tab)
    want = pstft.stft_plain(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 1e-3 * np.abs(want).max()


def test_fft_table_matches_its_definition():
    """The window is the plain version's float32 Hann window; the twiddles
    are e^{-2 pi i m / 160} and e^{-2 pi i k / 320} rounded once to float32."""
    tab = kstft.fft_table_np()
    assert tab.dtype == np.float32 and tab.shape == (962,)
    np.testing.assert_array_equal(tab[:320], pstft.hann_window(320))
    w160 = np.exp(-2j * np.pi * np.arange(160) / 160)
    w320 = np.exp(-2j * np.pi * np.arange(161) / 320)
    np.testing.assert_array_equal(tab[320:640:2], w160.real.astype(np.float32))
    np.testing.assert_array_equal(tab[321:640:2], w160.imag.astype(np.float32))
    np.testing.assert_array_equal(tab[640::2], w320.real.astype(np.float32))
    np.testing.assert_array_equal(tab[641::2], w320.imag.astype(np.float32))


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
