"""Port STFT/ISTFT and compression against the JAX package (CPU).

The port's plain framed-matmul STFT/ISTFT (the plain versions of the K1/K2
kernels) must equal the JAX ``stft_xla``/``istft_xla`` and the Pallas
kernels run in interpret mode.  Bounds: spectra <= 1e-5 * max|ref|,
waveforms <= 1e-5 absolute (float32 products of length 320/322 summed in
another order).
"""

import importlib
from unittest import mock

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


class _Launched(Exception):
    pass


def test_istft_refuses_a_misaligned_spectrum_before_launch():
    """K2 loads its bins as float2: the wrapper's kernel path refuses a
    spectrum that does not start on an 8-byte boundary (a contiguous view
    at an odd float offset) before it reaches the library, and passes an
    aligned one on to the launch, with a tile the kernel is built for."""
    flat = torch.zeros(1 + 2 * 3 * 161 * 2)

    def library():
        raise _Launched

    with mock.patch.object(kstft, "on_cuda", lambda x: True), \
            mock.patch.object(kstft.build, "library", library):
        with pytest.raises(ValueError, match="8-byte boundary"):
            kstft.istft(flat[1:].view(2, 3, 161, 2), 320)
        with pytest.raises(_Launched):
            kstft.istft(flat[:-1].view(2, 3, 161, 2), 320)
    assert kstft.ISTFT_ROWS in kstft.ISTFT_TILES


def _numerators(y: np.ndarray, t_frames: int) -> np.ndarray:
    """``y`` times the window-square envelope it was divided by (1 past
    row T).  The last frame's tail is divided by an envelope down to ~1e-8,
    which scales float32 rounding by 1/env there: compare numerators."""
    env = np.ones(y.shape[-1])
    tail = pstft._envelope_np(t_frames, 320, 160)[160:160 + y.shape[-1]]
    env[:len(tail)] = tail
    return y * env


@pytest.mark.parametrize("length", [161, 2017])
def test_kernel_operands_reproduce_plain(rng, length):
    """K2's formulation with its own table and index arithmetic, the frame
    inverse taken exactly (float64 irfft of the Hermitian spectrum): frames
    times the table's window / 320, output row q = first half of frame q + 1
    + second half of frame q, divided by envelope row 1 for q + 1 = T and
    row 0 before, zero past T; equals the plain version."""
    x = rng.standard_normal((1, length)).astype(np.float32)
    t_frames = length // 160 + 1
    spec = pstft.stft_plain(torch.from_numpy(x)).numpy()
    tab = kstft.istft_table_np().astype(np.float64)
    frames = np.fft.irfft(spec[0, ..., 0] + 1j * spec[0, ..., 1], 320) * 320 * tab[:320]
    frames = np.concatenate([frames, np.zeros((1, 320))])  # frame T: none
    env = tab[960:].reshape(2, 160)
    out_len = length + 250
    rows = -(-out_len // 160)
    out = np.zeros((rows, 160))
    for q in range(min(rows, t_frames)):
        out[q] = (frames[q + 1, :160] + frames[q, 160:]) / env[int(q + 1 == t_frames)]
    got = pstft.istft_plain(torch.from_numpy(spec), length=out_len).numpy()[0]
    np.testing.assert_allclose(_numerators(out.reshape(-1)[:out_len], t_frames),
                               _numerators(got, t_frames), rtol=0, atol=1e-5)


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
    k2 = np.array([_bitrev5(i) for i in range(32)])
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


def _bitrev5(i: int) -> int:
    return int(f"{i:05b}"[::-1], 2)


def _k2_emulate(spec: np.ndarray, length: int, tab=None, zero_edge_imag: bool = True,
                rows: int = kstft.ISTFT_ROWS) -> np.ndarray:
    """K2 (``csrc/stft.cu::istft_kernel``) in numpy, in complex64, step by
    step as one warp computes a frame and then the block its rows: Im X[0]
    and Im X[160] set to 0 (unless ``zero_edge_imag`` is False), the
    pre-split Z[k] = E + i O (E = X[k] + conj X[160-k], O = (X[k] - conj
    X[160-k]) e^{+2 pi i k / 320}) with lane l taking k = k1 + 5
    bitrev5(l), radix-2 decimation-in-time butterflies across the 32 lanes
    (K1's stages undone, the upper lane twiddled), the twiddle
    W160^-(lane k1), a 5-point inverse DFT in each lane (lane l holds
    z[32 n1 + l]), the window / 320; then blocks of ``rows`` output rows
    over frames q0 .. q0 + rows (zero past T): overlap-add, the envelope divide,
    zero past row T, trim to ``length``.  All constants come from ``tab``
    (default ``istft_table_np``)."""
    tab = kstft.istft_table_np() if tab is None else tab
    win = tab[:320]
    tw = (tab[320:640:2] + 1j * tab[321:640:2]).astype(np.complex64)
    w320 = (tab[640:960:2] + 1j * tab[641:960:2]).astype(np.complex64)
    env = tab[960:].reshape(2, 160)
    x = (spec[..., 0] + 1j * spec[..., 1]).astype(np.complex64)  # [B, T, 161]
    if zero_edge_imag:
        x[..., 0] = x[..., 0].real
        x[..., 160] = x[..., 160].real
    lane = np.arange(32)
    k = np.arange(5)[:, None] + 5 * np.array([_bitrev5(i) for i in lane])  # [k1, lane]
    a, c = x[..., k], np.conj(x[..., 160 - k])
    v = (a + c) + 1j * ((a - c) * w320[k])
    for h in (1, 2, 4, 8, 16):
        upper = (lane & h) != 0
        t = np.where(upper, v * tw[5 * (lane & (h - 1)) * (16 // h)], v)
        other = t[..., lane ^ h]
        v = np.where(upper, other - t, t + other).astype(np.complex64)
    for k1 in range(1, 5):
        v[..., k1, :] = v[..., k1, :] * tw[lane * k1]
    z = []
    for n1 in range(5):
        acc = v[..., 0, :]
        for k1 in range(1, 5):
            acc = acc + v[..., k1, :] * tw[32 * ((n1 * k1) % 5)]
        z.append(acc)
    z = np.stack(z, axis=-2).reshape(*x.shape[:-1], 160)  # n = 32 n1 + lane
    frames = np.stack([z.real, z.imag], axis=-1).reshape(*x.shape[:-1], 320) * win

    b, t_frames = x.shape[:2]
    n_rows = -(-length // 160)
    out = np.zeros((b, n_rows + rows, 160), np.float32)
    for q0 in range(0, n_rows, rows):
        fr = np.zeros((b, rows + 1, 320), np.float32)
        have = frames[:, q0:q0 + rows + 1]
        fr[:, :have.shape[1]] = have
        for i in range(rows):
            r = q0 + i + 1
            if r <= t_frames:
                out[:, q0 + i] = (fr[:, i + 1, :160] + fr[:, i, 160:]) / env[int(r == t_frames)]
    return out.reshape(b, -1)[:, :length]


@pytest.mark.parametrize("length", [161, 2017, 48000])
@pytest.mark.parametrize("out_delta", [0, -100, 333])
def test_k2_emulation_reproduces_plain(rng, length, out_delta):
    """K2's FFT and tiling with its table (float64 built, float32 stored)
    equal the plain ISTFT on an STFT's spectrum, at an output length equal
    to, 100 shorter than and 333 longer than the signal (numerators at
    row T, 1e-5 x max|ref|)."""
    x = rng.standard_normal((2, length)).astype(np.float32)
    spec = pstft.stft_plain(torch.from_numpy(x)).numpy()
    out_len = length + out_delta
    want = pstft.istft_plain(torch.from_numpy(spec), length=out_len).numpy()
    got = _k2_emulate(spec, out_len)
    _close_rel(_numerators(got, spec.shape[1]), _numerators(want, spec.shape[1]), 1e-5)


@pytest.mark.parametrize("rows", kstft.ISTFT_TILES)
@pytest.mark.parametrize("edge", ["1", "R", "R+1", "2R+1"])
@pytest.mark.parametrize("out_len", ["short", "in_row_t", "past_t"])
def test_k2_emulation_on_a_raw_spectrum(rng, rows, edge, out_len):
    """On a random spectrum whose DC and Nyquist bins have imaginary parts
    (as the DDPM's estimate has), at the edges of each tile the kernel is
    built for (T = 1, R, R + 1, 2R + 1 with R rows a block), with an output
    shorter than one row, ending inside row T, or reaching 2 rows past T:
    K2 equals the plain ISTFT."""
    t_frames = {"1": 1, "R": rows, "R+1": rows + 1, "2R+1": 2 * rows + 1}[edge]
    spec = rng.standard_normal((3, t_frames, 161, 2)).astype(np.float32)
    assert np.abs(spec[..., [0, 160], 1]).min() > 0
    length = {"short": 100, "in_row_t": t_frames * 160 - 50,
              "past_t": (t_frames + 2) * 160 + 37}[out_len]
    want = pstft.istft_plain(torch.from_numpy(spec), length=length).numpy()
    got = _k2_emulate(spec, length, rows=rows)
    _close_rel(_numerators(got, t_frames), _numerators(want, t_frames), 1e-5)


@pytest.mark.parametrize("fault", ["symmetric_window", "imag_dc_kept"])
def test_k2_emulation_sees_a_fault(rng, fault):
    """The emulation above can fail: with the symmetric Hann window in K2's
    table, or with Im X[0] and Im X[160] kept, it misses the plain ISTFT by
    more than 1e-3 x max|ref|."""
    spec = rng.standard_normal((2, 13, 161, 2)).astype(np.float32)
    tab = kstft.istft_table_np()
    if fault == "symmetric_window":
        tab[:320] = torch.hann_window(320, periodic=False).numpy() / 320
    length = (spec.shape[1] - 1) * 160
    got = _k2_emulate(spec, length, tab, zero_edge_imag=fault != "imag_dc_kept")
    want = pstft.istft_plain(torch.from_numpy(spec), length=length).numpy()
    assert np.abs(got - want).max() > 1e-3 * np.abs(want).max()


def test_istft_table_matches_its_definition():
    """K2's table: the plain version's float32 Hann window / 320, the
    twiddles e^{+2 pi i m / 160} and e^{+2 pi i k / 320}, and the envelope
    rows 1..T-1 and T, each computed in float64 and rounded once to
    float32."""
    tab = kstft.istft_table_np()
    assert tab.dtype == np.float32 and tab.shape == (1280,)
    np.testing.assert_array_equal(
        tab[:320], (pstft.hann_window(320).astype(np.float64) / 320).astype(np.float32))
    w160 = np.exp(2j * np.pi * np.arange(160) / 160)
    w320 = np.exp(2j * np.pi * np.arange(160) / 320)
    np.testing.assert_array_equal(tab[320:640:2], w160.real.astype(np.float32))
    np.testing.assert_array_equal(tab[321:640:2], w160.imag.astype(np.float32))
    np.testing.assert_array_equal(tab[640:960:2], w320.real.astype(np.float32))
    np.testing.assert_array_equal(tab[641:960:2], w320.imag.astype(np.float32))
    env = pstft._envelope_np(5, 320, 160).astype(np.float32)
    np.testing.assert_array_equal(tab[960:1120], env[160:320])  # any row 1..T-1
    np.testing.assert_array_equal(tab[960:1120], env[640:800])
    np.testing.assert_array_equal(tab[1120:], env[800:])  # row T


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
