"""STOI — short-time objective intelligibility (Taal et al., 2010).

Pure-numpy implementation of the published algorithm, in place of the
``pystoi`` package the reference imports at ``utils/metrics.py:6``; a
copy of ``prior_diffuse_tpu/metrics/stoi.py``.  Standard constants: 10 kHz analysis rate, 256-sample frames
(50% overlap, 512 FFT), 15 one-third-octave bands from 150 Hz, 384 ms
(30-frame) segments, -15 dB clipping, 40 dB silent-frame range.
"""

from __future__ import annotations

import numpy as np

_FS = 10000
_N_FRAME = 256
_NFFT = 512
_NUMBAND = 15
_MINFREQ = 150.0
_N = 30
_BETA = -15.0
_DYN_RANGE = 40.0
_EPS = np.finfo(np.float64).eps


def _hann(n: int) -> np.ndarray:
    return np.hanning(n + 2)[1:-1]


def _frames(x: np.ndarray, flen: int, hop: int) -> np.ndarray:
    n = 1 + (len(x) - flen) // hop if len(x) >= flen else 0
    idx = np.arange(flen)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def _remove_silent(x: np.ndarray, y: np.ndarray):
    w = _hann(_N_FRAME)
    xf = _frames(x, _N_FRAME, _N_FRAME // 2) * w
    yf = _frames(y, _N_FRAME, _N_FRAME // 2) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + _EPS)
    mask = energies > energies.max() - _DYN_RANGE
    xf, yf = xf[mask], yf[mask]
    # overlap-add reconstruction of the retained frames
    n = len(xf)
    out_len = (n - 1) * (_N_FRAME // 2) + _N_FRAME if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        s = i * (_N_FRAME // 2)
        xs[s : s + _N_FRAME] += xf[i]
        ys[s : s + _N_FRAME] += yf[i]
    return xs, ys


def _third_octave_matrix() -> np.ndarray:
    f = np.linspace(0, _FS, _NFFT + 1)[: _NFFT // 2 + 1]
    k = np.arange(_NUMBAND)
    cf = _MINFREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((_NUMBAND, len(f)))
    for i in range(_NUMBAND):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def _band_env(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    w = _hann(_N_FRAME)
    xf = _frames(x, _N_FRAME, _N_FRAME // 2) * w
    spec = np.fft.rfft(xf, _NFFT, axis=1)  # [T, F]
    power = np.abs(spec) ** 2
    return np.sqrt(obm @ power.T)  # [bands, T]


def _resample(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == _FS:
        return x.astype(np.float64)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(fs, _FS)
    return resample_poly(x.astype(np.float64), _FS // g, fs // g)


def stoi(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """-> intelligibility index in ~[0, 1]."""
    if clean.shape != processed.shape:
        raise ValueError("signals must match in length")
    x = _resample(clean, fs)
    y = _resample(processed, fs)
    x, y = _remove_silent(x, y)
    if len(x) < _N_FRAME * 2:
        return 0.0

    obm = _third_octave_matrix()
    X = _band_env(x, obm)  # [15, T]
    Y = _band_env(y, obm)
    if X.shape[1] < _N:
        return 0.0

    c = 10.0 ** (-_BETA / 20.0)
    scores = []
    for m in range(_N, X.shape[1] + 1):
        xs = X[:, m - _N : m]
        ys = Y[:, m - _N : m]
        alpha = np.linalg.norm(xs, axis=1, keepdims=True) / (
            np.linalg.norm(ys, axis=1, keepdims=True) + _EPS
        )
        ys = ys * alpha
        ys = np.minimum(ys, xs * (1.0 + c))
        xm = xs - xs.mean(axis=1, keepdims=True)
        ym = ys - ys.mean(axis=1, keepdims=True)
        num = np.sum(xm * ym, axis=1)
        den = np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + _EPS
        scores.append(num / den)
    return float(np.mean(scores))
