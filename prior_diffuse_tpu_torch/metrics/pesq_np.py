"""Approximate wideband PESQ (ITU-T P.862.2-style), pure numpy.

A copy of ``prior_diffuse_tpu/metrics/pesq_np.py``, whose docstring
records its validation status.  It implements the *structure* of the
P.862 perceptual model (level and time alignment, Bark-band power
spectra, Zwicker loudness, masked disturbance aggregation, the P.862.2
wideband MOS mapping) with simplifications.

**This is an approximation**: scores correlate with PESQ but are not
the ITU reference values; treat them as ordinal.  It is OFF by default;
enable via ``PDT_APPROX_PESQ=1`` or by calling :func:`pesq_approx`
explicitly.  When the real binding exists it always wins (see
``metrics.pesq``).
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12

_FRAME = 512  # 32 ms @ 16 kHz
_HOP = 256
_NBARK = 49
_SP = 6.910853e-006  # power scaling (P.862 constant family)
_ZWICKER_POWER = 0.23


def _hann(n):
    return 0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / n))


def _active_level(x: np.ndarray) -> float:
    """RMS over 'active' 40ms frames (simple energy VAD)."""
    flen = 640
    n = len(x) // flen
    if n == 0:
        return float(np.sqrt(np.mean(x**2) + _EPS))
    fr = x[: n * flen].reshape(n, flen)
    p = np.mean(fr**2, axis=1)
    thresh = p.max() * 1e-4
    act = p[p > thresh]
    return float(np.sqrt(np.mean(act) + _EPS)) if len(act) else float(
        np.sqrt(p.mean() + _EPS)
    )


def _align(ref: np.ndarray, deg: np.ndarray, max_lag: int = 1600):
    """Single global alignment via envelope cross-correlation."""
    def env(x):
        e = np.abs(x)
        k = np.ones(160) / 160.0
        return np.convolve(e, k, mode="same")[::80]

    er, ed = env(ref), env(deg)
    m = min(len(er), len(ed))
    er, ed = er[:m] - er[:m].mean(), ed[:m] - ed[:m].mean()
    lags = range(-max_lag // 80, max_lag // 80 + 1)
    best, best_lag = -np.inf, 0
    for lag in lags:
        if lag >= 0:
            a, b = er[lag:], ed[: m - lag]
        else:
            a, b = er[: m + lag], ed[-lag:]
        if len(a) < 10:
            continue
        c = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + _EPS))
        if c > best:
            best, best_lag = c, lag
    lag = best_lag * 80
    if lag >= 0:
        ref, deg = ref[lag:], deg[: len(deg) - lag] if lag else deg
    else:
        deg, ref = deg[-lag:], ref[: len(ref) + lag]
    m = min(len(ref), len(deg))
    return ref[:m], deg[:m]


def _bark_matrix(fs: int, nfft: int):
    """[nbark, nfft//2+1] triangular-free (rectangular) Bark binning."""
    f = np.linspace(0, fs / 2, nfft // 2 + 1)
    bark = 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)
    edges = np.linspace(0, bark[-1], _NBARK + 1)
    mat = np.zeros((_NBARK, len(f)))
    idx = np.digitize(bark, edges) - 1
    idx = np.clip(idx, 0, _NBARK - 1)
    for i, b in enumerate(idx):
        mat[b, i] = 1.0
    # normalize by band occupancy
    occ = mat.sum(axis=1, keepdims=True)
    occ[occ == 0] = 1.0
    widths = np.diff(edges)
    return mat, widths


# frequency-dependent absolute threshold (approximate, per Bark band),
# expressed in the internal power units where active speech sits around
# 1e4-1e6 x threshold (the operating range of the P.862 loudness law)
def _abs_threshold(widths):
    centers = np.cumsum(widths) - widths / 2
    # rough ISO-threshold shape mapped to bark centers
    thr_db = 3.64 * (centers / 3 + 0.05) ** -0.8
    thr_db = np.clip(thr_db, 0.0, 60.0)
    thr = 10.0 ** (thr_db / 10.0)
    return thr / thr.mean()


def _loudness(bark_pow, p0):
    """Zwicker loudness per band."""
    ratio = np.maximum(bark_pow / p0[:, None], 0.0)
    s = (p0[:, None] / 0.5) ** _ZWICKER_POWER * (
        np.maximum(0.5 + 0.5 * ratio, _EPS) ** _ZWICKER_POWER - 1.0
    )
    return np.maximum(s, 0.0)


def pesq_approx(ref: np.ndarray, deg: np.ndarray, fs: int = 16000) -> float:
    """-> approximate wideband PESQ MOS in [~1, 4.64]."""
    if fs != 16000:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(fs, 16000)
        ref = resample_poly(ref, 16000 // g, fs // g)
        deg = resample_poly(deg, 16000 // g, fs // g)

    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    # level alignment to a common active level
    target = 10 ** (-26 / 20.0)
    ref = ref * (target / max(_active_level(ref), _EPS))
    deg = deg * (target / max(_active_level(deg), _EPS))
    ref, deg = _align(ref, deg)
    if len(ref) < _FRAME * 2:
        return 1.0

    win = _hann(_FRAME)
    n = 1 + (len(ref) - _FRAME) // _HOP
    idx = np.arange(_FRAME)[None, :] + _HOP * np.arange(n)[:, None]
    spec_r = np.abs(np.fft.rfft(ref[idx] * win, axis=1)) ** 2 * _SP
    spec_d = np.abs(np.fft.rfft(deg[idx] * win, axis=1)) ** 2 * _SP

    bark_mat, widths = _bark_matrix(16000, _FRAME)
    br = bark_mat @ spec_r.T  # [nbark, T]
    bd = bark_mat @ spec_d.T
    p0 = _abs_threshold(widths)
    # self-calibrate into the internal units: active reference frames
    # average 1e5 x threshold (level alignment already normalized both)
    act = br.mean(axis=0) > br.mean() * 0.01
    ref_pow = br[:, act].mean() if act.any() else br.mean()
    scale = 1e5 / max(ref_pow, _EPS)
    br = br * scale
    bd = bd * scale

    # partial gain compensation of the degraded signal (per band, mean
    # over audible frames), a simplified version of P.862's
    audible = br.mean(axis=0) > p0.mean() * 10
    if audible.any():
        gain = (br[:, audible].mean(axis=1) + p0) / (
            bd[:, audible].mean(axis=1) + p0
        )
        gain = np.clip(gain, 2e-2, 5e1)
        bd = bd * gain[:, None]

    lr = _loudness(br, p0)
    ld = _loudness(bd, p0)

    # masked disturbance
    diff = ld - lr
    dead = 0.25 * np.minimum(ld, lr)
    d = np.sign(diff) * np.maximum(np.abs(diff) - dead, 0.0)

    # asymmetry factor per cell
    ratio = (bd + 50.0) / (br + 50.0)
    asym = ratio**1.2
    asym[asym < 3.0] = 0.0
    asym = np.minimum(asym, 12.0)

    wb = widths / widths.sum() * _NBARK  # band weights
    # frame disturbances: symmetric L2, asymmetric L1 over bands
    d_frame = np.sqrt(np.sum((np.abs(d) * wb[:, None]) ** 2, axis=0))
    da_frame = np.sum(np.abs(d) * asym * wb[:, None], axis=0)

    # frame weighting by reference energy
    e_frame = (br * wb[:, None]).sum(axis=0)
    wgt = ((e_frame + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / np.maximum(wgt, _EPS), 45.0)
    da_frame = np.minimum(da_frame / np.maximum(wgt, _EPS), 45.0)

    def _lp(x, p, axis=None):
        return np.power(np.mean(np.power(np.maximum(x, 0.0), p), axis=axis), 1 / p)

    # split-second (20-frame) L6 aggregation, then L2 across splits
    def aggregate(x, p_frame=6.0, p_split=2.0, split=20):
        ns = max(len(x) // split, 1)
        splits = [x[i * split : (i + 1) * split] for i in range(ns)]
        vals = np.array([_lp(s, p_frame) for s in splits if len(s)])
        return _lp(vals, p_split)

    d_sym = aggregate(d_frame)
    d_asym = aggregate(da_frame)

    raw = 4.5 - 0.1 * d_sym - 0.0309 * d_asym
    # P.862.2 wideband mapping
    mos = 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    return float(np.clip(mos, 1.0, 4.64))
