"""Composite speech-quality metrics (Loizou 2007): SSNR, fwSNRseg, LLR,
WSS and the CSIG/CBAK/COVL regressions.

Parity target: the reference's numpy implementations in
``utils/metrics.py:36-474`` (themselves the standard public formulas).
This is an independent, vectorized rewrite of those published
algorithms: same windows (asymmetric Hann ``0.5(1-cos(2*pi*n/(N+1)))``),
same 25 critical-band center frequencies/bandwidths, same Loizou
regression constants and clipping, same quirks (SNRseg drops the final
frame; LLR/WSS keep the best 95% of frames).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.signal import stft as _scipy_stft

_EPS = np.finfo(np.float64).eps

# 25 critical bands (Loizou): center frequencies and bandwidths in Hz
_CENT_FREQ = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63,
])
_BANDWIDTH = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056,
    95.3398, 105.411, 116.256, 127.914, 140.423, 153.823, 168.154,
    183.457, 199.776, 217.153, 235.631, 255.255, 276.072, 298.126,
    321.465, 346.136,
])


def _win_params(fs: int, frame_len: float = 0.03, overlap: float = 0.75):
    winlength = round(frame_len * fs)
    skiprate = int(np.floor((1 - overlap) * frame_len * fs))
    return winlength, skiprate


def _asym_hann(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(1, n + 1) / (n + 1)))


def _frames(x: np.ndarray, winlength: int, skiprate: int,
            window: Optional[np.ndarray] = None) -> np.ndarray:
    n = (len(x) - (winlength - skiprate)) // skiprate
    idx = np.arange(winlength)[None, :] + skiprate * np.arange(n)[:, None]
    out = x[idx]
    return out * window if window is not None else out


def _crit_filter(fs: int, n_fftby2: int) -> np.ndarray:
    max_freq = fs / 2.0
    bw_min = _BANDWIDTH[0]
    min_factor = np.exp(-30.0 / (2.0 * 2.303))
    j = np.arange(n_fftby2)
    f0 = np.floor(_CENT_FREQ / max_freq * n_fftby2)[:, None]
    bw = (_BANDWIDTH / max_freq * n_fftby2)[:, None]
    norm = (np.log(bw_min) - np.log(_BANDWIDTH))[:, None]
    filt = np.exp(-11.0 * ((j[None, :] - f0) / bw) ** 2 + norm)
    return filt * (filt > min_factor)


def snr_seg(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """Segmental SNR in dB, per-frame clipped to [-10, 35]; the final
    frame is dropped (reference quirk, utils/metrics.py:54)."""
    winlength, skiprate = _win_params(fs)
    win = _asym_hann(winlength)
    cf = _frames(clean, winlength, skiprate, win)
    pf = _frames(processed, winlength, skiprate, win)
    sig = np.sum(cf**2, axis=-1)
    noise = np.sum((cf - pf) ** 2, axis=-1)
    seg = 10.0 * np.log10(sig / (noise + _EPS) + _EPS)
    seg = np.clip(seg, -10.0, 35.0)[:-1]
    return float(np.mean(seg))


def _band_spectra(x: np.ndarray, fs: int, winlength: int, skiprate: int,
                  n_fft: int, crit: np.ndarray, power: bool,
                  scale: float = 1.0) -> np.ndarray:
    win = _asym_hann(winlength)
    num_frames = len(x) / skiprate - (winlength / skiprate)
    seg = x[: int(num_frames) * skiprate + int(winlength - skiprate)]
    _, _, z = _scipy_stft(
        seg, fs=fs, window=win, nperseg=winlength,
        noverlap=winlength - skiprate, nfft=n_fft, detrend=False,
        return_onesided=True, boundary=None, padded=False,
    )
    mag = np.abs(z)[:-1, :]
    if power:
        mag = (mag / scale) ** 2
    else:
        mag = mag / mag.sum(0)
    return crit @ mag


def fw_snr_seg(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """Frequency-weighted segmental SNR (utils/metrics.py:58-174)."""
    if clean.shape != processed.shape:
        raise ValueError("signals must match in length")
    clean = clean.astype(np.float64) + _EPS
    processed = processed.astype(np.float64) + _EPS
    winlength, skiprate = _win_params(fs)
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    crit = _crit_filter(fs, n_fft // 2)
    gamma = 0.2

    ce = _band_spectra(clean, fs, winlength, skiprate, n_fft, crit, False)
    pe = _band_spectra(processed, fs, winlength, skiprate, n_fft, crit, False)
    err = np.maximum((ce - pe) ** 2, _EPS)
    w = ce**gamma
    snr_log = 10.0 * np.log10(ce**2 / err)
    fw = np.sum(w * snr_log, 0) / np.sum(w, 0)
    return float(np.mean(np.clip(fw, -10.0, 35.0)))


def _lpc(frame: np.ndarray, order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Levinson-Durbin LPC -> (lp_params [order+1], autocorr [order+1]);
    denominators guarded by eps as in the reference fix
    (utils/metrics.py:214)."""
    n = len(frame)
    # np.sum (not np.dot/BLAS): the Levinson recursion amplifies even
    # 1e-8 summation-order differences into O(0.1) coefficient changes,
    # so autocorrelation must accumulate exactly like the reference.
    r = np.array([np.sum(frame[: n - k] * frame[k:]) for k in range(order + 1)])
    a = np.ones(order)
    e = np.zeros(order + 1)
    rc = np.zeros(order)
    e[0] = r[0]
    for i in range(order):
        if i == 0:
            acc = 0.0
        else:
            a_past = a[:i].copy()
            acc = np.sum(a_past * r[i:0:-1])
        rc[i] = (r[i + 1] - acc) / max(e[i], _EPS)
        a[i] = rc[i]
        if i > 0:
            a[:i] = a_past - rc[i] * a_past[::-1]
        e[i + 1] = (1.0 - rc[i] * rc[i]) * e[i]
    lp = np.concatenate(([1.0], -a)).astype(np.float32)
    return lp, r.astype(np.float32)


def llr(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """Log-likelihood ratio via frame LPC (utils/metrics.py:233-263):
    order 16 for fs >= 10 kHz, best-95% frame truncation."""
    winlength, skiprate = _win_params(fs)
    order = 16 if fs >= 10000 else 10
    win = _asym_hann(winlength)
    cf = _frames(clean, winlength, skiprate, win)
    pf = _frames(processed, winlength, skiprate, win)
    n = len(cf)
    dist = np.zeros(n - 1)
    for i in range(n - 1):
        a_c, r_c = _lpc(cf[i], order)
        a_p, _ = _lpc(pf[i], order)
        from scipy.linalg import toeplitz

        # float32 association must match the reference exactly:
        # A.dot(T.dot(A)) — the denominator suffers catastrophic
        # cancellation, so (A@T)@A rounds to a visibly different value.
        tc = toeplitz(r_c)
        num = a_p.dot(tc.dot(a_p))
        den = a_c.dot(tc.dot(a_c))
        dist[i] = num / den if den != 0 else 1000.0
    dist[dist <= 0] = 1000.0
    dist = np.sort(np.log(dist))
    keep = int(round(len(dist) * 0.95))
    return float(np.mean(dist[:keep]))


def _loc_peaks(slope: np.ndarray, energy: np.ndarray) -> np.ndarray:
    num_crit = len(energy)
    out = np.zeros_like(slope)
    for i in range(len(slope)):
        n = i
        if slope[i] > 0:
            while n < num_crit - 1 and slope[n] > 0:
                n += 1
            out[i] = energy[n - 1]
        else:
            while n >= 0 and slope[n] <= 0:
                n -= 1
            out[i] = energy[n + 1]
    return out


def wss(clean: np.ndarray, processed: np.ndarray, fs: int) -> float:
    """Weighted spectral slope distance (utils/metrics.py:285-427)."""
    if clean.shape != processed.shape:
        raise ValueError("signals must match in length")
    clean = clean.astype(np.float64) + _EPS
    processed = processed.astype(np.float64) + _EPS
    kmax, klocmax = 20.0, 1.0
    winlength, skiprate = _win_params(fs)
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    crit = _crit_filter(fs, n_fft // 2)
    win = _asym_hann(winlength)
    scale = np.sqrt(1.0 / win.sum() ** 2)

    ce = _band_spectra(clean, fs, winlength, skiprate, n_fft, crit, True, scale)
    pe = _band_spectra(processed, fs, winlength, skiprate, n_fft, crit, True, scale)
    log_c = np.clip(10 * np.log10(ce), -100, None)
    log_p = np.clip(10 * np.log10(pe), -100, None)

    slope_c = np.diff(log_c, axis=0)
    slope_p = np.diff(log_p, axis=0)
    dbmax_c = log_c.max(axis=0)
    dbmax_p = log_p.max(axis=0)

    nf = slope_c.shape[1]
    peaks_c = np.zeros_like(slope_c)
    peaks_p = np.zeros_like(slope_p)
    for i in range(nf):
        peaks_c[:, i] = _loc_peaks(slope_c[:, i], log_c[:, i])
        peaks_p[:, i] = _loc_peaks(slope_p[:, i], log_p[:, i])

    wmax_c = kmax / (kmax + dbmax_c - log_c[:-1, :])
    wloc_c = klocmax / (klocmax + peaks_c - log_c[:-1, :])
    wmax_p = kmax / (kmax + dbmax_p - log_p[:-1, :])
    wloc_p = klocmax / (klocmax + peaks_p - log_p[:-1, :])
    w = (wmax_c * wloc_c + wmax_p * wloc_p) / 2.0

    dist = np.sum(w * (slope_c - slope_p) ** 2, axis=0) / np.sum(w, axis=0)
    dist = np.sort(dist)
    keep = int(round(len(dist) * 0.95))
    return float(np.mean(dist[:keep]))


def composite(clean: np.ndarray, processed: np.ndarray, fs: int):
    """-> (segSNR, pesq, Csig, Cbak, Covl, stoi); PESQ falls back to 0.0
    when the optional binding is absent (the reference swallows PESQ
    errors per-utterance the same way, utils/metrics.py:449-450)."""
    from prior_diffuse_tpu_torch.metrics.pesq import pesq_score
    from prior_diffuse_tpu_torch.metrics.stoi import stoi as _stoi

    wss_dist = wss(clean, processed, fs)
    llr_mean = llr(clean, processed, fs)
    seg = snr_seg(clean, processed, fs)
    p = pesq_score(clean, processed, fs)
    pesq_mos = 0.0 if p is None else p
    st = _stoi(clean, processed, fs)

    csig = float(np.clip(3.093 - 1.029 * llr_mean + 0.603 * pesq_mos - 0.009 * wss_dist, 1, 5))
    cbak = float(np.clip(1.634 + 0.478 * pesq_mos - 0.007 * wss_dist + 0.063 * seg, 1, 5))
    covl = float(np.clip(1.594 + 0.805 * pesq_mos - 0.512 * llr_mean - 0.007 * wss_dist, 1, 5))
    return seg, pesq_mos, csig, cbak, covl, st


def compare_one(clean: np.ndarray, processed: np.ndarray, fs: int = 16000):
    """-> (csig, cbak, covl, pesq, ssnr, stoi) — the reference's
    ``compareone`` output ordering; LinAlg failures zero the utterance
    (utils/metrics.py:492-494)."""
    try:
        ssnr, pesq_mos, csig, cbak, covl, st = composite(clean, processed, fs)
    except np.linalg.LinAlgError:
        return 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    return csig, cbak, covl, pesq_mos, ssnr, st
