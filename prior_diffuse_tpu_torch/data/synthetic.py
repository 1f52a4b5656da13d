"""Synthetic VoiceBank-DEMAND-shaped data for tests and smoke runs.

Generates clean "speech" (harmonic tones with an envelope) plus noise,
and writes paired ``{noisy,clean}_{trainset,testset}_wav`` trees so the
full data pipeline / trainers run without the real corpus.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from prior_diffuse_tpu_torch.data.wavio import write_wav


def make_utterance(
    rng: np.random.Generator, length: int, sr: int = 16000, snr_db: float = 5.0
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (noisy, clean) float32 pair."""
    t = np.arange(length) / sr
    f0 = rng.uniform(90, 250)
    clean = np.zeros(length, np.float32)
    for h in range(1, 6):
        clean += (1.0 / h) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    env = 0.4 * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t))
    clean = (clean * env / np.max(np.abs(clean))).astype(np.float32) * 0.5
    noise = rng.standard_normal(length).astype(np.float32)
    p_clean = np.mean(clean**2)
    p_noise = np.mean(noise**2)
    noise *= np.sqrt(p_clean / (p_noise * 10 ** (snr_db / 10)))
    return clean + noise, clean


def make_speechlike(
    rng: np.random.Generator,
    length: int,
    sr: int = 16000,
    snr_db: float = 5.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Harder speech-shaped pair for convergence demos: voiced segments
    (time-varying F0, 20 harmonics shaped by random formant resonances),
    unvoiced fricative-like bursts, silence gaps; the noise is
    amplitude-modulated broadband + tonal interference at a controlled
    per-utterance SNR.  -> (noisy, clean)."""
    t = np.arange(length) / sr
    clean = np.zeros(length, np.float64)

    # segment grid: ~50-250 ms segments of voiced / unvoiced / silence
    pos = 0
    while pos < length:
        seg_len = int(rng.uniform(0.05, 0.25) * sr)
        seg_len = min(seg_len, length - pos)
        kind = rng.choice(["voiced", "unvoiced", "silence"],
                          p=[0.55, 0.25, 0.20])
        ts = t[pos : pos + seg_len]
        if kind == "voiced":
            f0 = rng.uniform(90, 280)
            drift = rng.uniform(-40, 40)
            inst_f0 = f0 + drift * (ts - ts[0]) / max(ts[-1] - ts[0], 1e-6)
            phase = 2 * np.pi * np.cumsum(inst_f0) / sr
            # random 3-formant spectral envelope over harmonics
            formants = rng.uniform([300, 900, 2200], [800, 2000, 3400])
            bws = rng.uniform(80, 220, size=3)
            seg = np.zeros(seg_len)
            for h in range(1, 21):
                fh = np.mean(inst_f0) * h
                if fh > sr / 2 - 200:
                    break
                gain = sum(
                    1.0 / (1.0 + ((fh - fc) / bw) ** 2)
                    for fc, bw in zip(formants, bws)
                ) / h**0.5
                seg += gain * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
        elif kind == "unvoiced":
            seg = rng.standard_normal(seg_len)
            # crude high-pass shaping (fricatives live up the band)
            seg = np.diff(seg, prepend=seg[0])
        else:
            seg = np.zeros(seg_len)
        # attack/decay ramps avoid clicks
        ramp = min(160, seg_len // 4)
        if ramp > 0:
            w = np.ones(seg_len)
            w[:ramp] = np.linspace(0, 1, ramp)
            w[-ramp:] = np.linspace(1, 0, ramp)
            seg = seg * w
        if np.max(np.abs(seg)) > 0:
            seg = seg / np.max(np.abs(seg)) * rng.uniform(0.3, 0.9)
        clean[pos : pos + seg_len] = seg
        pos += seg_len

    clean = (clean / max(np.max(np.abs(clean)), 1e-9) * 0.6).astype(np.float32)

    # modulated broadband + tonal interference
    noise = rng.standard_normal(length)
    mod = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) * t
                             + rng.uniform(0, 2 * np.pi))
    noise = noise * mod
    for _ in range(2):
        noise += 0.5 * np.sin(2 * np.pi * rng.uniform(300, 3000) * t
                              + rng.uniform(0, 2 * np.pi))
    noise = noise.astype(np.float32)
    p_clean = np.mean(clean**2)
    p_noise = np.mean(noise**2)
    noise *= np.sqrt(p_clean / (p_noise * 10 ** (snr_db / 10)))
    return clean + noise, clean


def write_corpus_speechlike(
    root: str,
    n_train: int = 48,
    n_test: int = 8,
    sr: int = 16000,
    min_len: int = 48000,
    max_len: int = 64000,
    snr_range: Tuple[float, float] = (0.0, 15.0),
    seed: int = 0,
) -> str:
    """VoiceBank-DEMAND-shaped tree of speech-like pairs at controlled
    per-utterance SNRs (the convergence-demo corpus)."""
    rng = np.random.default_rng(seed)
    for split, n in [("trainset", n_train), ("testset", n_test)]:
        nd = os.path.join(root, f"noisy_{split}_wav")
        cd = os.path.join(root, f"clean_{split}_wav")
        os.makedirs(nd, exist_ok=True)
        os.makedirs(cd, exist_ok=True)
        for i in range(n):
            length = int(rng.integers(min_len, max_len))
            snr = float(rng.uniform(*snr_range))
            noisy, clean = make_speechlike(rng, length, sr, snr)
            name = f"s{split[:2]}_{i:03d}.wav"
            write_wav(os.path.join(nd, name), noisy, sr)
            write_wav(os.path.join(cd, name), clean, sr)
    return root


def write_corpus(
    root: str,
    n_train: int = 8,
    n_test: int = 4,
    sr: int = 16000,
    min_len: int = 24000,
    max_len: int = 64000,
    seed: int = 0,
) -> str:
    """Create the 4-directory layout under ``root``; returns ``root``."""
    rng = np.random.default_rng(seed)
    for split, n in [("trainset", n_train), ("testset", n_test)]:
        nd = os.path.join(root, f"noisy_{split}_wav")
        cd = os.path.join(root, f"clean_{split}_wav")
        os.makedirs(nd, exist_ok=True)
        os.makedirs(cd, exist_ok=True)
        for i in range(n):
            length = int(rng.integers(min_len, max_len))
            noisy, clean = make_utterance(rng, length, sr)
            name = f"p{split[:2]}_{i:03d}.wav"
            write_wav(os.path.join(nd, name), noisy, sr)
            write_wav(os.path.join(cd, name), clean, sr)
    return root
