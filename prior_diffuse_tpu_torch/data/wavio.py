"""WAV I/O without external audio libraries.

The reference reads with ``librosa.load(sr=16000)`` (resample + float32
in [-1, 1]) and writes with ``soundfile.write`` (PCM16).  This module
provides the same behavior without either library, on numpy + scipy: RIFF/WAVE PCM 16/24/32-bit and IEEE-float
reading, channel averaging to mono, polyphase resampling, PCM16
writing.

A copy of ``prior_diffuse_tpu/data/wavio.py`` (numpy, scipy and
``wave`` only).
"""

from __future__ import annotations

import struct
import wave
from typing import Optional, Tuple

import numpy as np


def _resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def read_wav(path: str, sr: Optional[int] = 16000) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono waveform in [-1, 1], sample_rate).

    If ``sr`` is given the waveform is resampled to it (librosa.load
    semantics).  Pass ``sr=None`` to keep the native rate.
    """
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            cid, size = head[:4], struct.unpack("<I", head[4:])[0]
            payload = f.read(size)
            if size % 2:
                f.read(1)
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
                if fmt is not None:
                    break
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        (audio_fmt, n_ch, rate, _, _, bits) = struct.unpack("<HHIIHH", fmt[:16])
        if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
            audio_fmt = struct.unpack("<H", fmt[24:26])[0]

        if audio_fmt == 1:  # PCM
            if bits == 16:
                x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            elif bits == 32:
                x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
            elif bits == 24:
                raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
                ints = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
                x = ints.astype(np.float32) / float(1 << 23)
            elif bits == 8:
                x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
            else:
                raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
        elif audio_fmt == 3:  # IEEE float
            x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported WAV format code {audio_fmt}")

    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    if sr is not None and rate != sr:
        x = _resample(x, rate, sr)
        rate = sr
    return np.ascontiguousarray(x, np.float32), rate


def write_wav(path: str, x: np.ndarray, sr: int = 16000) -> None:
    """Write float waveform as PCM16 (soundfile.write default subtype)."""
    x = np.asarray(x, np.float32)
    # symmetric 32768 scale (libsndfile convention), clipped to int16 range
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
