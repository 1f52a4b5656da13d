"""Whole-file enhancement: host normalisation and length bucketing.

The counterpart of ``prior_diffuse_tpu/serving/enhance.py``
(``enhance_files``, ``enhance_waveform``).  Files are length-sorted into
batches of ``batch_size`` rows; a batch is padded to a rung of a
geometric (x1.5) ladder of ``bucket_samples`` multiples and its row count
to a power of two, which bounds the set of batch shapes a directory
produces.  Each wav is RMS-normalised on the host, enhanced, cut back to
its length and de-normalised.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from prior_diffuse_tpu_torch.signal.normalize import rms_scale


def _ladder_pad(longest: int, bucket_samples: int) -> int:
    rung = bucket_samples
    while rung < longest:
        rung = -(-int(rung * 1.5) // bucket_samples) * bucket_samples
    return rung


def _ladder_rows(count: int, batch_size: int) -> int:
    rows = 1
    while rows < count:
        rows *= 2
    return min(rows, max(batch_size, count))


def _buckets(lengths: Sequence[int], batch_size: int, bucket_samples: int):
    """Yield ``(file indices, rows, padded length)`` per batch."""
    order = np.argsort(lengths)
    for i in range(0, len(order), batch_size):
        idx = order[i: i + batch_size]
        yield (idx, _ladder_rows(len(idx), batch_size),
               _ladder_pad(max(lengths[j] for j in idx), bucket_samples))


def enhance_files(enhancer, wavs: List[np.ndarray], generator: torch.Generator,
                  batch_size: Optional[int] = None,
                  bucket_samples: int = 16000) -> List[np.ndarray]:
    """Enhance a list of waveforms; returns same-length enhanced wavs."""
    batch_size = batch_size or enhancer.cfg.train.batch_size
    lengths = [len(w) for w in wavs]
    results: List[Optional[np.ndarray]] = [None] * len(wavs)
    for idx, rows, pad_to in _buckets(lengths, batch_size, bucket_samples):
        batch = np.zeros((rows, pad_to), np.float32)
        scales = np.zeros(len(idx), np.float64)
        for row, j in enumerate(idx):
            with np.errstate(divide="ignore"):  # an all-zero wav: scale inf
                c = max(1.0 / float(rms_scale(wavs[j])), 1e-12)
            batch[row, : lengths[j]] = wavs[j] / c
            scales[row] = c
        out = enhancer.enhance_batch(batch, generator).cpu().numpy()
        for row, j in enumerate(idx):
            results[j] = (out[row, : lengths[j]] * scales[row]).astype(np.float32)
    return results  # type: ignore[return-value]


def enhance_waveform(enhancer, wav: np.ndarray,
                     generator: torch.Generator) -> np.ndarray:
    """Enhance one waveform (normalise, enhance, restore the scale)."""
    return enhance_files(enhancer, [wav], generator)[0]
