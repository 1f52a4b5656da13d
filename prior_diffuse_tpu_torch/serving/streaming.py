"""Long-file enhancement: fixed segments with crossfaded overlap-add.

The counterpart of ``prior_diffuse_tpu/serving/streaming.py``.  A long
waveform is RMS-normalised once over the whole file (no per-segment level
pumping), cut into segments of ``segment`` samples that overlap by
``overlap``, enhanced ``batch_size`` segments at a time (one batch shape),
and joined with complementary raised-cosine ramps, so the joins are
seam-free.  It is not the whole-file result: the chain draws its own
``x_T`` for every segment, and a segment's edges see less context.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from prior_diffuse_tpu_torch.serving.enhance import enhance_files
from prior_diffuse_tpu_torch.utils.profiler import count, span, tracing


def enhance_long(enhancer, wav: np.ndarray, generator: Optional[torch.Generator],
                 segment: int = 48000, overlap: int = 4800,
                 batch_size: Optional[int] = None) -> np.ndarray:
    """Enhance one waveform of any length in segments of ``segment``
    samples overlapping by ``overlap``; ``enhancer`` is an ``Enhancer`` or
    a ``prior_only_server``, ``generator`` the one ``torch.Generator`` its
    draws come from (each block of segments advances it).  A wav no longer
    than one segment goes through ``enhance_files`` whole."""
    if not 0 < overlap < segment:
        raise ValueError(f"need 0 < overlap < segment, got {overlap}, {segment}")
    batch_size = batch_size or enhancer.cfg.train.batch_size
    n = len(wav)
    if n <= segment:
        return enhance_files(enhancer, [wav], generator)[0]

    with span("front.call"):
        with span("front.segment"):
            c = np.sqrt(np.sum(wav.astype(np.float64) ** 2) / n)
            c = max(float(c), 1e-12)
            norm = (wav / c).astype(np.float32)

            hop = segment - overlap
            starts = list(range(0, max(n - overlap, 1), hop))
            segs = np.zeros((len(starts), segment), np.float32)
            for i, s in enumerate(starts):
                chunk = norm[s: s + segment]
                segs[i, : len(chunk)] = chunk

        outs = np.zeros_like(segs)
        for i in range(0, len(starts), batch_size):
            block = segs[i: i + batch_size]
            if tracing():
                count("front.audio_samples",
                      sum(min(segment, n - s) for s in starts[i: i + len(block)]))
                count("front.padded_samples", block.size)
            outs[i: i + len(block)] = enhancer.enhance_batch(block, generator).cpu().numpy()

        with span("front.finish"):
            # raised-cosine crossfade: the head of segment i overlaps the tail
            # of segment i - 1 with complementary ramps (fade_in + fade_out == 1)
            fade_in = 0.5 * (1 - np.cos(np.pi * np.arange(overlap) / overlap)).astype(np.float32)
            fade_out = 1.0 - fade_in
            result = np.zeros(starts[-1] + segment, np.float32)
            for i, s in enumerate(starts):
                seg = outs[i].copy()
                if i > 0:
                    seg[:overlap] *= fade_in
                if i < len(starts) - 1:
                    seg[hop:] *= fade_out
                result[s: s + segment] += seg
            return (result[:n] * c).astype(np.float32)
