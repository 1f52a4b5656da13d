"""The reference serving path: whole-file bucketing, long-file segments,
and one batch through the prior and the fast reverse chain.

What the port's front end does on the host is worked out here again from
the published behaviour: files sorted by length into batches of
``batch_size``, each padded to a rung of a x1.5 ladder of
``bucket_samples`` multiples and its rows to a power of two, every wav
divided by its RMS and the result multiplied back; a long recording
normalised once, cut into segments overlapping by ``overlap``, enhanced
``batch_size`` at a time and joined by raised-cosine crossfades.  The
chain's initial draws come from ``draw(shape)`` in the order the batches
are served.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dsp


def ladder_pad(longest: int, bucket: int) -> int:
    rung = bucket
    while rung < longest:
        rung = -(-int(rung * 1.5) // bucket) * bucket
    return rung


def ladder_rows(count: int, batch_size: int) -> int:
    rows = 1
    while rows < count:
        rows *= 2
    return min(rows, max(batch_size, count))


def buckets(lengths, batch_size: int, bucket: int):
    """``(file indices, rows, padded length)`` of each batch, in order."""
    order = np.argsort(lengths)
    for i in range(0, len(order), batch_size):
        idx = order[i: i + batch_size]
        yield idx, ladder_rows(len(idx), batch_size), ladder_pad(
            max(lengths[j] for j in idx), bucket)


def frames(length: int) -> int:
    return length // dsp.HOP + 1


@torch.no_grad()
def enhance_batch(prior, ddpm, wav: np.ndarray, x_t: torch.Tensor, sched: dsp.Schedule,
                  scale_c: float, block: int, keep=lambda x: x) -> np.ndarray:
    """``wav [B, L]`` (normalised, padded) and the chain's initial draw
    ``x_t [B, T, 161, 2]`` -> ``[B, L]``: STFT, compression, the prior's
    estimate over ``scale_c``, the reverse chain of the denoiser from
    ``x_t`` conditioned on that estimate, the estimate added back, times
    ``scale_c``, decompression, ISTFT.  ``block`` rows at a time (every
    layer acts on each row alone in eval mode).  ``keep`` rounds the
    chain's state after each step (the controls)."""
    if np.any(np.asarray(sched.sigma) != 0):
        raise ValueError("the reference chain covers noiseless schedules only")
    dev = x_t.device
    c1, c2, times = dsp.f32(sched.c1), dsp.f32(sched.c2), dsp.f32(sched.t)
    out = []
    for i in range(0, wav.shape[0], block):
        w = torch.as_tensor(wav[i: i + block], dtype=torch.float32, device=dev)
        feat = dsp.compress(dsp.stft(w))
        x_init = keep(prior(feat) / scale_c)
        x = keep(x_t[i: i + block].float())
        for n in range(len(times) - 1, -1, -1):
            t = torch.full((w.shape[0],), times[n], dtype=torch.float32, device=dev)
            x = keep(c1[n] * (x - c2[n] * ddpm(x, x_init, t)))
        est = (x + x_init) * scale_c
        out.append(dsp.istft(dsp.decompress(est), w.shape[1]).cpu().numpy())
    return np.concatenate(out)


def enhance_files(batch_fn, wavs, draw, batch_size: int, bucket: int) -> list:
    """Each wav of ``wavs`` enhanced through ``batch_fn(padded [rows, L],
    x_t)``, ``x_t = draw((1, rows, T, 161, 2))[0]``, in bucket order."""
    lengths = [len(w) for w in wavs]
    results = [None] * len(wavs)
    for idx, rows, pad_to in buckets(lengths, batch_size, bucket):
        batch = np.zeros((rows, pad_to), np.float32)
        scales = []
        for row, j in enumerate(idx):
            c = dsp.rms_factor(wavs[j])
            batch[row, : lengths[j]] = wavs[j] / c
            scales.append(c)
        out = batch_fn(batch, draw((1, rows, frames(pad_to), dsp.FREQ, 2))[0])
        for row, j in enumerate(idx):
            results[j] = (out[row, : lengths[j]] * np.float64(scales[row])).astype(np.float32)
    return results


def enhance_long(batch_fn, wav: np.ndarray, draw, segment: int, overlap: int,
                 batch_size: int) -> np.ndarray:
    """A recording longer than ``segment`` through segments of ``segment``
    samples overlapping by ``overlap``, joined by raised-cosine ramps."""
    n = len(wav)
    if n <= segment:
        raise ValueError("the reference's long path takes recordings longer than a segment")
    c = dsp.rms_factor(wav)
    norm = (wav / c).astype(np.float32)
    hop = segment - overlap
    starts = list(range(0, n - overlap, hop))
    segs = np.zeros((len(starts), segment), np.float32)
    for i, s in enumerate(starts):
        chunk = norm[s: s + segment]
        segs[i, : len(chunk)] = chunk
    outs = np.zeros_like(segs)
    for i in range(0, len(starts), batch_size):
        block = segs[i: i + batch_size]
        outs[i: i + len(block)] = batch_fn(
            block, draw((1, len(block), frames(segment), dsp.FREQ, 2))[0])
    ramp = (0.5 * (1 - np.cos(np.pi * np.arange(overlap) / overlap))).astype(np.float32)
    result = np.zeros(starts[-1] + segment, np.float32)
    for i, s in enumerate(starts):
        seg = outs[i].copy()
        if i > 0:
            seg[:overlap] *= ramp
        if i < len(starts) - 1:
            seg[hop:] *= 1.0 - ramp
        result[s: s + segment] += seg
    return (result[:n] * c).astype(np.float32)
