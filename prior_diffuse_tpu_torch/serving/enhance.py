"""Whole-file enhancement: host normalisation and length bucketing.

The counterpart of ``prior_diffuse_tpu/serving/enhance.py``
(``enhance_files``, ``enhance_waveform``, ``enhance_directory``,
``prior_only_server``), :class:`PriorServer`, the serving path of a
complex prior alone, and :class:`MagServer`, that of a magnitude prior
(GRN) alone.  Files
are length-sorted into batches of ``batch_size`` rows; a batch is padded
to a rung of a
geometric (x1.5) ladder of ``bucket_samples`` multiples and its row count
to a power of two, which bounds the set of batch shapes a directory
produces.  Each wav is RMS-normalised on the host, enhanced, cut back to
its length and de-normalised.

:func:`enhance_files` takes anything with ``enhance_batch`` and ``cfg``: a
server (``cfg`` an ``ExperimentConfig``) or, as the JAX package's, a
trainer (``cfg`` its ``train`` section), whose ``enhance_batch`` runs each
batch on the ranks of its data-parallel group and returns every row.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from prior_diffuse_tpu_torch.config import ExperimentConfig
from prior_diffuse_tpu_torch.data.wavio import read_wav, write_wav
from prior_diffuse_tpu_torch.models.precision import compute_view
from prior_diffuse_tpu_torch.parallel.distributed import is_main
from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
from prior_diffuse_tpu_torch.serving.enhancer import (ComputeEnhancer, serving_copy,
                                                      serving_device, upload_batch,
                                                      weights_key)
from prior_diffuse_tpu_torch.signal.compress import decompress_spec, from_mag_phase
from prior_diffuse_tpu_torch.signal.normalize import rms_scale
from prior_diffuse_tpu_torch.training.base import mag_features, spec_features
from prior_diffuse_tpu_torch.utils.profiler import count, span, tracing


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


class PriorServer:
    """Serve a prior alone: ``wav [B, L]`` -> STFT (K1) -> compression ->
    the prior's module forward in ``dtype`` -> decompress -> ISTFT (K2) ->
    ``[B, L]``, no K3 and no residual DDPM.  It is
    ``ComplexTrainer``'s serving path (JAX ``complex_trainer.py:193-210``)
    and :func:`prior_only_server`'s.  ``net`` is any complex prior of the
    model table (``[B, T, 161, 2] -> [B, T, 161, 2]``); in a ``dtype``
    other than float32 it runs as its ``serving_copy``, as the JAX package
    serves it.  A prior trained in bf16 takes ``compute_dtype`` instead: its
    bf16-compute module forward on the float32 weights
    (``models/precision.py::compute_view``), the estimate cast to float32
    for the ISTFT (K2 is float32 only; JAX's ``ComplexTrainer`` runs a bf16
    ISTFT there, ROADMAP Queue 3)."""

    def __init__(self, net, cfg: ExperimentConfig, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 compute_dtype: torch.dtype = torch.float32):
        if dtype != torch.float32 and compute_dtype != torch.float32:
            raise ValueError("a server casts its weights (dtype) or computes on the f32 "
                             "weights (compute_dtype), not both")
        self.device = serving_device(device)
        self.module = net.to(self.device)
        self.cfg = cfg
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.view = compute_view(self.module, compute_dtype)
        self._net, self._key = None, None

    def net(self):
        """The prior in the server's dtype: the module itself in float32
        (its ``compute_view`` with a ``compute_dtype``), else its
        ``serving_copy``, made again when a weight changed."""
        net = self.view.eval()
        if self.dtype == torch.float32:
            return net
        key = weights_key(net)
        if key != self._key:
            self._net, self._key = serving_copy(net, self.dtype), key
            count("enh.repacks")
        return self._net

    @torch.no_grad()
    def prior(self, feat: torch.Tensor) -> torch.Tensor:
        """Compressed spectrum ``feat [B, T, 161, 2]`` -> the prior's
        estimate, in the server's dtype."""
        with span("enh.prior"):
            return self.net()(feat.to(self.dtype))

    @torch.no_grad()
    def enhance_batch(self, wav, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``wav [B, L]`` -> ``[B, L]`` float32.  Draws nothing: the
        generator is taken and not used."""
        with span("enh.batch"):
            wav = upload_batch(wav, self.device)
            with span("enh.features"):
                feat = spec_features(wav, self.cfg.train)
            est = self.prior(feat)
            with span("enh.istft"):
                spec = decompress_spec(est.float(), self.cfg.train.feat_type)
                return kstft.istft(spec.contiguous(), wav.shape[-1])


class MagServer(PriorServer):
    """Serve a magnitude prior alone (``MagTrainer``'s serving path, JAX
    ``mag_trainer.py:201-217``): ``wav [B, L]`` -> STFT (K1) ->
    compression -> the compressed magnitude through the prior (GRN, ``[B,
    T, 161] -> [B, T, 161]``) -> the estimate on the **noisy** phase ->
    decompress -> ISTFT (K2) -> ``[B, L]``.  Float32, as the JAX trainer
    serves it, or the prior's bf16-compute forward (``compute_dtype``) for a
    GRN trained in bf16 (its output is float32, so the rest is too)."""

    def __init__(self, net, cfg: ExperimentConfig, device="cuda",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(net, cfg, device, compute_dtype=compute_dtype)

    @torch.no_grad()
    def enhance_batch(self, wav, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``wav [B, L]`` -> ``[B, L]`` float32.  Draws nothing."""
        with span("enh.batch"):
            wav = upload_batch(wav, self.device)
            with span("enh.features"):
                feat, phase = mag_features(wav, self.cfg.train)
            est = self.prior(feat)
            with span("enh.istft"):
                spec = decompress_spec(from_mag_phase(est.float(), phase),
                                       self.cfg.train.feat_type)
                return kstft.istft(spec.contiguous(), wav.shape[-1])


def prior_only_server(enhancer, dtype: Optional[torch.dtype] = None) -> PriorServer:
    """A :class:`PriorServer` of the prior of ``enhancer`` (its ``x_init``,
    no residual DDPM) through the same wav -> STFT -> ISTFT -> wav path,
    with the prior in ``dtype`` (default the enhancer's).  As the JAX
    package's, the prior is the module's own forward.  It has
    ``enhance_batch`` and ``cfg``, so :func:`enhance_files` and
    ``streaming.enhance_long`` take it where they take an ``Enhancer``.
    Chain-vs-prior comparisons on identical weights isolate the residual
    DDPM's contribution.  The prior of a :class:`ComputeEnhancer` (bf16
    training) runs in its compute dtype on the float32 weights, as the JAX
    package's does for a bf16-trained trainer, unless ``dtype`` is given."""
    if isinstance(enhancer, ComputeEnhancer) and dtype is None:
        return PriorServer(enhancer.dis, enhancer.cfg, enhancer.device,
                           compute_dtype=enhancer.compute_dtype)
    return PriorServer(enhancer.dis, enhancer.cfg, enhancer.device, dtype or enhancer.dtype)


def _train_cfg(enhancer):
    """The ``train`` section of a server's config, or a trainer's ``cfg``."""
    return getattr(enhancer.cfg, "train", enhancer.cfg)


def enhance_files(enhancer, wavs: List[np.ndarray], generator: torch.Generator,
                  batch_size: Optional[int] = None,
                  bucket_samples: int = 16000) -> List[np.ndarray]:
    """Enhance a list of waveforms; returns same-length enhanced wavs."""
    batch_size = batch_size or _train_cfg(enhancer).batch_size
    lengths = [len(w) for w in wavs]
    results: List[Optional[np.ndarray]] = [None] * len(wavs)
    with span("front.call"):
        for idx, rows, pad_to in _buckets(lengths, batch_size, bucket_samples):
            with span("front.prepare"):
                batch = np.zeros((rows, pad_to), np.float32)
                scales = np.zeros(len(idx), np.float64)
                for row, j in enumerate(idx):
                    with np.errstate(divide="ignore"):  # an all-zero wav: scale inf
                        c = max(1.0 / float(rms_scale(wavs[j])), 1e-12)
                    batch[row, : lengths[j]] = wavs[j] / c
                    scales[row] = c
            if tracing():
                count("front.audio_samples", sum(lengths[j] for j in idx))
                count("front.padded_samples", rows * pad_to)
            out = enhancer.enhance_batch(batch, generator).cpu().numpy()
            with span("front.finish"):
                for row, j in enumerate(idx):
                    results[j] = (out[row, : lengths[j]] * scales[row]).astype(np.float32)
    return results  # type: ignore[return-value]


def enhance_waveform(enhancer, wav: np.ndarray,
                     generator: torch.Generator) -> np.ndarray:
    """Enhance one waveform (normalise, enhance, restore the scale)."""
    return enhance_files(enhancer, [wav], generator)[0]


def enhance_directory(enhancer, data_path: str, out_dir: str,
                      generator: torch.Generator) -> float:
    """Enhance every wav under ``data_path`` into ``out_dir`` (same names,
    PCM16); returns the real-time factor on the host clock (seconds of
    audio per second of wall time, decode and write excluded).  In a process
    group rank 0 alone writes."""
    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(data_path, "*.wav")))
    if not paths:
        raise FileNotFoundError(f"no wavs under {data_path}")
    sr = _train_cfg(enhancer).sample_rate
    wavs = [read_wav(p, sr)[0] for p in paths]
    t0 = time.perf_counter()
    enhanced = enhance_files(enhancer, wavs, generator)
    wall = time.perf_counter() - t0
    if is_main():
        for p, w in zip(paths, enhanced):
            write_wav(os.path.join(out_dir, os.path.basename(p)), w, sr)
    audio_sec = sum(len(w) for w in wavs) / sr
    rtf = audio_sec / wall if wall > 0 else float("inf")
    logging.info("enhanced %d files (%.1f s audio) in %.2f s -> RTF %.1fx",
                 len(paths), audio_sec, wall, rtf)
    return rtf
