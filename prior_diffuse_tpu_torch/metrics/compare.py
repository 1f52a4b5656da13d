"""Batch / directory metric comparison.

The counterpart of ``prior_diffuse_tpu/metrics/compare.py``:
``compare_complex`` (spectrogram batches -> 6 metrics,
``utils/metrics.py:528-577``) and ``compare`` (two wav directories,
``utils/metrics.py:580-604``), and its command line:

    python -m prior_diffuse_tpu_torch.metrics.compare REF_DIR DEG_DIR

The ISTFT is the port's (K2 on CUDA tensors); metric scoring is host-side
numpy.
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from prior_diffuse_tpu_torch.data.wavio import read_wav
from prior_diffuse_tpu_torch.metrics.composite import compare_one
from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
from prior_diffuse_tpu_torch.signal.compress import decompress_spec

HOP = 160


def spec_batch_to_wavs(
    spec: torch.Tensor,
    frame_nums: Sequence[int],
    feat_type: str = "sqrt",
) -> List[np.ndarray]:
    """De-compress + batched ISTFT to ``(T - 1) * 160`` samples (the JAX
    ``istft`` default length) + per-utterance trim to ``(frames-1)*160``
    samples (the reference's trim, utils/metrics.py:562-563).  A bf16
    estimate (a bf16-compute prior's) is cast to float32 first: K2 is
    float32 only."""
    spec = decompress_spec(spec.float(), feat_type).contiguous()
    wavs = kstft.istft(spec, (spec.shape[1] - 1) * HOP).cpu().numpy()
    return [wavs[i, : (int(fn) - 1) * HOP] for i, fn in enumerate(frame_nums)]


def compare_complex(
    esti: torch.Tensor,
    label: torch.Tensor,
    frame_nums: Sequence[int],
    feat_type: str = "sqrt",
) -> Tuple[float, float, float, float, float, float]:
    """-> mean (csig, cbak, covl, pesq, ssnr, stoi) over the batch."""
    return compare_wavs(spec_batch_to_wavs(label, frame_nums, feat_type),
                        spec_batch_to_wavs(esti, frame_nums, feat_type))


def compare_wavs(label_wavs: Sequence[np.ndarray], esti_wavs: Sequence[np.ndarray]
                 ) -> Tuple[float, float, float, float, float, float]:
    """-> mean (csig, cbak, covl, pesq, ssnr, stoi) over the pairs of
    waveforms (what :func:`compare_complex` scores after its ISTFTs)."""
    results = [compare_one(c, p, 16000) for c, p in zip(label_wavs, esti_wavs)]
    return tuple(np.mean(np.asarray(results), axis=0))


def compare(refdir: str, degdir: str):
    """Score two wav directories pairwise (sequentially); returns the
    per-file list of (csig, cbak, covl, pesq, ssnr, stoi)."""
    reffiles = sorted(glob.glob(os.path.join(refdir, "*.wav")))
    degfiles = sorted(glob.glob(os.path.join(degdir, "*.wav")))
    if len(reffiles) != len(degfiles):
        raise ValueError(f"{refdir} holds {len(reffiles)} wavs, {degdir} {len(degfiles)}")
    out = []
    for rf, df in zip(reffiles, degfiles):
        c, _ = read_wav(rf, 16000)
        p, _ = read_wav(df, 16000)
        n = min(len(c), len(p))
        out.append(compare_one(c[:n], p[:n], 16000))
    return out


def main(argv=None):
    """Score DEG_DIR's wavs against REF_DIR's (paired by sorted name) and
    print the mean of each metric, as the JAX package's command line does."""
    import argparse
    import time

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("ref", help="directory of reference (clean) wavs")
    p.add_argument("deg", help="directory of degraded (enhanced) wavs")
    a = p.parse_args(argv)
    t0 = time.time()
    res = compare(a.ref, a.deg)
    pm = np.mean(np.asarray(res), axis=0)
    print("time: %.3f" % (time.time() - t0))
    print("ref=", a.ref)
    print("deg=", a.deg)
    print("csig:%6.4f cbak:%6.4f covl:%6.4f pesq:%6.4f ssnr:%6.4f stoi:%6.4f" % tuple(pm))


if __name__ == "__main__":
    main()
