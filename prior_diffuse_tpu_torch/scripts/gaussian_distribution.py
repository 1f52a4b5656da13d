"""Kolmogorov-Smirnov Gaussianity tests of waveforms and spectral
magnitudes (the PriorGrad prior's motivation).

The counterpart of the repository's ``scripts/gaussian_distribution.py``:
for the first ``n`` wavs of ``wav_dir``, the KS p-value of the
standardised waveform and of the standardised STFT magnitude (the port's
STFT on ``--device``: K1 on the card) against N(0, 1), with scipy.

Usage::

    python -m prior_diffuse_tpu_torch.scripts.gaussian_distribution wav_dir [n] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob

import numpy as np
import torch
from scipy import stats


def main(argv=None) -> dict:
    """Print and return ``{path: (wav KS p, magnitude KS p)}``."""
    from prior_diffuse_tpu_torch.data.wavio import read_wav
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.scripts import _setup

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("wav_dir")
    ap.add_argument("n", nargs="?", type=int, default=8)
    _setup.add_device_arg(ap)
    a = ap.parse_args(argv)
    dev = _setup.device(a.device)
    out = {}
    for path in sorted(glob.glob(f"{a.wav_dir}/*.wav"))[:a.n]:
        w, _ = read_wav(path)
        z = (w - w.mean()) / (w.std() + 1e-12)
        ks_wav = stats.kstest(z, "norm")
        spec = kstft.stft(torch.as_tensor(w[None], device=dev))[0].cpu().numpy()
        mag = np.hypot(spec[..., 0], spec[..., 1]).ravel()
        zm = (mag - mag.mean()) / (mag.std() + 1e-12)
        ks_mag = stats.kstest(zm, "norm")
        out[path] = (float(ks_wav.pvalue), float(ks_mag.pvalue))
        print(f"{path}: wav KS p={ks_wav.pvalue:.3g}  mag KS p={ks_mag.pvalue:.3g}")
    return out


if __name__ == "__main__":
    main()
