"""Noisy-against-clean floor metrics of a test set.

The counterpart of the repository's ``scripts/cal_metrics.py`` (itself a
port of the reference's, whose recorded VoiceBank-DEMAND means were CSIG
3.35 / CBAK 2.44 / COVL 2.62 / PESQ 1.97 / SSNR 1.67): the six metrics of
``<root>/noisy_testset_wav`` against ``<root>/clean_testset_wav`` through
``metrics/compare.py``, on the host.

Usage::

    python -m prior_diffuse_tpu_torch.scripts.cal_metrics [data_root]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> np.ndarray:
    """Print the floor's means; returns them (:data:`_report.NAMES` order)."""
    from prior_diffuse_tpu_torch.metrics.pesq import pesq_mode
    from prior_diffuse_tpu_torch.scripts._report import mean_scores

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", nargs="?", default="data")
    root = ap.parse_args(argv).root
    pm = mean_scores(f"{root}/clean_testset_wav", f"{root}/noisy_testset_wav")
    print("csig:%6.4f cbak:%6.4f covl:%6.4f pesq:%6.4f ssnr:%6.4f stoi:%6.4f"
          " [pesq=%s]" % (*pm, pesq_mode()))
    return pm


if __name__ == "__main__":
    main()
