"""Histogram of the wav lengths in a directory.

The counterpart of the repository's ``scripts/show_wav_len.py``: prints
the count, mean and longest length in seconds and draws the histogram
(matplotlib, imported when it draws) to ``out``.

Usage::

    python -m prior_diffuse_tpu_torch.scripts.show_wav_len wav_dir [out.png]
"""

from __future__ import annotations

import argparse
import glob


def main(argv=None) -> list:
    """Print the summary and draw the histogram; returns the lengths (s)."""
    import numpy as np

    from prior_diffuse_tpu_torch.data.wavio import read_wav
    from prior_diffuse_tpu_torch.viz import _plt

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("wav_dir")
    ap.add_argument("out", nargs="?", default="wav_lengths.png")
    a = ap.parse_args(argv)
    lengths = []
    for path in glob.glob(f"{a.wav_dir}/*.wav"):
        w, sr = read_wav(path, sr=None)
        lengths.append(len(w) / sr)
    print(f"{len(lengths)} files, mean {np.mean(lengths):.2f}s, max {np.max(lengths):.2f}s")
    plt = _plt()
    fig, ax = plt.subplots()
    ax.hist(lengths, bins=40)
    ax.set_xlabel("seconds")
    ax.set_ylabel("count")
    fig.savefig(a.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print("wrote", a.out)
    return lengths


if __name__ == "__main__":
    main()
