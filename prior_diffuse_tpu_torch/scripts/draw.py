"""4-panel spectrogram comparison figure (the reference's paper figure:
noisy / clean / baseline / ours).

The counterpart of the repository's ``scripts/draw.py``: the wav ``name``
from each of the four directories ('-' skips a panel) through
``viz.py::draw_comparison`` (the spectrograms from the port's STFT on
``--device``, K1 on the card; the figure needs matplotlib).

Usage::

    python -m prior_diffuse_tpu_torch.scripts.draw utt.wav noisy_dir clean_dir \\
        baseline_dir ours_dir out.png [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    """Draw the figure; returns its path."""
    from prior_diffuse_tpu_torch.data.wavio import read_wav
    from prior_diffuse_tpu_torch.scripts import _setup
    from prior_diffuse_tpu_torch.viz import draw_comparison

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("name")
    ap.add_argument("dirs_and_out", nargs="+", metavar="dir ... out.png")
    _setup.add_device_arg(ap)
    a = ap.parse_args(argv)
    dev = _setup.device(a.device)
    *dirs, out = a.dirs_and_out
    wavs, titles = [], []
    for d, t in zip(dirs, ["noisy", "clean", "baseline", "ours"]):
        if d == "-":
            continue
        wavs.append(read_wav(os.path.join(d, a.name))[0])
        titles.append(t)
    draw_comparison(wavs, titles, path=out, device=dev)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
