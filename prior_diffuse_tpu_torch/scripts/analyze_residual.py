"""Plot clean - estimate residual waveforms (the residual diffusion
design's motivation).

The counterpart of the repository's ``scripts/analyze_residual.py``: for
the first ``n`` wavs of ``clean_dir`` (by name), the residual against the
same name in ``estimate_dir`` as ``<out_dir>/residual_<name>.png``
(``viz.py::plot_wav``, which needs matplotlib) and its RMS.

Usage::

    python -m prior_diffuse_tpu_torch.scripts.analyze_residual clean_dir estimate_dir out_dir [n]
"""

from __future__ import annotations

import argparse
import glob
import os


def main(argv=None) -> dict:
    """Plot and print each residual; returns ``{name: residual rms}``."""
    import numpy as np

    from prior_diffuse_tpu_torch.data.wavio import read_wav
    from prior_diffuse_tpu_torch.viz import plot_wav

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("clean_dir")
    ap.add_argument("estimate_dir")
    ap.add_argument("out_dir")
    ap.add_argument("n", nargs="?", type=int, default=4)
    a = ap.parse_args(argv)
    os.makedirs(a.out_dir, exist_ok=True)
    names = sorted(os.path.basename(p) for p in glob.glob(f"{a.clean_dir}/*.wav"))[:a.n]
    out = {}
    for name in names:
        c, _ = read_wav(os.path.join(a.clean_dir, name))
        e, _ = read_wav(os.path.join(a.estimate_dir, name))
        m = min(len(c), len(e))
        plot_wav(c[:m] - e[:m], title=f"residual {name}",
                 path=os.path.join(a.out_dir, f"residual_{name}.png"))
        out[name] = float(np.sqrt(np.mean((c[:m] - e[:m]) ** 2)))
        print(name, "residual rms:", out[name])
    return out


if __name__ == "__main__":
    main()
