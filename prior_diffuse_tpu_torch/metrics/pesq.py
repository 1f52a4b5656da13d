"""PESQ wrapper (optional dependency).

A copy of ``prior_diffuse_tpu/metrics/pesq.py``.  The ``pesq`` C binding
is optional; the reference treats PESQ failures as soft (swallowed per-utterance, ``utils/metrics.py:449-450``).
We mirror that: when unavailable, :func:`pesq_score` returns ``None``
and the composite regression uses 0.0 for the PESQ term.

Includes the reference's narrowband raw-MOS remap for fs < 16 kHz
(``utils/metrics.py:433-448``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:  # pragma: no cover - optional binding
    from pesq import pesq as _pesq_inner
    from pesq import PesqError as _PesqError

    HAVE_PESQ = True
except ImportError:  # pragma: no cover
    _pesq_inner = None
    _PesqError = Exception
    HAVE_PESQ = False


def pesq_mode() -> str:
    """Which regime produced PESQ values (and therefore CSIG/CBAK/COVL):

    * ``"p862"``  — the real ITU P.862 binding;
    * ``"approx"`` — the in-repo approximation (``PDT_APPROX_PESQ=1``),
      scores labeled approximate;
    * ``"absent"`` — no PESQ available: composite() substitutes 0.0 for
      the PESQ term, so CSIG/CBAK/COVL are systematically deflated and
      must not be compared against PESQ-bearing numbers.
    """
    if HAVE_PESQ:
        return "p862"
    import os

    if os.environ.get("PDT_APPROX_PESQ") == "1":
        return "approx"
    return "absent"


def _nb_remap(mos: float) -> float:
    return 46607 / 14945 - (2000 * np.log(1 / (mos / 4 - 999 / 4000) - 1)) / 2989


def pesq_score(
    clean: np.ndarray, processed: np.ndarray, fs: int
) -> Optional[float]:
    """Wideband PESQ MOS, or ``None`` when the binding is unavailable or
    PESQ rejects the pair.

    Without the binding, setting ``PDT_APPROX_PESQ=1`` falls back to the
    in-repo approximate P.862.2 implementation (``metrics.pesq_np``);
    scores are then *approximate* and flagged as such in the docs.
    """
    if not HAVE_PESQ:
        import os

        if os.environ.get("PDT_APPROX_PESQ") == "1":
            from prior_diffuse_tpu_torch.metrics.pesq_np import pesq_approx

            try:
                return pesq_approx(clean, processed, fs)
            except Exception:
                return None
        return None
    from scipy.signal import resample

    try:
        if fs == 8000:
            return _nb_remap(_pesq_inner(fs, clean, processed, "nb"))
        if fs == 16000:
            return float(_pesq_inner(fs, clean, processed, "wb"))
        if fs > 16000:
            n = round(len(clean) / fs * 16000)
            return float(
                _pesq_inner(16000, resample(clean, n), resample(processed, n), "wb")
            )
        n = round(len(clean) / fs * 8000)
        return _nb_remap(
            _pesq_inner(8000, resample(clean, n), resample(processed, n), "nb")
        )
    except _PesqError:
        return None
