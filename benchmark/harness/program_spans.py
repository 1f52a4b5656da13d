"""The program's own spans and counters, for the per-layer metrics that read
them.

The port records spans and counters in memory while a ``torch.profiler``
capture runs (``prior_diffuse_tpu_torch.utils.profiler``: ``span``,
``count``, ``snapshot``).  A traced run profiles only its window, so after
the window the registry holds that window's records.  A program without
that registry gives None here, and its metrics report nothing.

:func:`totals` works each span name out from the raw records: ``calls``,
``host_s``, ``self_host_s`` (its host time less what its child spans
cover) and ``stream_ms`` (the CUDA-event milliseconds on its stream, None
without CUDA events).  It repeats the program's ``span_totals`` on
purpose: the metrics' arithmetic is part of the yardstick, so it lives
here, where a change to the program cannot move it.
"""

from __future__ import annotations

from typing import Dict, Optional


def snapshot() -> Optional[dict]:
    """The program's registry (``spans``, ``counters``), or None where the
    program has none."""
    try:
        from prior_diffuse_tpu_torch.utils.profiler import snapshot as program_snapshot
    except ImportError:
        return None
    return program_snapshot()


def totals(snap: Optional[dict]) -> Dict[str, dict]:
    """Per span name of ``snap``'s closed spans: ``calls``, ``host_s``,
    ``self_host_s`` and ``stream_ms`` (None if no span of the name has
    one)."""
    spans = (snap or {}).get("spans", [])
    child_ns = [0] * len(spans)
    for s in spans:
        if s["end_ns"] is not None and s["parent"] >= 0:
            child_ns[s["parent"]] += s["end_ns"] - s["start_ns"]
    out: Dict[str, dict] = {}
    for s, inner in zip(spans, child_ns):
        if s["end_ns"] is None:
            continue
        d = out.setdefault(s["name"], {"calls": 0, "host_s": 0.0, "self_host_s": 0.0,
                                       "stream_ms": None})
        dur = s["end_ns"] - s["start_ns"]
        d["calls"] += 1
        d["host_s"] += dur / 1e9
        d["self_host_s"] += (dur - inner) / 1e9
        if s["stream_ms"] is not None:
            d["stream_ms"] = (d["stream_ms"] or 0.0) + s["stream_ms"]
    return out


def counter(snap: Optional[dict], name: str) -> int:
    return int((snap or {}).get("counters", {}).get(name, 0))


def reading(snap: Optional[dict]) -> Optional[dict]:
    """``snap``, or the program's registry when ``snap`` is None."""
    return snapshot() if snap is None else snap
