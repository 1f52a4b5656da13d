"""Self host seconds of the program's ``front.segment`` and ``front.finish``
spans (``serving/streaming.py::enhance_long``: the recording's
normalisation and cutting into segments; the crossfade and rescale), over
the traced window's seconds.  The inside counterpart of
``front_share_pct.recordings``, without the read-back wait."""

from benchmark.harness import program_spans as ps

UNIT = "%"
LAYER = "serving front end"
MOVES = "recording_ms_p95"
WORKLOADS = ["diffunet.recordings-bf16"]


def read(t, snap=None):
    tot = ps.totals(ps.reading(snap))
    names = [n for n in ("front.segment", "front.finish") if n in tot]
    if not names or t.window_s <= 0:
        return None
    return 100.0 * sum(tot[n]["self_host_s"] for n in names) / t.window_s
