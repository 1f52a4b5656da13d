"""Self host seconds of the program's ``front.prepare`` and ``front.finish``
spans (``serving/enhance.py::enhance_files``: each batch's RMS scaling,
padding and batch array; the cut back and rescale of its output), over
the traced window's seconds.  The spans are the program's own
(``benchmark/harness/program_spans.py``)."""

from benchmark.harness import program_spans as ps

UNIT = "%"
LAYER = "serving front end"
MOVES = "audio_s_per_s"
WORKLOADS = ["diffunet.files-f32", "dbaiat.files-f32"]


def read(t, snap=None):
    tot = ps.totals(ps.reading(snap))
    names = [n for n in ("front.prepare", "front.finish") if n in tot]
    if not names or t.window_s <= 0:
        return None
    return 100.0 * sum(tot[n]["self_host_s"] for n in names) / t.window_s
