"""Host seconds of the program's ``enh.batch`` spans less their
``enh.upload`` (the host-to-device copy), over the traced window's
seconds: the host issuing the enhancer's work (``serving/enhancer.py::
Enhancer.enhance_batch``, which ends before the read-back)."""

from benchmark.harness import program_spans as ps

UNIT = "%"
LAYER = "enhancer"
MOVES = "recording_ms_p95"
WORKLOADS = ["diffunet.recordings-bf16"]


def read(t, snap=None):
    tot = ps.totals(ps.reading(snap))
    batch = tot.get("enh.batch")
    if not batch or t.window_s <= 0:
        return None
    upload = tot.get("enh.upload", {"host_s": 0.0})["host_s"]
    return 100.0 * (batch["host_s"] - upload) / t.window_s
