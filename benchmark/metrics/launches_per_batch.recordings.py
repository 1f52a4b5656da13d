"""Device operations (kernels, copies and fills) in the traced window over
the ``enhance_batch`` calls in it."""

UNIT = "launches/batch"
LAYER = "enhancer"
MOVES = "recording_ms_p95"
WORKLOADS = ["diffunet.recordings-bf16"]


def read(t):
    batches = t.counts.get("batches")
    if not batches or not t.launches:
        return None
    return t.launches / batches
