"""Host seconds of the ``enhance_long`` calls outside their
``enhance_batch`` calls (segmenting, read-back, crossfade), over the
calls' host seconds, in the traced window.  Each ``enhance_batch`` span
ends in a device synchronisation, so its seconds hold its device work."""

UNIT = "%"
LAYER = "serving front end"
MOVES = "recording_ms_p95"
WORKLOADS = ["diffunet.recordings-bf16"]


def read(t):
    calls = sum(t.spans.host.get("client.enhance_long", []))
    batches = sum(t.spans.host.get("enhancer.enhance_batch", []))
    if calls <= 0:
        return None
    return 100.0 * (calls - batches) / calls
