"""CUDA-event milliseconds inside the enhancer's ``prior`` over those inside
its ``enhance_batch``, summed over the traced window (the harness's spans
around its own ``Enhancer`` instance)."""

UNIT = "%"
LAYER = "enhancer"
MOVES = "audio_s_per_s"
WORKLOADS = ["diffunet.files-f32", "dbaiat.files-f32"]


def read(t):
    prior = t.spans.event_ms("enhancer.prior")
    batch = t.spans.event_ms("enhancer.enhance_batch")
    if not prior or not batch:
        return None
    return 100.0 * prior / batch
