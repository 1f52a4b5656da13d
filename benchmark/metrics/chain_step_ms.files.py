"""Stream milliseconds of one step of the reverse chain: the CUDA-event
time of the program's ``enh.step`` spans (``diffusion/sampler.py::
reverse_sample``, one a denoiser forward and update) over their count, in
the traced window."""

from benchmark.harness import program_spans as ps

UNIT = "ms"
LAYER = "enhancer"
MOVES = "audio_s_per_s"
WORKLOADS = ["diffunet.files-f32", "dbaiat.files-f32"]


def read(t, snap=None):
    step = ps.totals(ps.reading(snap)).get("enh.step")
    if not step or step["stream_ms"] is None:
        return None
    return step["stream_ms"] / step["calls"]
