"""Share of the padded sample-rows that are padding: the program's
``front.padded_samples`` (rows times padded length of each batch
``enhance_files`` sends) less ``front.audio_samples`` (the files' own
lengths), over ``front.padded_samples``, in the traced window."""

from benchmark.harness import program_spans as ps

UNIT = "%"
LAYER = "serving front end"
MOVES = "audio_s_per_s"
WORKLOADS = ["diffunet.files-f32", "dbaiat.files-f32"]


def read(t, snap=None):
    snap = ps.reading(snap)
    padded = ps.counter(snap, "front.padded_samples")
    if padded <= 0:
        return None
    return 100.0 * (padded - ps.counter(snap, "front.audio_samples")) / padded
