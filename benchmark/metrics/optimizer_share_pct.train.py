"""Stream milliseconds of the program's ``train.norms`` and
``train.optimizer`` spans (the per-group gradient norms, both Adam steps)
over those of its ``train.step`` spans (``training/ddpm_trainer.py::
_train_step``), in the traced window."""

from benchmark.harness import program_spans as ps

UNIT = "%"
LAYER = "trainer"
MOVES = "train_utt_per_s"
WORKLOADS = ["diffunet.train-f32"]


def read(t, snap=None):
    tot = ps.totals(ps.reading(snap))
    step = tot.get("train.step")
    if not step or not step["stream_ms"]:
        return None
    tail = [tot[n]["stream_ms"] for n in ("train.norms", "train.optimizer")
            if n in tot and tot[n]["stream_ms"] is not None]
    return 100.0 * sum(tail) / step["stream_ms"]
