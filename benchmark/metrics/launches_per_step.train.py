"""Device operations (kernels, copies and fills) in the traced window over
the train steps in it."""

UNIT = "launches/step"
LAYER = "trainer"
MOVES = "train_utt_per_s"
WORKLOADS = ["diffunet.train-f32"]


def read(t):
    steps = t.counts.get("steps")
    if not steps or not t.launches:
        return None
    return t.launches / steps
