"""Model FLOPs of the train steps (both nets' forwards and backwards at the
step's shape), over the traced window's seconds times the H100's dense
bf16 peak (989 TFLOP/s, NVIDIA's data sheet, SXM at 700 W). The FLOPs
are the benchmark's reference counted on the meta device
(``benchmark/count``), whatever the program runs."""

from benchmark.count.flops import PEAK_BF16

UNIT = "%"
LAYER = "trainer"
MOVES = "train_utt_per_s"
WORKLOADS = ["diffunet.train-f32"]


def read(t):
    flops = t.counts.get("model_flops")
    if not flops or t.window_s <= 0:
        return None
    return 100.0 * flops / (t.window_s * PEAK_BF16)
