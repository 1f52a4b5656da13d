"""Share of its roofline reached by enc_chain_kernel (K3, float32): the
least time of the encoder stages it ran in the traced window (without
stage 2-5's ``conv1``, which runs before the kernel, per stage the
larger of FLOPs at 3xTF32's 165 TFLOP/s and bytes at 3.35 TB/s,
``benchmark/count/ stages.py``), over the device time of the kernels
named ``enc_chain_kernel``."""

UNIT = "%"
LAYER = "kernels"
MOVES = "audio_s_per_s"
WORKLOADS = ["diffunet.files-f32", "dbaiat.files-f32"]


def read(t):
    device_s = t.kernel_seconds("enc_chain_kernel")
    bound = t.counts.get("k3_bound_s")
    if not device_s or not bound:
        return None
    return 100.0 * bound / device_s
