"""Share of its roofline reached by enc_chain_bf16_kernel (K3-bf16): the
least time of the encoder stages it ran in the traced window (``conv1``
included, bf16 bytes, per stage the larger of FLOPs at the bf16 peak of
989 TFLOP/s and bytes at 3.35 TB/s, ``benchmark/count/ stages.py``),
over the device time of the kernels named ``enc_chain_bf16_kernel``."""

UNIT = "%"
LAYER = "kernels"
MOVES = "recording_ms_p95"
WORKLOADS = ["diffunet.recordings-bf16"]


def read(t):
    device_s = t.kernel_seconds("enc_chain_bf16_kernel")
    bound = t.counts.get("k3_bound_s")
    if not device_s or not bound:
        return None
    return 100.0 * bound / device_s
