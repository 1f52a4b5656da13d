"""The frozen work of one encoder stage of the DiffUNet family.

A stage of the published encoder on an input of ``rows`` x ``frames``
frames x ``freq`` bins: a causal pad of one frame, a 1x1 conv to 32
channels (``conv1``), the two (2, kf) stride-2 window convs ``l`` and
``r``, the two 1x1 gate convs, the 1x1 ``conv2`` to 64 channels,
BatchNorm and PReLU.  FLOPs are 2 x the convolutions' multiply-adds;
bytes read the stage input once and write its output once, with the
weights, at the element size of the dtype.  Two boundaries, as the port's
encoder kernels take their work:

* ``with_conv1=False`` (K3 in float32): from the 32-channel ``conv1``
  output for stages 2-5 (``conv1`` runs as a product before the kernel),
  from the 2-channel input for stage 1 (whose ``conv1`` the kernel folds
  into its window);
* ``with_conv1=True`` (K3-bf16): from the stage input, ``conv1`` included,
  for every stage.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.count.flops import HBM_BYTES_PER_S, PEAK_3XTF32, PEAK_BF16

KERNELS = (5, 3, 3, 3, 3)
CIN = (2, 64, 64, 64, 64)
GATE = 32
COUT = 64


def stage_shapes(freq: int = 161) -> List[Tuple[int, int, int]]:
    """``(cin, freq_in, kf)`` of the five stages."""
    out = []
    for cin, kf in zip(CIN, KERNELS):
        out.append((cin, freq, kf))
        freq = (freq - kf) // 2 + 1
    return out


def stage_work(rows: int, frames: int, cin: int, freq: int, kf: int, with_conv1: bool,
               elem_bytes: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one stage on ``[rows, cin, frames, freq]``."""
    fout = (freq - kf) // 2 + 1
    padded = frames + 1
    out_pos = rows * frames * fout
    conv1 = rows * padded * freq * GATE * cin
    window = 2 * out_pos * GATE * (GATE * 2 * kf)
    gates = 2 * out_pos * GATE * GATE
    conv2 = out_pos * COUT * GATE
    w_window = 2 * GATE * GATE * 2 * kf + 2 * GATE * GATE + COUT * GATE
    w_conv1 = GATE * cin
    takes_conv1 = with_conv1 or cin < GATE
    macs = window + gates + conv2 + (conv1 if takes_conv1 else 0)
    in_elems = rows * frames * freq * (cin if takes_conv1 else GATE)
    out_elems = out_pos * COUT
    w_elems = w_window + (w_conv1 if takes_conv1 else 0)
    return 2.0 * macs, float((in_elems + out_elems + w_elems) * elem_bytes)


def encoder_bound_s(rows: int, frames: int, bf16: bool) -> float:
    """The least time of one encoder's five stages (each the larger of its
    FLOPs at the kernel's product rate and its bytes at the HBM rate):
    float32 at 3xTF32's rate without ``conv1`` for stages 2-5, bf16 at the
    bf16 peak with it."""
    total = 0.0
    for cin, freq, kf in stage_shapes():
        flops, nbytes = stage_work(rows, frames, cin, freq, kf, with_conv1=bf16,
                                   elem_bytes=2 if bf16 else 4)
        total += max(flops / (PEAK_BF16 if bf16 else PEAK_3XTF32), nbytes / HBM_BYTES_PER_S)
    return total
