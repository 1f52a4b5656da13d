"""Static roofline of a PyTorch program on an NVIDIA H100.

The counterpart of ``prior_diffuse_tpu/utils/roofline.py``.  Where the JAX
module walks a jaxpr, this one runs ``fn`` once under a
``TorchDispatchMode`` and records every aten operator with its shapes and
dtypes.  For each product and convolution (``mm``, ``addmm``, ``bmm``,
``baddbmm``, ``convolution``, ``convolution_backward``, and the
recurrences: ``aten.lstm`` and ``aten.gru`` are composite and reach the
mode as ``mkldnn_rnn_layer`` (an LSTM on the CPU), ``_cudnn_rnn`` (on
the card), their backwards, or as products (a GRU on the CPU); each
counts the same MACs) it computes:

- exact model MACs / FLOPs (a convolution's gradients: only those its
  ``output_mask`` asks for);
- *attainable* FLOPs under the card's tensor-core granularity, by the op's
  dtype: bf16 / fp16 ``wgmma`` (m64 nN k16) pads M to 64, N to 8 and K to
  16; TF32 (where the operands lie on a card and the backend allows it)
  pads K to 8 and M, N as bf16; float32 on the CUDA cores pads nothing;
  a convolution by its im2col view, as the JAX module's;
- bytes moved: operands and result at the dtypes the op sees (a fused
  bias is left out, as JAX's separate ``add`` is);
- the op's time ``max(padded flops / peak, bytes / bandwidth)``, with the
  peak of its dtype: bf16 at the bf16 peak, TF32 at the TF32 peak, a
  float32 product at 3xTF32's rate (TF32 peak / 3: the rate the port's f32
  encoder kernel runs at, so no f32 implementation beats the ceiling).

Summed, the per-op times give the program's *fused* ceiling; every other
operator adds twice its output bytes (one write, one read) to an unfused
elementwise bracket, except aliasing views, which move nothing.  True
traffic lies between the two.

**The kernels count as their plain versions' work.**  The hand-written
kernels launch through ctypes (``ops/cuda/_launch.py``), below the
dispatcher, so a mode sees nothing of them.  :func:`analyze` routes the
four kernel entry points (``ops/cuda/stft.py::stft``, ``istft``,
``ops/cuda/convblock.py::enc_stage``, ``enc_stage_bf16``) through their
plain versions while it walks, so the count is the same work whichever
implementation runs it.  The routing replaces module attributes for the
walk's duration: do not analyze while another thread serves.

Python loops unroll as they run, so ``has_unbounded_while`` is always
``False``; it is kept for the JAX report's keys.  The walk executes
``fn``: wrap it in ``torch.no_grad()`` for serving, leave autograd on
for a train step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Published dense peaks (NVIDIA's H100 data sheet) and the HBM rate, by
# ``torch.cuda.get_device_name``: bf16 and TF32 on the tensor cores,
# float32 on the CUDA cores.
CHIP_SPECS = {
    "H100 80GB HBM3": {"peak_bf16": 989e12, "peak_tf32": 495e12, "peak_f32": 67e12,
                       "hbm_bytes_per_s": 3.35e12},  # SXM
    "H100 PCIe": {"peak_bf16": 756e12, "peak_tf32": 378e12, "peak_f32": 51e12,
                  "hbm_bytes_per_s": 2.0e12},
    "H100 NVL": {"peak_bf16": 835e12, "peak_tf32": 418e12, "peak_f32": 60e12,
                 "hbm_bytes_per_s": 3.9e12},
}

# tensor-core granularity (M, N, K) by the dtype class of an op
_TILES = {"bf16": (64, 8, 16), "tf32": (64, 8, 8), "f32": (1, 1, 1)}


def _ceil_to(x: float, m: int) -> float:
    return float(math.ceil(x / m) * m) if x else 0.0


def op_peak(dtype_class: str, spec: Dict[str, float]) -> float:
    """The rate an op of ``dtype_class`` is charged at: bf16 and TF32 at
    their peaks, float32 at 3xTF32's (TF32 peak / 3)."""
    if dtype_class == "bf16":
        return spec["peak_bf16"]
    return spec["peak_tf32"] / (1.0 if dtype_class == "tf32" else 3.0)


@dataclasses.dataclass
class OpCost:
    """One product or convolution (or one group of identically-shaped ones)."""

    kind: str           # dot_general | conv | rnn
    shape_sig: str      # dtype class and B/M/K/N (or conv) signature
    dtype_class: str = "f32"  # bf16 | tf32 | f32
    count: int = 0      # executions
    macs: float = 0.0   # exact model MACs per execution
    padded_macs: float = 0.0
    bytes_moved: float = 0.0  # operand + result bytes per execution

    @property
    def flops(self):
        return 2.0 * self.macs * self.count

    @property
    def padded_flops(self):
        return 2.0 * self.padded_macs * self.count

    @property
    def total_bytes(self):
        return self.bytes_moved * self.count

    def compute_s(self, spec: Dict[str, float]) -> float:
        return self.padded_flops / op_peak(self.dtype_class, spec)

    def roofline_s(self, spec: Dict[str, float]) -> float:
        return max(self.compute_s(spec), self.total_bytes / spec["hbm_bytes_per_s"])


@dataclasses.dataclass
class RooflineReport:
    ops: Dict[str, OpCost]
    elementwise_bytes: float  # non-product output bytes (write + one read)
    has_unbounded_while: bool = False

    def totals(self, spec: Dict[str, float],
               measured_s: Optional[float] = None) -> Dict[str, Any]:
        """The program's counts and ceilings on the chip ``spec``; with
        ``measured_s`` also ``attained_fraction`` (fused ceiling over the
        measured time) and ``mfu`` (model FLOPs over the measured time at
        the bf16 peak, the highest dense rate of any dtype the port
        computes in)."""
        bw = spec["hbm_bytes_per_s"]
        ops = list(self.ops.values())
        flops = sum(o.flops for o in ops)
        pflops = sum(o.padded_flops for o in ops)
        mxu_bytes = sum(o.total_bytes for o in ops)
        times = [o.roofline_s(spec) for o in ops]
        by_compute = sum(t for o, t in zip(ops, times) if o.compute_s(spec) >= o.total_bytes / bw)
        attainable = sum(times)
        cuda_cores = sum(max((o.flops / spec["peak_f32"]) if o.dtype_class == "f32"
                             else o.compute_s(spec), o.total_bytes / bw) for o in ops)
        out = {
            "model_flops": flops,
            "padded_flops": pflops,
            "lane_occupancy": flops / pflops if pflops else 1.0,
            "mxu_bytes": mxu_bytes,
            "elementwise_bytes": self.elementwise_bytes,
            "compute_bound_s": sum(o.flops / op_peak(o.dtype_class, spec) for o in ops),
            "padded_compute_bound_s": sum(o.compute_s(spec) for o in ops),
            "mxu_memory_bound_s": mxu_bytes / bw,
            "attainable_s_fused": attainable,
            "attainable_s_unfused": attainable + self.elementwise_bytes / bw,
            # which bound sets the larger part of the fused ceiling
            "bound_by": "compute" if 2 * by_compute >= attainable else "memory",
            # the fused ceiling with float32 products on the CUDA cores
            "attainable_s_fused_f32_cuda_cores": cuda_cores,
            "has_unbounded_while": self.has_unbounded_while,
        }
        if measured_s is not None:
            out["measured_s"] = measured_s
            out["attained_fraction"] = attainable / measured_s
            out["mfu"] = flops / (measured_s * spec["peak_bf16"])
        return out


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size())


def _dtype_class(t: torch.Tensor, tf32_allowed: bool) -> str:
    if t.dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if t.dtype == torch.float32 and t.is_cuda and tf32_allowed:
        return "tf32"
    return "f32"


def _padded(dc: str, m: float, n: float, k: float) -> float:
    tm, tn, tk = _TILES[dc]
    return _ceil_to(m, tm) * _ceil_to(n, tn) * _ceil_to(k, tk)


def _dot(a, b, out) -> OpCost:
    """``a [.., M, K] @ b [.., K, N]`` with the leading dim of a 3-D ``a`` a batch."""
    dc = _dtype_class(a, torch.backends.cuda.matmul.allow_tf32)
    bsz = a.shape[0] if a.ndim == 3 else 1
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    return OpCost("dot_general", f"{dc} B{bsz} M{m} K{k} N{n}", dc,
                  macs=float(bsz * m * k * n), padded_macs=bsz * _padded(dc, m, n, k),
                  bytes_moved=_nbytes(a) + _nbytes(b) + _nbytes(out))


def _conv_geometry(x, w, y, transposed: bool, groups: int) -> tuple:
    """(MACs, rows M, reduction K, columns N) of one convolution's im2col
    view, per group: a convolution gathers ``K = taps x Cin / g`` inputs
    for each of its output pixels; a transposed one scatters each input
    pixel's ``Cin / g`` channels to ``taps x Cout / g`` outputs."""
    taps = math.prod(w.shape[2:])
    if transposed:  # w [Cin, Cout / g, *taps]
        m, k, n = x.shape[0] * math.prod(x.shape[2:]), w.shape[0] // groups, taps * w.shape[1]
    else:  # w [Cout, Cin / g, *taps]
        m, k, n = y.shape[0] * math.prod(y.shape[2:]), taps * w.shape[1], w.shape[0] // groups
    return float(groups * m * k * n), m, k, n


def _conv_cost(tag, x, w, y, transposed, groups, dims, moved) -> OpCost:
    dc = _dtype_class(x, torch.backends.cudnn.allow_tf32)
    macs, m, k, n = _conv_geometry(x, w, y, transposed, groups)
    mm, kk, nn = dims(m, k, n)
    sig = (f"{dc} {tag}M{m} k{'x'.join(map(str, w.shape[2:]))} Cin{x.shape[1]} "
           f"Cout{y.shape[1]}" + (f" g{groups}" if groups > 1 else "")
           + (" transposed" if transposed else ""))
    return OpCost("conv", sig, dc, macs=macs, padded_macs=groups * _padded(dc, mm, nn, kk),
                  bytes_moved=sum(_nbytes(t) for t in moved))


def _convolution(a, out):
    x, w = a["input"], a["weight"]
    return [_conv_cost("", x, w, out, a["transposed"], a["groups"],
                       lambda m, k, n: (m, k, n), (x, w, out))]


def _convolution_backward(a, out):
    """The gradients ``output_mask`` asks for, each with the forward's
    MACs.  With the forward's im2col view ``[M, K] @ [K, N]``, the input's
    gradient is ``[M, N] @ [N, K]`` (col2im) and the weight's ``[N, M] @
    [M, K]``."""
    gy, x, w = a["grad_output"], a["input"], a["weight"]
    transposed, groups, mask = a["transposed"], a["groups"], a["output_mask"]
    costs = []
    if mask[0]:
        costs.append(_conv_cost("dgrad ", x, w, gy, transposed, groups,
                                lambda m, k, n: (m, n, k), (gy, w, out[0])))
    if mask[1]:
        costs.append(_conv_cost("wgrad ", x, w, gy, transposed, groups,
                                lambda m, k, n: (n, m, k), (gy, x, out[1])))
    return costs


def _rnn_weights(flat, step: int) -> list:
    """``(w_ih, w_hh)`` per layer and direction from cuDNN's flat weight
    list (``step`` tensors each)."""
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), step)]


def _rnn_cost(tag, x, pairs, batch_first: bool, moved, wgrad: bool = False,
              dgrad_in: bool = False) -> OpCost:
    """A recurrence over ``x`` (``[T, N, I]``, or ``[N, T, I]`` batch
    first) with ``(w_ih [G H, I], w_hh [G H, H])`` per layer and
    direction.  Forward: the input projection (``T N`` rows) and, each
    time step, the hidden state's product (``N`` rows): ``T N (G H I + G H
    H)`` MACs.  Backward (``tag``): the hidden state's gradient through
    time, plus the input's and the weights' where asked."""
    t, n = (x.shape[1], x.shape[0]) if batch_first else (x.shape[0], x.shape[1])
    dc = _dtype_class(x, torch.backends.cudnn.allow_tf32)
    macs = padded = 0.0
    for w_ih, w_hh in pairs:
        gh, i = w_ih.shape
        h = w_hh.shape[1]
        if not tag:
            parts = [(1, t * n, gh, i), (t, n, gh, h)]  # (repeats, M, N, K)
        else:
            parts = [(t, n, h, gh)] + ([(1, t * n, i, gh)] if dgrad_in else []) + (
                [(1, gh, i, t * n), (1, gh, h, t * n)] if wgrad else [])
        for reps, m, c, k in parts:
            macs += reps * m * c * k
            padded += reps * _padded(dc, m, c, k)
    return OpCost("rnn", f"{dc} {tag}T{t} N{n} " + " ".join(
        f"{w.shape[1]}->{w.shape[0]}" for w, _ in pairs), dc,
        macs=float(macs), padded_macs=padded, bytes_moved=sum(_nbytes(v) for v in moved))


def _mkldnn_rnn(a, out):
    x, w = a["input"], (a["weight0"], a["weight1"])
    return [_rnn_cost("", x, [w], a["batch_first"], [x, *w, out[0]])]


def _mkldnn_rnn_backward(a, out):
    x, w = a["input"], (a["weight1"], a["weight2"])
    return [_rnn_cost("bwd ", x, [w], a["batch_first"], [x, *w, *_tensors(out)],
                      wgrad=True, dgrad_in=True)]


def _cudnn_rnn(a, out):
    x, pairs = a["input"], _rnn_weights(a["weight"], a["weight_stride0"])
    return [_rnn_cost("", x, pairs, a["batch_first"], [x, *_tensors(pairs), out[0]])]


def _cudnn_rnn_backward(a, out):
    x, pairs, mask = a["input"], _rnn_weights(a["weight"], a["weight_stride0"]), a["output_mask"]
    return [_rnn_cost("bwd ", x, pairs, a["batch_first"], [x, *_tensors(pairs), *_tensors(out)],
                      wgrad=mask[3], dgrad_in=mask[0])]


_aten = torch.ops.aten
_PRODUCTS = {
    _aten.mm: lambda a, out: [_dot(a["self"], a["mat2"], out)],
    _aten.bmm: lambda a, out: [_dot(a["self"], a["mat2"], out)],
    _aten.addmm: lambda a, out: [_dot(a["mat1"], a["mat2"], out)],
    _aten.baddbmm: lambda a, out: [_dot(a["batch1"], a["batch2"], out)],
    _aten.convolution: _convolution,
    _aten.convolution_backward: _convolution_backward,
    _aten.mkldnn_rnn_layer: _mkldnn_rnn,
    _aten.mkldnn_rnn_layer_backward: _mkldnn_rnn_backward,
    _aten._cudnn_rnn: _cudnn_rnn,
    _aten._cudnn_rnn_backward: _cudnn_rnn_backward,
}
# ops that alias their input (or only allocate) and move no bytes, beyond
# those whose schema marks them as views
_FREE = {_aten._unsafe_view, _aten.unsafe_split, _aten.unsafe_split_with_sizes,
         _aten.unsafe_chunk, _aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class _Walk(TorchDispatchMode):
    """Records each product's cost and the other ops' output bytes."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, OpCost] = {}
        self.ew_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        product = _PRODUCTS.get(func.overloadpacket)
        if product is not None:  # its arguments by name, as its schema has them
            named = {s.name: v for s, v in zip(func._schema.arguments, args)}
            for cost in product({**named, **kwargs}, out):
                key = f"{cost.kind} {cost.shape_sig}"
                self.ops.setdefault(key, cost).count += 1
        elif not (func.is_view or func.overloadpacket in _FREE):
            written = _tensors(out)
            if not written:  # an in-place op that returns nothing: its mutated args
                written = [a for a, s in zip(args, func._schema.arguments)
                           if s.alias_info is not None and s.alias_info.is_write
                           for a in _tensors(a)]
            self.ew_bytes += 2.0 * sum(_nbytes(t) for t in written)
        return out


@contextlib.contextmanager
def plain_kernels():
    """Route the four kernel entry points through their plain versions."""
    from prior_diffuse_tpu_torch.ops.cuda import convblock, stft as kstft

    routes = [(kstft, "stft", kstft.stft_plain), (kstft, "istft", kstft.istft_plain),
              (convblock, "enc_stage", convblock.enc_stage_plain),
              (convblock, "enc_stage_bf16", convblock.enc_stage_bf16_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes]
    try:
        for mod, name, plain in routes:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def analyze(fn, *args, **kwargs) -> RooflineReport:
    """Run ``fn(*args, **kwargs)`` once, the kernels through their plain
    versions, and return its roofline report."""
    walk = _Walk()
    with plain_kernels(), walk:
        fn(*args, **kwargs)
    return RooflineReport(ops=walk.ops, elementwise_bytes=walk.ew_bytes)


def chip_spec(device=None) -> Optional[Dict[str, float]]:
    """The peaks and HBM rate of a CUDA ``torch.device`` or of a card's
    name (``torch.cuda.get_device_name``); None on an unknown chip or
    without a device: callers must not silently assume a denominator."""
    if isinstance(device, torch.device):
        device = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    name = (device or "").lower()
    for key, spec in CHIP_SPECS.items():
        if key.lower() in name:
            return spec
    return None


def format_report(report: RooflineReport, spec: Dict[str, float],
                  measured_s: Optional[float] = None, top: int = 12) -> str:
    """Markdown table: top ops by roofline share + program totals."""
    t = report.totals(spec, measured_s)
    bw = spec["hbm_bytes_per_s"]
    lines = [
        "| op | shape | count | GFLOP | occupancy | MB | bound | roofline µs |",
        "|---|---|---|---|---|---|---|---|",
    ]
    ops = sorted(report.ops.values(), key=lambda o: -o.roofline_s(spec))
    for o in ops[:top]:
        bound = "compute" if o.compute_s(spec) >= o.total_bytes / bw else "memory"
        lines.append(
            f"| {o.kind} | {o.shape_sig} | {o.count:g} "
            f"| {o.flops / 1e9:.2f} | {o.flops / o.padded_flops if o.padded_flops else 1:.2f} "
            f"| {o.total_bytes / 1e6:.1f} | {bound} "
            f"| {o.roofline_s(spec) * 1e6:.0f} |")
    rest = ops[top:]
    if rest:
        rs = sum(o.roofline_s(spec) for o in rest)
        lines.append(f"| … {len(rest)} more | | | | | | | {rs * 1e6:.0f} |")
    lines.append("")
    lines.append(
        f"- model FLOPs {t['model_flops'] / 1e9:.1f} G, padded "
        f"{t['padded_flops'] / 1e9:.1f} G (tile occupancy "
        f"{t['lane_occupancy']:.3f})")
    lines.append(
        f"- attainable ceiling: {t['attainable_s_fused'] * 1e3:.2f} ms fused "
        f"— {t['attainable_s_unfused'] * 1e3:.2f} ms unfused "
        f"(set by {t['bound_by']}; product memory bound "
        f"{t['mxu_memory_bound_s'] * 1e3:.2f} ms, padded compute bound "
        f"{t['padded_compute_bound_s'] * 1e3:.2f} ms; f32 products on the CUDA "
        f"cores {t['attainable_s_fused_f32_cuda_cores'] * 1e3:.2f} ms)")
    if measured_s is not None:
        lines.append(
            f"- measured {measured_s * 1e3:.2f} ms = {1 / t['attained_fraction']:.2f}x the "
            f"fused ceiling, {measured_s / t['attainable_s_unfused']:.2f}x the unfused "
            f"bracket (attained fraction {t['attained_fraction']:.4f}, mfu {t['mfu']:.4f})")
    return "\n".join(lines)
