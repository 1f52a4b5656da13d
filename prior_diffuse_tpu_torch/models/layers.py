"""Building blocks of the model zoo that ``torch.nn`` lacks.

The counterparts of ``prior_diffuse_tpu/models/layers.py``.  Its PReLU,
conv1d/conv2d and ConvTranspose2d are ``nn.PReLU``, ``nn.Conv1d/2d`` and
``nn.ConvTranspose2d`` here (``convert.py`` maps the parameters); its
BatchNorm is :class:`BatchNorm1d` / :class:`BatchNorm2d`, which keep
flax's train-mode statistics.  Its LayerNorm is ``nn.LayerNorm``: flax
takes the variance in one pass (``E[x^2] - E[x]^2``) and torch in two, but
copying the one-pass formula does not copy flax's rounding, and the
two-pass variance is the closer to flax's result as to the exact one
(``tests/test_torch_priors.py::test_layer_matches_flax``, ROADMAP Queue
3).  Its LSTM and GRU are ``nn.LSTM`` and ``nn.GRU`` (cuDNN on the card),
and its MultiHeadAttention two products and a softmax.  Inside the convolutional models tensors are NCHW
``[B, C, T, F]``; the recurrent and attention layers take ``[N, L, d]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prior_diffuse_tpu_torch.parallel.mesh import current as current_parallel


def time_embedding_table(max_steps: int) -> np.ndarray:
    """``[max_steps, 128]`` sin/cos table of ``t * 10^(d * 4 / 63)``.

    At phases of ~5e5 rad one f32 ulp moves sin() by up to ~0.06, so the
    table is built exactly as the JAX package builds it: exponent in f32,
    pow in f64 rounded to f32, phase product in f32, sin/cos in f64 of the
    f32 phase, rounded to f32."""
    steps = np.arange(max_steps, dtype=np.float32)[:, None]
    dims = np.arange(64, dtype=np.float32)[None, :]
    exp = dims * np.float32(4.0) / np.float32(63.0)
    pow_ = np.power(10.0, exp.astype(np.float64)).astype(np.float32)
    phase = (steps * pow_).astype(np.float64)
    return np.concatenate([np.sin(phase), np.cos(phase)], axis=1).astype(np.float32)


class TimeEmbedding(nn.Module):
    """DiffWave timestep embedding: table lookup with linear interpolation
    for fractional ``t``, then two Linear -> SiLU layers to 512."""

    def __init__(self, max_steps: int):
        super().__init__()
        self.register_buffer(
            "table", torch.from_numpy(time_embedding_table(max_steps)),
            persistent=False)
        self.proj1 = nn.Linear(128, 512)
        self.proj2 = nn.Linear(512, 512)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """``t [B]`` float (fractional allowed) or integer -> ``[B, 512]``
        float32.  A bfloat16 ``t`` (the bf16 chain's) is taken as it is, as
        flax takes it: ``floor``/``ceil`` of the bf16 value, ``frac = t -
        low`` in bf16 (exact), the table and both projections in f32."""
        if t.is_floating_point():
            low = torch.floor(t).long()
            high = torch.ceil(t).long()
            frac = (t - low.to(t.dtype)).float()[:, None]
            x = self.table[low] + (self.table[high] - self.table[low]) * frac
        else:
            x = self.table[t]
        return F.silu(self.proj2(F.silu(self.proj1(x))))


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float, channel_dim: int = 1):
    """Train-mode BatchNorm as ``flax.linen.BatchNorm`` computes it:
    ``(y, mean, var)``.  The statistics are taken in float32 whatever
    ``x``'s dtype (flax promotes a bf16 input for them), the variance the
    *biased* one, ``E[x^2] - E[x]^2`` clipped at 0; the normalisation runs
    in float32 on the float32 ``weight`` and ``bias`` and the result is
    rounded once to ``x``'s dtype (a module of ``dtype=bfloat16``).  In
    float32 every op is the one it always was.

    Inside a ``parallel.mesh.DataParallel`` the statistics are those of the
    global batch, as flax's under a ``dp`` mesh: the float32 sums of ``x``
    and ``x^2`` and the count (exact in float32 below 2^24 elements a
    channel), summed over the ranks by one differentiable all-reduce (so
    the gradient is the global batch's too); outside one the ops above,
    unchanged."""
    xf = x.float()
    dims = [d for d in range(x.ndim) if d != channel_dim % x.ndim]
    dp = current_parallel()
    if dp is None:
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    else:
        c = xf.shape[channel_dim]
        sums = dp.all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                            xf.new_full((1,), xf.numel() // c)]))
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    scale = weight * torch.rsqrt(var + eps)
    y = (xf - mean.view(shape)) * scale.view(shape) + bias.view(shape)
    return y.to(x.dtype), mean, var


class _FlaxBatchStats:
    """Train mode as ``flax.linen.BatchNorm`` computes it (``momentum=0.9``,
    eps 1e-5; ``models/layers.py::BatchNorm`` of the JAX package):
    :func:`batch_norm_train`, whose biased variance is what enters
    ``running_var`` (torch's own BatchNorm stores the unbiased one).  The
    running statistics move by ``0.1`` of the batch statistics;
    ``num_batches_tracked`` counts the updates, which also marks the module
    as changed for whoever caches operands folded from it
    (``Enhancer.packs``).  A bf16 input (a bf16-compute forward,
    ``models/precision.py``) keeps the float32 parameters and statistics.
    Eval mode is torch's (running statistics; a bf16 input with float32
    statistics is normalised in f32 and rounded once, as flax does); with
    the statistics cast to another dtype (a cast copy of the net, as the
    JAX package casts its variables) it is flax's inference arithmetic, op
    by op in that dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if self.running_var.dtype == torch.float32:
                return super().forward(x)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            # the root in float32, rounded once (torch's CPU kernel rounds
            # a short bf16 tensor's differently); XLA's does so
            var = (self.running_var + self.eps).float()
            mul = torch.rsqrt(var).to(self.running_var.dtype) * self.weight
            return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        self._check_input_dim(x)
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps)
        self.update_stats(mean, var)
        return y

    @torch.no_grad()
    def update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running statistics ``0.1`` towards a batch's, flax's
        momentum, and count the update."""
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(m * mean)
        self.running_var.mul_(1.0 - m).add_(m * var)
        self.num_batches_tracked.add_(1)


class BatchNorm1d(_FlaxBatchStats, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's train-mode statistics."""


class BatchNorm2d(_FlaxBatchStats, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode statistics."""


def pad_time_causal(x: torch.Tensor, amount: int = 1) -> torch.Tensor:
    """Zero-pad ``amount`` frames at the start of the time axis of NCHW."""
    return F.pad(x, (0, 0, amount, 0))


def chomp_time_end(x: torch.Tensor, amount: int = 1) -> torch.Tensor:
    """Drop ``amount`` frames from the end of the time axis of NCHW."""
    return x[:, :, :-amount] if amount else x


class LSTM(nn.LSTM):
    """One-layer unidirectional LSTM, ``[N, L, in] -> [N, L, hidden]``.
    torch's gate order (i, f, g, o) and its two biases are the JAX
    layer's; its ``w_ih [in, 4h]`` is ``weight_ih_l0`` transposed."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__(in_dim, hidden, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(x)[0]


class GRU(nn.GRU):
    """One-layer GRU, ``[N, L, in] -> [N, L, hidden]`` (``2 * hidden``
    bidirectional).  torch's gates (r, z, n, with ``b_hn`` inside the reset
    gate) are the JAX layer's; its reverse direction runs the time-flipped
    sequence and flips the result back, as JAX's ``bwd`` does."""

    def __init__(self, in_dim: int, hidden: int, bidirectional: bool = False):
        super().__init__(in_dim, hidden, batch_first=True, bidirectional=bidirectional)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(x)[0]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight^T + bias``; in a dtype below float32 as flax computes it
    there: the product rounded to the dtype, then the bias added (torch's
    fused bias rounds once)."""
    if x.dtype == torch.float32:
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid``; in a dtype below float32 as XLA computes
    ``jax.nn.sigmoid`` there: ``1 / (1 + exp(-x))``, each step rounded to
    the dtype (``tools/bf16_trace.py``'s table; torch rounds once)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.softmax``; in a dtype below float32 as ``jax.nn.softmax``
    computes it there: ``exp(x - max)`` rounded to the dtype, its sum taken
    in float32 and rounded, then the quotient (torch rounds once)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True, dtype=torch.float32).to(e.dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention shaped as ``nn.MultiheadAttention``: a packed q, k, v
    projection ``in_proj_weight [3d, d]`` (JAX's ``w_in`` transposed),
    ``q k^T / sqrt(d / heads)`` (the root rounded to the input's dtype, as
    JAX's), a softmax over the keys and the output projection.  ``[N, L,
    d] -> [N, L, d]``; in bf16 with :func:`linear` and :func:`softmax`."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        d = d_model
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj_weight = nn.Parameter(torch.empty(d, d))
        self.out_proj_bias = nn.Parameter(torch.zeros(d))
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.uniform_(self.out_proj_weight, -1.0 / math.sqrt(d), 1.0 / math.sqrt(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return attention(x, self.in_proj_weight, self.in_proj_bias, self.out_proj_weight,
                         self.out_proj_bias, self.num_heads)


def attention(x, in_proj_weight, in_proj_bias, out_proj_weight, out_proj_bias,
              num_heads: int) -> torch.Tensor:
    """:class:`MultiHeadAttention`'s forward on the given parameters, all
    in ``x``'s dtype."""
    n, length, d = x.shape
    nh = num_heads
    qkv = linear(x, in_proj_weight, in_proj_bias)
    q, k, v = qkv.view(n, length, 3, nh, d // nh).permute(2, 0, 3, 1, 4)
    root = float(torch.tensor(math.sqrt(d // nh), dtype=x.dtype))
    attn = softmax(q @ k.transpose(-1, -2) / root, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(n, length, d)
    return linear(out, out_proj_weight, out_proj_bias)
