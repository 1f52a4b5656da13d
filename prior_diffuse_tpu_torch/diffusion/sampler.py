"""Reverse DDPM sampling in the three diffusion modes, as a plain Python loop.

The counterpart of ``prior_diffuse_tpu/diffusion/sampler.py::reverse_sample``
(and of the mode logic of ``training/ddpm_trainer.py::_mode``).
Random draws are explicit tensors (``x_T``, ``noise``), so a caller or a
test can hand the same numbers to both packages.  The chain runs in
``x_init``'s dtype (float32 or bfloat16), as the JAX sampler runs in its
``dtype``, or in float32 around a bf16 ``x_init`` (the JAX evaluation of a
bf16-trained model).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from prior_diffuse_tpu_torch.diffusion.schedule import InferenceSchedule
from prior_diffuse_tpu_torch.utils.profiler import span

# model_fn(x_t [B, T, F, 2], t [B] float32) -> network output, with the
# conditioning closed over
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


MODES = ("pirorgrad", "deltamu", "conditional")


def diffusion_mode(diff) -> str:
    """The mode of a ``DiffusionConfig``: ``pirorgrad`` wins over
    ``deltamu``, and neither flag is ``conditional`` (JAX
    ``ddpm_trainer.py:67-72``).  Raises ``ValueError`` for what the JAX
    trainer refuses (``:86-99``): ``cond_noisy`` outside pirorgrad, an
    unknown ``predict``, and ``predict="x0"`` in deltamu (its noise term
    mixes in ``x_init``, so it has no clean x0 target)."""
    mode = "pirorgrad" if diff.pirorgrad else "deltamu" if diff.deltamu else "conditional"
    if diff.cond_noisy and mode != "pirorgrad":
        raise ValueError("cond_noisy requires pirorgrad mode")
    if diff.predict not in ("eps", "x0"):
        raise ValueError(f"unknown predict {diff.predict!r}")
    if diff.predict == "x0" and mode == "deltamu":
        raise ValueError("predict='x0' is unsupported in deltamu mode")
    return mode


def rounded(values, dtype: torch.dtype = torch.float32) -> list:
    """Host constants rounded to ``dtype``, as python floats: to float32
    once, then (bfloat16) to the nearest bfloat16, as ``jnp.asarray(v,
    dtype)`` rounds a host array.  A python float multiplies a tensor at
    the tensor's compute precision, so it must hold the rounded value."""
    f32 = torch.from_numpy(np.asarray(values, np.float64).astype(np.float32))
    return f32.to(dtype).tolist()


def is_noiseless(sched: InferenceSchedule) -> bool:
    """True when every per-step noise scale is 0 (the reference schedules:
    ``c1 >= 1`` makes ``new_sigma`` vanish), so no step noise is drawn."""
    return bool((np.abs(np.asarray(sched.new_sigma)) < 1e-30).all())


def reverse_sample(
    model_fn: ModelFn,
    x_init: torch.Tensor,
    x_T: Optional[torch.Tensor],
    sched: InferenceSchedule,
    sig_mask: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    zero_init: bool = False,
    predict: str = "eps",
    mode: str = "pirorgrad",
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Run the reverse chain from ``x_T``; in ``mode``:

    * ``pirorgrad``: from ``x_T``, ``x_init`` added at the end;
    * ``deltamu``: from ``x_T + x_init`` (from ``x_init`` with
      ``zero_init``), nothing added at the end;
    * ``conditional``: from ``x_T``, nothing added (the conditioning is
      inside ``model_fn``).

    * ``x_T [n_avg, *x_init.shape]``: standard-normal initial draws, one
      per averaged chain; the result is the mean of the ``n_avg`` chains.
      Ignored (may be None) with ``zero_init``, which runs one chain from
      zeros (``x_init`` in deltamu).
    * ``sig_mask``: PriorGrad per-bin scale; the initial draw and every
      step noise are multiplied by ``sqrt(sig_mask)``.
    * ``noise [n_avg, N, *x_init.shape]``: per-step draws in loop order
      (index 0 is schedule position N-1); required only when the schedule
      is not noiseless (:func:`is_noiseless`).
    * ``predict="x0"``: the net predicts the clean-side residual, turned
      into eps with ``(x - sqrt(ab) * out) / sqrt(1 - ab)``; the constants
      are derived in float64 and rounded once (in bfloat16, ``1 - ab``
      taken after the cast is 0 for ``ab`` > ~0.996).

    The chain's dtype is ``dtype``, by default ``x_init``'s: ``x``, the
    schedule constants and the ``t`` fed to ``model_fn`` are in it (in
    bfloat16 the fractional fast-schedule ``T`` rounds, to a spacing of
    0.25 between 32 and 64), and so are ``x_T`` and ``noise``.  ``sig_mask``
    and its square root are in the chain's dtype or in ``x_init``'s: a
    float32 chain around a bf16 ``x_init`` (JAX's ``_eval_step`` of a
    bf16-trained model, ``ddpm_trainer.py:368-384``) takes the mask of the
    bf16 ``x_init`` in bf16 and promotes where it meets ``x``.
    """
    if predict not in ("eps", "x0"):
        raise ValueError(f"unknown predict parameterization {predict!r}")
    if mode not in MODES:
        raise ValueError(f"unknown diffusion mode {mode!r}")
    n_steps = sched.num_steps
    noiseless = is_noiseless(sched)
    if not noiseless and noise is None:
        raise ValueError("this schedule adds step noise: pass `noise`")
    dt = dtype or x_init.dtype
    c1, c2, t_steps = rounded(sched.c1, dt), rounded(sched.c2, dt), rounded(sched.T, dt)
    new_sigma = rounded(sched.new_sigma, dt)
    ab = np.asarray(sched.alpha_cum, np.float64)
    sqrt_ab, rsqrt_1mab = rounded(np.sqrt(ab), dt), rounded(1.0 / np.sqrt(1.0 - ab), dt)
    for name, arr in (("x_T", None if zero_init else x_T), ("noise", noise)):
        if arr is not None and arr.dtype != dt:
            raise ValueError(f"{name} is {arr.dtype}, the chain runs in {dt}")
    if sig_mask is not None and sig_mask.dtype not in (dt, x_init.dtype):
        raise ValueError(f"sig_mask is {sig_mask.dtype}, the chain runs in {dt}")
    scale = None if sig_mask is None else torch.sqrt(sig_mask)
    batch = x_init.shape[0]

    starts = [torch.zeros_like(x_init, dtype=dt)] if zero_init else list(x_T)
    chains = []
    for i, x in enumerate(starts):
        if scale is not None and not zero_init:
            x = x * scale
        if mode == "deltamu":
            x = x + x_init
        for step, n in enumerate(range(n_steps - 1, -1, -1)):
            with span("enh.step", x_init.device):
                t_vec = torch.full((batch,), t_steps[n], dtype=dt, device=x_init.device)
                out = model_fn(x, t_vec)
                if predict == "x0":
                    eps = (x - sqrt_ab[n] * out) * rsqrt_1mab[n]
                else:
                    eps = out
                x = c1[n] * (x - c2[n] * eps)
                if not noiseless and n > 0:  # step n = 0 adds no noise
                    z = noise[i, step]
                    x = x + new_sigma[n] * (z if scale is None else z * scale)
        chains.append(x + x_init if mode == "pirorgrad" else x)
    if len(chains) == 1:
        return chains[0]
    return torch.stack(chains).mean(dim=0)
