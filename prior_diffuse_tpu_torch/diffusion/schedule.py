"""Reverse-sampling constants (host numpy, float64).

A copy of ``prior_diffuse_tpu/diffusion/schedule.py::inference_schedule``:
that module cannot be imported without jax (its package ``__init__``
imports the jax sampler).  ``tests/test_torch_sampler.py`` holds the two
equal.  Kept quirks of the reference: ``sigmas[0]`` wraps to
``alpha_cum[-1]``, ``gamma[0]`` is overridden (0.2), and
``new_sigma = max(0, gamma - c1 * gamma)`` is identically 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from prior_diffuse_tpu_torch.config import DiffusionConfig


@dataclass(frozen=True)
class InferenceSchedule:
    """Per-step constants indexed by schedule position ``n`` (0..N-1);
    the sampler runs n = N-1 .. 0."""

    alpha: np.ndarray
    beta: np.ndarray
    alpha_cum: np.ndarray
    sigmas: np.ndarray
    T: np.ndarray  # float32 continuous timesteps on the training grid
    gamma: np.ndarray
    c1: np.ndarray  # 1 / sqrt(alpha)
    c2: np.ndarray  # beta / sqrt(1 - alpha_cum)
    new_sigma: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.alpha)


def inference_schedule(cfg: DiffusionConfig,
                       fast_sampling: bool | None = None) -> InferenceSchedule:
    if fast_sampling is None:
        fast_sampling = cfg.fast_sampling
    training = np.asarray(cfg.noise_schedule, dtype=np.float64)
    inference = (np.asarray(cfg.inference_noise_schedule, dtype=np.float64)
                 if fast_sampling else training)

    talpha_cum = np.cumprod(1.0 - training)
    beta = inference
    alpha = 1.0 - beta
    alpha_cum = np.cumprod(alpha)

    sigmas = np.zeros_like(alpha)
    for n in range(len(alpha) - 1, -1, -1):
        sigmas[n] = ((1.0 - alpha_cum[n - 1]) / (1.0 - alpha_cum[n])
                     * beta[n]) ** 0.5

    T = []
    for s in range(len(inference)):
        for t in range(len(training) - 1):
            if talpha_cum[t + 1] <= alpha_cum[s] <= talpha_cum[t]:
                twiddle = (talpha_cum[t] ** 0.5 - alpha_cum[s] ** 0.5) / (
                    talpha_cum[t] ** 0.5 - talpha_cum[t + 1] ** 0.5)
                T.append(t + twiddle)
                break
    T = np.asarray(T, dtype=np.float32)
    if len(T) != len(inference):
        raise ValueError(
            "inference schedule does not embed into the training schedule: "
            f"aligned {len(T)} of {len(inference)} steps")

    gamma = sigmas.copy()
    gamma[0] = cfg.gamma0_override
    c1 = 1.0 / np.sqrt(alpha)
    c2 = beta / np.sqrt(1.0 - alpha_cum)
    new_sigma = np.maximum(0.0, gamma - c1 * gamma)
    return InferenceSchedule(alpha=alpha, beta=beta, alpha_cum=alpha_cum,
                             sigmas=sigmas, T=T, gamma=gamma, c1=c1, c2=c2,
                             new_sigma=new_sigma)
