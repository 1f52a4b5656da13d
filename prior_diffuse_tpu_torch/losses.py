"""Masked spectral losses.

The counterpart of ``prior_diffuse_tpu/losses.py``: the valid-frame mask
comes from a ``frame_nums [B]`` integer tensor (``arange < n``).
Complex spectra are channels-last ``[B, T, F, 2]``; magnitudes
``[B, T, F]``.  Normalizers match the reference exactly: the mask covers
the full frequency axis for ``frame_nums[i]`` frames, so
``mask.sum() == sum(frame_nums) * F`` (twice that for complex losses).

Inside a ``parallel.mesh.DataParallel`` each loss is this rank's share of
the global batch's: its numerator over the mask sum of the global batch
(``global_sum``, without a gradient), so the ranks' losses sum to the one
loss JAX takes over the ``dp`` mesh and their gradients sum to its
gradient.  Outside one the mask sum is the local one, op for op as before.
"""

from __future__ import annotations

import torch

from prior_diffuse_tpu_torch.parallel.mesh import global_sum


def frame_mask(frame_nums: torch.Tensor, num_frames: int) -> torch.Tensor:
    """``[B, T]`` float 0/1 mask of valid frames."""
    t = torch.arange(num_frames, device=frame_nums.device)[None, :]
    return (t < frame_nums[:, None]).to(torch.float32)


def _mag_mask(esti: torch.Tensor, frame_nums: torch.Tensor) -> torch.Tensor:
    # [B, T, 1] broadcast over F
    return frame_mask(frame_nums, esti.shape[1])[..., None]


def mag_mse_loss(esti, label, frame_nums):
    """Masked MSE on magnitude ``[B, T, F]`` (utils/loss.py:10-19)."""
    m = _mag_mask(esti, frame_nums)
    return torch.sum(((esti - label) * m) ** 2) / (global_sum(torch.sum(m)) * esti.shape[-1])


def mag_mae_loss(esti, label, frame_nums):
    """Masked MAE on magnitude (utils/loss.py:22-31)."""
    m = _mag_mask(esti, frame_nums)
    return torch.sum(torch.abs((esti - label) * m)) / (global_sum(torch.sum(m)) * esti.shape[-1])


def com_mse_loss(esti, label, frame_nums):
    """Masked MSE on real-packed complex ``[B, T, F, 2]`` (utils/loss.py:34-44)."""
    m = _mag_mask(esti[..., 0], frame_nums)[..., None]  # [B, T, 1, 1]
    return torch.sum(((esti - label) * m) ** 2) / (2.0 * global_sum(torch.sum(m)) * esti.shape[-2])


def com_mse_sigma_loss(esti, label, frame_nums, sigma_mask):
    """PriorGrad Mahalanobis-weighted complex MSE (utils/loss.py:46-56):
    error squared divided once by the per-bin ``sigma_mask``."""
    m = _mag_mask(esti[..., 0], frame_nums)[..., None]
    d = (esti - label) * m
    return torch.sum(d * d / sigma_mask) / (2.0 * global_sum(torch.sum(m)) * esti.shape[-2])


def com_mag_mse_loss(esti, label, frame_nums):
    """0.5 * (complex MSE + magnitude MSE) (utils/loss.py:59-71)."""
    m = _mag_mask(esti[..., 0], frame_nums)  # [B, T, 1]
    freq = esti.shape[-2]
    valid = global_sum(torch.sum(m))
    loss1 = torch.sum(((esti - label) * m[..., None]) ** 2) / (2.0 * valid * freq)
    mag_e = torch.linalg.vector_norm(esti, dim=-1)
    mag_l = torch.linalg.vector_norm(label, dim=-1)
    loss2 = torch.sum(((mag_e - mag_l) * m) ** 2) / (valid * freq)
    return 0.5 * (loss1 + loss2)


def l1_loss(esti, label):
    """Plain mean absolute error (the reference's ``loss_fn_eva``)."""
    return torch.mean(torch.abs(esti - label))


def pesq_loss(esti, label, frame_nums, feat_type: str = "sqrt") -> float:
    """``4.5 - mean PESQ`` over the batch (utils/loss.py:74-113): host-side
    and non-differentiable, as in the reference.  Raises when no PESQ
    backend exists (the optional ``pesq`` package, or ``PDT_APPROX_PESQ=1``)."""
    import numpy as np

    from prior_diffuse_tpu_torch.metrics.compare import spec_batch_to_wavs
    from prior_diffuse_tpu_torch.metrics.pesq import pesq_mode, pesq_score

    if pesq_mode() == "absent":
        raise ImportError(
            "pesq_loss requires a PESQ backend (the optional `pesq` "
            "package, or PDT_APPROX_PESQ=1 for the labeled approximation)"
        )
    frames = [int(n) for n in frame_nums]
    esti_wavs = spec_batch_to_wavs(esti, frames, feat_type)
    label_wavs = spec_batch_to_wavs(label, frames, feat_type)
    scores = []
    for c, p in zip(label_wavs, esti_wavs):
        s = pesq_score(c, p, 16000)
        if s is not None:  # PESQ errors are swallowed per-utterance
            scores.append(s)
    return 4.5 - float(np.mean(scores))


LOSSES = {
    "mag_mse_loss": mag_mse_loss,
    "mag_mae_loss": mag_mae_loss,
    "com_mse_loss": com_mse_loss,
    "com_mse_sigma_loss": com_mse_sigma_loss,
    "com_mag_mse_loss": com_mag_mse_loss,
    "pesq_loss": pesq_loss,
}
