"""Forward diffusion (q-sample) and the PriorGrad sigma mask.

The counterpart of ``prior_diffuse_tpu/diffusion/qsample.py``.  Random
draws come from a ``torch.Generator``, or are handed in explicitly
(:class:`Draws`), so a test can give the port the numbers the JAX
function drew.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from prior_diffuse_tpu_torch.parallel.mesh import draw_rows


def sigma_mask(x_init: torch.Tensor) -> torch.Tensor:
    """Per-bin noise scale in ``[0.5, 1]``: ``|x| / max_{T,F}|x| / 2 + 0.5``
    with the max per (batch, channel) of ``[B, T, F, 2]``, floored at
    1e-12 so an all-zero (padded) row gives 0.5, not 0/0."""
    a = torch.abs(x_init)
    m = torch.clamp(torch.amax(a, dim=(1, 2), keepdim=True), min=1e-12)
    return a / m / 2.0 + 0.5


class Draws(NamedTuple):
    """The random numbers of one :func:`q_sample` call.

    ``idx [B]`` int64: the timestep index (into ``alpha_bar``, or into
    ``t_grid``); ``normal``: a standard-normal draw of the spectrum's
    shape, before the sigma scaling; ``dropped [B]`` bool: the
    ``leak_drop`` mask (None when ``leak_drop`` is 0)."""

    idx: torch.Tensor
    normal: torch.Tensor
    dropped: Optional[torch.Tensor] = None


def draw(clean: torch.Tensor, n_t: int, leak_drop: float,
         generator: torch.Generator) -> Draws:
    """The draws of one q-sample from ``generator``, in a fixed order:
    timestep indices, the normal draw, then the drop mask.  Inside a
    ``parallel.mesh.DataParallel`` each is drawn for the global padded batch
    and this rank's rows kept (``draw_rows``)."""
    batch, dev = clean.shape[0], clean.device
    idx = draw_rows(lambda s: torch.randint(0, n_t, s, generator=generator, device=dev),
                    (batch,))
    normal = draw_rows(lambda s: torch.randn(s, generator=generator, device=dev,
                                             dtype=clean.dtype), clean.shape)
    dropped = None
    if leak_drop > 0.0:
        dropped = draw_rows(lambda s: torch.rand(s, generator=generator, device=dev),
                            (batch,)) < leak_drop
    return Draws(idx, normal, dropped)


def q_sample(
    clean: torch.Tensor,
    x_init: Optional[torch.Tensor],
    alpha_bar: torch.Tensor,
    num_steps: int,
    mode: str = "pirorgrad",
    sig_mask: Optional[torch.Tensor] = None,
    t_grid: Optional[torch.Tensor] = None,
    ab_grid: Optional[torch.Tensor] = None,
    leak_drop: float = 0.0,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build ``x_t``; returns ``(x_t, noise, t)``.

    ``t`` is int64 ``[B]`` drawn uniformly from ``0..num_steps-1``, or,
    with ``t_grid``/``ab_grid`` (the fast schedule's aligned pairs), a
    float32 timestep of the grid.  Modes
    (trainer/complex_ddpm_trainer.py:720-733):

    * ``pirorgrad``:   x_t = sqrt(ab)*(clean - x_init) + sqrt(1-ab)*eps
    * ``deltamu``:     x_t = sqrt(ab)*clean + sqrt(1-ab)*(eps + x_init)
    * ``conditional``: x_t = sqrt(ab)*clean + sqrt(1-ab)*eps

    With ``sig_mask`` the noise is scaled by ``sqrt(mask)`` before mixing,
    and the *returned* noise (the regression target) is the scaled one.
    ``leak_drop``: with this probability per sample the signal term of
    ``x_t`` is zeroed (the target is unchanged).  The draws come from
    ``generator`` unless ``draws`` gives them."""
    if mode not in ("pirorgrad", "deltamu", "conditional"):
        raise ValueError(f"unknown diffusion mode {mode!r}")
    if leak_drop > 0.0 and mode == "deltamu":
        raise ValueError("leak_drop is unsupported in deltamu mode")
    batch = clean.shape[0]
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or explicit draws")
        n_t = len(t_grid) if t_grid is not None else num_steps
        draws = draw(clean, n_t, leak_drop, generator)
    if t_grid is not None:
        t = t_grid.to(torch.float32)[draws.idx]
        ab = ab_grid.to(clean.dtype)[draws.idx]
    else:
        t = draws.idx
        ab = alpha_bar.to(clean.dtype)[t]
    ab = ab.reshape(batch, 1, 1, 1)
    noise = draws.normal
    if sig_mask is not None:
        noise = noise * torch.sqrt(sig_mask)

    if mode == "deltamu":
        return torch.sqrt(ab) * clean + torch.sqrt(1.0 - ab) * (noise + x_init), noise, t
    signal = clean - x_init if mode == "pirorgrad" else clean
    if leak_drop > 0.0:
        keep = torch.where(draws.dropped, 0.0, 1.0).to(clean.dtype)
        signal = signal * keep.reshape(batch, 1, 1, 1)
    return torch.sqrt(ab) * signal + torch.sqrt(1.0 - ab) * noise, noise, t
