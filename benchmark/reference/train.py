"""The reference joint train step: prior and residual DDPM, one loss, Adam.

``--joint --sigma`` in pirorgrad mode, as published: the compressed noisy
and clean spectra; the prior's train-mode forward and its masked complex
MSE; ``x_init`` its detached output over ``c``; PriorGrad's sigma mask of
``x_init``; ``x_t = sqrt(ab) (clean / c - x_init) + sqrt(1 - ab) z
sqrt(mask)`` at the drawn step; the denoiser's train-mode forward on
``(x_t, x_init, t)``; its mask-weighted MSE against the scaled noise;
``lam L_ddpm + L_prior``; one backward; Adam with the L2 decay added to
the gradient, on both nets.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dsp


def frame_mask(frame_nums, frames):
    t = torch.arange(frames, device=frame_nums.device)[None]
    return (t < frame_nums[:, None]).float()[:, :, None, None]


def com_mse(esti, label, frame_nums, weight=None):
    m = frame_mask(frame_nums, esti.shape[1])
    d = (esti - label) * m
    err = d * d if weight is None else d * d / weight
    return err.sum() / (2.0 * m.sum() * esti.shape[-2])


class Adam:
    """``torch.optim.Adam``'s update, written out: the decay added to the
    gradient, bias-corrected first and second moments."""

    def __init__(self, params, lr, l2, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, self.l2, self.betas, self.eps = lr, l2, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0
        self.first_grads = None

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        grads = []
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.l2 * p
            grads.append(g.clone())
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / np.sqrt(1 - b2 ** self.t)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))
        if self.first_grads is None:
            self.first_grads = grads


def step_loss(prior, ddpm, noisy, clean, frame_nums, idx, normal, alpha_bar, c, lam):
    """The joint loss of one step (both nets in train mode)."""
    feat = dsp.compress(dsp.stft(noisy))
    label = dsp.compress(dsp.stft(clean))
    out = prior(feat)
    loss_prior = com_mse(out, label, frame_nums)
    x_init = out.detach() / c
    mask = dsp.sigma_mask(x_init)
    ab = alpha_bar[idx].reshape(-1, 1, 1, 1)
    noise = normal * torch.sqrt(mask)
    x_t = torch.sqrt(ab) * (label / c - x_init) + torch.sqrt(1.0 - ab) * noise
    pred = ddpm(x_t, x_init, idx)
    return lam * com_mse(pred, noise, frame_nums, mask) + loss_prior


def train(prior, ddpm, batches, draws, exp: dict, steps: int, moments=None, t0: int = 0):
    """``steps`` steps of the nets in place; returns the losses and the
    first step's gradients as Adam takes them (name -> tensor).  Adam
    starts from nothing, or, with ``moments`` (name -> ``(m, v)``), from
    those moments after ``t0`` steps."""
    diff, optim = exp["diffusion"], exp["optim"]
    optim_ddpm = exp.get("optim_ddpm") or optim
    dev = next(prior.parameters()).device
    alpha_bar = torch.tensor(np.cumprod(1.0 - np.asarray(diff["noise_schedule"], np.float64)),
                             dtype=torch.float32, device=dev)
    opts = (Adam(prior.parameters(), optim["lr"], optim["l2"]),
            Adam(ddpm.parameters(), optim_ddpm["lr"], optim_ddpm["l2"]))
    names = [[f"{key}.{n}" for n, _ in net.named_parameters()]
             for key, net in (("dis", prior), ("ddpm", ddpm))]
    if moments is not None:
        for opt, keys in zip(opts, names):
            opt.m = [moments[k][0].to(p).clone() for k, p in zip(keys, opt.params)]
            opt.v = [moments[k][1].to(p).clone() for k, p in zip(keys, opt.params)]
            opt.t = t0
    prior.train()
    ddpm.train()
    losses = []
    for k in range(steps):
        noisy, clean, frame_nums = batches[k]
        idx, normal = draws[k]
        for p in [*prior.parameters(), *ddpm.parameters()]:
            p.grad = None
        loss = step_loss(prior, ddpm, noisy, clean, frame_nums, idx, normal, alpha_bar,
                         diff["scale_c"], exp["train"]["lam"])
        loss.backward()
        for opt in opts:
            opt.step()
        losses.append(float(loss.detach()))
    grads = dict(zip(names[0] + names[1], opts[0].first_grads + opts[1].first_grads))
    return losses, grads
