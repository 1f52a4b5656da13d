"""Residual-DDPM diagnostic probe.

The counterpart of the repository's ``scripts/diagnose_ddpm.py``.  It loads
a ``train_demo`` run's latest checkpoint and measures, on every cv batch,
*why* the sampled residual helps or hurts:

* energy calibration: E|r_samp|^2 against E|r_true|^2, where
  ``r_true = label/c - x_init`` (the DDPM's regression target) and
  ``r_samp = chain/c - x_init`` (what the sampler adds);
* direction: the masked cosine of ``r_samp`` and ``r_true``;
* the spectral MSE of the prior alone and of the full chain (the chain
  helps iff ``chain_mse < prior_mse``);
* per step of the inference schedule, the teacher-forced eps MSE of the
  denoiser against the trivial ``x_t / sqrt(1 - ab)``;
* all of it with the DDPM's BatchNorms on their running statistics and on
  the batch's statistics (``bn`` ``running`` / ``batch``), which isolates
  BatchNorm miscalibration.

As the JAX probe, the chain runs without the PriorGrad mask, one chain,
eps prediction.  The prior and, on running statistics, the DDPM run as the
trainer's evaluation runs them (``serving.enhancer.Enhancer``: K3 in every
encoder stage on the card); on batch statistics the DDPM runs its module
forward in train mode on a copy of the net, so the trainer's BatchNorm
statistics stay as they were (JAX's probe drops the updated statistics).
One JSON record a batch and mode is printed.

Usage::

    python -m prior_diffuse_tpu_torch.scripts.diagnose_ddpm --assets assets/speech_demo
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Optional

import torch

from prior_diffuse_tpu_torch.scripts import _setup


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--assets", default="assets/speech_demo")
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--sigma", action="store_true")
    _setup.add_device_arg(ap)
    return ap.parse_args(argv)


def masked_stats(a, b, frames):
    """Masked ``(E|a|^2, E|b|^2, cos(a, b))`` over the valid frames."""
    from prior_diffuse_tpu_torch.losses import frame_mask

    m = frame_mask(frames, a.shape[1])[:, :, None, None]
    n = torch.sum(m * torch.ones_like(a))
    ea = torch.sum((a * m) ** 2) / n
    eb = torch.sum((b * m) ** 2) / n
    cos = torch.sum(a * b * m) / torch.sqrt(torch.sum((a * m) ** 2) * torch.sum((b * m) ** 2))
    return ea, eb, cos


@torch.no_grad()
def probe(tr, noisy, clean, frames, bn_batch_stats: bool,
          generator: Optional[torch.Generator] = None,
          x_T: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None) -> tuple:
    """The JAX script's ``probe`` on one batch of device tensors: returns
    ``((prior_mse, chain_mse, e_true, e_samp, cos), [(model, trivial) per
    inference step])`` as 0-d tensors.  The chain's ``x_T [1, *x_init.shape]``
    and the teacher-forcing ``eps [N, *x_init.shape]`` (one per inference
    step) are drawn from ``generator`` unless given."""
    from prior_diffuse_tpu_torch.diffusion.sampler import reverse_sample
    from prior_diffuse_tpu_torch.losses import com_mse_loss
    from prior_diffuse_tpu_torch.models.fused_forward import fused_unet_forward
    from prior_diffuse_tpu_torch.training.base import spec_features

    enh, c = tr.enhancer, tr.c
    sched = enh.sched
    feat = spec_features(noisy, tr.cfg)
    label = spec_features(clean, tr.cfg)
    tr.dis.eval()
    tr.ddpm.eval()
    x_init = enh.prior(feat) / c
    r_true = label / c - x_init
    cond = enh.conditioner(feat, c, x_init)
    if bn_batch_stats:  # the batch's statistics, on a copy: the trainer's stay
        net = copy.deepcopy(tr.ddpm).train()
        model = (lambda x, t: net(x, t)) if cond is None else (lambda x, t: net(x, cond, t))
    else:
        _, pack = enh.packs()
        model = lambda x, t: fused_unet_forward(pack, x, cond, t)
    if x_T is None or eps is None:
        x_T = torch.randn((1, *x_init.shape), generator=generator, device=x_init.device)
        eps = torch.randn((sched.num_steps, *x_init.shape), generator=generator,
                          device=x_init.device)

    chain = reverse_sample(model, x_init, x_T, sched, mode=tr.mode)
    r_samp = chain - x_init
    prior_mse = com_mse_loss(x_init * c, label, frames)
    chain_mse = com_mse_loss(chain * c, label, frames)
    e_samp, e_true, cos = masked_stats(r_samp, r_true, frames)

    # the teacher-forced denoiser quality at each inference step
    per_step = []
    for n in range(sched.num_steps):
        ab = float(sched.alpha_cum[n])
        x_t = ab ** 0.5 * r_true + (1.0 - ab) ** 0.5 * eps[n]
        t_vec = torch.full((x_t.shape[0],), float(sched.T[n]), device=x_t.device)
        eps_hat = model(x_t, t_vec)
        per_step.append((com_mse_loss(eps_hat, eps[n], frames),
                         com_mse_loss(x_t / (1.0 - ab) ** 0.5, eps[n], frames)))
    return (prior_mse, chain_mse, e_true, e_samp, cos), per_step


def record(bn_batch: bool, bi: int, sched, result) -> dict:
    """The JAX script's JSON record of one probe."""
    (pm, cm, et, es, cos), steps = result
    return {
        "bn": "batch" if bn_batch else "running",
        "batch": bi,
        "prior_mse": float(pm),
        "chain_mse": float(cm),
        "res_energy_true": float(et),
        "res_energy_sampled": float(es),
        "res_cos": float(cos),
        "eps_mse_per_step": [
            {"n": n, "T": float(sched.T[n]), "alpha_cum": float(sched.alpha_cum[n]),
             "model": float(a), "trivial": float(b)}
            for n, (a, b) in enumerate(steps)],
    }


def main(argv=None) -> list:
    """Probe every cv batch in both BatchNorm modes; returns the records."""
    from prior_diffuse_tpu_torch.config import DiffusionConfig

    args = parse_args(argv)
    dev = _setup.device(args.device)
    exp = _setup.experiment(args.batch, diffusion=DiffusionConfig())
    print("building trainer ...", flush=True)
    tr = _setup.trainer(args.assets, "demo", exp, dev, joint=True, sigma=args.sigma)
    print(f"checkpoint step {tr.step}", flush=True)
    recs = []
    for bn_batch in (False, True):
        for bi, batch in enumerate(tr.cv_loader):
            noisy, clean, frames = tr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
            gen = torch.Generator(device=dev).manual_seed(123 + bi)
            rec = record(bn_batch, bi, tr.enhancer.sched,
                         probe(tr, noisy, clean, frames, bn_batch, gen))
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    tr.metrics.close()
    return recs


if __name__ == "__main__":
    main()
