"""Residual predictability ceiling.

The counterpart of the repository's ``scripts/probe_predictability.py``.
The residual DDPM can only beat the prior if the residual ``r = label/c -
x_init`` is predictable from its conditioning (in pirorgrad mode ``x_init``
alone).  This probe measures that ceiling with no diffusion in the way: a
fresh ``DiffUNet1`` trained as a supervised regressor of ``r_true``, with
the validation cosine of prediction and target.  Two variants:

* ``cond``: ``model(0, x_init, t_fix)``, what the reference's sampler
  conditions on;
* ``cond+noisy``: ``model(feat/c, x_init, t_fix)``, the bound if the DDPM
  could also see the noisy spectrum.

``t_fix = num_steps - 1``; the loss is the masked MSE; the optimizer is
``training/optim.py::torch_adam`` (the reference's Adam, no decay).  The
prior is the run's checkpoint, frozen, in eval mode (K1 and, on the card,
K3 through the trainer's ``Enhancer``); the regressor runs its module
forward, in train mode on the train batches and in eval mode on the cv
batches, where ``val_mse``, ``val_cos``, ``e_pred`` and ``e_true`` are
printed every ``--eval-every`` steps.  The last record is written to
``--out`` (default ``<assets>/probe_predictability_<tag>.json``).

Usage::

    python -m prior_diffuse_tpu_torch.scripts.probe_predictability \\
        --assets assets/speech_demo --sigma
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from prior_diffuse_tpu_torch.scripts import _setup

SEED = 77  # the regressor's initialisation (the JAX script's PRNGKey(77))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--assets", default="assets/speech2k")
    ap.add_argument("--doc", default="demo",
                    help="checkpoint doc dir to restore the frozen prior from")
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--sigma", action="store_true")
    ap.add_argument("--variant", choices=["cond", "cond+noisy"], default="cond")
    ap.add_argument("--out", default=None,
                    help="output JSON (default: <assets>/probe_predictability_<tag>.json)")
    ap.add_argument("--chunk", type=int, default=48000,
                    help="chunk length (match the checkpoint's run)")
    _setup.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.out is None:
        tag = args.variant.replace("+", "_")
        if args.doc != "demo":
            tag = f"{args.doc.removeprefix('demo_')}_{tag}"
        args.out = os.path.join(args.assets, f"probe_predictability_{tag}.json")
    return args


def regressor(tr, seed: int):
    """A fresh ``DiffUNet1`` of the run's DDPM shape, torch's default
    initialisation drawn from ``seed``, on the trainer's device."""
    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet1

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = DiffUNet1(tr.num_steps, cond_channels=2)
    return net.to(tr.device)


@torch.no_grad()
def fields(tr, noisy, clean, use_noisy: bool) -> tuple:
    """``(x_in, x_init, r_true)``: the regressor's input (``feat / c`` or
    zeros), its conditioner and its target, from the frozen prior."""
    from prior_diffuse_tpu_torch.training.base import spec_features

    feat = spec_features(noisy, tr.cfg)
    label = spec_features(clean, tr.cfg)
    tr.dis.eval()
    x_init = tr.enhancer.prior(feat).float() / tr.c
    r_true = label / tr.c - x_init
    x_in = feat / tr.c if use_noisy else torch.zeros_like(x_init)
    return x_in, x_init, r_true


def masked_mse_cos(pred, target, frames) -> tuple:
    """The masked MSE and cosine of ``pred`` against ``target``."""
    from prior_diffuse_tpu_torch.losses import frame_mask

    m = frame_mask(frames, pred.shape[1])[:, :, None, None]
    mse = torch.sum(((pred - target) * m) ** 2) / torch.sum(m * torch.ones_like(pred))
    cos = torch.sum(pred * target * m) / torch.sqrt(
        torch.sum((pred * m) ** 2) * torch.sum((target * m) ** 2) + 1e-20)
    return mse, cos


def train_step(tr, reg, opt, noisy, clean, frames, use_noisy: bool) -> torch.Tensor:
    """One Adam step of the regressor in train mode (batch statistics);
    returns the loss before it."""
    x_in, x_init, r_true = fields(tr, noisy, clean, use_noisy)
    t = torch.full((noisy.shape[0],), float(tr.num_steps - 1), device=noisy.device)
    reg.train()
    with torch.enable_grad():
        loss, _ = masked_mse_cos(reg(x_in, x_init, t), r_true, frames)
        opt.zero_grad(set_to_none=True)
        loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_step(tr, reg, noisy, clean, frames, use_noisy: bool) -> tuple:
    """``(mse, cos, e_pred, e_true)`` of the regressor in eval mode."""
    x_in, x_init, r_true = fields(tr, noisy, clean, use_noisy)
    t = torch.full((noisy.shape[0],), float(tr.num_steps - 1), device=noisy.device)
    reg.eval()
    pred = reg(x_in, x_init, t)
    mse, cos = masked_mse_cos(pred, r_true, frames)
    return mse, cos, torch.mean(pred ** 2), torch.mean(r_true ** 2)


def run_eval(tr, reg, step: int, args) -> dict:
    rows = []
    for batch in tr.cv_loader:
        noisy, clean, frames = tr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
        rows.append([float(x) for x in eval_step(tr, reg, noisy, clean, frames,
                                                 args.variant == "cond+noisy")])
    m = np.mean(np.asarray(rows), axis=0)
    rec = {"step": step, "variant": args.variant,
           "val_mse": round(float(m[0]), 6), "val_cos": round(float(m[1]), 4),
           "e_pred": round(float(m[2]), 7), "e_true": round(float(m[3]), 7)}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    """Train the regressor; returns the last evaluation record."""
    from prior_diffuse_tpu_torch.config import DiffusionConfig
    from prior_diffuse_tpu_torch.training.optim import torch_adam

    args = parse_args(argv)
    dev = _setup.device(args.device)
    exp = _setup.experiment(args.batch, args.chunk, lr_ddpm=args.lr,
                            diffusion=DiffusionConfig())
    print("building trainer (prior restored, frozen) ...", flush=True)
    tr = _setup.trainer(args.assets, args.doc, exp, dev, joint=False, sigma=args.sigma)
    print(f"checkpoint step {tr.step}", flush=True)
    use_noisy = args.variant == "cond+noisy"
    reg = regressor(tr, SEED)
    opt = torch_adam(reg.parameters(), args.lr)

    t0 = time.time()
    step = 0
    run_eval(tr, reg, step, args)
    while step < args.steps:
        for batch in tr.tr_loader:
            if step >= args.steps:
                break
            noisy, clean, frames = tr.to_device(batch.noisy, batch.clean, batch.frame_nums)
            loss = train_step(tr, reg, opt, noisy, clean, frames, use_noisy)
            step += 1
            if step % 200 == 0:
                print(f"step {step}: loss {float(loss):.6f} [{time.time() - t0:.0f}s]",
                      flush=True)
            if step % args.eval_every == 0:
                run_eval(tr, reg, step, args)
    final = run_eval(tr, reg, step, args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(final, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    tr.metrics.close()
    return final


if __name__ == "__main__":
    main()
