"""Faults planted under the harness, to see each cell's check fail.

``mutate(kind, limits)`` returns a function for ``run_cell(...,
mutate=...)`` (and ``calibrate.py --fault``) that breaks the program
object a driver has built, before the driver drives it:

* ``state_unchanged``: serving: the reverse chain returns its start, the
  prior's estimate; training: the optimizers' steps do nothing;
* ``half_batch``: serving: the second half of each batch comes back as it
  went in; training: each step sees the first half of its rows, its loss
  the mean over those;
* ``answer_altered``: serving: the first row of each batch scaled by
  ``1 + 3 x`` the limit; training: each step's loss so scaled.

No fault of an exchange between chips: every cell runs on one chip.
"""

from __future__ import annotations

import numpy as np
import torch

KINDS = ("state_unchanged", "half_batch", "answer_altered")


def _serving(kind, limits):
    limit = limits["wav_rel_err"]

    def mutate(driver):
        enh = driver.enhancer
        chain, batch = enh.chain, enh.enhance_batch
        if kind == "state_unchanged":
            def broken_chain(feat, generator=None, x_T=None):
                _, x_init = chain(feat, generator, x_T)
                return x_init.float() * enh.cfg.diffusion.scale_c, x_init
            enh.chain = broken_chain
            return

        def broken_batch(wav, generator=None, **kw):
            out = batch(wav, generator, **kw).clone()
            if kind == "half_batch":
                half = out.shape[0] // 2
                out[half:] = torch.as_tensor(np.asarray(wav)[half:], device=out.device)
            else:
                out[0] *= 1 + 3 * limit
            return out
        enh.enhance_batch = broken_batch
    return mutate


def _train(kind, limits):
    def mutate(driver):
        tr = driver.trainer
        step = tr._train_step
        if kind == "state_unchanged":
            tr.opt_dis.step = tr.opt_ddpm.step = lambda *a, **k: None
        elif kind == "half_batch":
            def half(noisy, clean, frames, draws=None, norms=True):
                h = noisy.shape[0] // 2
                return step(noisy[:h], clean[:h], frames[:h],
                            draws=type(draws)(draws.idx[:h], draws.normal[:h]), norms=norms)
            tr._train_step = half
        else:
            def altered(*a, **k):
                out = step(*a, **k)
                return (out[0] * (1 + 3 * limits["loss_gap"]), *out[1:])
            tr._train_step = altered
    return mutate


def mutate(kind: str, limits: dict):
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")
    return (_train if "loss_gap" in limits else _serving)(kind, limits)
