"""MagTrainer: a magnitude prior (GRN) trained alone.

The counterpart of ``prior_diffuse_tpu/training/mag_trainer.py`` on one
device (``conf/grn.yml``), in float32 or in bf16 compute as
``ComplexTrainer`` (GRN's bf16-compute output is float32, so its loss,
phase and ISTFT are too, as in JAX): the prior takes the compressed
magnitude ``[B, T, 161]`` of the noisy batch and is trained on the clean
one's with the loss of ``train.loss`` (``mag_mse_loss``), Adam with the
reference's L2 decay.  Unlike the complex trainers:

* the cv loader keeps the ragged last batch (``drop_last=False``, JAX
  ``mag_trainer.py:39-40``), so K1 and K2 see a batch smaller than
  ``batch_size``;
* ``_eval_step`` rebuilds complex spectra for scoring on the **noisy**
  phase for the estimate and the clean phase for the label
  (``mag_trainer.py:122-131``);
* serving is ``serving.enhance.MagServer``: K1, the prior on the
  magnitude, the estimate on the noisy phase, decompression, K2.

The epoch loop, evaluation, checkpoints, ``load_best`` and
``generate_wav`` are ``ComplexTrainer``'s.
"""

from __future__ import annotations

from typing import Optional

import torch

from prior_diffuse_tpu_torch.config import ExperimentConfig, RunConfig
from prior_diffuse_tpu_torch.data.dataset import EvalLoader
from prior_diffuse_tpu_torch.models import magnitude_prior_class
from prior_diffuse_tpu_torch.parallel.mesh import DataParallel, global_shares
from prior_diffuse_tpu_torch.serving.enhance import MagServer
from prior_diffuse_tpu_torch.signal.compress import from_mag_phase
from prior_diffuse_tpu_torch.training.base import mag_features, sharded
from prior_diffuse_tpu_torch.training.complex_trainer import ComplexTrainer
from prior_diffuse_tpu_torch.utils.logging import MetricsLogger


class MagTrainer(ComplexTrainer):
    prior_class = staticmethod(magnitude_prior_class)
    server_class = MagServer

    def __init__(self, run: RunConfig, exp: ExperimentConfig, device="cuda",
                 metrics_logger: Optional[MetricsLogger] = None,
                 parallel: Optional[DataParallel] = None):
        super().__init__(run, exp, device, metrics_logger, parallel)
        # the reference's MagTrainer scores every cv utterance
        self.cv_loader = EvalLoader(self.cv_dataset, self.cfg.batch_size, drop_last=False)

    @sharded
    def _train_step(self, noisy, clean, frame_nums, norms: bool = True):
        """One train step on device tensors ``noisy, clean [B, L]``,
        ``frame_nums [B]``: K1 and compression of both batches, the
        train-mode forward on the noisy magnitude, the loss against the
        clean one, the backward, the group gradient norms under ``model``
        (empty unless ``norms``), Adam; returns ``(loss, gnorms)``."""
        feat, _ = mag_features(noisy, self.cfg)
        label, _ = mag_features(clean, self.cfg)
        self.model_train.train()
        with torch.enable_grad():
            loss = self.loss_fn(self.model_train(feat).float(), label, frame_nums)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        return self._update(loss, norms)

    @sharded
    @torch.no_grad()
    def _eval_step(self, noisy, clean, frame_nums):
        """The prior in inference mode on one cv batch; returns ``(est,
        label, loss)``: the estimate on the noisy phase and the label on the
        clean phase, compressed ``[B, T, 161, 2]``, and the magnitude loss,
        a 0-d tensor."""
        feat, noisy_phase = mag_features(noisy, self.cfg)
        label, clean_phase = mag_features(clean, self.cfg)
        est = self.server.prior(feat).float()
        loss = global_shares(self.loss_fn(est, label, frame_nums))[0]
        return from_mag_phase(est, noisy_phase), from_mag_phase(label, clean_phase), loss
