"""ComplexTrainer: a prior trained alone in the complex domain.

The counterpart of ``prior_diffuse_tpu/training/complex_trainer.py`` on
one device, in float32 or in bf16 compute (``train.compute_dtype:
bfloat16``: the prior's ``models/precision.py::compute_view`` on its
float32 parameters, the estimate cast to float32 before the loss, JAX
``complex_trainer.py:98-104``): the prior of ``model.name`` (``GCRN`` for
``conf/gcrn.yml``, ``aia_complex_trans_ri`` for ``conf/dbaiat.yml``, or
any other prior of the model table), the loss of ``train.loss``, Adam with
the reference's L2 decay, and the epoch loop of the JAX trainer:

* ``_train_step``: the STFT (K1 on CUDA) and compression of the noisy and
  the clean batch, one train-mode forward, the loss, the backward, the
  per-group gradient norms under ``model``, Adam;
* ``evaluate``: the prior in inference mode on each cv batch, its loss and
  ``compare_complex``'s six metrics (whose ISTFT is K2);
* ``train``: epochs, an evaluation after each, LR halving and early stop
  on plateau, best and per-epoch checkpoints.

Serving (``enhance_batch``, ``generate_wav``) is
``serving.enhance.PriorServer``: K1, the prior (in bf16 compute for a
bf16-compute trainer, as evaluation), decompression, K2 on the estimate
cast to float32.

With ``parallel`` (``training/base.py``) each rank steps on its rows of the
global batch (global BatchNorm statistics and loss denominators, the
gradients summed before the norms and Adam), ``evaluate`` takes the global
cv loss and scores the gathered estimates on rank 0, and ``generate_wav``
serves each bucket on the ranks' rows; rank 0 writes.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from prior_diffuse_tpu_torch.config import ExperimentConfig, RunConfig
from prior_diffuse_tpu_torch.losses import LOSSES
from prior_diffuse_tpu_torch.metrics.compare import compare_complex
from prior_diffuse_tpu_torch.models import complex_prior_class, model_class
from prior_diffuse_tpu_torch.models.precision import compute_dtype, compute_view
from prior_diffuse_tpu_torch.parallel.mesh import DataParallel, global_shares
from prior_diffuse_tpu_torch.serving.enhance import PriorServer
from prior_diffuse_tpu_torch.training.base import (TrainerBase, grad_groups,
                                                   group_grad_norms, sharded, spec_features)
from prior_diffuse_tpu_torch.training.optim import get_lr, set_lr, torch_adam
from prior_diffuse_tpu_torch.utils.logging import MetricsLogger
from prior_diffuse_tpu_torch.utils.profiler import StepTimer


def seeded_model(seed: int, name: str) -> torch.nn.Module:
    """The prior named ``name`` with torch's default initialisation (the
    reference's own), drawn from ``seed`` without touching the caller's
    global random state."""
    cls = model_class(name)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return cls()


class ComplexTrainer(TrainerBase):
    # per-group grad norms go to the JSONL metrics every N steps
    grad_log_every = 50
    # the priors the trainer takes (raising for any other) and their server
    prior_class = staticmethod(complex_prior_class)
    server_class = PriorServer

    def __init__(self, run: RunConfig, exp: ExperimentConfig, device="cuda",
                 metrics_logger: Optional[MetricsLogger] = None,
                 parallel: Optional[DataParallel] = None):
        self.prior_class(exp.model.name)  # an unknown or a model of another kind raises
        super().__init__(run, exp, device, metrics_logger, parallel)
        self.loss_fn = LOSSES[self.cfg.loss]
        # the server turns TF32 off before any train step (f32 means f32)
        self.compute_dtype = compute_dtype(self.cfg.compute_dtype)
        self.server = self.server_class(seeded_model(run.seed, exp.model.name), exp,
                                        device=self.device, compute_dtype=self.compute_dtype)
        self.model = self.server.module
        # the train forward: the model itself, or its bf16-compute view
        self.model_train = compute_view(self.model, self.compute_dtype)
        self.opt = torch_adam(self.model.parameters(), exp.optim.lr, exp.optim.l2)
        self.nets = {"model": self.model}
        self.opts = {"opt": self.opt}
        self.grad_groups = grad_groups(self.model)
        self.gen = torch.Generator(device=self.device)
        self.seed_generator()
        self.start()

    # ---- steps --------------------------------------------------------------
    @sharded
    def _train_step(self, noisy, clean, frame_nums, norms: bool = True):
        """One train step on device tensors ``noisy, clean [B, L]``,
        ``frame_nums [B]``; returns ``(loss, gnorms)``, the loss a 0-d
        tensor and ``gnorms`` the per-group gradient norms (empty unless
        ``norms``).  In a group the tensors are this rank's rows and the
        loss and norms the global batch's."""
        feat = spec_features(noisy, self.cfg)
        label = spec_features(clean, self.cfg)
        self.model_train.train()
        with torch.enable_grad():
            loss = self.loss_fn(self.model_train(feat).float(), label, frame_nums)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        return self._update(loss, norms)

    def _update(self, loss, norms: bool):
        """After the backward of ``loss``: the gradients summed over the
        ranks, the group norms (if ``norms``), Adam; ``(loss, gnorms)``."""
        self.sum_grads()
        gnorms = group_grad_norms(self.grad_groups, "model") if norms else {}
        self.opt.step()
        return global_shares(loss.detach())[0], gnorms

    @sharded
    @torch.no_grad()
    def _eval_step(self, noisy, clean, frame_nums):
        """The prior in inference mode on one cv batch; returns ``(est,
        label, loss)``: the compressed estimate (in the prior's output dtype,
        bf16 from a bf16-compute GCRN, as JAX's) and label ``[B, T, 161,
        2]`` and the loss, a 0-d tensor (in a group: this rank's rows and
        the global loss)."""
        feat = spec_features(noisy, self.cfg)
        label = spec_features(clean, self.cfg)
        est = self.server.prior(feat)
        return est, label, global_shares(self.loss_fn(est, label, frame_nums))[0]

    # ---- epoch loop and serving ---------------------------------------------
    def evaluate(self) -> float:
        losses, results = [], []
        for batch in self.cv_loader:
            noisy, clean, frames = self.put_batch(batch.noisy, batch.clean,
                                                  batch.frame_nums)
            est, label, loss = self._eval_step(noisy, clean, frames)
            losses.append(float(loss))
            # scoring casts to float32 anyway; gathered in it
            est, label = self.gather_rows(len(batch.frame_nums), est.float(), label)
            if self.is_main:  # scoring (K2 and the metrics) on rank 0
                results.append(compare_complex(est, label, batch.frame_nums,
                                               self.cfg.feat_type))
        self.check_cv_nonempty(losses)
        cv_loss = float(np.mean(losses))
        if self.is_main:
            self.log_eval("test", cv_loss, np.mean(np.asarray(results), axis=0))
        return cv_loss

    def _halve_lrs(self):
        lr = get_lr(self.opt) / 2.0
        set_lr(self.opt, lr)
        logging.info("Learning rate adjusted to %f", lr)

    def train(self, max_epochs: Optional[int] = None, max_steps: Optional[int] = None):
        """The reference's main loop: train epochs with an evaluation after
        each, LR halving and early stop on plateau, best and per-epoch
        checkpoints."""
        timer = StepTimer()  # step to step, across epochs, as the JAX trainers log it
        n_epochs = max_epochs or self.cfg.n_epochs
        while self.epoch < n_epochs:
            logging.info("Epoch %d", self.epoch)
            for batch in self.tr_loader:
                if max_steps is not None and self.step >= max_steps:
                    return
                noisy, clean, frames = self.to_device(batch.noisy, batch.clean,
                                                      batch.frame_nums)
                loss, gnorms = self._train_step(
                    noisy, clean, frames, norms=self.step % self.grad_log_every == 0)
                loss = float(loss)  # scalar readback: step complete
                dt = timer.tick()
                self.check_nan(loss)
                rec = {"train_batch_loss": loss}
                if dt is not None:
                    rec["step_time_ms"] = dt * 1e3
                    rec["utt_per_sec"] = self.cfg.batch_size / dt
                rec.update({k: float(v) for k, v in gnorms.items()})
                self.metrics.log(rec, step=self.step)
                self.step += 1
            cv_loss = self.evaluate()
            halve, stop, is_best = self.plateau_update(cv_loss)
            if halve:
                self._halve_lrs()
            self.save_checkpoints(is_best, cv_loss)
            self.epoch += 1
            if stop:
                logging.info("No improvement and apply early stop")
                break

    # the CLI dispatches train_ddpm on every trainer, as the reference's main.py
    train_ddpm = train

    def load_best(self) -> bool:
        restored = self.ckpt.restore_best()
        if restored is not None:
            self.restore_payload(restored)
        return restored is not None

    def enhance_batch(self, noisy_padded, generator: Optional[torch.Generator] = None):
        """Enhance an RMS-normalised padded batch ``[B, L] -> [B, L]``: K1,
        the prior, decompression, K2.  Draws nothing.  In a group on this
        rank's rows, every row returned (:meth:`serve`)."""
        return self.serve(self.server, noisy_padded, generator)

    def generate_wav(self, load_pre_train: bool = True,
                     data_path: Optional[str] = None,
                     out_dir: Optional[str] = None,
                     compare_after: bool = False) -> float:
        """Enhance every wav of ``data_path`` (default: the noisy test set)
        into ``out_dir``; returns the real-time factor.  With
        ``compare_after``, score the output against the clean test set (the
        reference's dis-only ``generate_wav`` ends so)."""
        from prior_diffuse_tpu_torch.metrics.compare import compare
        from prior_diffuse_tpu_torch.serving.enhance import enhance_directory

        if load_pre_train:
            self.load_best()
        data_path = data_path or f"{self.run.data_root}/noisy_testset_wav"
        out_dir = out_dir or self.run.generated_wav_dir
        rtf = enhance_directory(self, data_path, out_dir, self.gen)
        if compare_after and self.is_main:  # rank 0 wrote the wavs
            clean_dir = f"{self.run.data_root}/clean_testset_wav"
            res = np.mean(np.asarray(compare(clean_dir, out_dir)), axis=0)
            logging.info("ref=%s", clean_dir)
            logging.info("deg=%s", out_dir)
            logging.info(
                "csig:%6.4f cbak:%6.4f covl:%6.4f pesq:%6.4f ssnr:%6.4f stoi:%6.4f",
                *res,
            )
        return rtf
