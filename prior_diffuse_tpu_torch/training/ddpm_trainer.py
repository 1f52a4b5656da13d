"""ComplexDDPMTrainer — the joint prior + residual DDPM trainer.

The counterpart of ``prior_diffuse_tpu/training/ddpm_trainer.py`` on one
device, with any prior of the model table (``model.name``: the
``DiffUNet``, ``GCRN`` or a DB-AIAT variant; JAX ``:148-155``), in the
three diffusion modes (``pirorgrad`` and
``conditional`` with the ``DiffUNet1`` denoiser, ``deltamu`` with the
unconditional ``Nocon``), with the ``cond_noisy``, ``train_t_fast``,
``predict="x0"`` and ``x0_leak_drop`` extensions, in float32 or in bf16
compute (``train.compute_dtype: bfloat16``).  ``_train_step`` follows the
JAX ``_train_step_impl`` line for line:

* STFT (K1 on CUDA) and compression of the noisy and the clean batch, in
  float32;
* one train-mode prior forward; its output, cast to float32, detached and
  divided by ``c``, is ``x_init``; in joint mode the prior's loss uses the
  output itself (in non-joint mode the prior still runs in train mode and
  keeps its new BN statistics, but takes no update);
* q-sample in the mode, the train-mode DDPM forward (conditioned on
  ``x_init``, on the noisy spectrum in conditional mode, on nothing in
  deltamu), its output cast to float32, the eps or x0 target, the
  sigma-weighted loss under ``--sigma``;
* ``lam * L_ddpm + L_dis``, one backward, per-group gradient norms, Adam,
  all in float32.

The train forwards and backward are plain PyTorch (cuDNN convolutions,
autograd), as the JAX package leaves them to XLA.  In bf16 compute the
nets run as their ``models/precision.py::compute_view`` on their float32
parameters (the optimizer's, the checkpoint's), and the DiffUNet family
trains through ``models/fused_forward.py::dual_train_forward`` (JAX's
default there, ``fused_train``), any other prior through its module
forward.

Evaluation and ``--generate`` of a float32 trainer run the serving path
(``serving.enhancer.Enhancer``): K3 on packed encoder operands in all 7
forwards of a batch (in the 6 DDPM forwards with a prior other than the
``DiffUNet``, which runs unpacked, JAX's ``_dis_apply``), K2 in scoring.
Those of a bf16-compute trainer run ``serving.enhancer.ComputeEnhancer``,
as JAX evaluates and serves a bf16-trained model: the bf16-compute
modules, the chain in float32, K1 and K2, no K3.

As in JAX, ``run.draw`` replaces training with :meth:`draw_audio` (one cv
batch scored and plotted) and ``run.profile_steps`` traces the first
steps (``utils/profiler.py::trace``, on rank 0).

With ``parallel`` (``training/base.py``) each rank steps on its rows of the
global batch: global BatchNorm statistics, loss denominators and q-sample
draws, the gradients summed before the norms and Adam, the losses reported
summed; ``evaluate`` takes the global cv loss and diagnostics and scores
the gathered estimates on rank 0 (K2 runs there); ``--generate`` serves
each bucket on the ranks' rows and rank 0 writes the wavs.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Optional

import numpy as np
import torch

from prior_diffuse_tpu_torch.config import ExperimentConfig, RunConfig
from prior_diffuse_tpu_torch.diffusion.qsample import Draws, q_sample, sigma_mask
from prior_diffuse_tpu_torch.diffusion.sampler import diffusion_mode
from prior_diffuse_tpu_torch.diffusion.schedule import inference_schedule
from prior_diffuse_tpu_torch.losses import (LOSSES, com_mse_loss, com_mse_sigma_loss,
                                             frame_mask)
from prior_diffuse_tpu_torch.metrics.compare import (compare_complex, compare_wavs,
                                                     spec_batch_to_wavs)
from prior_diffuse_tpu_torch.models import complex_prior_class
from prior_diffuse_tpu_torch.models.diffunet import DiffUNet, DiffUNet1, Nocon
from prior_diffuse_tpu_torch.models.fused_forward import dual_train_forward
from prior_diffuse_tpu_torch.models.precision import compute_dtype, compute_view
from prior_diffuse_tpu_torch.parallel.mesh import DataParallel, global_shares, global_sum
from prior_diffuse_tpu_torch.serving.enhancer import ComputeEnhancer, Enhancer
from prior_diffuse_tpu_torch.training.base import (TrainerBase, grad_groups,
                                                   group_grad_norms, sharded, spec_features)
from prior_diffuse_tpu_torch.training.optim import get_lr, set_lr, torch_adam
from prior_diffuse_tpu_torch.utils.logging import MetricsLogger
from prior_diffuse_tpu_torch.utils.profiler import StepTimer, span, trace


def seeded_nets(seed: int, num_steps: int, cond_channels: int, mode: str = "pirorgrad",
                prior: str = "DiffUNet"):
    """The prior named ``prior`` (the model table's names) and the mode's
    denoiser (``Nocon`` in deltamu, else ``DiffUNet1``: the mode picks the
    net, not the config's name, JAX ``ddpm_trainer.py:156-160``) with
    torch's default initialisation (the reference's own), drawn from
    ``seed`` without touching the caller's global random state."""
    prior_cls = complex_prior_class(prior)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        ddpm = (Nocon(num_steps) if mode == "deltamu"
                else DiffUNet1(num_steps, cond_channels=cond_channels))
        return prior_cls(), ddpm


class ComplexDDPMTrainer(TrainerBase):
    # per-group grad norms go to the JSONL metrics every N steps; the JAX
    # package computes them inside its train-step jit, the port only on
    # the steps that log them
    grad_log_every = 50

    def __init__(self, run: RunConfig, exp: ExperimentConfig, device="cuda",
                 metrics_logger: Optional[MetricsLogger] = None,
                 parallel: Optional[DataParallel] = None):
        diff = exp.diffusion
        mode = diffusion_mode(diff)
        complex_prior_class(exp.model.name)  # an unknown or a non-complex model raises
        self.x0_leak_drop = float(diff.x0_leak_drop)
        if self.x0_leak_drop and diff.predict != "x0":
            raise ValueError("x0_leak_drop requires predict='x0'")
        if not 0.0 <= self.x0_leak_drop <= 1.0:
            raise ValueError("x0_leak_drop must be in [0, 1]")
        super().__init__(run, exp, device, metrics_logger, parallel)
        self.mode = mode
        self.predict = diff.predict
        self.cond_noisy = bool(diff.cond_noisy)
        self.c = diff.scale_c
        self.num_steps = diff.num_steps
        dev = self.device
        self.alpha_bar = torch.tensor(
            np.cumprod(1.0 - np.asarray(diff.noise_schedule, np.float64)),
            dtype=torch.float32, device=dev)
        if diff.train_t_fast:
            inf = inference_schedule(diff, fast_sampling=True)
            self.t_grid = torch.tensor(inf.T, dtype=torch.float32, device=dev)
            self.ab_grid = torch.tensor(inf.alpha_cum, dtype=torch.float32, device=dev)
        else:
            self.t_grid = self.ab_grid = None
        self.loss_fn = LOSSES[self.cfg.loss]

        dis, ddpm = seeded_nets(run.seed, self.num_steps, 4 if self.cond_noisy else 2,
                                self.mode, exp.model.name)
        # the evaluation path holds the same modules; it also turns TF32
        # off before any train step (f32 means f32, as in the JAX reference)
        self.compute_dtype = compute_dtype(self.cfg.compute_dtype)
        if self.compute_dtype == torch.float32:
            self.enhancer = Enhancer(dis, ddpm, exp, device=dev, sigma=run.sigma)
        else:
            self.enhancer = ComputeEnhancer(dis, ddpm, exp, device=dev, sigma=run.sigma,
                                            compute_dtype=self.compute_dtype)
        self.dis, self.ddpm = self.enhancer.dis, self.enhancer.ddpm
        # the train forwards: the nets themselves in float32; in bf16 their
        # compute views, the DiffUNet family through the dual decoder (JAX's
        # fused_train, the default for bf16, ddpm_trainer.py:146-147)
        self.dis_train = compute_view(self.dis, self.compute_dtype)
        self.ddpm_train = compute_view(self.ddpm, self.compute_dtype)
        self.fused_train = self.compute_dtype != torch.float32
        opt_ddpm_cfg = exp.optim_ddpm or exp.optim
        self.opt_dis = torch_adam(self.dis.parameters(), exp.optim.lr, exp.optim.l2)
        self.opt_ddpm = torch_adam(self.ddpm.parameters(), opt_ddpm_cfg.lr, opt_ddpm_cfg.l2)
        self.nets = {"dis": self.dis, "ddpm": self.ddpm}
        self.opts = {"opt_dis": self.opt_dis, "opt_ddpm": self.opt_ddpm}
        self.grad_groups = {n: grad_groups(m) for n, m in self.nets.items()}
        self.gen = torch.Generator(device=dev)
        self.seed_generator()
        self.start()

    # ---- steps --------------------------------------------------------------
    @sharded
    def _train_step(self, noisy, clean, frame_nums, draws: Optional[Draws] = None,
                    norms: bool = True):
        """One train step on device tensors ``noisy, clean [B, L]``,
        ``frame_nums [B]``; returns ``(total, loss_dis, loss_ddpm, gnorms)``
        as 0-d tensors, ``gnorms`` the per-group gradient norms (empty
        unless ``norms``).  The q-sample draws come from ``self.gen`` unless
        ``draws`` gives them (in a group, this rank's rows of them).  In a
        group the tensors are this rank's rows and the losses and norms
        returned are the global batch's."""
        cfg, joint, sigma = self.cfg, self.run.joint, self.run.sigma
        with span("train.step", self.device):
            with span("train.features", self.device):
                feat = spec_features(noisy, cfg)
                label = spec_features(clean, cfg)
            self.dis_train.train()
            self.ddpm_train.train()
            with span("train.forward", self.device), torch.enable_grad():
                with torch.set_grad_enabled(joint):
                    dis_out = self._dis_forward(feat).float()
                if joint:
                    loss_dis = self.loss_fn(dis_out, label, frame_nums)
                else:
                    loss_dis = torch.zeros((), device=self.device)
                x_init = dis_out.detach() / self.c
                lbl = label / self.c
                sig = sigma_mask(x_init) if sigma else None
                x_t, noise, t = q_sample(
                    lbl, x_init, self.alpha_bar, self.num_steps, self.mode, sig,
                    t_grid=self.t_grid, ab_grid=self.ab_grid,
                    leak_drop=self.x0_leak_drop, generator=self.gen, draws=draws)
                cond = self.enhancer.conditioner(feat, self.c, x_init)
                pred = self._ddpm_forward(x_t, cond, t).float()
                if self.predict == "x0":
                    # the chain's clean-side quantity: the residual the sampler
                    # adds back onto x_init (pirorgrad), the clean spectrum
                    # (conditional)
                    target = lbl - x_init if self.mode == "pirorgrad" else lbl
                else:
                    target = noise
                if sigma:
                    loss_ddpm = com_mse_sigma_loss(pred, target, frame_nums, sig)
                else:
                    loss_ddpm = self.loss_fn(pred, target, frame_nums)
                total = cfg.lam * loss_ddpm + loss_dis
            with span("train.backward", self.device):
                with torch.enable_grad():
                    self.opt_dis.zero_grad(set_to_none=True)
                    self.opt_ddpm.zero_grad(set_to_none=True)
                    total.backward()
                self.sum_grads()
            gnorms = {}
            if norms:
                with span("train.norms", self.device):
                    for n, groups in self.grad_groups.items():
                        gnorms.update(group_grad_norms(groups, n))
            with span("train.optimizer", self.device):
                self.opt_ddpm.step()
                if joint:
                    self.opt_dis.step()
            return (*global_shares(total.detach(), loss_dis.detach(), loss_ddpm.detach()),
                    gnorms)

    def _dis_forward(self, feat):
        """The prior's train-mode forward (JAX ``_dis_apply``, train)."""
        if self.fused_train and isinstance(self.dis, DiffUNet):
            return dual_train_forward(self.dis_train, feat, dtype=self.compute_dtype)
        return self.dis_train(feat)

    def _ddpm_forward(self, x_t, cond, t):
        """The denoiser's train-mode forward (JAX ``_ddpm_apply``, train);
        ``cond`` None for ``Nocon``."""
        if self.fused_train:
            return dual_train_forward(self.ddpm_train, x_t, cond, t, dtype=self.compute_dtype)
        return self.ddpm_train(x_t, t) if cond is None else self.ddpm_train(x_t, cond, t)

    @sharded
    @torch.no_grad()
    def _eval_step(self, noisy, clean, frame_nums, x_T: Optional[torch.Tensor] = None):
        """The prior and the reverse chain in inference mode on one cv batch;
        returns ``(audio, label, loss, diag)``: the compressed estimate and
        label ``[B, T, 161, 2]``, the chain's masked MSE and the residual
        diagnostics (``prior_mse``, ``res_energy_true``,
        ``res_energy_sampled``, ``res_cos``), all 0-d tensors.  In a group
        the estimate and label are this rank's rows (``x_T`` too, if given)
        and the loss and diagnostics the global batch's."""
        feat = spec_features(noisy, self.cfg)
        label = spec_features(clean, self.cfg)
        audio, x_init = self.enhancer.eval_chain(feat, self.gen, x_T)
        loss = com_mse_loss(audio, label, frame_nums)
        # the DDPM's regression target is r_true = label/c - x_init; r_samp
        # is what the chain adds.  The chain helps iff loss < prior_mse.
        r_true = label / self.c - x_init
        r_samp = audio / self.c - x_init
        m = frame_mask(frame_nums, r_true.shape[1])[:, :, None, None]
        n_valid = global_sum(torch.sum(m)) * r_true.shape[2] * r_true.shape[3]
        e_true = torch.sum((r_true * m) ** 2) / n_valid
        e_samp = torch.sum((r_samp * m) ** 2) / n_valid
        dot, s_samp, s_true = global_sum(torch.stack([
            torch.sum(r_samp * r_true * m), torch.sum((r_samp * m) ** 2),
            torch.sum((r_true * m) ** 2)]))
        cos = dot / torch.sqrt(s_samp * s_true + 1e-20)
        loss, prior_mse, e_true, e_samp = global_shares(
            loss, com_mse_loss(x_init * self.c, label, frame_nums), e_true, e_samp)
        diag = {
            "prior_mse": prior_mse,
            "res_energy_true": e_true,
            "res_energy_sampled": e_samp,
            "res_cos": cos,
        }
        return audio, label, loss, diag

    # ---- drivers --------------------------------------------------------------
    def evaluate(self) -> float:
        losses, results, diags = [], [], []
        for batch in self.cv_loader:
            noisy, clean, frames = self.put_batch(batch.noisy, batch.clean,
                                                  batch.frame_nums)
            audio, label, loss, diag = self._eval_step(noisy, clean, frames)
            losses.append(float(loss))
            diags.append({k: float(v) for k, v in diag.items()})
            audio, label = self.gather_rows(len(batch.frame_nums), audio, label)
            if self.is_main:  # scoring (K2 and the metrics) on rank 0
                results.append(compare_complex(audio, label, batch.frame_nums,
                                               self.cfg.feat_type))
        self.check_cv_nonempty(losses)
        cv_loss = float(np.mean(losses))
        diag_mean = {f"test_{k}": float(np.mean([d[k] for d in diags]))
                     for k in diags[0]}
        diag_mean["test_chain_mse"] = cv_loss
        self.metrics.log(diag_mean, step=self.step)
        logging.info(
            "residual diag: prior_mse %.5f chain_mse %.5f e_true %.6f "
            "e_samp %.6f cos %.3f",
            diag_mean["test_prior_mse"], cv_loss,
            diag_mean["test_res_energy_true"],
            diag_mean["test_res_energy_sampled"], diag_mean["test_res_cos"],
        )
        if self.is_main:
            self.log_eval("test", cv_loss, np.mean(np.asarray(results), axis=0))
        return cv_loss

    def _halve_lrs(self):
        for name, opt in self.opts.items():
            lr = get_lr(opt) / 2.0
            set_lr(opt, lr)
            logging.info("Learning rate of %s adjusted to %f", name, lr)

    def train_ddpm(self, max_epochs: Optional[int] = None,
                   max_steps: Optional[int] = None):
        """The reference's main loop: train epochs with a sampling eval after
        each, LR halving and early stop on plateau, best and per-epoch
        checkpoints.  ``run.draw`` runs :meth:`draw_audio` instead;
        ``run.profile_steps`` traces the loop until that many steps are
        done (``utils/profiler.py::trace``, under ``<log_dir>/trace``)."""
        if self.run.draw:  # draw-from-checkpoint mode (main loop skipped)
            self.draw_audio()
            return
        profiling = contextlib.ExitStack()  # closed after step profile_steps
        if self.is_main and self.run.profile_steps and self.step < self.run.profile_steps:
            profiling.enter_context(trace(os.path.join(self.run.log_dir, "trace"),
                                          self.device))
        with profiling:
            self._train_loop(max_epochs or self.cfg.n_epochs, max_steps, profiling)

    def _train_loop(self, n_epochs: int, max_steps: Optional[int],
                    profiling: contextlib.ExitStack) -> None:
        timer = StepTimer()  # step to step, across epochs, as the JAX trainers log it
        while self.epoch < n_epochs:
            logging.info("Epoch %d", self.epoch)
            if not self.run.eval:
                for batch in self.tr_loader:
                    if max_steps is not None and self.step >= max_steps:
                        return
                    noisy, clean, frames = self.to_device(
                        batch.noisy, batch.clean, batch.frame_nums)
                    log_norms = self.step % self.grad_log_every == 0
                    total, l_dis, l_ddpm, gnorms = self._train_step(
                        noisy, clean, frames, norms=log_norms)
                    total = float(total)  # scalar readback: step complete
                    dt = timer.tick()
                    self.check_nan(total)
                    rec = {"dis_loss": float(l_dis), "ddpm_loss": float(l_ddpm),
                           "loss_sum": total}
                    if dt is not None:
                        rec["step_time_ms"] = dt * 1e3
                        rec["utt_per_sec"] = self.cfg.batch_size / dt
                    rec.update({k: float(v) for k, v in gnorms.items()})
                    self.metrics.log(rec, step=self.step)
                    self.step += 1
                    if self.step == self.run.profile_steps:
                        profiling.close()
            cv_loss = self.evaluate()
            if self.run.eval:
                return
            halve, stop, is_best = self.plateau_update(cv_loss)
            if halve:
                self._halve_lrs()
            self.save_checkpoints(is_best, cv_loss)
            self.epoch += 1
            if stop:
                logging.info("No improvement and apply early stop")
                break

    def draw_audio(self, out_dir: Optional[str] = None, max_batches: int = 1) -> str:
        """Eval + plot path: runs reverse sampling on the first
        ``max_batches`` cv batches, writes a noisy / clean / enhanced
        spectrogram figure per utterance (``draw_b{batch}_{i}.png`` in
        ``out_dir``, default ``<wav dir>/draw``), logs the loss and the 6
        metrics as ``draw_*`` and returns ``out_dir``.

        The JAX ``draw_audio`` (``ddpm_trainer.py:525-567``), a working
        replacement for the reference's, which crashes on undefined names
        (SURVEY 2.9).  The metrics score the same waveforms the figures
        show, so a batch runs two ISTFTs (JAX's runs the same two twice);
        the spectrograms are computed on the trainer's device (K1 on the
        card).  Without matplotlib the first figure raises its
        ``ImportError``, as in JAX."""
        from prior_diffuse_tpu_torch.viz import draw_comparison

        out_dir = out_dir or os.path.join(self.run.generated_wav_dir, "draw")
        os.makedirs(out_dir, exist_ok=True)
        losses, results = [], []
        for bi, batch in enumerate(self.cv_loader):
            if bi >= max_batches:
                break
            noisy, clean, frames = self.put_batch(batch.noisy, batch.clean,
                                                  batch.frame_nums)
            audio, label, loss, _ = self._eval_step(noisy, clean, frames)
            losses.append(float(loss))
            audio, label = self.gather_rows(len(batch.frame_nums), audio, label)
            if not self.is_main:  # rank 0 scores and draws
                continue
            esti_wavs = spec_batch_to_wavs(audio, batch.frame_nums, self.cfg.feat_type)
            label_wavs = spec_batch_to_wavs(label, batch.frame_nums, self.cfg.feat_type)
            results.append(compare_wavs(label_wavs, esti_wavs))
            for i, (e, l) in enumerate(zip(esti_wavs, label_wavs)):
                n = batch.wav_lens[i]
                draw_comparison(
                    [batch.noisy[i, :n], l, e], ["noisy", "clean", "enhanced"],
                    path=os.path.join(out_dir, f"draw_b{bi}_{i}.png"), device=self.device)
        if self.is_main:
            self.log_eval("draw", float(np.mean(losses)), np.mean(np.asarray(results), axis=0))
        return out_dir

    def enhance_batch(self, noisy_padded, generator: Optional[torch.Generator] = None):
        """Enhance an RMS-normalised padded batch ``[B, L] -> [B, L]``
        through the serving path (the bf16-compute one for a bf16-compute
        trainer), drawing from ``generator`` (default: the trainer's own); in
        a group on this rank's rows, every row returned (:meth:`serve`)."""
        return self.serve(self.enhancer, noisy_padded, generator or self.gen)

    def load_best(self) -> bool:
        restored = self.ckpt.restore_best()
        if restored is not None:
            self.restore_payload(restored)
        return restored is not None

    def generate_wav(self, load_pre_train: bool = True,
                     data_path: Optional[str] = None,
                     out_dir: Optional[str] = None,
                     compare_after: bool = False) -> float:
        """Enhance every wav of ``data_path`` (default: the noisy test set)
        into ``out_dir``; returns the real-time factor.  With
        ``compare_after``, score the output against the clean test set."""
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
