"""Shared trainer scaffolding.

The counterpart of ``prior_diffuse_tpu/training/base.py``: datasets and
loaders, device placement, the NaN guard, eval logging, and the
checkpoint payload with the full training context (nets, optimizers,
step, generator, plateau state).  Host work (wav decode, metric scoring,
checkpointing, LR control) stays in numpy.

A trainer runs on one device, or as one rank of a data-parallel group
(``parallel=parallel.mesh.DataParallel``), the port of JAX's ``dp`` mesh:
``cfg.batch_size`` is the global batch, each rank takes its contiguous
rows of it (zero-padded to a multiple of the ranks, as JAX's
:meth:`TrainerBase.put_batch`), the steps run inside the group (the
:func:`sharded` methods: global BatchNorm statistics, loss denominators and
draws, ``parallel/mesh.py``), the gradients are summed over the ranks
before the optimizer, and rank 0 alone writes metrics and checkpoints and
decides the plateau's halving and stop for every rank.
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from prior_diffuse_tpu_torch.config import ExperimentConfig, RunConfig
from prior_diffuse_tpu_torch.convert import flax_key
from prior_diffuse_tpu_torch.data.dataset import EvalLoader, PairedWavDataset, TrainLoader
from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
from prior_diffuse_tpu_torch.parallel.mesh import DataParallel
from prior_diffuse_tpu_torch.signal.compress import compress_spec, mag_phase
from prior_diffuse_tpu_torch.training.checkpoint import CheckpointStore
from prior_diffuse_tpu_torch.training.plateau import PlateauController
from prior_diffuse_tpu_torch.utils.logging import MetricsLogger


def spec_features(wav: torch.Tensor, cfg) -> torch.Tensor:
    """waveform ``[B, L]`` -> compressed complex spectrum ``[B, T, F, 2]``
    (the STFT is K1 on CUDA tensors; 320/160 framing only)."""
    if (cfg.fft_num, cfg.win_size, cfg.win_shift) != (320, 320, 160):
        raise ValueError("the STFT kernels implement the 320/160 framing only")
    return compress_spec(kstft.stft(wav), cfg.feat_type)


def mag_features(wav: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """waveform ``[B, L]`` -> (compressed magnitude, phase), each ``[B, T,
    161]``: :func:`spec_features` (K1 on CUDA tensors), then its magnitude
    and phase (JAX ``training/base.py:64-68``)."""
    return mag_phase(spec_features(wav, cfg))


def grad_groups(model: torch.nn.Module, depth: int = 2) -> Dict[str, List[torch.nn.Parameter]]:
    """The parameters of ``model`` grouped as the JAX package groups its
    gradient norms: by the first ``depth`` components of their flax path
    (``convert.flax_key``), e.g. ``core/en`` or ``preprocess/kernel``."""
    groups: Dict[str, List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        groups.setdefault("/".join(flax_key(model, name)[1][:depth]), []).append(p)
    return groups


def group_grad_norms(groups: Dict[str, List[torch.nn.Parameter]],
                     prefix: str) -> Dict[str, torch.Tensor]:
    """Per-group global gradient norms (0-d tensors) of :func:`grad_groups`,
    named as in the JAX package: ``gn_<prefix>/<group>``.  A parameter
    without a gradient counts as 0."""
    return {f"gn_{prefix}/{k}": torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
                [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps])))
            for k, ps in groups.items()}


def sharded(method):
    """Run a trainer method inside the trainer's :class:`DataParallel` (its
    collective hooks act), or as it is on one device."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self.parallel is None:
            return method(self, *args, **kwargs)
        with self.parallel:
            return method(self, *args, **kwargs)
    return run


class TrainerBase:
    """Dataset/loader/device/checkpoint plumbing for the trainers.

    A subclass sets ``self.nets`` and ``self.opts`` (name -> module or
    optimizer) and ``self.gen``, the ``torch.Generator`` of its draws, then
    calls :meth:`start`.  With ``parallel``, the trainer is that rank of its
    group, on ``parallel.device`` (``device`` is not used)."""

    def __init__(self, run: RunConfig, exp: ExperimentConfig, device="cuda",
                 metrics_logger: Optional[MetricsLogger] = None,
                 parallel: Optional[DataParallel] = None):
        self.run = run
        self.exp = exp
        self.cfg = exp.train
        self.parallel = parallel
        self.is_main = parallel is None or parallel.is_main
        self.device = parallel.device if parallel is not None else torch.device(device)
        self.metrics = metrics_logger or MetricsLogger(run.log_dir)
        self.ckpt = CheckpointStore(run.checkpoint_dir)
        self.plateau = PlateauController(
            half_lr=exp.optim.half_lr, early_stop=exp.optim.early_stop
        )
        self.epoch = 0
        self.step = 0

        root = run.data_root
        datasets = [
            PairedWavDataset(
                f"{root}/noisy_{split}_wav",
                f"{root}/clean_{split}_wav",
                chunk_length=self.cfg.chunk_length,
                win_size=self.cfg.win_size,
                fft_num=self.cfg.fft_num,
                win_shift=self.cfg.win_shift,
                sample_rate=self.cfg.sample_rate,
            )
            for split in ("trainset", "testset")
        ]
        self.tr_dataset, self.cv_dataset = datasets
        logging.info("Total %d train data.", len(self.tr_dataset))
        logging.info("Total %d eval data.", len(self.cv_dataset))
        shard = (0, 1) if parallel is None else (parallel.rank, parallel.world)
        self.tr_loader = TrainLoader(self.tr_dataset, self.cfg.batch_size, seed=run.seed,
                                     shard=shard)
        self.cv_loader = EvalLoader(self.cv_dataset, self.cfg.batch_size, drop_last=True)

    def check_cv_nonempty(self, losses):
        """Fail loudly when evaluate() saw zero cv batches: the eval loader
        drops the ragged tail (reference parity), so a test split smaller
        than ``batch_size`` yields none."""
        if not losses:
            raise RuntimeError(
                f"evaluate(): no cv batches — test split has "
                f"{len(self.cv_dataset)} utterances < batch_size "
                f"{self.cfg.batch_size} and the eval loader drops the "
                f"ragged tail (reference parity); use a larger test "
                f"set or a smaller batch_size"
            )

    def put_batch(self, *arrays) -> tuple:
        """Host arrays (or tensors) of a global batch onto the trainer's
        device; in a group, this rank's rows of it, zero-padded to a
        multiple of the ranks (JAX ``put_batch``): the pad rows have
        ``frame_nums`` 0, so the losses mask them out, while BatchNorm's
        statistics see them, as JAX's do."""
        if self.parallel is not None:
            arrays = [self.parallel.shard_rows(a) for a in arrays]
        return self.to_device(*arrays)

    def to_device(self, *arrays) -> tuple:
        """Host arrays (or tensors) that are already this rank's rows (a
        ``TrainLoader`` batch) onto the trainer's device."""
        return tuple(torch.as_tensor(a).to(self.device) for a in arrays)

    def gather_rows(self, rows: int, *tensors) -> tuple:
        """Each of ``tensors``, this rank's rows, as the global batch of
        ``rows`` rows on every rank (the pad rows dropped); as they are on
        one device."""
        if self.parallel is None:
            return tensors
        return tuple(self.parallel.gather_rows(t, rows) for t in tensors)

    @sharded
    def serve(self, server, noisy_padded, generator) -> torch.Tensor:
        """``server.enhance_batch`` of a global batch ``[B, L]``: in a group,
        on this rank's rows (JAX's ``enhance_batch`` through ``put_batch``),
        every row returned on every rank."""
        wav, = self.put_batch(noisy_padded)
        return self.gather_rows(len(noisy_padded), server.enhance_batch(wav, generator))[0]

    def start(self) -> None:
        """A subclass's last step of construction, once its nets, optimizers
        and generator exist: rank 0's nets on every rank, then, under
        ``--retrain``, the latest checkpoint and the epoch after it."""
        self.sync_nets()
        if self.run.retrain:
            restored = self.ckpt.restore_latest()
            if restored is not None:
                self.restore_payload(restored)
                last = self.ckpt.latest_epoch()
                self.epoch = 0 if last is None else last + 1
                logging.info("resumed at epoch %d (step %d)", self.epoch, self.step)

    # ---- the group's collectives ------------------------------------------
    def sync_nets(self) -> None:
        """Rank 0's parameters and buffers on every rank (after the nets are
        built and after a restore)."""
        if self.parallel is not None:
            self.parallel.broadcast_modules(self.nets.values())

    def sum_grads(self) -> None:
        """Every gradient summed over the ranks, before the norms and the
        optimizer: each rank's loss is its share of the global loss."""
        if self.parallel is not None:
            self.parallel.sum_grads(p for m in self.nets.values() for p in m.parameters())

    def plateau_update(self, cv_loss: float) -> tuple:
        """The plateau's ``(halve, stop, is_best)`` for ``cv_loss``, rank 0's
        on every rank, so that no rank leaves the epoch loop alone."""
        decision = self.plateau.update(cv_loss)
        return decision if self.parallel is None else self.parallel.broadcast_object(decision)

    def save_checkpoints(self, is_best: bool, cv_loss: float) -> None:
        """The epoch's checkpoint, and the best one if ``is_best``, from rank 0."""
        if not self.is_main:
            return
        payload = self.ckpt_payload()
        if is_best:
            logging.info("new best cv loss %.5f; saving best", cv_loss)
            self.ckpt.save_best(payload)
        self.ckpt.save_epoch(self.epoch, payload)

    # ---- checkpoint payloads ----------------------------------------------
    def ckpt_payload(self) -> dict:
        return {
            "state": {name: obj.state_dict()
                      for name, obj in {**self.nets, **self.opts}.items()},
            "meta": {
                "step": self.step,
                "generator": self.gen.get_state(),
                "plateau_prev": self.plateau.prev_loss,
                "plateau_best": self.plateau.best_loss,
                "plateau_bad": self.plateau.bad_epochs,
            },
        }

    def restore_payload(self, payload) -> None:
        for name, obj in {**self.nets, **self.opts}.items():
            obj.load_state_dict(payload["state"][name])
        meta = payload["meta"]
        self.step = int(meta["step"])
        if meta["generator"] is None:  # a converted JAX checkpoint: no torch state
            self.seed_generator()
        else:
            self.gen.set_state(meta["generator"])
        self.plateau.prev_loss = float(meta["plateau_prev"])
        self.plateau.best_loss = float(meta["plateau_best"])
        self.plateau.bad_epochs = int(meta["plateau_bad"])
        self.sync_nets()

    def seed_generator(self) -> None:
        """Seed ``self.gen`` from the run's seed (salted as the JAX
        package salts its per-step key, ``ddpm_trainer.py``)."""
        self.gen.manual_seed(self.run.seed ^ 0x5EED)

    # ---- epoch-driver helpers --------------------------------------------
    def check_nan(self, loss: float):
        if not np.isfinite(loss):
            raise RuntimeError(f"Detected NaN loss at step {self.step}.")

    def log_eval(self, prefix: str, loss: float, metrics6) -> None:
        from prior_diffuse_tpu_torch.metrics.pesq import pesq_mode

        csig, cbak, covl, pesq, ssnr, stoi = metrics6
        # CSIG/CBAK/COVL are regressions ON PESQ; when no PESQ backend is
        # available the 0.0 substitute deflates them, so every eval record
        # carries the regime that produced these numbers.
        mode = pesq_mode()
        self.metrics.log(
            {
                f"{prefix}_loss": loss,
                f"{prefix}_mean_csig": csig,
                f"{prefix}_mean_cbak": cbak,
                f"{prefix}_mean_covl": covl,
                f"{prefix}_mean_pesq": pesq,
                f"{prefix}_mean_ssnr": ssnr,
                f"{prefix}_mean_stoi": stoi,
                "pesq_mode": mode,
            },
            step=self.step,
        )
        note = "" if mode == "p862" else f" [pesq={mode}]"
        # CSIG/CBAK/COVL clip at the Loizou regression floor of 1.0
        clipped = [n for n, v in [("csig", csig), ("cbak", cbak), ("covl", covl)]
                   if v <= 1.0 + 5e-4]
        if clipped:
            note += f" [at regression floor: {','.join(clipped)}]"
        logging.info(
            "%s: loss %.5f csig %.3f cbak %.3f covl %.3f pesq %.3f ssnr %.3f stoi %.3f%s",
            prefix, loss, csig, cbak, covl, pesq, ssnr, stoi, note,
        )
