"""What the training and serving drivers share: the device, the corpus
directory and the experiment of the speech-like demo, and its trainer.

The JAX package's drivers build the same ``ExperimentConfig`` in each
script (``scripts/train_demo.py:171-189``, ``eval_schedules.py:134-146``,
``diagnose_ddpm.py:59-66``, ``probe_predictability.py:75-82``): a
``DiffUNet`` prior, ``com_mse_loss``, one epoch, and the run's own batch,
chunk, learning rates and diffusion extensions.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

from prior_diffuse_tpu_torch.config import (DiffusionConfig, ExperimentConfig, ModelConfig,
                                            OptimConfig, RunConfig, TrainConfig)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device (default: the card; there is no fallback "
                         "to the CPU)")


def approx_pesq() -> None:
    """Score PESQ with the in-repo approximation where the P.862 binding is
    absent, as the JAX drivers do; every report names the regime."""
    os.environ.setdefault("PDT_APPROX_PESQ", "1")


def device(name: str) -> torch.device:
    """``name`` as a torch device; ``cuda`` without a card raises before any
    file is written."""
    from prior_diffuse_tpu_torch.serving.enhancer import serving_device

    return serving_device(name)


@contextlib.contextmanager
def logging_to(log_dir: str):
    """The package's logging (``utils/logging.py::setup_logging``) into
    ``<log_dir>/stdout.txt`` while the block runs; the handlers it added
    are closed after it, so a second run in one process logs to its own
    directory only."""
    from prior_diffuse_tpu_torch.utils.logging import setup_logging

    root = logging.getLogger()
    before = list(root.handlers)
    setup_logging(log_dir)
    try:
        yield
    finally:
        for h in [h for h in root.handlers if h not in before]:
            root.removeHandler(h)
            h.close()


def corpus_dir(assets: str) -> str:
    return os.path.join(assets, "data")


def experiment(batch: int, chunk: int = 48000, lr: float = 5e-4, lr_ddpm: float = 2e-4,
               lam: float = 1.0, bf16: bool = False,
               diffusion: DiffusionConfig = DiffusionConfig()) -> ExperimentConfig:
    """The demo's experiment: ``DiffUNet`` prior, the mode's denoiser, one
    epoch of ``batch`` x ``chunk``, Adam at ``lr`` / ``lr_ddpm``, float32 or
    (``bf16``) bf16 compute."""
    return ExperimentConfig(
        train=TrainConfig(batch_size=batch, n_epochs=1, loss="com_mse_loss",
                          chunk_length=chunk, lam=lam,
                          compute_dtype="bfloat16" if bf16 else "float32"),
        model=ModelConfig("DiffUNet"),
        optim=OptimConfig(lr=lr),
        optim_ddpm=OptimConfig(lr=lr_ddpm),
        diffusion=diffusion)


def trainer(assets: str, doc: str, exp: ExperimentConfig, dev, joint: bool,
            sigma: bool, data_root: str = None, seed: int = 1234):
    """A ``ComplexDDPMTrainer`` on ``<assets>/{log,checkpoint,wav}/<doc>``
    and the corpus under ``<assets>/data`` (or ``data_root``), its nets,
    crops and draws from ``seed``, resumed from the latest checkpoint there
    if one exists (``--retrain``)."""
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    run = RunConfig(seed=seed, assets=assets, doc=doc,
                    data_root=data_root or corpus_dir(assets), joint=joint, retrain=True,
                    sigma=sigma)
    return ComplexDDPMTrainer(run, exp, device=dev)
