"""Command-line entry point.

The counterpart of ``prior_diffuse_tpu/cli.py`` (reference ``main.py:20-41``):

    python -m prior_diffuse_tpu_torch.cli --trainer ComplexDDPMTrainer \\
        --config conf/diff.yml [--joint] [--sigma] [--retrain] [--eval] [--generate] \\
        [--draw] [--profile-steps N] [--wandb]
    python -m prior_diffuse_tpu_torch.cli --trainer ComplexTrainer \\
        --config conf/gcrn.yml [--retrain] [--generate]     (or conf/dbaiat.yml)
    python -m prior_diffuse_tpu_torch.cli --trainer MagTrainer \\
        --config conf/grn.yml [--retrain] [--generate]

with assets under ``<assets>/{log,checkpoint,wav}/<doc>`` and data under
``--data-root`` (``{noisy,clean}_{trainset,testset}_wav``).  ``--device``
names the torch device (``cuda`` by default; there is no fallback).  A
yml whose ``train:`` section sets ``compute_dtype: bfloat16`` trains,
evaluates and generates in bf16 compute with any of the three trainers.
As in the JAX CLI, ``ComplexDDPMTrainer`` takes ``--draw`` (score one cv
batch and plot each utterance's spectrograms under ``<wav dir>/draw``
instead of training) and ``--profile-steps N`` (a ``torch.profiler``
trace of the first N train steps under ``<log dir>/trace``); the other
trainers ignore both.  ``--wandb`` mirrors the metrics to wandb, or warns
and goes on where wandb is not installed.

Data parallelism: under ``torch.distributed.run`` each process joins the
group (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and trains,
evaluates or generates on its rows of each global batch of ``batch_size``
(``training/base.py``); rank 0 writes the log, metrics, checkpoints and
wavs::

    python -m torch.distributed.run --nproc_per_node=N -m prior_diffuse_tpu_torch.cli ...

A process started without that environment runs alone, as before.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import torch.distributed as dist

from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
from prior_diffuse_tpu_torch.parallel import distributed
from prior_diffuse_tpu_torch.parallel.mesh import DataParallel
from prior_diffuse_tpu_torch.utils.logging import MetricsLogger, setup_logging

TRAINERS = ("ComplexDDPMTrainer", "ComplexTrainer", "MagTrainer")


def parse_args(argv=None):
    """-> ``(RunConfig, use_wandb, verbose, device)``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=1234, help="Random seed")
    p.add_argument("--trainer", type=str, default="ComplexDDPMTrainer",
                   help=f"One of: {', '.join(TRAINERS)}")
    p.add_argument("--config", type=str, default="conf/diff.yml",
                   help="Path to the experiment YAML")
    p.add_argument("--verbose", type=str, default="info")
    p.add_argument("--doc", type=str, default="diff")
    p.add_argument("--assets", type=str, default="assets_dpm")
    p.add_argument("--data-root", type=str, default="data")
    p.add_argument("--device", type=str, default="cuda", help="torch device")
    p.add_argument("--generate", action="store_true", help="Run enhancement")
    p.add_argument("--retrain", action="store_true", help="Resume from checkpoint")
    p.add_argument("--joint", action="store_true", help="Joint dis+DDPM training")
    p.add_argument("--eval", action="store_true", help="Evaluation only")
    p.add_argument("--sigma", action="store_true", help="PriorGrad sigma conditioning")
    p.add_argument("--noisy", action="store_true")
    p.add_argument("--draw", action="store_true", help="Eval/plot from best checkpoint")
    p.add_argument("--wandb", action="store_true", help="Mirror metrics to wandb")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="Trace the first N train steps")
    a = p.parse_args(argv)
    run = RunConfig(
        seed=a.seed, trainer=a.trainer, config=a.config, doc=a.doc,
        assets=a.assets, generate=a.generate, retrain=a.retrain,
        joint=a.joint, eval=a.eval, sigma=a.sigma, noisy=a.noisy,
        draw=a.draw, profile_steps=a.profile_steps, data_root=a.data_root,
    )
    return run, a.wandb, a.verbose, a.device


def main(argv=None):
    run, use_wandb, verbose, device = parse_args(argv)
    device = distributed.local_device(device)
    parallel = DataParallel(device) if distributed.initialize(device=device) else None
    try:
        setup_logging(run.log_dir, verbose)
        if parallel is not None:
            logging.info("process group: rank %d of %d, backend %s, device %s", parallel.rank,
                         parallel.world, dist.get_backend(), device)
        _run(run, use_wandb, device, parallel)
    finally:
        if parallel is not None:
            dist.destroy_process_group()


def _run(run: RunConfig, use_wandb: bool, device, parallel) -> None:
    if run.trainer not in TRAINERS:
        raise KeyError(f"unknown trainer {run.trainer!r}; one of: {', '.join(TRAINERS)}")
    if run.trainer == "ComplexTrainer":
        from prior_diffuse_tpu_torch.training.complex_trainer import ComplexTrainer as trainer_cls
    elif run.trainer == "MagTrainer":
        from prior_diffuse_tpu_torch.training.mag_trainer import MagTrainer as trainer_cls
    else:
        from prior_diffuse_tpu_torch.training.ddpm_trainer import (
            ComplexDDPMTrainer as trainer_cls)

    exp = load_experiment(run.config)
    logging.info("Run = %s", dataclasses.asdict(run))
    logging.info("Experiment = %s", dataclasses.asdict(exp))
    metrics = MetricsLogger(run.log_dir, use_wandb=use_wandb)
    try:
        trainer = trainer_cls(run, exp, device=device, metrics_logger=metrics,
                              parallel=parallel)
        if run.generate:
            trainer.generate_wav(load_pre_train=True)
        else:
            trainer.train_ddpm()
    finally:
        metrics.close()


if __name__ == "__main__":
    main()
