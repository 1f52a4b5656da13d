#!/usr/bin/env python3
"""Carry a checkpoint of the JAX package's ``ComplexDDPMTrainer`` (or of its
``ComplexTrainer`` or ``MagTrainer``) into the PyTorch port.

    python3 tools/jax_ckpt_to_torch.py JAX_DIR TORCH_DIR [--epoch best|latest|N]
        [--model NAME]

``JAX_DIR`` is a JAX trainer's checkpoint directory (``<assets>/checkpoint/
<doc>``, written by ``prior_diffuse_tpu/training/checkpoint.py``): its
``best/`` checkpoint (the default), or ``epochs/<N>/`` (``latest``: the
newest).  ``TORCH_DIR`` receives the port's ``best.pt`` or
``epochs/<N>.pt`` (``prior_diffuse_tpu_torch/training/checkpoint.py``),
which the port's trainer restores with ``load_best`` / ``--generate`` or
``--retrain`` when its checkpoint directory is ``TORCH_DIR``.

The script runs where the JAX package runs (it needs orbax; the port
itself imports neither).  It restores the checkpoint without a template
(orbax hands the optax states back as plain dicts and lists), picks the
denoiser from the tree (no ``preprocess``: the deltamu mode's ``Nocon``;
else ``DiffUNet1`` with the preprocess's conditioner width), or for a
trainer of one net (``{"model", "opt"}``: ``ComplexTrainer``,
``MagTrainer``) the prior that ``--model`` names (the yml's
``model.name``, e.g. ``GCRN`` or ``GRN``), and converts,
through ``prior_diffuse_tpu_torch/convert.py::payload_from_jax``, both
nets' parameters and BatchNorm statistics, both Adam states (moments,
count, learning rate and L2), the step and the plateau state, checking
every leaf's shape.  The JAX PRNG key has no torch counterpart: it is not
carried, and the port's trainer seeds its generator from its own
``--seed`` when it restores the result.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def restore_jax(jax_dir: str, epoch: str):
    """``(payload, label)`` of the JAX checkpoint, restored without a
    template into numpy arrays in dicts and lists."""
    import orbax.checkpoint as ocp

    jax_dir = os.path.abspath(jax_dir)
    if epoch == "best":
        path = os.path.join(jax_dir, "best")
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no best checkpoint under {jax_dir}")
        return ocp.StandardCheckpointer().restore(path), "best"
    mgr = ocp.CheckpointManager(os.path.join(jax_dir, "epochs"))
    try:
        n = mgr.latest_step() if epoch == "latest" else int(epoch)
        if n is None or n not in mgr.all_steps():
            raise FileNotFoundError(f"no epoch {epoch} under {jax_dir}/epochs "
                                    f"(found {list(mgr.all_steps())})")
        return mgr.restore(n, args=ocp.args.StandardRestore()), n
    finally:
        mgr.close()


def port_layout(payload, model=None):
    """The port trainer's nets and optimizers whose layout the JAX tree
    has: ``Nocon`` (deltamu) without a preprocess, else ``DiffUNet1``; for
    a one-net trainer's tree the model named ``model``."""
    from prior_diffuse_tpu_torch.training.complex_trainer import seeded_model
    from prior_diffuse_tpu_torch.training.ddpm_trainer import seeded_nets
    from prior_diffuse_tpu_torch.training.optim import torch_adam

    if "model" in payload["state"]:
        if model is None:
            raise ValueError("a ComplexTrainer or MagTrainer checkpoint: name its model "
                             "with --model")
        net = seeded_model(0, model)
        return {"model": net}, {"opt": torch_adam(net.parameters(), 1e-3)}
    pre = payload["state"]["ddpm"]["params"].get("preprocess")
    cond = 2 if pre is None else np.asarray(pre["kernel"]).shape[2] - 2  # [1, 1, 2 + c, 2]
    dis, ddpm = seeded_nets(0, 50, cond, "deltamu" if pre is None else "pirorgrad")
    nets = {"dis": dis, "ddpm": ddpm}
    opts = {f"opt_{n}": torch_adam(m.parameters(), 1e-3) for n, m in nets.items()}
    return nets, opts


def convert(jax_dir: str, torch_dir: str, epoch: str = "best", model=None) -> str:
    """Convert one checkpoint; returns the path written."""
    from prior_diffuse_tpu_torch.convert import payload_from_jax
    from prior_diffuse_tpu_torch.training.checkpoint import CheckpointStore

    payload, label = restore_jax(jax_dir, epoch)
    nets, opts = port_layout(payload, model)
    out = payload_from_jax(payload, nets, opts)
    store = CheckpointStore(torch_dir, max_to_keep=None)
    if label == "best":
        store.save_best(out)
        path = os.path.join(store.directory, "best.pt")
    else:
        store.save_epoch(label, out)
        path = os.path.join(store.directory, "epochs", f"{label}.pt")
    meta = out["meta"]
    what = " + ".join(type(n).__name__ for n in nets.values())
    lrs = " / ".join(f"{out['state'][o]['param_groups'][0]['lr']:g}" for o in opts)
    print(f"{jax_dir} ({label}) -> {path}: {what}, step {meta['step']}, lr {lrs}, plateau best "
          f"{meta['plateau_best']:g}, {meta['plateau_bad']} bad epoch(s). The JAX PRNG key "
          f"is not carried (no torch counterpart): the port's trainer seeds its generator "
          f"from its --seed.", flush=True)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jax_dir", help="the JAX trainer's checkpoint directory")
    p.add_argument("torch_dir", help="the port's checkpoint directory to write")
    p.add_argument("--epoch", default="best", help="best (default), latest, or an epoch")
    p.add_argument("--model", default=None,
                   help="the model of a ComplexTrainer or MagTrainer checkpoint")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    convert(a.jax_dir, a.torch_dir, a.epoch, a.model)


if __name__ == "__main__":
    main()
