"""One rank of a data-parallel group, for the port's data-parallel tests.

    python tests/test_torch_dp_worker.py TASK RANK WORLD DIR

joins a gloo group of WORLD processes through ``file://DIR/pg``, runs TASK
on the inputs ``torch.load(DIR/in.pt)`` and writes ``DIR/out_<RANK>.pt``.
It imports torch and the port only; ``tests/test_torch_parallel.py`` and
``tests/test_torch_dp_trainer.py`` start it through :func:`launch` and hold
its results to JAX's and to the port's own single-process results.  It
holds no tests.
"""

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bn(inp, dp):
    """Train-mode BatchNorm1d/2d on this rank's rows of each global ``x``,
    the VJP of the global cotangent's rows; the weight and bias gradients
    summed over the ranks (as a trainer sums them)."""
    from prior_diffuse_tpu_torch.models import layers as tl

    out = {}
    for name, case in inp["bn"].items():
        x = dp.shard_rows(case["x"]).movedim(-1, 1).requires_grad_(True)
        bn = (tl.BatchNorm1d if x.ndim == 3 else tl.BatchNorm2d)(x.shape[1])
        with torch.no_grad():
            for key in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, key).copy_(case[key])
        bn.train()
        with dp:
            y = bn(x)
            y.backward(dp.shard_rows(case["cot"]).movedim(-1, 1))
        dp.sum_grads(bn.parameters())
        out[name] = {"y": y.detach().movedim(1, -1), "dx": x.grad.movedim(1, -1),
                     "dw": bn.weight.grad, "db": bn.bias.grad,
                     "running_mean": bn.running_mean, "running_var": bn.running_var}
    return out


def _losses(inp, dp):
    """Each masked loss on this rank's rows, and its global value."""
    from prior_diffuse_tpu_torch import losses

    args = {k: dp.shard_rows(v) for k, v in inp["loss_args"].items()}
    out = {}
    with dp:
        for name in ("mag_mse_loss", "mag_mae_loss", "com_mse_loss", "com_mag_mse_loss"):
            kind = "mag" if name.startswith("mag") else "com"
            out[name] = losses.LOSSES[name](args[f"{kind}_e"], args[f"{kind}_l"], args["frames"])
        out["com_mse_sigma_loss"] = losses.com_mse_sigma_loss(
            args["com_e"], args["com_l"], args["frames"], args["sigma"])
        share = {k: v.clone() for k, v in out.items()}
        total = dict(zip(out, dp.sum_scalars(*out.values())))
    return {"share": share, "total": total}


def configs(inp):
    """The ``RunConfig`` and ``ExperimentConfig`` of ``inp``: a yml
    (``config``) with ``train`` overrides, or the sections' fields."""
    import dataclasses

    from prior_diffuse_tpu_torch import config as tcfg

    run = tcfg.RunConfig(**inp["run"])
    if "config" in inp:
        exp = tcfg.load_experiment(inp["config"])
        return run, dataclasses.replace(exp, train=dataclasses.replace(exp.train, **inp["train"]))
    return run, tcfg.ExperimentConfig(
        train=tcfg.TrainConfig(**inp["train"]), optim=tcfg.OptimConfig(**inp["optim"]),
        optim_ddpm=tcfg.OptimConfig(**inp["optim_ddpm"]),
        diffusion=tcfg.DiffusionConfig(**inp["diffusion"]))


def step_record(tr, out) -> dict:
    """A train step's losses and group norms, and the nets' gradients and
    state after it."""
    *losses, gnorms = out
    return {"losses": [float(v) for v in losses],
            "gnorms": {k: float(v) for k, v in gnorms.items()},
            "grad": {n: {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                         for k, p in m.named_parameters()} for n, m in tr.nets.items()},
            "state": _state(tr)}


def _state(tr):
    return {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in tr.nets.items()}


def _ddpm(inp, dp):
    """``ComplexDDPMTrainer`` on this rank's rows: ``enhance_files`` with
    the seeded weights, then the given weights, one step with the global
    draws' rows, the eval step with the global ``x_T``'s rows and one
    ``evaluate()`` with the draws replaced by them."""
    import io
    import json
    from unittest import mock

    from prior_diffuse_tpu_torch.diffusion.qsample import Draws
    from prior_diffuse_tpu_torch.serving.enhance import enhance_files
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    run, exp = configs(inp)
    tr = ComplexDDPMTrainer(run, exp, device="cpu", parallel=dp)
    served = enhance_files(tr, [w.numpy() for w in inp["wavs"]],
                           torch.Generator().manual_seed(inp["serve_seed"]), batch_size=2)
    for name, sd in inp["weights"].items():
        tr.nets[name].load_state_dict(sd)
    draws = Draws(*(None if d is None else dp.shard_rows(d) for d in inp["draws"]))
    noisy, clean, frames = tr.put_batch(*inp["batch"])
    rec = step_record(tr, tr._train_step(noisy, clean, frames, draws=draws))

    noisy, clean, frames = tr.put_batch(*inp["cv_batch"])
    x_T = inp["x_T"][:, dp.rank * noisy.shape[0]:(dp.rank + 1) * noisy.shape[0]]
    audio, label, loss, diag = tr._eval_step(noisy, clean, frames, x_T=x_T)
    # what the metrics logger writes (rank 0 alone opens its file)
    if tr.metrics._file is not None:
        tr.metrics._file.close()
        tr.metrics._file = io.StringIO()
    with mock.patch.object(tr.enhancer, "_draws", lambda shape, gen, x: (None, x_T)):
        cv_loss = tr.evaluate()
    records = ([] if tr.metrics._file is None else
               [{k: v for k, v in json.loads(line).items() if k not in ("time", "step")}
                for line in tr.metrics._file.getvalue().splitlines()])
    return {"step": rec, "served": [torch.from_numpy(w) for w in served], "eval_step": {
        "audio": audio, "label": label, "loss": float(loss),
        "diag": {k: float(v) for k, v in diag.items()}},
        "cv_loss": cv_loss, "records": records}


def _prior(inp, dp):
    """``ComplexTrainer`` (GCRN) and ``MagTrainer`` (GRN) on this rank's
    rows of the global batch: two steps each; the first's record, the state
    after the second."""
    from prior_diffuse_tpu_torch.training.complex_trainer import ComplexTrainer
    from prior_diffuse_tpu_torch.training.mag_trainer import MagTrainer

    out = {}
    for name, case in inp["priors"].items():
        cls = MagTrainer if name == "MagTrainer" else ComplexTrainer
        tr = cls(*configs(case), device="cpu", parallel=dp)
        batch = tr.put_batch(*case["batch"])
        out[name] = {"step": step_record(tr, tr._train_step(*batch))}
        tr._train_step(*batch)
        out[name]["state"] = _state(tr)
    return out


TASKS = {"bn": _bn, "losses": _losses, "ddpm": _ddpm, "prior": _prior}


def launch(task: str, world: int, tmp: str, inp: dict, timeout: float = 120.0) -> list:
    """Run ``task`` on ``world`` ranks of this script, each in a process of
    its own, all within ``timeout`` seconds (then every rank is killed and
    the call fails); returns their outputs by rank."""
    import subprocess

    torch.save(inp, os.path.join(tmp, "in.pt"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, *sys.path])}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), task, str(r),
                               str(world), tmp], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} of {world} exited {p.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=True)
            for r in range(world)]


def main(task: str, rank: int, world: int, tmp: str) -> None:
    from prior_diffuse_tpu_torch.parallel import distributed
    from prior_diffuse_tpu_torch.parallel.mesh import DataParallel

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", rank=rank, world_size=world,
                           init_method=f"file://{os.path.join(tmp, 'pg')}", device="cpu")
    try:
        inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=True)
        out = {}
        for name in task.split(","):
            out[name] = TASKS[name](inp, DataParallel("cpu"))
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
