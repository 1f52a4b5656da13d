#!/usr/bin/env python3
"""How far rounding alone moves the data-parallel slice's train step (a CPU
probe; the port and ``chip_smoke.py`` do not use it).  It imports both
packages and the tests' helpers, so it runs where JAX runs, on the CPU:

    python3 tools/dp_probe.py

On the inputs of ``tests/test_torch_dp_trainer.py`` (``ComplexDDPMTrainer``
``--joint --sigma``, a ragged global batch of 3 x 4800 padded to 4, JAX's
initial state and q-sample draws) it takes one step:

* in JAX on ``make_mesh(dp=2)`` (the reference) and on ``make_mesh(dp=1)``
  with the pad row given explicitly: the same arithmetic partitioned
  another way;
* in the port in one process on the padded batch, and again with the clean
  batch times ``1 + 1e-7 N(0, 1)`` (two draws);
* in the port on two gloo ranks (this script, ``rank`` mode).

and prints, for each against JAX's ``dp=2`` step and the port's variants
against its one-process step, the three group gradient norms furthest
apart (relative), and each net's update over the elements whose JAX
gradient is at least 1e-6 and whose two updates have the same sign
(relative L2).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402


def rank_main(rank: int, tmp: str) -> None:
    """One of the two gloo ranks: the step on its rows; rank 0 saves it."""
    from prior_diffuse_tpu_torch.diffusion.qsample import Draws
    from prior_diffuse_tpu_torch.parallel import distributed
    from prior_diffuse_tpu_torch.parallel.mesh import DataParallel
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
    from test_torch_dp_worker import configs

    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", rank=rank, world_size=2,
                           init_method=f"file://{tmp}/pg", device="cpu")
    try:
        inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=True)
        dp = DataParallel("cpu")
        tr = ComplexDDPMTrainer(*configs(inp), device="cpu", parallel=dp)
        for name, sd in inp["weights"].items():
            tr.nets[name].load_state_dict(sd)
        draws = Draws(*(None if d is None else dp.shard_rows(d) for d in inp["draws"]))
        out = tr._train_step(*tr.put_batch(*inp["batch"]), draws=draws)
        if rank == 0:
            torch.save(record(tr, out), os.path.join(tmp, "out.pt"))
    finally:
        torch.distributed.destroy_process_group()


def record(tr, out) -> dict:
    """The group norms and the nets' flax parameter trees after a step."""
    from prior_diffuse_tpu_torch.convert import state_dict_to_flax

    return {"gnorms": {k: float(v) for k, v in out[3].items()},
            "params": {n: state_dict_to_flax(m, m.state_dict())["params"]
                       for n, m in tr.nets.items()}}


def main() -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2").strip()
    import jax
    import numpy as np

    import prior_diffuse_tpu.config as jcfg
    from prior_diffuse_tpu.data import synthetic
    from prior_diffuse_tpu.parallel.mesh import make_mesh
    from prior_diffuse_tpu.training import ComplexDDPMTrainer as JTrainer
    from prior_diffuse_tpu_torch.convert import flax_to_state_dict
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
    from test_torch_dp_trainer import CHUNK, LR_DDPM, LR_DIS, _batch, _ddpm_inp
    from test_torch_dp_worker import configs
    from test_torch_train_step import _flat, _jax_draws, _jax_grad, _np

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        from pathlib import Path

        tmp = Path(tmp)
        corpus = synthetic.write_corpus(str(tmp / "corpus"), n_train=4, n_test=3,
                                        min_len=6000, max_len=9000, seed=5)
        inp = _ddpm_inp(corpus, tmp)
        jexp = jcfg.ExperimentConfig(
            train=jcfg.TrainConfig(**inp["train"]), optim=jcfg.OptimConfig(lr=LR_DIS),
            optim_ddpm=jcfg.OptimConfig(lr=LR_DDPM), diffusion=jcfg.DiffusionConfig())
        batch = _batch(corpus, 3, CHUNK)
        padded = [torch.cat([a, torch.zeros_like(a[:1])]) for a in batch]
        rng = jax.random.PRNGKey(11)
        res, grads = {}, None
        for dp in (2, 1):
            jtr = JTrainer(jcfg.RunConfig(assets=str(tmp / f"jax{dp}"), doc="t",
                                          data_root=corpus, joint=True, sigma=True),
                           jexp, mesh=make_mesh(dp=dp))
            state0 = {k: _np(jtr.state[k]) for k in ("dis", "ddpm")}
            arrays = jtr.put_batch(*(a.numpy() for a in (batch if dp == 2 else padded)))
            jstate, _, _, _, gnorms = jtr._train_step(jtr.state, *arrays, rng)
            res["JAX dp=2" if dp == 2 else "JAX dp=1, padded"] = {
                "gnorms": {k: float(v) for k, v in gnorms.items()},
                "params": {n: _np(jstate[n]["params"]) for n in ("dis", "ddpm")}}
            if dp == 2:
                grads = {n: _jax_grad(jstate["opt_" + n]) for n in ("dis", "ddpm")}
        draws = _jax_draws(rng, jexp.diffusion, (4, CHUNK // 160 + 1, 161, 2))
        for label, seed in (("port, one process", None), ("port, clean x (1 + 1e-7 N) #1", 1),
                            ("port, clean x (1 + 1e-7 N) #2", 2)):
            tr = ComplexDDPMTrainer(*configs(inp), device="cpu")
            for n in tr.nets:
                tr.nets[n].load_state_dict(flax_to_state_dict(tr.nets[n], state0[n]))
            arrays = list(padded)
            if seed is not None:
                g = torch.Generator().manual_seed(seed)
                arrays[1] = arrays[1] * (1 + 1e-7 * torch.randn(arrays[1].shape, generator=g))
            res[label] = record(tr, tr._train_step(*arrays, draws=draws))
        inp.update(weights={n: flax_to_state_dict(tr.nets[n], state0[n]) for n in tr.nets},
                   batch=batch, draws=tuple(draws))
        torch.save(inp, tmp / "in.pt")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "rank", str(r),
                                   str(tmp)]) for r in range(2)]
        for p in procs:
            if p.wait(timeout=600) != 0:
                raise SystemExit(f"a rank exited {p.returncode}")
        res["port, 2 gloo ranks"] = torch.load(tmp / "out.pt", weights_only=False)

    old = {n: _flat(state0[n]["params"]) for n in ("dis", "ddpm")}

    def distance(got, ref, ref_name):
        worst = sorted(((abs(got["gnorms"][k] - v) / abs(v), k)
                        for k, v in ref["gnorms"].items()), reverse=True)[:3]
        line = f"{ref_name}: group norms " + ", ".join(f"{k} {r:.2e}" for r, k in worst)
        for n in ("dis", "ddpm"):
            d_got = _flat(got["params"][n]) - old[n]
            d_ref = _flat(ref["params"][n]) - old[n]
            steady = np.abs(grads[n]) >= 1e-6
            same = steady & (np.sign(d_got) == np.sign(d_ref))
            l2 = np.linalg.norm(d_got[same] - d_ref[same]) / np.linalg.norm(d_ref[same])
            line += f"; {n} same-sign updates {l2:.2e}"
        return line

    for label, got in res.items():
        print(f"{label:32s} vs {distance(got, res['JAX dp=2'], 'JAX dp=2')}")
    for label in ("port, 2 gloo ranks", "port, clean x (1 + 1e-7 N) #1",
                  "port, clean x (1 + 1e-7 N) #2"):
        print(f"{label:32s} vs {distance(res[label], res['port, one process'], 'one process')}")
    net_max = {n: max(v for k, v in res["JAX dp=2"]["gnorms"].items() if k.startswith(f"gn_{n}/"))
               for n in ("dis", "ddpm")}
    print(f"largest group norm a net (JAX dp=2): {net_max}; gn_ddpm/preprocess/bias "
          f"{res['JAX dp=2']['gnorms']['gn_ddpm/preprocess/bias']:.4e}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        main()
