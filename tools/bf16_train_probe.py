#!/usr/bin/env python3
"""How far the port's bf16 training sits from the JAX package's, against
how far the JAX package's own two runs of it sit apart (CPU, both packages).

    python3 tools/bf16_train_probe.py forward [NAME ...]
    python3 tools/bf16_train_probe.py step [CASE ...]
    python3 tools/bf16_train_probe.py card          (on the H100)

bf16 arithmetic is noisy at 2^-9 a rounding, and train-mode BatchNorm over
a small batch amplifies it, so a bound for the port is only meaningful
beside the spread of the reference itself: JAX's jitted run against the
same run op by op (``jax.disable_jit``: every op rounded to its dtype, as
the port rounds them).  The bounds of ``tests/test_torch_bf16_train*.py``
come from these tables (ROADMAP Queue 3).

``forward``: each model (``DiffUNet``, ``DiffUNet1``, ``Nocon``, ``GCRN``,
the four DB-AIAT variants, ``GRN``) at ``dtype=bfloat16`` on the perturbed
float32 variables of ``tests/test_torch_priors.py`` (B = 2, T = 12), in
train mode (``mutable=["batch_stats"]``) and eval mode: relative RMS of the
port's ``models/precision.py::compute_view`` against JAX's jitted and
op-by-op forwards, of those two against each other, and of JAX's bf16
against its f32 forward; in train mode also the largest relative L2 of a
new BatchNorm statistic (port vs jitted JAX).

``step``: one bf16 train step (``train.compute_dtype: bfloat16``) of a
trainer from one state on one batch (B = 2, 1600 samples: 11 frames), the
port's against JAX's jitted ``_train_step``, and JAX's own spread: its
op-by-op ``_train_step_impl`` and its jitted step on the batch times ``1 +
1e-7 N(0, 1)`` (two seeds) against the jitted one: losses, the worst group
gradient norms, BN statistics (relative L2 over all of a net's), Adam's
updates (the largest over ``lr``, the relative L2 over the elements of the
same gradient sign), the share of the gradient's norm whose sign flips,
and the gradient's relative L2.
Cases: ``ddpm-DiffUNet`` (the DDPM trainer, ``--joint --sigma``, the dual
train forward of both nets), ``ddpm-GCRN`` (a GCRN prior), ``complex-GCRN``,
``complex-aia_complex_trans_ri`` (``ComplexTrainer``), ``mag-GRN``
(``MagTrainer``).  A JAX DDPM step takes a few minutes to compile on the
CPU and its op-by-op run a few more.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1600
CASES = ("ddpm-DiffUNet", "ddpm-GCRN", "complex-GCRN", "complex-aia_complex_trans_ri",
         "mag-GRN")
MODELS = ("DiffUNet", "DiffUNet1", "Nocon", "GCRN", "aia_complex_trans_ri",
          "aia_complex_trans_mag", "dual_aia_complex_trans", "dual_aia_trans_merge_crm", "GRN")


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def forward(name: str) -> None:
    """``forward``'s rows for the model ``name``."""
    import jax
    import jax.numpy as jnp
    import torch

    from test_torch_bf16_train import make_model
    from prior_diffuse_tpu_torch.convert import state_dict_to_flax
    from prior_diffuse_tpu_torch.models.precision import compute_view

    jm, jm32, variables, tm, args = make_model(name)
    targs = [torch.from_numpy(a) for a in args]
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    for train in (True, False):
        def apply(module, v, *a):
            out = module.apply(v, *a, train=train, mutable=["batch_stats"] if train else False)
            return out if train else (out, None)

        jargs = [jnp.asarray(a) for a in args]
        jit, stats = jax.jit(lambda v, *a: apply(jm, v, *a))(variables, *jargs)
        with jax.disable_jit():
            eager = apply(jm, variables, *jargs)[0]
        exact = apply(jm32, variables, *jargs)[0]
        tm.load_state_dict(make_model(name)[3].state_dict())
        view = compute_view(tm, torch.bfloat16).train(train)
        with torch.no_grad():
            port = view(*targs).float().numpy()
        row = (f"{name} {'train' if train else 'eval '}: port_vs_jit "
               f"{rel_rms(port, f32(jit)):.3e}, port_vs_op_by_op {rel_rms(port, f32(eager)):.3e}, "
               f"jit_vs_op_by_op {rel_rms(f32(jit), f32(eager)):.3e}, "
               f"jax_bf16_vs_f32 {rel_rms(f32(jit), f32(exact)):.3e}")
        if train and stats is not None and jax.tree.leaves(stats):
            got = jax.tree.leaves(state_dict_to_flax(tm, tm.state_dict())["batch_stats"])
            worst = max(rel_l2(g, w) for g, w in zip(got, jax.tree.leaves(stats)))
            row += f", bn_stats {worst:.3e}"
        print(row, flush=True)


def step(case: str) -> None:
    """``step``'s rows for ``case``."""
    from test_torch_bf16_train_step import step_pair, step_report

    with tempfile.TemporaryDirectory() as tmp:
        pair = step_pair(case, tmp)
        runs = [("port_vs_jit", pair["got"]), ("op_by_op_vs_jit", pair["eager"]())]
        runs += [(f"input_x_1e-7_vs_jit (seed {i})", pair["perturbed"](i)) for i in (1, 2)]
        for label, run in runs:
            rep = step_report(pair, run)
            print(f"{case} {label}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in rep.items()),
                flush=True)


def card() -> None:
    """``card``'s measurements."""
    import copy

    import torch

    import chip_smoke as cs
    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.models.grn import GRN
    from prior_diffuse_tpu_torch.ops import build
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    failed = []
    cs.fail = lambda msg: (failed.append(msg), print(f"CHECK FAILED: {msg}", flush=True))
    card_line = cs.card_line()
    print(f"card: {card_line}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    build.build()
    build.library()
    device = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as root:
        corpus = cs.write_train_corpus(root)
        exp = cs.bf16_exp(load_experiment(os.path.join(ROOT, "conf", "diff.yml")))
        run = RunConfig(seed=7, joint=True, sigma=True, data_root=corpus,
                        assets=os.path.join(root, "probe"))
        tr = ComplexDDPMTrainer(run, exp, device=device)
        b = next(iter(tr.tr_loader))
        batch = tr.put_batch(b.noisy, b.clean, b.frame_nums)
        snap = copy.deepcopy(tr.ckpt_payload())
        ref = cs.one_step(tr, batch, plain=True)
        for defect in ("symmetric Hann window", 1e-3, 1e-2, 5e-2):
            tr.restore_payload(copy.deepcopy(snap))
            with cs.k1_defect(defect):
                got = cs.one_step(tr, batch)
            dist = cs.step_distance(tr, got, ref)
            print(f"bf16 DDPM step, K1 with the window defect {defect!r} vs the plain STFT: "
                  f"losses {dist['loss']:.3e}, gradients " + ", ".join(
                      f"{n} {dist[n]:.3e}" for n in tr.nets), flush=True)
        del tr
        priors = cs.prior_nets(device)
        priors["GRN"] = cs.seeded_nets(60, device, (GRN,))[0]
        cs.bf16_train_phase(device, card_line, root, corpus, priors)
    if failed:
        raise SystemExit(f"{len(failed)} check(s) failed: {failed}")


def main(argv=None) -> None:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    args = list(argv if argv is not None else sys.argv[1:])
    mode = args.pop(0) if args else "forward"
    if mode == "card":
        card()
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    if mode == "forward":
        for name in args or MODELS:
            forward(name)
    elif mode == "step":
        for case in args or CASES:
            step(case)
    else:
        raise SystemExit(f"unknown mode {mode!r}: forward, step or card")


if __name__ == "__main__":
    main()
