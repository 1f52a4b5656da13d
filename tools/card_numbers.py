#!/usr/bin/env python3
"""The times of ``chip_smoke.py``'s paths that no check reads, on one GPU.

    python3 tools/card_numbers.py

``chip_smoke.py`` checks the port's paths; this prints what they cost, for
the same paths, shapes, weights and corpus, each line ending with the
card's name and power limit (``nvidia-smi``).  It holds no check and fails
without a CUDA card.  In ``chip_smoke.py``'s phase order:

3. the serving batch (``Enhancer.enhance_batch``, 8 x 3 s, fast-6) in f32
   and bf16, plain and ``--sigma``: ms a batch (CUDA events, mean of 10
   after 2) and RTF, the plain versions' ms (5 after 1), device ms
   (profiler), kernel launches and the top kernels; each plain batch's
   layer times (STFT, prior, a chain step, the chain, ISTFT);
4. a second call of ``enhance_long`` on the 30 s wav (bf16 enhancer and
   its prior-only server), wall ms; the bf16 enhancer's CUDA graphs: each
   first batch's seconds with its capture at 4-32 rows of 3 s and 16 of
   12 s, and the memory the eight graphs of 3 s hold;
5. ``conf/diff.yml``'s trainer (``--joint --sigma``, 6 x 48000): 10 steps
   (CUDA events, after 2) with utterances/s, peak memory and the host
   clock's median of 5; one step's device ms, launches and top kernels;
   the eval step on a cv batch (3 after 1);
7. the deltamu and conditional batches (f32 and bf16; the plain batch's
   plain-version ms, device ms, launches and top kernels, the ``--sigma``
   batch's ms), and each mode's trainer: 5 timed steps;
8. GCRN and ``aia_complex_trans_ri``: ``ComplexTrainer.enhance_batch``
   (ms, plain-version ms, device ms, launches, top kernels), each prior
   under the DDPM's ``Enhancer`` (as the modes' batches), 5 timed steps of
   ``ComplexTrainer``;
9. GRN with ``MagTrainer`` (its batch and 5 timed steps), DiffWave's
   forward at [2, 48000] (ms, device ms), the bf16 priors'
   ``prior_only_server`` (ms, device ms, launches, top kernels) and bf16
   ``Enhancer`` batches;
10. bf16 training: the floor of each bf16 step check (the step through the
   plain STFT times 1 + 1e-7 N(0, 1), two seeds, against the plain STFT),
   10 timed steps of each dtype in turns (f32, bf16, bf16, f32), each
   step's device ms, launches and top kernels, the bf16 eval step; the
   bf16 priors' trainers: 5 timed steps and the bf16-trained
   ``enhance_batch``;
11. the train loader's ms a batch, native and on the Python path;
12. a step of ``conf/diff.yml``'s trainer in one process and on two gloo
   ranks sharing the card (5 after 1, CUDA events).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def batch_line(label: str, ms: float, card, extra: str = "") -> str:
    return (f"enhance_batch [{label}] batch {cs.BATCH} x {cs.LENGTH // cs.SR} s, fast-6: "
            f"{ms:.3f} ms/batch, RTF {cs.BATCH * cs.LENGTH / cs.SR / (ms / 1e3):.1f}x{extra}; "
            f"card {card}")


def top_line(top) -> str:
    return "; ".join(f"{name} {kernel_ms:.3f} ({n})" for name, kernel_ms, n in top)


def serve_numbers(device, card, dis, ddpm, dtype, mode: str = "pirorgrad",
                  sigmas=(False, True), deep: bool = False) -> None:
    """A serving batch of :func:`chip_smoke.run_main_path` for each of
    ``sigmas``: its ms; the plain versions' ms, device ms, launches and top
    kernels for every batch with ``deep`` (phase 3), else for the plain
    batch; with ``deep`` the plain batch's layer times."""
    import torch

    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    wav = torch.from_numpy(cs.speechlike(cs.BATCH, cs.LENGTH, 3)).to(device)
    for sigma in sigmas:
        label = cs.serve_label(dis, mode, dtype, sigma)
        enh = Enhancer(dis, ddpm, cs.mode_config(mode), device=device, sigma=sigma, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(5)
        batch = lambda: enh.enhance_batch(wav, gen)  # noqa: E731
        eager = lambda: enh.eager_batch(wav, gen)  # noqa: E731
        ms = cs.cuda_ms(batch, iters=10, warmup=2)
        # bf16 replays a CUDA graph: its op-by-op time beside it
        op_by_op = (f" (op by op {cs.cuda_ms(eager, iters=10, warmup=2):.3f} ms)"
                    if dtype == torch.bfloat16 else "")
        if sigma and not deep:
            print(batch_line(label, ms, card, op_by_op), flush=True)
            continue
        with cs.plain_versions():
            plain_ms = cs.cuda_ms(eager, iters=5, warmup=1)
        dev = cs.device_ms(batch, calls=3)
        top, launches = cs.top_kernels(batch)
        print(batch_line(label, ms, card, f"{op_by_op} (plain versions {plain_ms:.3f} ms); "
                         f"device {cs.fmt(dev)} ms, {launches} kernel launches a batch"),
              flush=True)
        if not sigma:
            if deep:
                layer_times(enh, wav, card, label)
            print(f"top kernels [{label}] by device ms per batch: {top_line(top)}", flush=True)


def layer_times(enh, wav, card, label: str) -> None:
    """Per-layer times of one batch in the enhancer's dtype and mode: STFT,
    prior (packed, or a module forward), one chain step, the chain (its
    steps), ISTFT; device ms from the profiler."""
    import torch

    from prior_diffuse_tpu_torch.models.fused_forward import fused_unet_forward
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.signal.compress import compress_spec

    c = enh.cfg.diffusion.scale_c
    steps = enh.sched.num_steps
    with torch.no_grad():
        feat = compress_spec(kstft.stft(wav), "sqrt")
        _, pack_ddpm = enh.packs()
        prior = lambda: enh.prior(feat)  # noqa: E731 (packed, or the serving copy)
        x_init = prior() / c
        cond = enh.conditioner(feat, c, x_init)
        t = torch.full((cs.BATCH,), float(enh.sched.T[-1]), device=wav.device, dtype=enh.dtype)
        x = torch.randn_like(x_init)
        spec = feat.contiguous()
        step = lambda: fused_unet_forward(pack_ddpm, x, cond, t)  # noqa: E731
        times = {"stft": cs.cuda_ms(lambda: kstft.stft(wav)), "prior": cs.cuda_ms(prior, iters=10),
                 "ddpm_step": cs.cuda_ms(step, iters=10),
                 "istft": cs.cuda_ms(lambda: kstft.istft(spec, cs.LENGTH))}
        times["chain"] = steps * times["ddpm_step"]
        dev = {"stft": cs.device_ms(lambda: kstft.stft(wav)), "prior": cs.device_ms(prior),
               "ddpm_step": cs.device_ms(step),
               "istft": cs.device_ms(lambda: kstft.istft(spec, cs.LENGTH))}
        dev["chain"] = None if dev["ddpm_step"] is None else steps * dev["ddpm_step"]
    print(f"layers [{label}] (ms per batch of {cs.BATCH} x {cs.LENGTH // cs.SR} s, CUDA events): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + "; device ms (profiler) "
          + ", ".join(f"{k} {cs.fmt(v)}" for k, v in dev.items()) + f"; card {card}", flush=True)


def long_numbers(device, nets, card) -> None:
    """Phase 4b's 30 s wav through ``enhance_long`` (the bf16 enhancer and
    its prior-only server): a first call (it casts the prior and picks
    cuDNN's plans), then the second call's wall ms."""
    import torch

    from prior_diffuse_tpu_torch.config import ExperimentConfig, TrainConfig
    from prior_diffuse_tpu_torch.serving.enhance import prior_only_server
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
    from prior_diffuse_tpu_torch.serving.streaming import enhance_long

    enh = Enhancer(*nets, ExperimentConfig(train=TrainConfig(batch_size=cs.BATCH)),
                   device=device, dtype=torch.bfloat16)
    wav = 0.1 * cs.speechlike(1, cs.LONG_SECONDS * cs.SR, 20)[0]
    segment, overlap = cs.LENGTH, cs.LENGTH // 10
    for name, server in (("enhance_long_bf16", enh),
                         ("prior_only_long_bf16", prior_only_server(enh))):
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            enhance_long(server, wav, torch.Generator(device=device).manual_seed(9),
                         segment=segment, overlap=overlap)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"{name}: {cs.LONG_SECONDS} s, {walls[0]:.1f} ms wall incl. host, again "
              f"{walls[1]:.1f} ms; card {card}", flush=True)


def graph_numbers(device, nets, card) -> None:
    """The bf16 enhancer's CUDA graphs: the host seconds of each shape's
    first ``enhance_batch`` (its eager run and its capture) at the
    recordings cell's eight rungs of 3 s (4-32 rows, in the ascending order
    in which its warm-up meets them), then at a bf16 files stream's longest
    (16 rows of 12 s); after the eight, the allocated and reserved bytes
    and the bytes of the graphs' shared pool."""
    import torch

    from prior_diffuse_tpu_torch.config import ExperimentConfig, TrainConfig
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    enh = Enhancer(*nets, ExperimentConfig(train=TrainConfig(batch_size=32)), device=device,
                   dtype=torch.bfloat16)
    enh.packs()
    gen = torch.Generator(device=device).manual_seed(1)

    def first_call(rows: int, length: int) -> float:
        wav = (0.1 * np.random.default_rng(rows).standard_normal((rows, length))).astype(
            np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enh.enhance_batch(wav, gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    seconds = {rows: first_call(rows, cs.LENGTH) for rows in range(4, 33, 4)}
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(enh._graph_pool[0]))
    print("bf16 graphs: first batch with its capture, rows x 3 s: "
          + ", ".join(f"{r} {t:.3f} s" for r, t in seconds.items())
          + f"; after {len(enh._graphs)} graphs allocated "
          f"{torch.cuda.memory_allocated(device) / 1e9:.3f} GB, reserved "
          f"{torch.cuda.memory_reserved(device) / 1e9:.3f} GB, the graphs' pool "
          f"{pool / 1e9:.3f} GB; 16 x 12 s {first_call(16, 4 * cs.LENGTH):.3f} s; card {card}",
          flush=True)


def timed_steps(tr, batches, card, iters: int = 10, label: str = "joint, sigma") -> None:
    """``iters`` train steps timed with CUDA events after 2 warm-up steps,
    without the group gradient norms (``train_ddpm`` takes them on 1 step
    in ``grad_log_every``), with peak memory; then 5 steps on the host
    clock, each ending in a scalar readback."""
    import torch

    losses = []

    def step():
        out = tr._train_step(*batches[len(losses) % len(batches)], norms=False)
        losses.append(torch.stack(cs.train_losses(out)))

    torch.cuda.reset_peak_memory_stats()
    ms = cs.cuda_ms(step, iters=iters, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    wall = []
    for i in range(5):
        t0 = time.perf_counter()
        float(tr._train_step(*batches[i % len(batches)], norms=False)[0])
        wall.append((time.perf_counter() - t0) * 1e3)
    rows = batches[0][0].shape[0]
    dtype = str(getattr(tr, "compute_dtype", torch.float32)).split(".")[-1]
    print(f"train step [{label}] batch {rows} x {cs.LENGTH}, {dtype}: {ms:.3f} ms/step "
          f"(CUDA events, mean of {iters}), {rows / (ms / 1e3):.2f} utterances/s, "
          f"peak memory {peak / 2**20:.1f} MiB; host clock {np.median(wall):.3f} ms/step "
          f"(median of 5, {min(wall):.3f}-{max(wall):.3f}); losses of the last timed step "
          f"{[round(float(v), 5) for v in losses[-1]]}; card {card}", flush=True)


def step_profile(tr, batch, label: str, card) -> None:
    """Device ms, kernel launches and top kernels of one train step (no
    group norms; memsets and copies counted as launches)."""
    step = lambda: tr._train_step(*batch, norms=False)  # noqa: E731
    dev = cs.device_ms(step, calls=3)
    top, launches = cs.top_kernels(step)
    print(f"train step [{label}]: device {cs.fmt(dev)} ms, {launches} kernel launches a step; "
          f"top kernels by device ms per step: {top_line(top)}; card {card}", flush=True)


def eval_step_ms(tr, card, label: str) -> None:
    """The eval step (prior, chain, diagnostics) on the first cv batch."""
    b = next(iter(tr.cv_loader))
    noisy, clean, frames = tr.put_batch(b.noisy, b.clean, b.frame_nums)
    ms = cs.cuda_ms(lambda: tr._eval_step(noisy, clean, frames), iters=3, warmup=1)
    print(f"{label}eval step {ms:.3f} ms (CUDA events) on {tuple(noisy.shape)}; card {card}",
          flush=True)


def trainer_batches(tr) -> list:
    """A trainer's train batches of one epoch, on its device."""
    return [tr.put_batch(b.noisy, b.clean, b.frame_nums) for b in tr.tr_loader]


def ddpm_trainer(device, root: str, corpus: str, tag: str, exp):
    """A ``--joint --sigma`` ``ComplexDDPMTrainer`` (seed 7) and its train
    batches."""
    from prior_diffuse_tpu_torch.config import RunConfig
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    run = RunConfig(seed=7, joint=True, sigma=True, data_root=corpus,
                    assets=os.path.join(root, f"assets_{tag}"))
    tr = ComplexDDPMTrainer(run, exp, device=device)
    return tr, trainer_batches(tr)


def complex_serving_numbers(device, card, name: str, tr) -> None:
    """``ComplexTrainer.enhance_batch`` (``MagTrainer``'s for GRN) on the
    batch of phase 3: ms, plain-version ms, device ms, launches, top
    kernels."""
    import torch

    trainer = type(tr).__name__
    wav = torch.from_numpy(cs.speechlike(cs.BATCH, cs.LENGTH, 3)).to(device)
    batch = lambda: tr.enhance_batch(wav)  # noqa: E731
    ms = cs.cuda_ms(batch, iters=10, warmup=2)
    with cs.plain_versions():
        plain_ms = cs.cuda_ms(batch, iters=3, warmup=1)
    dev = cs.device_ms(batch, calls=3)
    top, launches = cs.top_kernels(batch)
    print(f"{trainer}.enhance_batch [{name}, f32] batch {cs.BATCH} x {cs.LENGTH // cs.SR} s: "
          f"{ms:.3f} ms/batch, RTF {cs.BATCH * cs.LENGTH / cs.SR / (ms / 1e3):.1f}x (plain "
          f"versions {plain_ms:.3f} ms); device {cs.fmt(dev)} ms, {launches} kernel launches a "
          f"batch; top kernels by device ms per batch: {top_line(top)}; card {card}", flush=True)


def prior_only_bf16_numbers(device, card, name: str, net, ddpm) -> None:
    """The bf16 ``prior_only_server`` of phase 9f: ms, device ms,
    launches, top kernels."""
    import torch

    from prior_diffuse_tpu_torch.serving.enhance import prior_only_server
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    server = prior_only_server(Enhancer(net, ddpm, cs.mode_config("pirorgrad"), device=device,
                                        dtype=torch.bfloat16))
    wav = torch.from_numpy(cs.speechlike(cs.BATCH, cs.LENGTH, 3)).to(device)
    batch = lambda: server.enhance_batch(wav)  # noqa: E731
    ms = cs.cuda_ms(batch, iters=10, warmup=2)
    top, launches = cs.top_kernels(batch)
    print(f"prior_only_server [{name}, bf16] batch {cs.BATCH} x {cs.LENGTH // cs.SR} s: "
          f"{ms:.3f} ms/batch; device {cs.fmt(cs.device_ms(batch, calls=3))} ms, {launches} "
          f"kernel launches a batch; top kernels: {top_line(top)}; card {card}", flush=True)


def diffwave_numbers(device, card) -> None:
    """Phase 9e's DiffWave forward at [2, 48000], f32: ms and device ms."""
    import torch

    from prior_diffuse_tpu_torch.models.diffwave import DiffWave

    net = cs.seeded_nets(61, device, (DiffWave,))[0]
    g = torch.Generator().manual_seed(61)
    args = [a.to(device) for a in (torch.randn(2, cs.LENGTH, generator=g),
                                   0.5 * torch.randn(2, cs.LENGTH, generator=g),
                                   torch.tensor([3, 41]))]
    ms = cs.cuda_ms(lambda: net(*args), iters=5, warmup=1)
    print(f"DiffWave forward [2, {cs.LENGTH}], f32: {ms:.3f} ms (CUDA events); device "
          f"{cs.fmt(cs.device_ms(lambda: net(*args), calls=2))} ms; card {card}", flush=True)


@contextmanager
def stft_times(noise_seed: int):
    """The plain STFT times ``1 + 1e-7 N(0, 1)``: a float32 rounding change."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft

    plain = kstft.stft_plain

    def perturbed(wav):
        s = plain(wav)
        g = torch.Generator(device=s.device).manual_seed(noise_seed)
        return s * (1 + 1e-7 * torch.randn(s.shape, generator=g, device=s.device))

    with mock.patch.object(kstft, "stft", perturbed):
        yield


def bf16_step_floor(tr, batch, label: str, card) -> None:
    """From one state, the bf16 step through the plain STFT and through the
    plain STFT times 1 + 1e-7 N(0, 1) (seeds 1 and 2): their distance,
    beside phase 10's bounds, is the floor under the K1 step check."""
    snap = copy.deepcopy(tr.ckpt_payload())

    def run(ctx=None):
        tr.restore_payload(copy.deepcopy(snap))
        if ctx is None:
            return cs.one_step(tr, batch, plain=True)
        with ctx:
            return cs.one_step(tr, batch)

    ref = run()
    for seed in (1, 2):
        d = cs.step_distance(tr, run(stft_times(seed)), ref)
        print(f"bf16 step [{label}]: plain STFT x (1 + 1e-7 N) (seed {seed}) vs plain: losses "
              f"{d['loss']:.3e} (the check's bound {cs.BF16_STEP_LOSS_RTOL:g}), gradients "
              + ", ".join(f"{n} {v:.3e}" for n, v in d.items() if n != "loss")
              + f" (bound {cs.BF16_STEP_GRAD_RTOL:g}); card {card}", flush=True)
    tr.restore_payload(copy.deepcopy(snap))


def loader_numbers(corpus: str, card) -> None:
    """Phase 11a's train loader: ms a batch of an epoch at 6 x 48000, the
    native runtime's and the Python path's (host clock, prefetch thread
    included)."""
    from prior_diffuse_tpu_torch.data.dataset import PairedWavDataset, TrainLoader

    ds = PairedWavDataset(f"{corpus}/noisy_trainset_wav", f"{corpus}/clean_trainset_wav",
                          chunk_length=cs.LENGTH)
    ms = {}
    for native in (True, False):
        loader = TrainLoader(ds, cs.TRAIN_BATCH, seed=11, native=native)
        t0 = time.perf_counter()
        n = len(list(loader))
        ms[native] = (time.perf_counter() - t0) * 1e3 / n
    print(f"train loader, {n} batches of {cs.TRAIN_BATCH} x {cs.LENGTH}: {ms[True]:.2f} ms a "
          f"batch native, {ms[False]:.2f} ms on the Python path (host clock, one epoch, "
          f"prefetch thread included); card {card}", flush=True)


def dp_numbers(device, card, root: str, corpus: str) -> None:
    """Phase 12's step (``conf/diff.yml``, 6 x 48000) in one process and on
    two gloo ranks sharing the card (each rank a process of its own)."""
    inp, one = cs.dp_inputs(device, root, corpus, cs.DP_WORLD, "gloo", None, True)
    full = one.put_batch(*inp["batch"])
    ms = cs.dp_ms(lambda: one._train_step(*full, norms=False), device)
    del one, full
    outs, wall = cs.dp_outputs(cs.dp_spawn(inp, root))
    print(f"data-parallel step of {len(inp['batch'][0])} x {cs.LENGTH}: {ms:.3f} ms in one "
          f"process, " + ", ".join(f"{o['ms']:.3f} ms on rank {r}" for r, o in enumerate(outs))
          + f" of {cs.DP_WORLD} gloo ranks sharing the card (CUDA events, 5 steps after 1; gloo "
          f"copies every collective through the host: no scaling claimed); {wall:.1f} s for the "
          f"ranks' processes; card {card}", flush=True)


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    from prior_diffuse_tpu_torch.config import load_experiment
    from prior_diffuse_tpu_torch.models import model_class
    from prior_diffuse_tpu_torch.models.diffunet import Nocon
    from prior_diffuse_tpu_torch.ops import build

    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    device = torch.device("cuda:0")
    build.build()
    build.library()
    t0 = time.perf_counter()

    def mark(phase) -> None:
        print(f"[{time.perf_counter() - t0:.1f} s] phase {phase}", flush=True)

    nets = cs.seeded_nets(0, device)
    denoisers = {"deltamu": cs.seeded_nets(1, device, (Nocon,))[0], "conditional": nets[1]}
    mark(3)
    for dtype in (torch.float32, torch.bfloat16):
        serve_numbers(device, card, *nets, dtype, deep=True)
    mark(4)
    long_numbers(device, nets, card)
    graph_numbers(device, nets, card)
    exp32 = load_experiment(os.path.join(ROOT, "conf", "diff.yml"))
    with tempfile.TemporaryDirectory(prefix="card_numbers_") as root:
        corpus = cs.write_train_corpus(root)
        mark(5)
        tr, batches = ddpm_trainer(device, root, corpus, "f32", exp32)
        timed_steps(tr, batches, card)
        step_profile(tr, batches[0], f"f32, joint, sigma, batch {cs.TRAIN_BATCH}", card)
        eval_step_ms(tr, card, "evaluate(): ")
        del tr, batches
        mark(7)
        for mode, ddpm in denoisers.items():
            for dtype in (torch.float32, torch.bfloat16):
                serve_numbers(device, card, nets[0], ddpm, dtype, mode,
                              (False, True) if mode == "deltamu" else (False,))
        for mode, flags in cs.MODES.items():
            exp = dataclasses.replace(exp32, diffusion=dataclasses.replace(exp32.diffusion,
                                                                          **flags))
            tr, batches = ddpm_trainer(device, root, corpus, mode, exp)
            timed_steps(tr, batches, card, iters=5, label=f"{mode}, joint, sigma")
            del tr, batches
        mark(8)
        priors = {name: cs.seeded_nets(40 + list(cs.PRIOR_PARAMS).index(name), device,
                                       (model_class(name),))[0] for name in cs.BF16_PRIORS}
        for name, net in priors.items():
            complex_serving_numbers(device, card, name, cs.complex_trainer(
                device, name, net, root, corpus))
            serve_numbers(device, card, net, nets[1], torch.float32)
            tr = cs.complex_trainer(device, name, net, root, corpus, tag="_train")
            timed_steps(tr, trainer_batches(tr), card, iters=5,
                        label=f"{type(tr).__name__}, {name}")
            del tr
        mark(9)
        grn = cs.grn_net(device)
        grn_corpus = cs.grn_corpus(root, corpus)
        complex_serving_numbers(device, card, "GRN", cs.complex_trainer(
            device, "GRN", grn, root, grn_corpus))
        tr = cs.complex_trainer(device, "GRN", grn, root, grn_corpus, tag="_train")
        timed_steps(tr, trainer_batches(tr), card, iters=5, label=f"{type(tr).__name__}, GRN")
        del tr
        diffwave_numbers(device, card)
        for name, net in priors.items():
            prior_only_bf16_numbers(device, card, name, net, nets[1])
            serve_numbers(device, card, net, nets[1], torch.bfloat16)
        mark(10)
        tr, batches = ddpm_trainer(device, root, corpus, "bf16", cs.bf16_exp(exp32))
        bf16_step_floor(tr, batches[0], "DDPM, conf/diff.yml", card)
        tr32, _ = ddpm_trainer(device, root, corpus, "bf16_f32", exp32)
        for t, label in ((tr32, "f32"), (tr, "bf16"), (tr, "bf16"), (tr32, "f32")):
            timed_steps(t, batches, card, label=f"{label}, joint, sigma")
        for t, label in ((tr32, "f32"), (tr, "bf16")):
            step_profile(t, batches[0], f"{label}, joint, sigma, batch {cs.TRAIN_BATCH}", card)
        del tr32
        eval_step_ms(tr, card, "bf16 evaluate(): ")
        del tr, batches
        wav = torch.from_numpy(cs.speechlike(cs.BATCH, cs.LENGTH, 3)).to(device)
        for name, net in {**priors, "GRN": grn}.items():
            tr = cs.complex_trainer(device, name, net, root, corpus, tag="_bf16", bf16=True)
            trainer = type(tr).__name__
            batches = trainer_batches(tr)
            bf16_step_floor(tr, batches[0], f"{trainer}, {name}", card)
            timed_steps(tr, batches, card, iters=5, label=f"{trainer}, {name}, bf16")
            ms = cs.cuda_ms(lambda: tr.enhance_batch(wav), iters=5, warmup=1)
            print(f"{trainer}.enhance_batch [{name}, bf16-trained] batch {cs.BATCH} x "
                  f"{cs.LENGTH // cs.SR} s: {ms:.3f} ms/batch; card {card}", flush=True)
            del tr, batches
        mark(11)
        loader_numbers(corpus, card)
        mark(12)
        dp_numbers(device, card, root, corpus)
        mark("done")


if __name__ == "__main__":
    main()
