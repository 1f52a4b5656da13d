#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: build, check, serve.

    python3 chip_smoke.py

Phases (each passes or ends the script with a non-zero exit):

0. a CUDA card is present; print its name and power limit; TF32 off;
1. build the kernels of ``prior_diffuse_tpu_torch/csrc`` (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card, on the same
   inputs, at the shapes of the serving path (batch 8 x 3 s): K1 STFT and
   K2 ISTFT on ``[8, 48000]``, K3 at the five encoder stages of both nets
   at T = 301 with a per-batch bias; times from CUDA events after warm-up;
   then off those shapes: batch 1 and 3, odd lengths, 1-3 frames;
3. the serving path at full width: ``DiffUNet`` and ``DiffUNet1`` with
   weights drawn from a seeded ``torch.Generator`` (randomised BN
   statistics), ``Enhancer.enhance_batch`` on 8 speech-like 3 s wavs,
   fast-6 schedule, f32, plain and ``--sigma`` modes; output finite and
   ``[8, 48000]``, equal to the same ``Enhancer`` run through the plain
   versions on the card, and launch counts K1 = 1, K2 = 1, K3 = 35;
4. five requests of 1-4 s through ``serving.enhance.enhance_files``.

It prints a JSON line of per-kernel results before the last line, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, LENGTH, SR = 8, 48000, 16000
T_FRAMES = LENGTH // 160 + 1
# Kernel vs plain on the card: the same float32 products summed in another
# order (FMA chains in the kernels, blocked GEMMs in cuBLAS), so the bound
# is relative to the largest reference value.
KERNEL_RTOL = 1e-5
# Whole serving path: 35 K3 calls and 6 chain steps carry those
# differences through 7 UNet forwards and the squaring of decompression.
PATH_RTOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> tuple[float, float]:
    """(max|got - want|, max|want|), after checking shapes and finiteness."""
    import torch

    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail("non-finite values")
    return float((got - want).abs().max()), float(want.abs().max())


def expect_close(label: str, got, want, rtol: float = KERNEL_RTOL) -> float:
    """Fail unless max|got - want| <= rtol * max|want|; returns max|got - want|."""
    import torch

    torch.cuda.synchronize()
    err, ref = max_err(got, want)
    print(f"{label} -> {tuple(got.shape)}: max|err| {err:.3e} (bound {rtol * ref:.3e})",
          flush=True)
    if err > rtol * ref:
        fail(f"{label}: kernel disagrees with its plain version")
    return err


def speechlike(n: int, length: int, seed: int) -> np.ndarray:
    """Voiced-speech-like test signals: harmonics of a gliding f0 under a
    syllable-rate envelope, plus noise; RMS-normalised per row."""
    g = np.random.default_rng(seed)
    t = np.arange(length) / SR
    rows = []
    for _ in range(n):
        f0 = g.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * g.uniform(0.5, 2) * t))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        voiced = sum(np.sin(h * phase) / h for h in range(1, 12))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * g.uniform(2, 5) * t) ** 2
        rows.append(voiced * env + 0.1 * g.standard_normal(length))
    x = np.stack(rows)
    return (x / np.sqrt(np.mean(x ** 2, axis=1, keepdims=True))).astype(np.float32)


def seeded_nets(seed: int, device):
    """Full-width DiffUNet and DiffUNet1 with weights drawn from an explicit
    generator: uniform(+-1/sqrt(fan_in)) kernels and biases, PReLU slopes
    in [0.1, 0.4], BN scale/shift near 1/0 and running statistics
    mean ~ N(0, 0.1), var ~ U(0.5, 1.5) (not the 0/1 defaults, so the
    folded BN is exercised)."""
    import torch
    import torch.nn as nn

    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet, DiffUNet1

    g = torch.Generator().manual_seed(seed)
    nets = []
    for net in (DiffUNet(), DiffUNet1()):
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.weight.uniform_(0.8, 1.2, generator=g)
                    m.bias.uniform_(-0.1, 0.1, generator=g)
                    m.running_mean.normal_(0.0, 0.1, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
                elif isinstance(m, nn.PReLU):
                    m.weight.uniform_(0.1, 0.4, generator=g)
                elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                    fan_in = m.weight[0].numel() if not isinstance(
                        m, nn.ConvTranspose2d) else m.weight[:, 0].numel()
                    bound = 1.0 / np.sqrt(fan_in)
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.uniform_(-bound, bound, generator=g)
        nets.append(net.to(device).eval())
    return nets


@contextmanager
def plain_versions():
    """Route the serving path through every kernel's plain version (for
    the reference run on the card)."""
    from prior_diffuse_tpu_torch.ops.cuda import convblock, stft as kstft

    with mock.patch.object(kstft, "stft", kstft.stft_plain), \
            mock.patch.object(kstft, "istft",
                              lambda spec, length: kstft.istft_plain(spec, length=length)), \
            mock.patch.object(convblock, "enc_stage", convblock.enc_stage_plain):
        yield


def counters():
    from prior_diffuse_tpu_torch.ops.cuda import convblock, stft as kstft

    return {"stft": kstft.stft, "istft": kstft.istft, "enc_stage": convblock.enc_stage}


def check_kernels(device, nets):
    """Phase 2: each kernel against its plain version; returns the rows of
    the kernels JSON line (without launch counts)."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft

    rows = {}
    wav = torch.from_numpy(speechlike(BATCH, LENGTH, 1)).to(device)
    want = kstft.stft_plain(wav)
    err = expect_close(f"K1 stft {tuple(wav.shape)}", kstft.stft(wav), want)
    rows["stft"] = {"max_abs_err": err, "ms": cuda_ms(lambda: kstft.stft(wav)),
                    "plain_ms": cuda_ms(lambda: kstft.stft_plain(wav))}

    spec = want
    err = expect_close(f"K2 istft {tuple(spec.shape)}", kstft.istft(spec, LENGTH),
                       kstft.istft_plain(spec, length=LENGTH))
    rows["istft"] = {"max_abs_err": err,
                     "ms": cuda_ms(lambda: kstft.istft(spec, LENGTH)),
                     "plain_ms": cuda_ms(lambda: kstft.istft_plain(spec, length=LENGTH))}

    g = torch.Generator(device=device).manual_seed(2)
    worst, k3_ms, k3_plain_ms = 0.0, 0.0, 0.0
    for name, net in zip(("DiffUNet", "DiffUNet1"), nets):
        packed = cb.pack_encoder(net.core.en)
        temb = None
        if name == "DiffUNet1":
            t = torch.rand(BATCH, generator=g, device=device) * 40.0  # fractional t
            temb = net.time_embedding(t)
        x = torch.randn(BATCH, T_FRAMES, 161, 2, generator=g, device=device)
        for i, (ops, tp) in enumerate(packed, start=1):
            xin, bias_b, pad = cb.stage_inputs(x, ops, tp, temb)
            want = cb.enc_stage_plain(xin, ops, bias_b, pad)
            err = expect_close(f"K3 {name} stage {i} {tuple(xin.shape)} pad={pad}",
                               cb.enc_stage(xin, ops, bias_b, pad), want)
            ms = cuda_ms(lambda: cb.enc_stage(xin, ops, bias_b, pad))
            plain_ms = cuda_ms(lambda: cb.enc_stage_plain(xin, ops, bias_b, pad))
            print(f"    {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            worst = max(worst, err)
            if name == "DiffUNet1":
                k3_ms += ms
                k3_plain_ms += plain_ms
            x = want  # both versions see the same input at the next stage
    # K3's time: the five stages of one DiffUNet1 forward
    rows["enc_stage"] = {"max_abs_err": worst, "ms": k3_ms, "plain_ms": k3_plain_ms}
    return rows


def check_edge_shapes(device, nets):
    """Kernels against their plain versions off the main path's shapes:
    batch 1 and 3, the shortest signal (161 samples), lengths that are not
    multiples of 160, output lengths trimmed and zero-padded, and encoder
    stages with 1-3 frames (partial tiles on every edge)."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.signal.stft import _envelope_np

    for b, n in [(1, 161), (3, 16037), (2, 10241)]:
        wav = torch.from_numpy(speechlike(b, n, n)).to(device)
        spec = kstft.stft_plain(wav)
        expect_close(f"K1 stft {tuple(wav.shape)}", kstft.stft(wav), spec)
        for out_len in (n, max(n - 100, 1), n + 333):
            # the last frame's tail is divided by a window-square envelope
            # down to ~1e-8 (both versions), which scales float32 rounding
            # by 1/env: compare the numerators of that division
            env = np.ones(out_len)
            tail = _envelope_np(spec.shape[1], 320, 160)[160:160 + out_len]
            env[:len(tail)] = tail
            env = torch.tensor(env, dtype=torch.float32, device=device)
            expect_close(f"K2 istft {tuple(spec.shape)} length {out_len} (x envelope)",
                         kstft.istft(spec, out_len) * env,
                         kstft.istft_plain(spec, length=out_len) * env)
    g = torch.Generator(device=device).manual_seed(3)
    packed = cb.pack_encoder(nets[1].core.en)
    temb = nets[1].time_embedding(torch.tensor([7.25], device=device))
    for t_frames in (1, 3):
        x = torch.randn(1, t_frames, 161, 2, generator=g, device=device)
        for i, (ops, tp) in enumerate(packed[:2], start=1):
            xin, bias_b, pad = cb.stage_inputs(x, ops, tp, temb)
            x = cb.enc_stage_plain(xin, ops, bias_b, pad)
            expect_close(f"K3 stage {i} {tuple(xin.shape)} pad={pad}",
                         cb.enc_stage(xin, ops, bias_b, pad), x)


def run_main_path(device, nets, card):
    """Phase 3; returns the launch counts of one plain-mode batch."""
    import torch

    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    wav = speechlike(BATCH, LENGTH, 3)
    counts = None
    for sigma in (False, True):
        enh = Enhancer(*nets, device=device, sigma=sigma)
        fns = counters()
        for fn in fns.values():
            fn.launches = 0
        out = enh.enhance_batch(wav, torch.Generator(device=device).manual_seed(4))
        torch.cuda.synchronize()
        got_counts = {k: fn.launches for k, fn in fns.items()}
        if got_counts != {"stft": 1, "istft": 1, "enc_stage": 35}:
            fail(f"launch counts of one batch: {got_counts}")
        if counts is None:
            counts = got_counts
        with plain_versions():
            ref = enh.enhance_batch(wav, torch.Generator(device=device).manual_seed(4))
        torch.cuda.synchronize()
        if {k: fn.launches for k, fn in fns.items()} != got_counts:
            fail("the plain reference run launched a kernel")
        err, refmax = max_err(out, ref)
        mode = "sigma" if sigma else "plain"
        print(f"enhance_batch [{mode}] {tuple(out.shape)}: max|kernels - plain| "
              f"{err:.3e} (bound {PATH_RTOL * refmax:.3e}, max|ref| {refmax:.3e})",
              flush=True)
        if out.shape != (BATCH, LENGTH) or err > PATH_RTOL * refmax:
            fail(f"enhance_batch [{mode}] disagrees with its plain-version run")

        gen = torch.Generator(device=device).manual_seed(5)
        wav_dev = torch.from_numpy(wav).to(device)
        ms = cuda_ms(lambda: enh.enhance_batch(wav_dev, gen), iters=10, warmup=2)
        with plain_versions():
            plain_ms = cuda_ms(lambda: enh.enhance_batch(wav_dev, gen), iters=5, warmup=1)
        rtf = BATCH * LENGTH / SR / (ms / 1e3)
        print(f"enhance_batch [{mode}] batch {BATCH} x {LENGTH // SR} s, fast-6, f32: "
              f"{ms:.3f} ms/batch, RTF {rtf:.1f}x (plain versions {plain_ms:.3f} ms); "
              f"card {card}", flush=True)
        if not sigma:
            layer_times(enh, wav_dev, card)
    return counts


def layer_times(enh, wav, card):
    """Per-layer device times of one batch: STFT, prior, one chain step, ISTFT."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.signal.compress import compress_spec

    c = enh.cfg.diffusion.scale_c
    with torch.no_grad():
        feat = compress_spec(kstft.stft(wav), "sqrt")
        pack_dis, pack_ddpm = enh._packed()
        x_init = enh.dis(feat, packed=pack_dis) / c
        t = torch.full((BATCH,), float(enh.sched.T[-1]), device=wav.device)
        x = torch.randn_like(x_init)
        spec = feat.contiguous()
        times = {
            "stft": cuda_ms(lambda: kstft.stft(wav)),
            "prior": cuda_ms(lambda: enh.dis(feat, packed=pack_dis), iters=10),
            "ddpm_step": cuda_ms(lambda: enh.ddpm(x, x_init, t, packed=pack_ddpm), iters=10),
            "istft": cuda_ms(lambda: kstft.istft(spec, LENGTH)),
        }
    print(f"layers (ms per batch of {BATCH} x {LENGTH // SR} s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()) + f"; card {card}", flush=True)


def serve_requests(device, nets):
    """Phase 4: five requests of 1-4 s through enhance_files."""
    import torch

    from prior_diffuse_tpu_torch.config import ExperimentConfig, TrainConfig
    from prior_diffuse_tpu_torch.serving.enhance import enhance_files
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    enh = Enhancer(*nets, ExperimentConfig(train=TrainConfig(batch_size=BATCH)),
                   device=device)
    lengths = [16000, 23456, 40000, 64000, 31234]
    wavs = [0.1 * speechlike(1, n, 10 + i)[0] for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    outs = enhance_files(enh, wavs, torch.Generator(device=device).manual_seed(6))
    wall = time.perf_counter() - t0
    for w, o in zip(wavs, outs):
        if o.shape != w.shape or not np.isfinite(o).all():
            fail(f"enhance_files returned {o.shape} for {w.shape} or non-finite values")
    print(f"enhance_files: {len(wavs)} requests, {sum(lengths) / SR:.2f} s of audio, "
          f"lengths {lengths} -> ok ({wall * 1e3:.1f} ms wall incl. host)", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    try:
        import prior_diffuse_tpu_torch
    except ImportError as e:
        fail(f"cannot import the port next to this script: {e}")
    if not os.path.abspath(prior_diffuse_tpu_torch.__file__).startswith(ROOT + os.sep):
        fail(f"imported {prior_diffuse_tpu_torch.__file__}, not the checkout's package")
    from prior_diffuse_tpu_torch.ops import build

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)  # inference only
    device = torch.device("cuda:0")

    b = build.build()
    print(f"build: {b.path.name} in {b.seconds:.2f} s", flush=True)
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)
    build.library()

    nets = seeded_nets(0, device)
    rows = check_kernels(device, nets)
    check_edge_shapes(device, nets)
    counts = run_main_path(device, nets, card)
    serve_requests(device, nets)

    meta = {
        "stft": ("cuda", "prior_diffuse_tpu_torch/csrc/stft.cu",
                 "prior_diffuse_tpu/ops/pallas/stft_kernel.py:44"),
        "istft": ("cuda", "prior_diffuse_tpu_torch/csrc/stft.cu",
                  "prior_diffuse_tpu/ops/pallas/stft_kernel.py:106"),
        "enc_stage": ("cuda", "prior_diffuse_tpu_torch/csrc/enc_chain.cu",
                      "prior_diffuse_tpu/ops/pallas/convblock_kernel.py:109"),
    }
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": counts[name], **rows[name]}
               for name, (route, src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
