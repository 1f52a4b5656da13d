#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: build, check, serve, train.

    python3 chip_smoke.py

Phases (each passes or ends the script with a non-zero exit):

0. a CUDA card is present; print its name and power limit; TF32 off;
1. build the kernels of ``prior_diffuse_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source);
2. each kernel against its plain PyTorch version on the card, on the same
   inputs, at the shapes of the serving path (batch 8 x 3 s): K1 STFT on
   ``[8, 48000]``, K2 ISTFT on its spectrum and on a seeded random
   spectrum ``[8, 301, 161, 2]`` whose DC and Nyquist bins have imaginary
   parts (as the DDPM's estimate has), K3 at the five encoder stages of
   both nets at T = 301 with a per-batch bias, in f32 and (K3-bf16, the
   whole stage with stage 2-5's conv1 on the 64-channel input) in bf16,
   each stage's device ms, graph ms and bound, and the bf16 encoder with
   its glue (``encoder_fused``: device ms, graph ms, launches); K3-bf16 on
   a stage whose conv1 is an exact embedding and whose gate halves cancel,
   where a chain that kept y in bf16 must miss the bound; times from CUDA
   events after
   warm-up, device times from ``torch.profiler`` and from CUDA-graph
   replays; K1 and K2 timed in turns against their library yardsticks
   (``torch.stft``, ``torch.istft``), and marked slower on device where
   their profiler time exceeds the yardstick's; each kernel's bound (bytes,
   or operations at the H100's published f32 or bf16 peak) from the
   shapes; then
   off those shapes: batch 1 and 3, odd lengths, K2 on random spectra at
   the edges of each tile it is built for (R = 4, 8, 16 rows a block; T =
   1, R, R + 1, 2R + 1; an output shorter than one row, ending in row T,
   or past it), every K3 stage at 1-3 frames and at frame counts that no
   time tile divides;
3. the serving path at full width: ``DiffUNet`` and ``DiffUNet1`` with
   weights drawn from a seeded ``torch.Generator`` (randomised BN
   statistics), ``Enhancer.enhance_batch`` on 8 speech-like 3 s wavs,
   fast-6 schedule, f32, plain and ``--sigma`` modes; output finite and
   ``[8, 48000]``, equal to the same ``Enhancer`` run through the plain
   versions on the card, and launch counts K1 = 1, K2 = 1, K3 = 35;
   then the same batch in bf16 (``Enhancer(dtype=torch.bfloat16)``: K3-bf16
   in every encoder stage, the dual decoder, the bf16 sampler; K1 and K2 in
   f32), plain and ``--sigma``: through the kernels against the plain
   versions (relative RMS), against the f32 enhancer on the same weights and
   draws (between a floor and a ceiling), launch counts K1 = 1, K2 = 1,
   K3-bf16 = 35, K3 = 0;
4. five requests of 1-4 s through ``serving.enhance.enhance_files`` in f32
   and bf16; one 30 s wav through ``serving.streaming.enhance_long`` in bf16
   (finite, seam-free) and through ``prior_only_server`` (K1 and K2 only);
   one 45-segment bf16 recording through ``enhance_long`` in blocks of 32,
   its blocks replayed as CUDA graphs, against the same call eager at the
   same padding (bit for bit), with both ms and the ``enh.graph_*``
   counters;
5. training at full width: ``ComplexDDPMTrainer`` of ``conf/diff.yml``
   (batch 6 x 48000, ``--joint --sigma``, weights from a seed) on a
   synthetic corpus of 24 + 8 utterances of 3-4 s. K1 against its plain
   version at ``[6, 48000]``; one train step through K1 against the same
   step through the plain STFT (losses and gradients), and through K1 with
   a wrong window, which that check must reject; a step on each train batch
   (K1 = 2 launches a step, finite losses); ``evaluate()`` (K1 = 2, K2 = 2,
   K3 = 35 a cv batch), then K2 and K3 against their plain versions at the
   trained weights' eval shapes; a checkpoint restored into a fresh trainer
   takes the same next step;
6. the entry point: ``cli.main`` trains 2 epochs on that corpus and writes
   its log and checkpoints, then ``--generate`` writes one wav per test
   utterance;
7. the deltamu and conditional diffusion modes: the batch of phase 3 with
   the unconditional ``Nocon`` (deltamu, plain and ``--sigma``) or
   ``DiffUNet1`` conditioned on the noisy spectrum (conditional, plain),
   in f32 and bf16, each through the kernels against the plain versions
   (f32 ``PATH_RTOL``, bf16 ``BF16_PATH_RMS``), bf16 against f32 on the
   same weights and ``x_T``, launch counts K1 = 1, K2 = 1, K3 or K3-bf16 =
   35; the bf16
   enhancer on the card against the same enhancer on the CPU (the plain
   versions, the CPU branch the tests hold to JAX) at 2 x 0.5 s in each
   mode; and the trainer of phase 5 in each mode: the K1 step against the
   plain-STFT step, a step on each train batch, one ``evaluate()`` cv batch (K1 = 2,
   K2 = 2, K3 = 35);
8. the GCRN and DB-AIAT priors (``conf/gcrn.yml``, ``conf/dbaiat.yml``):
   the five families' parameter counts against the reference oracle;
   cuDNN's f32 LSTM and GRU and each family's forward on the card against
   the same module on the CPU, with TF32 off (bounded) and on (printed);
   ``ComplexTrainer.enhance_batch`` on the batch of phase 3 for GCRN and
   ``aia_complex_trans_ri`` (K1 = 1, K2 = 1, K3 = 0) against the plain
   versions, plus five requests through ``enhance_files``; each of
   those priors under ``ComplexDDPMTrainer``'s ``Enhancer`` (plain and
   ``--sigma``: K1 = 1, K2 = 1, K3 = 30, the prior unpacked) and
   ``prior_only_server``, then that trainer's joint step and one
   ``evaluate()`` cv batch; ``ComplexTrainer`` training at each config's
   width (GCRN 8 x 48000, DB-AIAT 4 x 48000): the K1 step against the
   plain-STFT step (and the wrong window rejected), a step on each train batch,
   ``evaluate()`` (K1 = 2, K2 = 2 a cv batch); and ``cli.main --trainer
   ComplexTrainer`` on each yml for one epoch, then ``--generate``;
9. ``conf/grn.yml``'s GRN (3,131,731 parameters) with ``MagTrainer``: its
   forward on the card against the CPU at [8, 301, 161] (TF32 off bounded,
   on printed); ``MagTrainer.enhance_batch`` on the batch of phase 3 (K1 =
   1, K2 = 1, K3 = 0) against the plain versions, and five requests
   through ``enhance_files``; training at 8 x 48000 on phase 5's corpus with
   two more test utterances (the K1 step against the plain-STFT step, the
   wrong window rejected, a step on each train batch, ``evaluate()``
   with K1 = 2, K2 = 2 a cv batch over cv batches of 8 and a ragged 2);
   ``cli.main --trainer MagTrainer`` for one epoch, then ``--generate``;
   DiffWave at full width (64 x 30) on the card against the CPU at [2,
   48000]; and the GCRN and ``aia_complex_trans_ri`` priors served in bf16
   as the JAX package serves them (``serving_copy``): ``prior_only_server``
   in bf16 (K1 = 1, K2 = 1) against the plain versions and against f32
   (a floor and a ceiling), the bf16 ``Enhancer`` (pirorgrad, plain and
   ``--sigma``: K1 = 1, K2 = 1, K3-bf16 = 30, K3 = 0) through the kernels
   against the plain versions, against f32, and on the card against
   the CPU at 2 x 0.5 s;
10. bf16 training (``train.compute_dtype: bfloat16``, f32 parameters and
   Adam state): ``conf/diff.yml``'s trainer at 6 x 48000, ``--joint
   --sigma``: one bf16 step through K1 against the same step through the
   plain STFT (losses and gradients; K1 with a window defect, the control,
   rejected), against the f32 step on the same weights, batch and draws
   (near, and not equal), and on the card against the CPU at 2 x 0.5 s; a
   step of each dtype on each train batch; ``evaluate()`` on the bf16-compute
   path (K1 = 2, K2 = 2 a cv batch, K3 = 0); a checkpoint restored into a
   fresh trainer; ``cli.main`` on a bf16 copy of the yml for one epoch and
   ``--generate`` (K3 = 0); then ``ComplexTrainer`` (GCRN 8 x 48000,
   ``aia_complex_trans_ri`` 4 x 48000) and ``MagTrainer`` (GRN 8 x 48000)
   in bf16: the K1 step against the plain-STFT step, a step on each train
   batch, and ``enhance_batch`` (K1 = 1, K2 = 1);
11. the tooling around the train loop, on phase 5's corpus: the native
   train loader (``runtime/native.py``, built with ``g++`` at first use,
   the trainers' default) serves all 4 batches of an epoch at 6 x 48000,
   equal bit for bit to a numpy re-derivation of its crops (``start % (len
   - chunk + 1)`` of one ``integers(0, 2**62)`` draw a batch); ``python -m
   prior_diffuse_tpu_torch.cli --joint --sigma --profile-steps 2`` for one
   epoch in a process of its own: its Chrome trace holds one kernel record
   for each launch call and exactly 4 K1 launches (2 steps); ``cli.main
   --draw --retrain`` on that run's checkpoint: one cv batch (K1 = 2, K2 =
   2, K3 = 35), its ``draw_*`` record, and one figure call per utterance
   with the trainer's device (recorded, not drawn: this machine may have no
   matplotlib); ``spec_db`` of one figure's waveforms on the card (K1)
   against the CPU (the plain version), magnitudes within ``KERNEL_RTOL``
   of the peak; ``python -m prior_diffuse_tpu_torch.metrics.compare`` on
   the clean test set against phase 6's ``--generate`` output prints six
   finite metrics;
12. data parallelism (``parallel/``), on phase 5's corpus: ``conf/diff.yml``'s
   trainer (``--joint --sigma``) on two ranks of a gloo group sharing the
   card (this script with ``--dp-rank``, each rank a process of its own
   under a timeout): each rank's sharded train loader gives its rows of the
   one-process batch bit for bit; one step on the global batch of 6 (3 rows
   a rank) and one on a ragged 5 (padded to 6 as JAX pads it) against the
   one-process step on the same global batch, weights and draws (losses,
   group norms, BN running statistics, updates; the ranks' nets equal bit
   for bit; K1 = 2 launches a step on each rank), and ``evaluate()`` of one
   cv batch against the one process's (cv
   loss, diagnostics, the six metrics scored on rank 0; K1 = 2, K3 = 35 on
   each rank, K2 = 2 on rank 0 alone); then ``python -m
   torch.distributed.run --standalone --nproc_per_node=1 -m
   prior_diffuse_tpu_torch.cli`` on NCCL for one epoch (rank 0's log,
   metrics and checkpoints), run beside the ranks, and ``--generate``;
13. the static roofline (``utils/roofline.py``): the f32 and bf16 serving
   batch, the f32 and bf16 train step and the GCRN and DB-AIAT batches alone,
   each counted on the card (model and padded FLOPs, product bytes and the
   elementwise bracket, fused and unfused ceilings) with its kernels routed
   through their plain versions, equal in model FLOPs to the count under the
   plain versions; each timed (CUDA events and device ms) and its
   ``attained_fraction`` and ``mfu`` of both times printed, each at most
   1.05; an unknown card fails;
14. the research drivers (``prior_diffuse_tpu_torch/scripts``), each through
   its ``main`` from an empty working directory (which stays empty; no
   file of the checkout changes): ``train_demo`` at full width (``DiffUNet``
   + ``DiffUNet1``, 6 x 48000, ``--sigma``, 48 + 8 speech-like utterances)
   in f32 and in bf16 compute from one seed, ``STEPS_A`` joint steps then
   ``STEPS_B`` DDPM-only steps: every logged loss and gradient norm finite,
   K1 = 2 launches a step, ``evaluate()`` K1 = 2, K2 = 2, K3 = 35 a cv
   batch (K3 = 0 in bf16 compute), each served and prior-only batch K1 =
   K2 = 1, stage B leaving the prior's parameters unchanged bit for bit
   and moving the DDPM's, the prior's cv MSE after stage A below its value
   at step 0, the six metrics of the floor, the prior alone and the chain
   finite and the report under the run's assets; the two loss curves side
   by side; ``eval_schedules`` on the f32 run's checkpoint in f32 and bf16
   serving: seven finite rows of 0, 2, 3, 4, 6, 8 and 50 steps, each batch
   K1 = 1, K2 = 1, K3 (or K3-bf16) = 5 x (1 + steps), with its ms and RTF
   (CUDA events), and full-50's batch (255 K3 launches) through the kernels
   against the plain versions (f32 ``PATH_RTOL``, bf16 ``BF16_PATH_RMS``);
   ``diagnose_ddpm`` in both BatchNorm modes (finite; the trainer's
   parameters and buffers unchanged bit for bit); ``probe_predictability``
   for ``PROBE_STEPS`` regressor steps (finite).

Timing that no check reads is ``tools/card_numbers.py``'s.  The script
prints where its own seconds went (``{"phase_seconds": {phase: {"setup",
"check", "measure", "subprocess"}}, "total_s"}``, :class:`Accounts`), then
a JSON line of per-kernel results, and as its last line ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import glob
import json
import os
import subprocess
import sys
import tempfile
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
# K3-bf16 vs its plain version: both round y, the gate operand, comb and
# the output to bf16 at the same points from f32 sums taken in another
# order, so an output may land one bf16 step apart: 2^-7 of the largest.
KERNEL_BF16_RTOL = 2.0 ** -7
# Whole serving path: 35 K3 calls and 6 chain steps carry those
# differences through 7 UNet forwards and the squaring of decompression.
PATH_RTOL = 1e-3
# The bf16 batch through the kernels vs through the plain versions, and vs
# the f32 enhancer on the same weights and draws (relative RMS; the bounds
# are stated in PERF.md).  bf16 and f32 sit ~1e-2 apart on the card, so the
# second is held between a floor and a ceiling: a path that quietly stayed
# in f32 falls under the floor.
BF16_PATH_RMS = 2e-2
BF16_VS_F32_RMS = (1e-3, 3e-2)
# One train step through K1 against the same step through the plain STFT.
# The step is chaotic in its STFT's rounding: any change of rounding (an FFT
# in place of the plain version's float32 GEMM, torch.stft, or the plain
# STFT times 1 + 1e-8 N(0, 1)) moves a net's gradient up to ~2e-4 relative
# L2 and Adam's first update (about lr * sign(g)) up to ~1.5e-3 on this
# batch (tools/kernel_probe.py step).  So the step is held on its losses
# and on each net's gradient, 5x above that floor; the updates are
# printed, not bounded.  The check is shown to fail each run: the same
# step through K1 with the symmetric Hann window in its table (0.6 % of
# the spectrum) must miss it.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
# A step from a restored checkpoint against the same step in the trainer
# that saved it (the same STFT, cuDNN deterministic): the losses and
# gradients as above, and the updates held elementwise to 2 * lr (where
# |g| is float32 rounding, e.g. a conv bias feeding a BatchNorm, a sum in
# another order flips its sign) and in L2 over the elements whose gradient
# has the same sign in both runs and |g| >= 100 * eps (1e-6); the elements
# of opposite sign must be rounding noise: at most 1e-3 of the gradient norm.
STEP_UPDATE_RTOL = 1e-3
STEADY_GRAD = 1e-6
TRAIN_BATCH, CORPUS = 6, (24, 8)  # conf/diff.yml's batch; train, test utterances
UTTERANCE_LEN = (48000, 64000)  # the corpus's utterances: 3-4 s
PARAMS = {"dis": 1_662_565, "ddpm": 2_780_273}  # published DiffUNet, DiffUNet1
NOCON_PARAMS = 2_780_263  # the deltamu denoiser: DiffUNet1 without its preprocess
MODES = {"deltamu": {"pirorgrad": False, "deltamu": True}, "conditional": {"pirorgrad": False}}
# The bf16 enhancer on the card against the same enhancer on the CPU, on one
# x_T (relative RMS): cuDNN's bf16 convolutions, cuBLAS's bf16 products with
# an f32 output and the kernels against the CPU's bf16 convolutions and f32
# products of bf16 operands, both rounding at the same points.
BF16_CARD_VS_CPU_RMS = 2e-2
CARD_VS_CPU_LENGTH = 8000
# Phase 8: the reference oracle's parameter counts (tests/test_models.py)
PRIOR_PARAMS = {"GCRN": 9_771_340, "aia_complex_trans_ri": 1_179_030,
                "dual_aia_trans_merge_crm": 2_810_859, "dual_aia_complex_trans": 2_085_935,
                "aia_complex_trans_mag": 906_905}
# the served and trained priors, their experiment files and train batches
PRIOR_CONFS = {"GCRN": ("gcrn.yml", 8), "aia_complex_trans_ri": ("dbaiat.yml", 4),
               "GRN": ("grn.yml", 8)}
# A recurrent or attention forward on the card (cuDNN RNNs, cuBLAS products,
# TF32 off) against the same module on the CPU: float32 sums in another
# order through 301 recurrent steps; TF32 (10-bit mantissas) misses it.
CARD_VS_CPU_F32 = 1e-4
# Phase 9: GRN's parameter count (tests/test_models.py); MagTrainer's corpus
# is phase 5's with two more test utterances, so its cv loader (which keeps
# the ragged tail) ends in a batch of 2
GRN_PARAMS = 3_131_731
GRN_TEST = CORPUS[1] + 2
# bf16 serving of the complex priors, as the JAX package serves them: the
# prior-only server's bf16 waveform through the kernels against the plain
# versions, and against its f32 one on the same weights (relative RMS, a
# floor and a ceiling as BF16_VS_F32_RMS), and the bf16 enhancer on the
# card against the CPU.  DB-AIAT's bf16 forward is chaotic in its input's
# rounding: its dense blocks and attention amplify bf16 rounding flips (JAX's
# own jitted and op-by-op bf16 forwards sit 2e-2 apart; an STFT times 1 +
# 1e-7 N(0, 1) moves its prior-only waveform 9e-3 and its enhancer's 1e-3 on
# the CPU: python3 tools/bf16_trace.py --parity, --sensitivity), and its
# bf16 prior-only waveform sits 2.8e-2 from f32 on the CPU at 2 x 0.3 s; so
# its prior-only bounds are twice the others', its enhancer's the CPU
# tests' 3e-2
BF16_PRIORS = ("GCRN", "aia_complex_trans_ri")
BF16_PRIOR_ONLY_PATH_RMS = {"GCRN": BF16_PATH_RMS, "aia_complex_trans_ri": 2 * BF16_PATH_RMS}
BF16_PRIOR_VS_F32_RMS = {"GCRN": (1e-3, 3e-2), "aia_complex_trans_ri": (1e-3, 6e-2)}
BF16_PRIOR_CARD_VS_CPU_RMS = {"GCRN": 2e-2, "aia_complex_trans_ri": 3e-2}
# Phase 10, bf16 training (train.compute_dtype: bfloat16).  One bf16 train
# step through K1 against the same step through the plain STFT: bf16
# rounding flips wherever the two STFTs round apart, and the train-mode
# BatchNorms carry them, so the gradients move as far as any float32
# rounding change of the input moves them.  The plain STFT times 1 + 1e-7
# N(0, 1) (printed each run) moved the DDPM step's losses 1.6e-5 .. 5.2e-5
# and its gradients 7.0e-3 .. 8.3e-3 relative L2, the priors' losses up to
# 1.7e-5 and gradients up to 4.0e-2 (GRN); K1 itself read 6.9e-5 and
# 7.2e-3 / 7.8e-3; K1 with the symmetric Hann window (the control) moved
# the losses 9.1e-4 .. 1.3e-3 but the gradients only 8.5e-3 .. 1.1e-1 (tools/
# bf16_train_probe.py card on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
# §6).  So the losses carry the check, 4x above the floor and
# 3x below the control, and the gradients are held above their floor.
BF16_STEP_LOSS_RTOL = 3e-4
BF16_STEP_GRAD_RTOL = 0.1
BF16_STEP_CONTROL = "symmetric Hann window"  # the defect of K1 the check must reject
# the bf16 step against the f32 step on the same weights, batch and draws
# (measured on that card: losses 7.7e-5, gradients 1.0e-2): near, and not
# equal
BF16_VS_F32_STEP_GRAD = (1e-3, 0.1)
BF16_VS_F32_STEP_LOSS = 1e-3
# the bf16 step on the card against the same step on the CPU (the branch the
# tests hold to JAX), 2 x 8000 samples, explicit q-sample draws (measured:
# losses 2.7e-4, gradients 3.6e-2 / 4.2e-2): losses (relative), gradients
# (relative L2)
BF16_STEP_CARD_VS_CPU = (1e-3, 0.1)
BF16_TRAIN_PRIORS = ("GCRN", "aia_complex_trans_ri", "GRN")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


KINDS = ("setup", "check", "measure", "subprocess")


class Accounts:
    """Seconds of a run by phase and kind: builds of nets, trainers and
    corpora (``setup``), the work a ``fail(...)`` reads (``check``), timing
    and profiling (``measure``), child processes (``subprocess``).  Each
    second goes to the phase last named by :meth:`phase` and to the
    innermost open :meth:`spent` block (``check`` outside any)."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.name, self.kinds, self.seconds = "0-1", ["check"], {}

    def _book(self) -> None:
        now = time.perf_counter()
        row = self.seconds.setdefault(self.name, dict.fromkeys(KINDS, 0.0))
        row[self.kinds[-1]] += now - self.t
        self.t = now

    def phase(self, name: str) -> None:
        self._book()
        self.name = name

    @contextmanager
    def spent(self, kind: str):
        if kind not in KINDS:
            raise ValueError(f"kind {kind!r} is not one of {KINDS}")
        self._book()
        self.kinds.append(kind)
        try:
            yield
        finally:
            self._book()
            self.kinds.pop()

    def line(self) -> dict:
        """``{"phase_seconds": {phase: {kind: s}}, "total_s": s}``."""
        self._book()
        return {"phase_seconds": {p: {k: round(s, 3) for k, s in row.items()}
                                  for p, row in self.seconds.items()},
                "total_s": round(self.t - self.t0, 3)}


ACCOUNTS = Accounts()


def spent(kind: str):
    """Book the block's seconds under ``kind`` (:class:`Accounts`)."""
    return ACCOUNTS.spent(kind)


def booked(kind: str):
    """Decorate a function so that each call's seconds go to ``kind``."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with spent(kind):
                return fn(*args, **kwargs)
        return inner
    return deco


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


@booked("measure")
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


@booked("measure")
def in_turns(kernel, library) -> dict:
    """Kernel against its library yardstick in turns (kernel, library,
    library, kernel): ``ms`` and ``library_ms`` are the slower of each pair,
    ``*_turns`` both readings; the kernel is slower only if it is so in
    both turns."""
    k1, l1, l2, k2 = cuda_ms(kernel), cuda_ms(library), cuda_ms(library), cuda_ms(kernel)
    return {"ms": max(k1, k2), "library_ms": max(l1, l2),
            "ms_turns": [k1, k2], "library_ms_turns": [l1, l2],
            "slower_than_library": k1 > l1 and k2 > l2}


@booked("measure")
def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn`` from CUDA-graph replays (``calls``
    calls a graph, ``replays`` replays between two CUDA events), so the
    host's pace does not enter."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


@booked("measure")
def device_ms(fn, calls: int = 5):
    """Summed device time (kernels, copies, fills) per call of ``fn`` in ms,
    from a ``torch.profiler`` pass over ``calls`` calls after a warm-up; a
    pass that records no device event is repeated (twice at most), then
    the result is None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = device_us(prof)
        if us > 0:
            return us / calls / 1e3
    return None


def device_us(prof) -> float:
    """The summed duration in us of a finished profile's device events
    (kernels, copies, fills), read from its kineto events: what
    ``prof.events()`` sums as the ``device_time_total`` of its CUDA events,
    without the event tree that ``events()`` builds in Python (seconds for a
    train step's ~10,000 launches).  An annotated range (the optimizer's
    step) on the device timeline spans kernels counted on their own."""
    from torch.autograd import DeviceType

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
               and not getattr(e, "is_hidden_event", lambda: False)()) / 1e3


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def sxm() -> dict:
    """The published dense peaks of an H100 SXM (f32 outside the tensor
    cores, TF32 and bf16 on them) and its HBM3 rate: the entry of
    ``utils/roofline.py::CHIP_SPECS`` that every kernel's bound is taken
    against, whatever card runs."""
    from prior_diffuse_tpu_torch.utils.roofline import CHIP_SPECS

    return CHIP_SPECS["H100 80GB HBM3"]


def bound(flops: float, nbytes: float, peak: str = "peak_f32") -> dict:
    """Least time of the work on the card: the larger of the bytes over the
    memory rate and the operations over the ``peak`` of :func:`sxm`
    (default the f32 non-tensor rate)."""
    t_ops, t_bytes = flops / sxm()[peak], nbytes / sxm()["hbm_bytes_per_s"]
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def fft_flops(frames: int, n: int = 320) -> float:
    """A real n-point FFT per frame (2.5 n log2 n) plus its window product."""
    return frames * (2.5 * n * np.log2(n) + n)


def stft_bound(b: int, length: int) -> dict:
    t = length // 160 + 1
    return bound(fft_flops(b * t), 4 * (b * length + b * t * 161 * 2))


def istft_bound(b: int, t: int, length: int) -> dict:
    # plus the overlap-add and the envelope divide of each output sample
    return bound(fft_flops(b * t) + 2 * b * length, 4 * (b * t * 161 * 2 + b * length))


def enc_stage_work(xin, ops, pad: int) -> tuple:
    """(operations, bytes) of one f32 encoder stage: per output row the
    window product [K] x [K, 64], the two 32 x 32 gate blocks and W2 [32,
    64]; the stage input, operands, per-batch bias and output once each."""
    b, tin, f, c = xin.shape
    k = ops["kernel_f"]
    rows = b * (tin - 1 + pad) * ((f - k) // 2 + 1)
    flops = rows * 2 * (2 * k * c * 64 + 2 * 32 * 32 + 32 * 64)
    operands = sum(ops[n].numel() * ops[n].element_size()
                   for n in ("wmain", "wg", "bg", "w2", "b2", "alpha"))
    nbytes = xin.element_size() * (xin.numel() + rows * 64) + operands + 4 * b * 64
    return flops, nbytes


def enc_stage_bf16_work(x, ops, *biases) -> tuple:
    """(operations, bytes) of one whole bf16 encoder stage on its input ``x
    [B, T, F, C]`` and per-batch ``biases`` (a broadcast one counted once):
    the f32 stage's products plus, at stages 2-5, conv1 [64] x [64, 32] per
    input pixel; the input (64 channels at stages 2-5), the output, the
    product weights, biases and alpha once each."""
    b, t, f, c = x.shape
    k = ops["kernel_f"]
    rows = b * t * ((f - k) // 2 + 1)
    flops = rows * 2 * (2 * k * min(c, 32) * 64 + 2 * 32 * 32 + 32 * 64)
    weights = [ops[n] for n in ("wmain", "wg", "bg", "w2", "b2", "alpha")]
    if ops["pre"] is not None:
        flops += b * t * f * 2 * 64 * 32
        weights.append(ops["pre"][0])
    nbytes = (2 * (x.numel() + rows * 64) + sum(w.numel() * w.element_size() for w in weights)
              + sum(4 * (v.shape[1] if v.stride(0) == 0 else v.numel())
                    for v in biases if v is not None))
    return flops, nbytes


def max_err(got, want) -> tuple[float, float]:
    """(max|got - want|, max|want|), after checking shapes and finiteness."""
    import torch

    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail("non-finite values")
    got, want = got.float(), want.float()
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


def expect_istft_close(label: str, spec, out_len: int) -> float:
    """K2 against its plain version at ``out_len``, both times the
    window-square envelope they divide by: the last frame's tail is divided
    by an envelope down to ~1e-8 (both versions), which scales float32
    rounding by 1/env, so the numerators of that division are compared."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.signal.stft import _envelope_np

    env = np.ones(out_len)
    tail = _envelope_np(spec.shape[1], 320, 160)[160:160 + out_len]
    env[:len(tail)] = tail
    env = torch.tensor(env, dtype=torch.float32, device=spec.device)
    return expect_close(f"{label} {tuple(spec.shape)} length {out_len} (x envelope)",
                        kstft.istft(spec, out_len) * env,
                        kstft.istft_plain(spec, length=out_len) * env)


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


@booked("setup")
def seeded_nets(seed: int, device, classes=None):
    """Full-width nets (``DiffUNet`` and ``DiffUNet1`` unless ``classes``
    names others) with weights drawn from an explicit
    generator: uniform(+-1/sqrt(fan_in)) kernels and biases (recurrent
    weights +-1/sqrt(hidden), the attention's products the same), PReLU
    slopes in [0.1, 0.4], BN and layer-norm scale/shift near 1/0 and BN
    running statistics mean ~ N(0, 0.1), var ~ U(0.5, 1.5) (not the 0/1
    defaults, so the folded BN is exercised)."""
    import torch
    import torch.nn as nn

    from prior_diffuse_tpu_torch.models import dbaiat, layers
    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet, DiffUNet1

    g = torch.Generator().manual_seed(seed)
    norms = (nn.LayerNorm, dbaiat.LayerNormOverF, dbaiat.GroupNorm1)
    nets = []
    for net in (cls() for cls in (classes or (DiffUNet, DiffUNet1))):
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, norms):
                    m.weight.uniform_(0.8, 1.2, generator=g)
                    m.bias.uniform_(-0.1, 0.1, generator=g)
                elif isinstance(m, nn.RNNBase):
                    for w in m.parameters():
                        w.uniform_(-m.hidden_size ** -0.5, m.hidden_size ** -0.5, generator=g)
                elif isinstance(m, layers.MultiHeadAttention):
                    for w in m.parameters():
                        w.uniform_(-m.in_proj_weight.shape[1] ** -0.5,
                                   m.in_proj_weight.shape[1] ** -0.5, generator=g)
                elif isinstance(m, nn.modules.batchnorm._BatchNorm):
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
            mock.patch.object(convblock, "enc_stage", convblock.enc_stage_plain), \
            mock.patch.object(convblock, "enc_stage_bf16", convblock.enc_stage_bf16_plain):
        yield


def counters():
    from prior_diffuse_tpu_torch.ops.cuda import convblock, stft as kstft

    return {"stft": kstft.stft, "istft": kstft.istft, "enc_stage": convblock.enc_stage,
            "enc_stage_bf16": convblock.enc_stage_bf16}


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
    window = torch.hann_window(320, device=device)
    # the one PyTorch call that computes K1's function (a yardstick only)
    lib_stft = lambda: torch.view_as_real(torch.stft(
        wav, 320, 160, window=window, center=True, pad_mode="reflect",
        return_complex=True).transpose(1, 2))
    expect_close("torch.stft (yardstick)", lib_stft(), want)
    rows["stft"] = {"max_abs_err": err, **in_turns(lambda: kstft.stft(wav), lib_stft),
                    "plain_ms": cuda_ms(lambda: kstft.stft_plain(wav)),
                    "device_ms": device_ms(lambda: kstft.stft(wav)),
                    "graph_ms": graph_ms(lambda: kstft.stft(wav)),
                    "library_device_ms": device_ms(lib_stft),
                    **stft_bound(BATCH, LENGTH)}

    spec = want
    ref = kstft.istft_plain(spec, length=LENGTH)
    err = expect_close(f"K2 istft {tuple(spec.shape)}", kstft.istft(spec, LENGTH), ref)
    lib_istft = lambda: torch.istft(
        torch.view_as_complex(spec).transpose(1, 2), 320, 160, window=window,
        center=True, length=LENGTH)
    expect_close("torch.istft (yardstick)", lib_istft(), ref)
    # a spectrum no STFT made: Im X[0] and Im X[160] nonzero, which K2
    # (as the plain inverse) must ignore
    g = torch.Generator(device=device).manual_seed(12)
    raw = torch.randn(BATCH, T_FRAMES, 161, 2, generator=g, device=device)
    if not bool((raw[..., [0, 160], 1] != 0).all()):
        fail("the random spectrum has a zero DC or Nyquist imaginary part")
    err_raw = expect_close(f"K2 istft {tuple(raw.shape)} random spectrum",
                           kstft.istft(raw, LENGTH), kstft.istft_plain(raw, length=LENGTH))
    rows["istft"] = {"max_abs_err": err, "max_abs_err_random_spectrum": err_raw,
                     **in_turns(lambda: kstft.istft(spec, LENGTH), lib_istft),
                     "plain_ms": cuda_ms(lambda: kstft.istft_plain(spec, length=LENGTH)),
                     "device_ms": device_ms(lambda: kstft.istft(spec, LENGTH)),
                     "graph_ms": graph_ms(lambda: kstft.istft(spec, LENGTH)),
                     "library_device_ms": device_ms(lib_istft),
                     **istft_bound(BATCH, T_FRAMES, LENGTH)}
    for name in ("stft", "istft"):
        r = rows[name]
        # torch.istft reads back to the host on every call (its envelope
        # check), which stalls the stream and favours the kernel on events;
        # the profiler's device times compare the work alone
        r["slower_on_device"] = (None if None in (r["device_ms"], r["library_device_ms"])
                                 else r["device_ms"] > r["library_device_ms"])
        print(f"{name}: {r['ms_turns']} ms (device {fmt(r['device_ms'])}, graph "
              f"{fmt(r['graph_ms'])}) vs library "
              f"{r['library_ms_turns']} ms (device {fmt(r['library_device_ms'])}); bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); slower than the library: "
              f"{r['slower_than_library']} on events, {r['slower_on_device']} on device",
              flush=True)

    # K3's rows: the five stages of one DiffUNet1 forward, in f32 and in
    # bf16; no single PyTorch call computes a stage (conv, two 1x1 gate
    # convs, the cross gate, a 1x1 conv and PReLU), so no library yardstick
    for key, dtype in (("enc_stage", torch.float32), ("enc_stage_bf16", torch.bfloat16)):
        g = torch.Generator(device=device).manual_seed(2)
        worst = 0.0
        for name, net in zip(("DiffUNet", "DiffUNet1"), nets):
            temb = None
            if name == "DiffUNet1":
                t = torch.rand(BATCH, generator=g, device=device) * 40.0  # fractional t
                temb = net.time_embedding(t).to(dtype)
            x = torch.randn(BATCH, T_FRAMES, 161, 2, generator=g, device=device).to(dtype)
            err, k3 = check_encoder(name, cb.pack_encoder(net.core.en, dtype), x, temb)
            worst = max(worst, err)
        rows[key] = {"max_abs_err": worst, **k3, "library_ms": None,
                     "library_device_ms": None}
    check_bf16_keeps_y_f32(device)
    return rows


def check_bf16_keeps_y_f32(device) -> None:
    """K3-bf16 on a serving-size stage-2 input of 64 channels whose conv1 is
    an exact embedding (W1 picks channels 0-31, bias1 = 0, so conv1's
    output is those channels, and its pad frame zeros), and whose left and
    right window halves carry biases of +48 and -48 under constant gates
    (wg = 0): y is large and the cross gate small.  Inputs and weights on
    coarse binary grids make y exact in f32 in any summation order.  The
    kernel must meet its bound against the plain version, and a chain that
    rounds y to bf16 before the combine must miss it."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb

    g = torch.Generator(device=device).manual_seed(13)
    grid = lambda shape, n, scale: (torch.randint(-n, n + 1, shape, generator=g,
                                                  device=device) / scale).bfloat16()
    w1 = torch.zeros(64, 32, device=device, dtype=torch.bfloat16)
    w1[torch.arange(32), torch.arange(32)] = 1.0
    ops = cb.pack_wgmma({
        "kernel_f": 3, "pre": (w1, torch.zeros(32, device=device)), "wcsum": None,
        "wmain": grid((192, 64), 4, 16.0),
        "wg": torch.zeros(64, 64, device=device, dtype=torch.bfloat16),
        "bg": torch.zeros(64, device=device), "w2": grid((32, 64), 8, 16.0),
        "b2": torch.zeros(64, device=device), "alpha": torch.tensor([0.25], device=device)})
    x = grid((BATCH, T_FRAMES, 79, 64), 8, 8.0)
    bias_b = torch.cat([torch.full((BATCH, 32), 48.0, device=device),
                        torch.full((BATCH, 32), -48.0, device=device)], dim=1)
    bias1 = torch.zeros(BATCH, 32, device=device)
    want = cb.enc_stage_bf16_plain(x, ops, bias_b, bias1)
    expect_close(f"K3-bf16 stage 2 {tuple(x.shape)}, cancelling gate halves",
                 cb.enc_stage_bf16(x, ops, bias_b, bias1), want, KERNEL_BF16_RTOL)
    # the plain chain with y rounded to bf16 before the cross gate, on the
    # padded conv1 output
    xin = cb.conv1_input(x, w1, bias1)
    if not torch.equal(xin[:, 1:], x[..., :32]) or bool(xin[:, 0].any()):
        fail("the embedding conv1 is not exact")
    t, fo = xin.shape[1] - 1, (xin.shape[2] - 3) // 2 + 1
    col = torch.cat([xin[:, kt:kt + t, kf:kf + 2 * (fo - 1) + 1:2]
                     for kt in range(2) for kf in range(3)], dim=-1).float()
    y = (col @ ops["wmain"].float() + bias_b[:, None, None]).bfloat16().float()
    m = y @ ops["wg"].float() + ops["bg"]
    comb = y[..., :32] * torch.sigmoid(m[..., 32:]) + y[..., 32:] * torch.sigmoid(m[..., :32])
    y2 = comb.bfloat16().float() @ ops["w2"].float() + ops["b2"]
    err, ref = max_err(torch.where(y2 >= 0, y2, ops["alpha"] * y2).bfloat16(), want)
    print(f"  a chain with y in bf16: max|err| {err:.3e} (bound {KERNEL_BF16_RTOL * ref:.3e})",
          flush=True)
    if err <= 4 * KERNEL_BF16_RTOL * ref:
        fail("the cancelling-stage check does not tell y in bf16 from y in f32")


def check_encoder(name, packed, x, temb):
    """K3 against its plain version at the five stages of one encoder, from
    its input ``x [B, T, 161, C]``; returns the largest error and a row of
    the kernel's and plain version's times, its device time and its
    bounds, summed over the stages (bf16: each stage's device and graph ms
    and bound, and the five stages with their glue, ``encoder_fused``)."""
    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb

    import torch

    bf16 = packed[0][0]["wmain"].dtype == torch.bfloat16
    label, rtol, peak = ("K3-bf16", KERNEL_BF16_RTOL, "peak_bf16") if bf16 else (
        "K3", KERNEL_RTOL, "peak_f32")
    worst, ms_sum, plain_sum, dev_sum, graph_sum, flops, nbytes = (0.0,) * 7
    stages = {"stage_device_ms": [], "stage_graph_ms": [], "stage_bound_ms": []}
    x0 = x
    for i, (ops, tp) in enumerate(packed, start=1):
        if bf16:  # the whole stage, conv1 included, on the last stage's output
            args = (x, ops, *cb.stage_biases(x, ops, tp, temb))
            kernel, plain = cb.enc_stage_bf16, cb.enc_stage_bf16_plain
            f, nb = enc_stage_bf16_work(*args)
        else:
            xin, bias_b, pad = cb.stage_inputs(x, ops, tp, temb)
            args = (xin, ops, bias_b, pad)
            kernel, plain = cb.enc_stage, cb.enc_stage_plain
            f, nb = enc_stage_work(xin, ops, pad)
        want = plain(*args)
        err = expect_close(f"{label} {name} stage {i} {tuple(args[0].shape)}",
                           kernel(*args), want, rtol)
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        dev = device_ms(lambda: kernel(*args))
        gms = graph_ms(lambda: kernel(*args))
        b = bound(f, nb, peak)
        print(f"    {ms:.4f} ms (device {fmt(dev)}, graph {gms:.4f}), plain {plain_ms:.4f} "
              f"ms; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}), {f / ms / 1e9:.1f} TFLOP/s",
              flush=True)
        worst, ms_sum, plain_sum = max(worst, err), ms_sum + ms, plain_sum + plain_ms
        graph_sum += gms
        dev_sum = None if dev is None or dev_sum is None else dev_sum + dev
        flops, nbytes = flops + f, nbytes + nb
        for key, v in zip(stages, (dev, gms, b["bound_ms"])):
            stages[key].append(v)
        x = want  # both versions see the same input at the next stage
    row = {"ms": ms_sum, "plain_ms": plain_sum, "device_ms": dev_sum, "graph_ms": graph_sum,
           **bound(flops, nbytes, peak)}
    if bf16:
        # the five stages as the serving path runs them, with their glue (the
        # time projections, the bias sums, the casts)
        enc = lambda: cb.encoder_fused(x0, packed, temb)
        _, launches = top_kernels(enc)
        row.update(stages, encoder_device_ms=device_ms(enc), encoder_graph_ms=graph_ms(enc),
                   encoder_launches=launches)
        print(f"  {label} {name} per stage: device ms "
              + ", ".join(fmt(v) for v in stages["stage_device_ms"]) + "; graph ms "
              + ", ".join(f"{v:.4f}" for v in stages["stage_graph_ms"]) + "; bound ms "
              + ", ".join(f"{v:.4f}" for v in stages["stage_bound_ms"])
              + f"; the encoder with its glue: device {fmt(row['encoder_device_ms'])} ms, "
              f"graph {row['encoder_graph_ms']:.4f} ms, {launches} launches", flush=True)
    else:  # the 3xTF32 split does three TF32 products for each f32 one
        row["bound_3xtf32_ms"] = 3 * flops / sxm()["peak_tf32"] * 1e3
    return worst, row


def check_edge_shapes(device, nets):
    """Kernels against their plain versions off the main path's shapes:
    batch 1 and 3, the shortest signal (161 samples), lengths that are not
    multiples of 160, output lengths trimmed and zero-padded, K2 on random
    spectra at its tile's edges, and encoder stages with 1-3 frames
    (partial tiles on every edge)."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft

    for b, n in [(1, 161), (3, 16037), (2, 10241), (1, 48000), (3, 2017)]:
        wav = torch.from_numpy(speechlike(b, n, n)).to(device)
        spec = kstft.stft_plain(wav)
        expect_close(f"K1 stft {tuple(wav.shape)}", kstft.stft(wav), spec)
        for out_len in (n, max(n - 100, 1), n + 333):
            expect_istft_close("K2 istft", spec, out_len)
    g = torch.Generator(device=device).manual_seed(3)
    # for each tile K2 is built for (the path's and the others): T = 1, one
    # tile, one tile and one frame, two tiles and one frame; an output
    # shorter than one row, one that ends inside row T, one that reaches 2
    # rows past T (zero pad)
    for rows in kstft.ISTFT_TILES:
        with mock.patch.object(kstft, "ISTFT_ROWS", rows):
            for b in (1, 3):
                for t_frames in (1, rows, rows + 1, 2 * rows + 1):
                    raw = torch.randn(b, t_frames, 161, 2, generator=g, device=device)
                    for out_len in (100, t_frames * 160 - 50, (t_frames + 2) * 160 + 37):
                        expect_istft_close(f"K2 istft ({rows} rows a block) random spectrum",
                                           raw, out_len)
    # every stage at 1-3 frames, batch 1 and 3, and frame counts that are
    # not a multiple of any stage's time tile; K3 and K3-bf16
    for dtype, kernel, label, rtol in (
            (torch.float32, cb.enc_stage, "K3", KERNEL_RTOL),
            (torch.bfloat16, cb.enc_stage_bf16, "K3-bf16", KERNEL_BF16_RTOL)):
        packed = cb.pack_encoder(nets[1].core.en, dtype)
        for b, t_frames in [(1, 1), (3, 2), (1, 3), (3, 37), (1, 150)]:
            temb = nets[1].time_embedding(
                torch.rand(b, generator=g, device=device) * 40.0).to(dtype)
            x = torch.randn(b, t_frames, 161, 2, generator=g, device=device).to(dtype)
            for i, (ops, tp) in enumerate(packed, start=1):
                if dtype == torch.bfloat16:
                    args = (x, ops, *cb.stage_biases(x, ops, tp, temb))
                    x = cb.enc_stage_bf16_plain(*args)
                else:
                    xin, bias_b, pad = cb.stage_inputs(x, ops, tp, temb)
                    args = (xin, ops, bias_b, pad)
                    x = cb.enc_stage_plain(*args)
                expect_close(f"{label} stage {i} {tuple(args[0].shape)}", kernel(*args), x, rtol)


def rel_rms(got, want) -> float:
    """Relative RMS difference, after checking shapes and finiteness."""
    import torch

    max_err(got, want)
    got, want = got.double(), want.double()
    return float(torch.sqrt(torch.mean((got - want) ** 2) / torch.mean(want ** 2)))


def run_main_path(device, dis, ddpm, dtype, mode: str = "pirorgrad",
                  sigmas=(False, True)) -> dict:
    """Phase 3 (pirorgrad), 7a (the other modes) or 8 (another prior) in
    ``dtype``: a batch for each of ``sigmas`` (``--sigma`` off, on) through
    the kernels, against the same enhancer through the plain versions and
    (bf16) against f32 on one ``x_T``, with its launch counts.  Returns the
    launch counts of each batch by path name (:func:`serve_path`); its times
    are ``tools/card_numbers.py``'s."""
    import torch

    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    bf16 = dtype == torch.bfloat16
    # a prior other than the DiffUNet runs unpacked: K3 in the 6 DDPM forwards
    packed_prior = isinstance(dis, DiffUNet)
    want = {"stft": 1, "istft": 1,
            "enc_stage_bf16" if bf16 else "enc_stage": 35 if packed_prior else 30}
    wav = speechlike(BATCH, LENGTH, 3)
    counts = {}
    for sigma in sigmas:
        label = serve_label(dis, mode, dtype, sigma)
        with spent("setup"):
            enh = Enhancer(dis, ddpm, mode_config(mode), device=device, sigma=sigma, dtype=dtype)
        if enh.mode != mode:
            fail(f"the enhancer serves {enh.mode}, not {mode}")
        reset_counts()
        out = enh.enhance_batch(wav, torch.Generator(device=device).manual_seed(4))
        torch.cuda.synchronize()
        path = serve_path(dis, mode, dtype, sigma)
        if enh._graphs:  # a first batch on the card runs eagerly, then is captured
            counts[path] = expect_counts(f"one batch [{label}], its eager run and its capture",
                                         {k: 2 * v for k, v in want.items()})
        else:
            counts[path] = expect_counts(f"one batch [{label}]", want)
        reset_counts()
        with plain_versions():  # op by op: a bf16 replay would run the kernels
            ref = enh.eager_batch(wav, torch.Generator(device=device).manual_seed(4))
        torch.cuda.synchronize()
        if any(read_counts().values()):
            fail("the plain reference run launched a kernel")
        if out.shape != (BATCH, LENGTH) or out.dtype != torch.float32:
            fail(f"enhance_batch [{label}] returned {tuple(out.shape)} {out.dtype}")
        if bf16:
            err = rel_rms(out, ref)
            print(f"enhance_batch [{label}] {tuple(out.shape)}: kernels vs plain versions rel "
                  f"RMS {err:.3e} (bound {BF16_PATH_RMS:g})", flush=True)
            if err > BF16_PATH_RMS:
                fail(f"enhance_batch [{label}] disagrees with its plain-version run")
            # bf16 against f32 on the same weights and the same initial draw
            x_T = torch.randn((1, BATCH, T_FRAMES, 161, 2), device=device,
                              generator=torch.Generator(device=device).manual_seed(7))
            with spent("setup"):
                f32 = Enhancer(dis, ddpm, mode_config(mode), device=device, sigma=sigma)
            vs = rel_rms(enh.enhance_batch(wav, x_T=x_T), f32.enhance_batch(wav, x_T=x_T))
            lo, hi = BF16_VS_F32_RMS
            print(f"enhance_batch [{label}] vs f32 on the same weights and x_T: rel RMS "
                  f"{vs:.3e} (bounds {lo:g} .. {hi:g})", flush=True)
            if vs > hi:
                fail(f"enhance_batch [{label}] strays from the f32 batch")
            if vs < lo:
                fail(f"enhance_batch [{label}] is the f32 batch: it did not run in bf16")
        else:
            err, refmax = max_err(out, ref)
            print(f"enhance_batch [{label}] {tuple(out.shape)}: max|kernels - plain| "
                  f"{err:.3e} (bound {PATH_RTOL * refmax:.3e}, max|ref| {refmax:.3e})",
                  flush=True)
            if err > PATH_RTOL * refmax:
                fail(f"enhance_batch [{label}] disagrees with its plain-version run")
    return counts


def serve_label(dis, mode: str, dtype, sigma: bool) -> str:
    """The words that name a serving batch in the lines of both scripts."""
    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet

    return (("" if isinstance(dis, DiffUNet) else f"{type(dis).__name__} prior, ")
            + f"{mode}, {'bf16' if str(dtype) == 'torch.bfloat16' else 'f32'}, "
            + ("sigma" if sigma else "plain"))


def serve_path(dis, mode: str, dtype, sigma: bool) -> str:
    """A serving batch's path name in the ``kernels`` line's launch counts."""
    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet

    return ("serve_batch" + ("" if isinstance(dis, DiffUNet) else f"_{type(dis).__name__}")
            + ("" if mode == "pirorgrad" else f"_{mode}")
            + ("_bf16" if str(dtype) == "torch.bfloat16" else "") + ("_sigma" if sigma else ""))


@booked("measure")
def top_kernels(fn, n: int = 8, calls: int = 2) -> tuple:
    """``([(kernel name, device ms per call, launches per call)], all
    kernel launches per call)``: the ``n`` kernels with the most device
    time in ``fn``, from the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key[:60], e.device_time_total / calls / 1e3, e.count // calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])[:n], sum(r[2] for r in rows)


def serve_requests(device, nets, dtype):
    """Phase 4: five requests of 1-4 s through enhance_files in ``dtype``."""
    import torch

    from prior_diffuse_tpu_torch.config import ExperimentConfig, TrainConfig
    from prior_diffuse_tpu_torch.serving.enhance import enhance_files
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    enh = Enhancer(*nets, ExperimentConfig(train=TrainConfig(batch_size=BATCH)),
                   device=device, dtype=dtype)
    lengths = [16000, 23456, 40000, 64000, 31234]
    wavs = [0.1 * speechlike(1, n, 10 + i)[0] for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    outs = enhance_files(enh, wavs, torch.Generator(device=device).manual_seed(6))
    wall = time.perf_counter() - t0
    for w, o in zip(wavs, outs):
        if o.shape != w.shape or not np.isfinite(o).all():
            fail(f"enhance_files returned {o.shape} for {w.shape} or non-finite values")
    print(f"enhance_files [{str(dtype)[6:]}]: {len(wavs)} requests, {sum(lengths) / SR:.2f} s "
          f"of audio, lengths {lengths} -> ok ({wall * 1e3:.1f} ms wall incl. host)", flush=True)


LONG_SECONDS = 30


def serve_long(device, nets, card) -> dict:
    """Phase 4b: one 30 s wav through ``enhance_long`` with the bf16
    enhancer (11 segments of 3 s, 2 blocks) and through its bf16
    ``prior_only_server`` (the prior's module forward on a bf16 copy, as
    the JAX package's: no K3): shapes, finiteness, a seam-free join, the
    call's wall time (the first: it also casts the prior and picks cuDNN's
    plans; ``tools/card_numbers.py`` times a second); returns the launch
    counts."""
    import torch

    from prior_diffuse_tpu_torch.config import ExperimentConfig, TrainConfig
    from prior_diffuse_tpu_torch.serving.enhance import prior_only_server
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
    from prior_diffuse_tpu_torch.serving.streaming import enhance_long

    enh = Enhancer(*nets, ExperimentConfig(train=TrainConfig(batch_size=BATCH)),
                   device=device, dtype=torch.bfloat16)
    wav = 0.1 * speechlike(1, LONG_SECONDS * SR, 20)[0]
    segment, overlap = LENGTH, LENGTH // 10
    hop = segment - overlap
    blocks = -(-len(range(0, len(wav) - overlap, hop)) // BATCH)
    counts = {}
    for name, server in (("enhance_long_bf16", enh),
                         ("prior_only_long_bf16", prior_only_server(enh))):
        reset_counts()
        t0 = time.perf_counter()
        out = enhance_long(server, wav, torch.Generator(device=device).manual_seed(9),
                           segment=segment, overlap=overlap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = 35 * blocks if server is enh else 0  # the prior-only server: the module forward
        want = {"stft": blocks, "istft": blocks, "enc_stage_bf16": k3}
        if server is enh and enh._graphs:  # each block ran eagerly, then was captured
            want = {k: 2 * v for k, v in want.items()}
        counts[name] = expect_counts(name, want)
        if out.shape != wav.shape or not np.isfinite(out).all():
            fail(f"{name} returned {out.shape} for {wav.shape} or non-finite values")
        jumps = np.abs(np.diff(out))
        seam = np.zeros(len(jumps), bool)
        for st in range(hop, len(wav) - 1, hop):
            seam[max(st - overlap, 0): st + 1] = True
        ratio = float(jumps[seam].max() / jumps[~seam].max())
        print(f"{name}: {LONG_SECONDS} s in {blocks} blocks of {BATCH} x {segment}, "
              f"{wall * 1e3:.1f} ms wall incl. host; largest step inside the crossfades / "
              f"outside: {ratio:.3f} (bound 4); card {card}", flush=True)
        if ratio > 4.0:
            fail(f"{name}: the crossfade joins jump")
    return counts


RECORDING_SEGMENTS = 45  # a block of 32 and one of 13: the recordings cell's longest


def serve_recording(device, nets, card) -> dict:
    """Phase 4c: one 45-segment bf16 recording (~119 s) through
    ``enhance_long`` in blocks of 32 segments, whose blocks replay the CUDA
    graphs of their rungs (32 rows, and 13 rows padded to 16), against the
    same call with every graph's capture and replay its eager forward on
    the same static buffers (eager at the same padding): bit for bit; the
    replayed call's kernels from a device trace (K1 2, K2 2, K3-bf16 70;
    a replay runs no wrapper, so the wrappers' counters stay), its
    ``enh.graph_*`` counters under that trace (2 replays, 0 captures, 3 pad
    rows), and both calls' ms (host clock; each ends in the read-back).
    Returns the traced launch counts."""
    import torch

    from prior_diffuse_tpu_torch.config import ExperimentConfig, TrainConfig
    from prior_diffuse_tpu_torch.serving.enhancer import BatchGraph, Enhancer
    from prior_diffuse_tpu_torch.serving.streaming import enhance_long
    from prior_diffuse_tpu_torch.utils import profiler

    segment, overlap = LENGTH, LENGTH // 10
    wav = 0.1 * speechlike(1, (RECORDING_SEGMENTS - 1) * (segment - overlap) + overlap + 1000,
                           21)[0]
    cfg = ExperimentConfig(train=TrainConfig(batch_size=32))

    def call(enh):
        t0 = time.perf_counter()
        out = enhance_long(enh, wav, torch.Generator(device=device).manual_seed(12),
                           segment=segment, overlap=overlap)
        return out, (time.perf_counter() - t0) * 1e3

    graphed = Enhancer(*nets, cfg, device=device, dtype=torch.bfloat16)
    eager = Enhancer(*nets, cfg, device=device, dtype=torch.bfloat16)
    with spent("setup"):
        call(graphed)  # the eager run and capture of each rung
    if sorted(graphed._graphs) != [(16, segment), (32, segment)]:
        fail(f"enhance_long [graphed] kept the graphs {sorted(graphed._graphs)}")
    reset_counts()
    with spent("measure"):
        got, graph_ms = call(graphed)
    expect_counts("enhance_long [graphed, 45 segments], the wrappers' counters", {})

    def replayed() -> dict:  # the program's graph counters of one traced call
        call(graphed)
        return {k: v for k, v in profiler.counters().items() if k.startswith("enh.graph_")}

    profiler.reset()
    counted, counts = traced_counts("enhance_long [graphed, 45 segments]", replayed,
                                    {"stft": 2, "istft": 2, "enc_stage_bf16": 70})
    profiler.reset()
    with mock.patch.object(BatchGraph, "capture", BatchGraph.forward), \
            mock.patch.object(BatchGraph, "replay", BatchGraph.forward):
        with spent("setup"):
            call(eager)
        with spent("measure"):
            want, eager_ms = call(eager)
    diff = float(np.max(np.abs(got - want)))
    print(f"enhance_long [bf16, {RECORDING_SEGMENTS} segments of {segment}, blocks of 32]: "
          f"graphed {graph_ms:.1f} ms, eager at the same padding {eager_ms:.1f} ms; "
          f"max|graphed - eager| {diff:.3e} (bound 0); counters {counted}; card {card}",
          flush=True)
    if diff != 0:
        fail("enhance_long: the graphed recording differs from the eager one")
    want_counters = {"enh.graph_replays": 2, "enh.graph_captures": 0, "enh.graph_pad_rows": 3}
    if {k: counted.get(k, 0) for k in want_counters} != want_counters:
        fail(f"enhance_long [graphed]: counters {counted}, expected {want_counters}")
    return {"enhance_long_graphed_bf16": counts}


def traced_launches(prof) -> dict:
    """Each hand-written kernel's launches in a finished profile, by the
    name of its wrapper (:func:`counters`), counted from the device trace
    (a CUDA-graph replay runs the kernels without their wrappers)."""
    import re

    from torch.autograd import DeviceType

    kernels = {"stft": "stft_kernel", "istft": "istft_kernel", "enc_stage": "enc_chain_kernel",
               "enc_stage_bf16": "enc_chain_bf16_kernel"}
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return {k: sum(bool(re.search(rf"(^|::|\s){kernels[k]}[<(]", n)) for n in names)
            for k in counters()}


def traced_counts(what: str, fn, want: dict) -> tuple:
    """Run ``fn`` under a device trace and fail unless its hand-written
    kernels ran ``want`` times (a kernel it leaves out: 0): the count of a
    path that replays a CUDA graph, whose kernels run without their
    wrappers.  Returns ``fn``'s result and the counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    got = traced_launches(prof)
    want = {k: want.get(k, 0) for k in got}
    print(f"launches in {what}, from the device trace: {got}", flush=True)
    if got != want:
        fail(f"launch counts in {what}: {got} on the device, expected {want}")
    return out, got


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def expect_counts(what: str, want: dict) -> dict:
    """Fail unless the launch counts are ``want`` (a kernel it leaves out: 0)."""
    got = read_counts()
    want = {k: want.get(k, 0) for k in got}
    print(f"launches in {what}: {got}", flush=True)
    if got != want:
        fail(f"launch counts in {what}: {got}, expected {want}")
    return got


def metric_records(log_dir: str) -> list:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def logged_step_ms(steps: list, what: str) -> list:
    """The ``step_time_ms`` of a run's train records, as the JAX trainers
    log it: from one step's readback to the next (the loop's ``StepTimer``:
    the loader's wait and the logging included), none on the run's first
    step."""
    if not steps or "step_time_ms" in steps[0] or "utt_per_sec" in steps[0] or not all(
            "step_time_ms" in r and "utt_per_sec" in r for r in steps[1:]):
        fail(f"{what}: step_time_ms is not logged from one step to the next")
    return [r["step_time_ms"] for r in steps[1:]]


def finite(values) -> bool:
    return bool(np.isfinite(np.asarray(list(values), np.float64)).all())


@booked("setup")
def write_train_corpus(root: str) -> str:
    """24 train and 8 test utterances of 3-4 s (speech-like, 0-15 dB SNR)."""
    from prior_diffuse_tpu_torch.data.synthetic import write_corpus_speechlike

    return write_corpus_speechlike(os.path.join(root, "corpus"), n_train=CORPUS[0],
                                   n_test=CORPUS[1], min_len=UTTERANCE_LEN[0],
                                   max_len=UTTERANCE_LEN[1], seed=8)


def train_losses(out) -> list:
    """The loss tensors of a ``_train_step``'s result: ``(total, loss_dis,
    loss_ddpm)`` of ``ComplexDDPMTrainer``'s, ``(loss,)`` of
    ``ComplexTrainer``'s (the group norms left out)."""
    return [v for v in out if not isinstance(v, dict)]


def opt_of(tr, net: str):
    """The optimizer of ``tr``'s net ``net`` (``ComplexTrainer`` has one)."""
    return tr.opts.get(f"opt_{net}") or tr.opts["opt"]


def one_step(tr, batch, plain: bool = False) -> dict:
    """One ``_train_step`` (through the plain STFT if ``plain``); returns the
    losses and, per net, the flat gradient and parameter update."""
    import torch

    before = {n: torch.cat([p.detach().flatten() for p in m.parameters()])
              for n, m in tr.nets.items()}
    if plain:
        with plain_versions():
            out = tr._train_step(*batch)
    else:
        out = tr._train_step(*batch)
    torch.cuda.synchronize()
    res = {"loss": [float(v) for v in train_losses(out)], "grad": {}, "update": {}}
    for n, m in tr.nets.items():
        res["grad"][n] = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                    .flatten() for p in m.parameters()])
        res["update"][n] = torch.cat([p.detach().flatten() for p in m.parameters()]) - before[n]
    return res


def compare_steps(label: str, tr, got: dict, ref: dict, updates: bool) -> list:
    """Two runs of one train step against the STEP_* bounds (the updates
    only if ``updates``); returns what misses them."""
    import torch

    rel = lambda a, b: float(torch.linalg.vector_norm(a - b)
                             / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))
    misses = []
    for name, a, b in zip(("loss", "loss_dis", "loss_ddpm"), got["loss"], ref["loss"]):
        print(f"{label}: {name} {a:.7e} vs {b:.7e} (rel {abs(a - b) / abs(b):.3e}, "
              f"bound {STEP_LOSS_RTOL:g})", flush=True)
        if not (finite([a, b]) and abs(a - b) <= STEP_LOSS_RTOL * abs(b)):
            misses.append(f"{name} {a} vs {b}")
    for n in tr.nets:
        lr = opt_of(tr, n).param_groups[0]["lr"]
        g, g_ref = got["grad"][n], ref["grad"][n]
        du, ref_u = got["update"][n], ref["update"][n]
        flips = torch.sign(g) != torch.sign(g_ref)
        steady = ~flips & (g_ref.abs() >= STEADY_GRAD)
        g_rel, u_rel = rel(g, g_ref), rel(du[steady], ref_u[steady])
        u_max = float((du - ref_u).abs().max())
        # the share of the gradient norm at the elements of opposite sign
        flip_share = rel(torch.where(flips, 0.0, g_ref), g_ref)
        print(f"{label}: {n}: grad rel L2 {g_rel:.3e} (bound {STEP_GRAD_RTOL:g}); update "
              f"rel L2 {u_rel:.3e} over {float(steady.float().mean()) * 100:.2f} % of "
              f"elements ({rel(du, ref_u):.3e} over all); gradient signs differ at "
              f"{int(flips.sum())} of {flips.numel()}, {flip_share:.3e} of the gradient "
              f"norm; max|diff| {u_max / lr:.3f} lr" + (
                  f" (bounds {STEP_UPDATE_RTOL:g}, {STEP_UPDATE_RTOL:g}, 2 lr)" if updates
                  else " (not bounded)"), flush=True)
        if not g_rel <= STEP_GRAD_RTOL:
            misses.append(f"{n} gradients")
        if updates and not (u_rel <= STEP_UPDATE_RTOL and u_max <= 2 * lr
                            and flip_share <= STEP_UPDATE_RTOL):
            misses.append(f"{n} updates")
    return misses


def step_through_k1_and_plain(tr, batch) -> None:
    """From one state, one train step through K1 and the same step through
    the plain STFT (the same q-sample draws: the generator is restored);
    then the step through K1 with a wrong window, which must fail."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft

    snap = copy.deepcopy(tr.ckpt_payload())
    reset_counts()
    got = one_step(tr, batch)
    expect_counts("one train step", {"stft": 2, "istft": 0, "enc_stage": 0})
    tr.restore_payload(copy.deepcopy(snap))
    ref = one_step(tr, batch, plain=True)
    expect_counts("the plain-STFT step", {"stft": 2, "istft": 0, "enc_stage": 0})
    misses = compare_steps("train step K1 vs plain STFT", tr, got, ref, updates=False)
    if misses:
        fail(f"train step K1 vs plain STFT: {', '.join(misses)} disagree")

    # K1 itself, launched on its table with the symmetric Hann window
    tab, itab = kstft._device_operands(batch[0].device)
    wrong = tab.clone()
    wrong[:320] = torch.hann_window(320, periodic=False, device=tab.device)
    tr.restore_payload(copy.deepcopy(snap))
    with mock.patch.object(kstft, "_device_operands", lambda device: (wrong, itab)):
        bad = one_step(tr, batch)
    tr.restore_payload(copy.deepcopy(snap))
    misses = compare_steps("train step K1 (symmetric window) vs plain STFT", tr, bad, ref,
                           updates=False)
    if not misses:
        fail("the train-step check passed a K1 with the wrong window")
    print(f"the train-step check rejects K1 with the wrong window: {', '.join(misses)}",
          flush=True)


def checked_steps(tr, batches, label: str = "joint, sigma") -> dict:
    """One train step through K1 on each of ``batches`` in turn (an epoch),
    without the group gradient norms (``train_ddpm`` takes them on 1 step
    in ``grad_log_every``): K1 = 2 launches a step, every loss finite;
    returns the launch counts of one step.  ``tools/card_numbers.py`` times
    such steps."""
    import torch

    reset_counts()
    losses = torch.stack([torch.stack(train_losses(tr._train_step(*b, norms=False)))
                          for b in batches])
    torch.cuda.synchronize()
    n = len(batches)
    expect_counts(f"{n} train steps [{label}]", {"stft": 2 * n, "istft": 0, "enc_stage": 0})
    if not bool(torch.isfinite(losses).all()):
        fail(f"non-finite train loss [{label}]")
    return {"stft": 2, "istft": 0, "enc_stage": 0}


def eval_and_kernels(tr, card) -> tuple:
    """``evaluate()`` over the cv split, then K2 and K3 against their plain
    versions at the trained weights' eval shapes; returns the launch
    counts of one cv batch and the kernel rows."""
    import torch

    from prior_diffuse_tpu_torch.models.fused_forward import fused_unet_forward
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.signal.compress import decompress_spec
    from prior_diffuse_tpu_torch.training.base import spec_features

    n_cv = len(tr.cv_loader)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cv_loss = tr.evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_counts(f"evaluate() over {n_cv} cv batch(es)",
                  {"stft": 2 * n_cv, "istft": 2 * n_cv, "enc_stage": 35 * n_cv})
    recs = metric_records(tr.run.log_dir)
    diag = [r for r in recs if "test_prior_mse" in r][-1]
    ev = [r for r in recs if "test_loss" in r][-1]
    keys = ["test_prior_mse", "test_res_energy_true", "test_res_energy_sampled",
            "test_res_cos", "test_chain_mse"]
    scores = [f"test_mean_{m}" for m in ("csig", "cbak", "covl", "pesq", "ssnr", "stoi")]
    if not finite([cv_loss, *(diag[k] for k in keys), *(ev[k] for k in scores)]):
        fail(f"non-finite evaluation: {diag} {ev}")
    batch = next(iter(tr.cv_loader))
    noisy, clean, frames = tr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    print(f"evaluate(): cv loss {cv_loss:.5f}, " + ", ".join(
        f"{k[5:]} {diag[k]:.5f}" for k in keys[:4]) + ", " + ", ".join(
        f"{k[10:]} {ev[k]:.3f}" for k in scores) + f" (pesq {ev['pesq_mode']}); "
        f"{wall / n_cv * 1e3:.1f} ms wall per cv batch incl. host scoring; card {card}",
        flush=True)

    rows = {}
    feat, label = spec_features(noisy, tr.cfg), spec_features(clean, tr.cfg)
    spec = decompress_spec(label, tr.cfg.feat_type).contiguous()
    length = (spec.shape[1] - 1) * 160
    err = expect_close(f"K2 istft {tuple(spec.shape)} length {length}",
                       kstft.istft(spec, length), kstft.istft_plain(spec, length=length))
    rows["istft"] = {"shape": list(spec.shape), "max_abs_err": err,
                     "ms": cuda_ms(lambda: kstft.istft(spec, length)),
                     "plain_ms": cuda_ms(lambda: kstft.istft_plain(spec, length=length))}
    tr.dis.eval()
    tr.ddpm.eval()
    pack_dis, pack_ddpm = tr.enhancer.packs()
    x_init = fused_unet_forward(pack_dis, feat) / tr.c
    g = torch.Generator(device=feat.device).manual_seed(9)
    x_t = torch.randn(x_init.shape, generator=g, device=feat.device)
    t = torch.full((feat.shape[0],), float(tr.enhancer.sched.T[0]), device=feat.device)
    x_ddpm = tr.ddpm.preprocess(torch.cat([x_t, x_init], dim=-1).permute(0, 3, 1, 2))
    e_dis, _ = check_encoder("DiffUNet (trained)", pack_dis["enc"], feat, None)
    e_ddpm, k3 = check_encoder(
        "DiffUNet1 (trained)", pack_ddpm["enc"], x_ddpm.permute(0, 2, 3, 1).contiguous(),
        tr.ddpm.time_embedding(t))
    rows["enc_stage"] = {"shape": list(feat.shape), "max_abs_err": max(e_dis, e_ddpm), **k3}
    return {"stft": 2, "istft": 2, "enc_stage": 35}, rows


def resume_check(tr, run, exp, batch) -> None:
    """Save a checkpoint, restore it into a fresh trainer (``--retrain``)
    and take the next step in both; cuDNN deterministic for this check."""
    import torch

    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    tr.ckpt.save_epoch(tr.epoch, tr.ckpt_payload())
    with spent("setup"):  # fresh: the check is that a new trainer restores the state
        fresh = ComplexDDPMTrainer(dataclasses.replace(run, retrain=True), exp,
                                   device=tr.device)
    if (fresh.epoch, fresh.step) != (tr.epoch + 1, tr.step) or not torch.equal(
            fresh.gen.get_state(), tr.gen.get_state()):
        fail("the restored trainer's epoch, step or generator differ")
    torch.backends.cudnn.deterministic = True
    try:
        ref, got = one_step(tr, batch), one_step(fresh, batch)
    finally:
        torch.backends.cudnn.deterministic = False
    exact = got["loss"] == ref["loss"] and all(
        torch.equal(got[k][n], ref[k][n]) for k in ("grad", "update") for n in tr.nets)
    print(f"checkpoint restored into a fresh trainer: next step bit-exact: {exact}", flush=True)
    misses = compare_steps("next step after restore", tr, got, ref, updates=True)
    if misses:
        fail(f"next step after restore: {', '.join(misses)} disagree")


def train_phase(device, card, root: str, corpus: str):
    """Phase 5; returns the launch counts of one train step and of one cv
    batch's evaluation, and the kernel rows at the slice's shapes."""
    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    exp = load_experiment(os.path.join(ROOT, "conf", "diff.yml"))
    if (exp.train.batch_size, exp.train.chunk_length) != (TRAIN_BATCH, LENGTH):
        fail(f"conf/diff.yml: batch {exp.train.batch_size} x {exp.train.chunk_length}")
    run = RunConfig(seed=7, joint=True, sigma=True, data_root=corpus,
                    assets=os.path.join(root, "assets"))
    with spent("setup"):
        tr = ComplexDDPMTrainer(run, exp, device=device)
        batches = [tr.put_batch(b.noisy, b.clean, b.frame_nums) for b in tr.tr_loader]
    n_params = {n: sum(p.numel() for p in m.parameters()) for n, m in tr.nets.items()}
    print(f"trainer: DiffUNet {n_params['dis']:,} + DiffUNet1 {n_params['ddpm']:,} "
          f"parameters, batch {TRAIN_BATCH} x {LENGTH}, lr {exp.optim.lr:g} / "
          f"{exp.optim_ddpm.lr:g}, joint, sigma", flush=True)
    if n_params != PARAMS:
        fail(f"parameter counts {n_params}, expected {PARAMS}")
    if len(batches) != CORPUS[0] // TRAIN_BATCH:
        fail(f"{len(batches)} train batches")

    noisy = batches[0][0]
    want = kstft.stft_plain(noisy)
    rows = {"stft": {"shape": list(noisy.shape),
                     "max_abs_err": expect_close(f"K1 stft {tuple(noisy.shape)}",
                                                 kstft.stft(noisy), want),
                     "ms": cuda_ms(lambda: kstft.stft(noisy)),
                     "plain_ms": cuda_ms(lambda: kstft.stft_plain(noisy))}}
    step_through_k1_and_plain(tr, batches[0])
    step_counts = checked_steps(tr, batches)
    eval_counts, eval_rows = eval_and_kernels(tr, card)
    rows.update(eval_rows)
    resume_check(tr, run, exp, batches[1])
    return step_counts, eval_counts, rows


def cli_phase(root: str, corpus: str, card) -> tuple:
    """Phase 6: ``cli.main`` trains 2 epochs, then ``--generate``; returns
    the launch counts of both runs."""
    import torch

    from prior_diffuse_tpu_torch import cli
    from prior_diffuse_tpu_torch.data.wavio import read_wav

    with open(os.path.join(ROOT, "conf", "diff.yml")) as f:
        text = f.read()
    if "n_epochs: 50" not in text:
        fail("conf/diff.yml has no 'n_epochs: 50' line")
    conf = os.path.join(root, "diff_2_epochs.yml")
    with open(conf, "w") as f:
        f.write(text.replace("n_epochs: 50", "n_epochs: 2"))
    assets = os.path.join(root, "cli")
    args = ["--config", conf, "--joint", "--data-root", corpus, "--assets", assets,
            "--seed", "11"]
    n_steps, n_cv = 2 * (CORPUS[0] // TRAIN_BATCH), CORPUS[1] // TRAIN_BATCH
    print(f"cli.main {' '.join(args)}", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = expect_counts("cli.main (2 epochs)", {"stft": 2 * (n_steps + 2 * n_cv),
                                                  "istft": 4 * n_cv, "enc_stage": 70 * n_cv})
    recs = metric_records(os.path.join(assets, "log", "diff"))
    steps = [r for r in recs if "loss_sum" in r]
    evals = [r for r in recs if "test_loss" in r]
    if len(steps) != n_steps or len(evals) != 2 or not finite(
            [r[k] for r in steps for k in ("loss_sum", "dis_loss", "ddpm_loss")]
            + [r["test_loss"] for r in evals]):
        fail(f"cli log: {len(steps)} train records, {len(evals)} eval records")
    ckpt = os.path.join(assets, "checkpoint", "diff")
    for path in ("epochs/0.pt", "epochs/1.pt", "best.pt"):
        if not os.path.exists(os.path.join(ckpt, path)):
            fail(f"cli: no checkpoint {path}")
    step_ms = logged_step_ms(steps, "cli log")
    print(f"cli.main: {n_steps} steps and 2 evaluations in {wall:.1f} s wall; step to step "
          f"{np.median(step_ms):.3f} ms median on the host clock ({min(step_ms):.3f}-"
          f"{max(step_ms):.3f}; the evaluation between the epochs included); cv loss "
          f"{[round(r['test_loss'], 5) for r in evals]}; card {card}", flush=True)

    reset_counts()
    cli.main(args + ["--generate"])
    torch.cuda.synchronize()
    n_gen = -(-CORPUS[1] // TRAIN_BATCH)
    generate = expect_counts("cli.main --generate",
                             {"stft": n_gen, "istft": n_gen, "enc_stage": 35 * n_gen})
    ins = sorted(glob.glob(os.path.join(corpus, "noisy_testset_wav", "*.wav")))
    outs = sorted(glob.glob(os.path.join(assets, "wav", "diff", "*.wav")))
    if [os.path.basename(p) for p in outs] != [os.path.basename(p) for p in ins]:
        fail(f"--generate wrote {len(outs)} wavs for {len(ins)} inputs")
    for i, o in zip(ins, outs):
        x, y = read_wav(i)[0], read_wav(o)[0]
        if y.shape != x.shape or not np.isfinite(y).all() or not np.abs(y).max() > 0:
            fail(f"--generate: {o} has {y.shape} for {x.shape}, or no finite signal")
    print(f"cli.main --generate: {len(outs)} wavs of {[len(read_wav(p)[0]) for p in outs]} "
          f"samples, finite, at the inputs' lengths", flush=True)
    return train, generate


def mode_config(mode: str):
    """The default experiment in a diffusion mode (``pirorgrad`` or one of MODES)."""
    from prior_diffuse_tpu_torch.config import DiffusionConfig, ExperimentConfig

    return ExperimentConfig(diffusion=DiffusionConfig(**MODES.get(mode, {})))


def bf16_card_vs_cpu(device, dis, denoisers, bound: float = None, what: str = "") -> None:
    """Phase 7b (9e with another prior, ``what``): the bf16 enhancer on the
    card (kernels, cuDNN and cuBLAS in bf16) against the same enhancer on
    the CPU (the plain versions) on one ``x_T``, at 2 x 0.5 s, in each
    mode; within ``bound`` (default BF16_CARD_VS_CPU_RMS)."""
    bound = bound or BF16_CARD_VS_CPU_RMS
    import torch

    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    wav = speechlike(2, CARD_VS_CPU_LENGTH, 30)
    x_T = torch.randn((1, 2, CARD_VS_CPU_LENGTH // 160 + 1, 161, 2),
                      generator=torch.Generator().manual_seed(31)).bfloat16()
    for mode, ddpm in denoisers.items():
        out = {}
        for dev in (device, torch.device("cpu")):
            nets = [copy.deepcopy(m).to(dev) for m in (dis, ddpm)]
            enh = Enhancer(*nets, mode_config(mode), device=dev, dtype=torch.bfloat16)
            out[dev.type] = enh.enhance_batch(wav, x_T=x_T).cpu()
        err = rel_rms(out["cuda"], out["cpu"])
        print(f"enhance_batch [{what}{mode}, bf16] {tuple(out['cpu'].shape)} on the card vs on "
              f"the CPU (plain versions), one x_T: rel RMS {err:.3e} (bound {bound:g})",
              flush=True)
        if err > bound:
            fail(f"the bf16 batch [{what}{mode}] on the card strays from the CPU's")


def train_mode_phase(device, card, root: str, corpus: str, mode: str) -> tuple:
    """Phase 7c: phase 5's trainer (``conf/diff.yml``, ``--joint --sigma``)
    in ``mode``: the K1 step against the plain-STFT step, a step on each
    train batch, one ``evaluate()`` cv batch; returns the launch counts of
    one step and of the evaluation."""
    import torch

    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.diffusion.sampler import diffusion_mode
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    exp = load_experiment(os.path.join(ROOT, "conf", "diff.yml"))
    exp = dataclasses.replace(exp, diffusion=dataclasses.replace(exp.diffusion, **MODES[mode]))
    if diffusion_mode(exp.diffusion) != mode:
        fail(f"the config's mode is {diffusion_mode(exp.diffusion)}, not {mode}")
    run = RunConfig(seed=7, joint=True, sigma=True, data_root=corpus,
                    assets=os.path.join(root, f"assets_{mode}"))
    with spent("setup"):
        tr = ComplexDDPMTrainer(run, exp, device=device)
        batches = [tr.put_batch(b.noisy, b.clean, b.frame_nums) for b in tr.tr_loader]
    n_params = {n: sum(p.numel() for p in m.parameters()) for n, m in tr.nets.items()}
    want = {"dis": PARAMS["dis"], "ddpm": NOCON_PARAMS if mode == "deltamu" else PARAMS["ddpm"]}
    print(f"trainer [{mode}]: DiffUNet {n_params['dis']:,} + {type(tr.ddpm).__name__} "
          f"{n_params['ddpm']:,} parameters, joint, sigma", flush=True)
    if n_params != want:
        fail(f"parameter counts {n_params}, expected {want}")
    step_through_k1_and_plain(tr, batches[0])
    step_counts = checked_steps(tr, batches, f"{mode}, joint, sigma")
    n_cv = len(tr.cv_loader)
    reset_counts()
    t0 = time.perf_counter()
    cv_loss = tr.evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_counts = expect_counts(f"evaluate() [{mode}] over {n_cv} cv batch(es)",
                                {"stft": 2 * n_cv, "istft": 2 * n_cv, "enc_stage": 35 * n_cv})
    diag = [r for r in metric_records(tr.run.log_dir) if "test_prior_mse" in r][-1]
    if not finite([cv_loss, *(v for k, v in diag.items() if k.startswith("test_"))]):
        fail(f"non-finite evaluation [{mode}]: {diag}")
    print(f"evaluate() [{mode}]: cv loss {cv_loss:.5f}, prior_mse {diag['test_prior_mse']:.5f}, "
          f"{wall / n_cv * 1e3:.1f} ms wall per cv batch incl. host scoring; card {card}",
          flush=True)
    return step_counts, eval_counts


@booked("setup")
def prior_nets(device) -> dict:
    """Phase 8: the five non-DiffUNet families at full width with seeded
    weights, their parameter counts held to the reference oracle; returns
    the served two by name."""
    from prior_diffuse_tpu_torch.models import model_class

    counts, served = {}, {}
    for i, name in enumerate(PRIOR_PARAMS):
        net = seeded_nets(40 + i, device, (model_class(name),))[0]
        counts[name] = sum(p.numel() for p in net.parameters())
        if name in PRIOR_CONFS:
            served[name] = net
    print("prior parameter counts: " + ", ".join(f"{k} {v:,}" for k, v in counts.items()),
          flush=True)
    if counts != PRIOR_PARAMS:
        fail(f"prior parameter counts {counts}, expected {PRIOR_PARAMS}")
    return served


@contextmanager
def tf32(on: bool):
    import torch

    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def card_vs_cpu_f32(device, priors) -> None:
    """Phase 8a: cuDNN's f32 LSTM (GCRN's, [8, 301, 512]) and bidirectional
    GRU (DB-AIAT's column pass, [640, 301, 32]) and each served prior's
    forward on 2 x 1 s on the card against the same module on the CPU: with
    TF32 off, within CARD_VS_CPU_F32; with TF32 on, printed (the larger
    distance shows that the switch reaches cuDNN's RNNs)."""
    import torch

    from prior_diffuse_tpu_torch.models import layers

    g = torch.Generator().manual_seed(50)
    cases = [("LSTM(512, 512)", layers.LSTM(512, 512), torch.randn(BATCH, T_FRAMES, 512,
                                                                    generator=g)),
             ("bidirectional GRU(32, 64)", layers.GRU(32, 64, True),
              torch.randn(BATCH * 80, T_FRAMES, 32, generator=g))]
    cases += [(f"{name} forward", net, torch.randn(2, 101, 161, 2, generator=g))
              for name, net in priors.items()]
    card_vs_cpu(device, [(label, net, (x,)) for label, net, x in cases])


def card_vs_cpu(device, cases) -> None:
    """Each ``(label, net, inputs)`` forward on the card against the same
    module on the CPU: with TF32 off within CARD_VS_CPU_F32 of the largest
    value, with TF32 on printed."""
    for label, net, args in cases:
        cpu = copy.deepcopy(net).cpu().eval()
        card = copy.deepcopy(net).to(device).eval()
        want = cpu(*args)
        errs = {}
        for on in (False, True):
            with tf32(on):
                err, ref = max_err(card(*(a.to(device) for a in args)).cpu(), want)
            errs[on] = err / ref
        print(f"{label} {tuple(args[0].shape)} on the card vs the CPU: max|err| / max|ref| "
              f"{errs[False]:.3e} with TF32 off (bound {CARD_VS_CPU_F32:g}), {errs[True]:.3e} "
              f"with TF32 on", flush=True)
        if errs[False] > CARD_VS_CPU_F32:
            fail(f"{label}: the card's float32 forward strays from the CPU's")


def prior_exp(name: str):
    """The experiment of the prior's yml (``conf/gcrn.yml`` or
    ``conf/dbaiat.yml``), checked against its published batch."""
    from prior_diffuse_tpu_torch.config import load_experiment

    conf, batch = PRIOR_CONFS[name]
    exp = load_experiment(os.path.join(ROOT, "conf", conf))
    if (exp.model.name, exp.train.batch_size, exp.train.chunk_length) != (name, batch, LENGTH):
        fail(f"conf/{conf}: {exp.model.name}, batch {exp.train.batch_size} x "
             f"{exp.train.chunk_length}")
    return exp


def trainer_of(name: str) -> str:
    """The trainer that trains the prior alone: ``MagTrainer`` for GRN (a
    magnitude model), else ``ComplexTrainer``."""
    return "MagTrainer" if name == "GRN" else "ComplexTrainer"


@booked("setup")
def complex_trainer(device, name, net, root, corpus, tag="", bf16: bool = False):
    """The trainer (:func:`trainer_of`) of the prior's yml on the corpus
    (with ``bf16``, training in bf16 compute), holding ``net``'s weights."""
    from prior_diffuse_tpu_torch.config import RunConfig
    from prior_diffuse_tpu_torch.training.complex_trainer import ComplexTrainer
    from prior_diffuse_tpu_torch.training.mag_trainer import MagTrainer

    cls = MagTrainer if trainer_of(name) == "MagTrainer" else ComplexTrainer
    run = RunConfig(seed=7, trainer=trainer_of(name), data_root=corpus,
                    assets=os.path.join(root, f"assets_{name}{tag}"))
    exp = bf16_exp(prior_exp(name)) if bf16 else prior_exp(name)
    tr = cls(run, exp, device=device)
    tr.model.load_state_dict(net.state_dict())
    return tr


def complex_serving(device, name, tr) -> dict:
    """Phase 8b (9b for GRN): ``ComplexTrainer.enhance_batch`` (or
    ``MagTrainer``'s) on the batch of phase 3 through the kernels against
    the plain versions, launch counts K1 = 1, K2 = 1, K3 = 0; then five
    requests through ``enhance_files``."""
    import torch

    from prior_diffuse_tpu_torch.serving.enhance import enhance_files

    trainer = type(tr).__name__
    wav = speechlike(BATCH, LENGTH, 3)
    reset_counts()
    out = tr.enhance_batch(wav)
    torch.cuda.synchronize()
    counts = expect_counts(f"{trainer}.enhance_batch [{name}]",
                           {"stft": 1, "istft": 1, "enc_stage": 0})
    with plain_versions():
        ref = tr.enhance_batch(wav)
    torch.cuda.synchronize()
    if out.shape != (BATCH, LENGTH) or out.dtype != torch.float32:
        fail(f"{trainer}.enhance_batch [{name}] returned {tuple(out.shape)} {out.dtype}")
    err, refmax = max_err(out, ref)
    print(f"{trainer}.enhance_batch [{name}, f32] {tuple(out.shape)}: max|kernels - "
          f"plain| {err:.3e} (bound {PATH_RTOL * refmax:.3e}, max|ref| {refmax:.3e})",
          flush=True)
    if err > PATH_RTOL * refmax:
        fail(f"{trainer}.enhance_batch [{name}] disagrees with its plain-version run")
    lengths = [16000, 23456, 40000, 64000, 31234]
    wavs = [0.1 * speechlike(1, n, 10 + i)[0] for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    outs = enhance_files(tr.server, wavs, torch.Generator(device=device).manual_seed(6))
    wall = time.perf_counter() - t0
    for w, o in zip(wavs, outs):
        if o.shape != w.shape or not np.isfinite(o).all():
            fail(f"enhance_files [{name}] returned {o.shape} for {w.shape} or non-finite values")
    print(f"enhance_files [{name}, {trainer}]: {len(wavs)} requests, lengths {lengths} "
          f"-> ok ({wall * 1e3:.1f} ms wall incl. host)", flush=True)
    return counts


def prior_ddpm_phase(device, card, root, corpus, name, net, ddpm) -> dict:
    """Phase 8c: the prior under ``ComplexDDPMTrainer``: its ``Enhancer``
    on the batch of phase 3 (plain and ``--sigma``, K3 = 30), its
    ``prior_only_server`` (K3 = 0), then the trainer of ``conf/diff.yml``
    with ``model.name`` the prior: one joint step (``--sigma``) and one
    ``evaluate()`` cv batch (K1 = 2, K2 = 2, K3 = 30)."""
    import torch

    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.serving.enhance import prior_only_server
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    paths = run_main_path(device, net, ddpm, torch.float32)
    with spent("setup"):
        server = prior_only_server(Enhancer(net, ddpm, mode_config("pirorgrad"), device=device))
    reset_counts()
    out = server.enhance_batch(speechlike(BATCH, LENGTH, 3))
    torch.cuda.synchronize()
    paths[f"prior_only_{name}"] = expect_counts(f"prior_only_server [{name}]",
                                                {"stft": 1, "istft": 1, "enc_stage": 0})
    if out.shape != (BATCH, LENGTH) or not bool(torch.isfinite(out).all()):
        fail(f"prior_only_server [{name}]: {tuple(out.shape)} or non-finite values")

    exp = load_experiment(os.path.join(ROOT, "conf", "diff.yml"))
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, name=name))
    run = RunConfig(seed=7, joint=True, sigma=True, data_root=corpus,
                    assets=os.path.join(root, f"assets_ddpm_{name}"))
    with spent("setup"):
        tr = ComplexDDPMTrainer(run, exp, device=device)
        batch = next(iter(tr.tr_loader))
        batch = tr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    if type(tr.dis).__name__ != type(net).__name__:
        fail(f"the DDPM trainer's prior is {type(tr.dis).__name__}")
    reset_counts()
    t0 = time.perf_counter()
    losses = train_losses(tr._train_step(*batch))
    step_wall = (time.perf_counter() - t0) * 1e3
    paths[f"train_step_ddpm_{name}"] = expect_counts(
        f"a joint step [{name} prior]", {"stft": 2, "istft": 0, "enc_stage": 0})
    if not finite(float(v) for v in losses):
        fail(f"non-finite joint step [{name} prior]: {losses}")
    n_cv = len(tr.cv_loader)
    reset_counts()
    t0 = time.perf_counter()
    cv_loss = tr.evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths[f"evaluate_cv_batch_ddpm_{name}"] = expect_counts(
        f"evaluate() [{name} prior] over {n_cv} cv batch(es)",
        {"stft": 2 * n_cv, "istft": 2 * n_cv, "enc_stage": 30 * n_cv})
    if not finite([cv_loss]):
        fail(f"non-finite evaluation [{name} prior]")
    print(f"ComplexDDPMTrainer [{name} prior, joint, sigma]: first step "
          f"{step_wall:.1f} ms wall, losses {[round(float(v), 5) for v in losses]}; "
          f"evaluate() cv loss {cv_loss:.5f}, {wall / n_cv * 1e3:.1f} ms wall per cv batch "
          f"incl. host scoring; card {card}", flush=True)
    return paths


def complex_train_phase(device, card, root, corpus, name, net) -> dict:
    """Phase 8d (9c for GRN): ``ComplexTrainer`` (``MagTrainer``) of the
    prior's yml at its width: the K1 step against the plain-STFT step (the
    wrong window rejected), a step on each train batch, ``evaluate()``;
    returns the launch counts of a step and of the evaluation."""
    import torch

    tr = complex_trainer(device, name, net, root, corpus, tag="_train")
    trainer, kind = type(tr).__name__, "mag" if name == "GRN" else "complex"
    with spent("setup"):
        batches = [tr.put_batch(b.noisy, b.clean, b.frame_nums) for b in tr.tr_loader]
    rows = PRIOR_CONFS[name][1]
    if len(batches) != CORPUS[0] // rows or batches[0][0].shape != (rows, LENGTH):
        fail(f"{len(batches)} train batches of {tuple(batches[0][0].shape)}")
    step_through_k1_and_plain(tr, batches[0])
    counts = {f"train_step_{kind}_{name}": checked_steps(tr, batches, f"{trainer}, {name}")}
    n_cv = len(tr.cv_loader)
    cv_rows = [len(b.frame_nums) for b in tr.cv_loader]
    print(f"{trainer} [{name}]: cv batches of {cv_rows} utterances", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    cv_loss = tr.evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts[f"evaluate_cv_batch_{kind}_{name}"] = expect_counts(
        f"{trainer}.evaluate() [{name}] over {n_cv} cv batch(es)",
        {"stft": 2 * n_cv, "istft": 2 * n_cv, "enc_stage": 0})
    ev = [r for r in metric_records(tr.run.log_dir) if "test_loss" in r][-1]
    scores = [f"test_mean_{m}" for m in ("csig", "cbak", "covl", "pesq", "ssnr", "stoi")]
    if not finite([cv_loss, *(ev[k] for k in scores)]):
        fail(f"non-finite evaluation [{name}]: {ev}")
    print(f"{trainer}.evaluate() [{name}]: cv loss {cv_loss:.5f}, " + ", ".join(
        f"{k[10:]} {ev[k]:.3f}" for k in scores) + f"; {wall / n_cv * 1e3:.1f} ms wall per "
        f"cv batch incl. host scoring; card {card}", flush=True)
    return counts


def complex_cli_phase(root, corpus, name, card, n_test: int = CORPUS[1]) -> dict:
    """Phase 8e (9d for GRN): ``cli.main --trainer ComplexTrainer`` (or
    ``MagTrainer``) on a copy of the prior's yml for one epoch, then
    ``--generate``, on a corpus of ``n_test`` test utterances; returns the
    launch counts of both runs."""
    import torch

    from prior_diffuse_tpu_torch import cli
    from prior_diffuse_tpu_torch.data.wavio import read_wav

    conf, rows = PRIOR_CONFS[name]
    with open(os.path.join(ROOT, "conf", conf)) as f:
        text = f.read()
    epochs = next((line for line in text.splitlines() if "n_epochs:" in line), None)
    if epochs is None:
        fail(f"conf/{conf} has no n_epochs line")
    path = os.path.join(root, f"one_epoch_{conf}")
    with open(path, "w") as f:
        f.write(text.replace(epochs, "  n_epochs: 1"))
    assets = os.path.join(root, f"cli_{name}")
    trainer, kind = trainer_of(name), "mag" if name == "GRN" else "complex"
    args = ["--trainer", trainer, "--config", path, "--data-root", corpus,
            "--assets", assets, "--doc", name, "--seed", "11"]
    # MagTrainer keeps the ragged last cv batch; ComplexTrainer drops it
    n_steps = CORPUS[0] // rows
    n_cv = -(-n_test // rows) if trainer == "MagTrainer" else n_test // rows
    print(f"cli.main {' '.join(args)}", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = expect_counts(f"cli.main --trainer {trainer} [{name}, 1 epoch]",
                          {"stft": 2 * (n_steps + n_cv), "istft": 2 * n_cv, "enc_stage": 0})
    recs = metric_records(os.path.join(assets, "log", name))
    steps = [r for r in recs if "train_batch_loss" in r]
    if len(steps) != n_steps or not any("test_loss" in r for r in recs) or not finite(
            r["train_batch_loss"] for r in steps):
        fail(f"cli log [{name}]: {len(steps)} train records")
    for ckpt in ("epochs/0.pt", "best.pt"):
        if not os.path.exists(os.path.join(assets, "checkpoint", name, ckpt)):
            fail(f"cli [{name}]: no checkpoint {ckpt}")
    print(f"cli.main [{name}]: {n_steps} steps and an evaluation in {wall:.1f} s wall; step "
          f"to step {np.median(logged_step_ms(steps, f'cli log [{name}]')):.3f} ms median on "
          f"the host clock; card {card}", flush=True)
    reset_counts()
    cli.main(args + ["--generate"])
    torch.cuda.synchronize()
    n_gen = -(-n_test // rows)
    generate = expect_counts(f"cli.main --trainer {trainer} --generate [{name}]",
                             {"stft": n_gen, "istft": n_gen, "enc_stage": 0})
    ins = sorted(glob.glob(os.path.join(corpus, "noisy_testset_wav", "*.wav")))
    outs = sorted(glob.glob(os.path.join(assets, "wav", name, "*.wav")))
    if [os.path.basename(p) for p in outs] != [os.path.basename(p) for p in ins]:
        fail(f"--generate [{name}] wrote {len(outs)} wavs for {len(ins)} inputs")
    for i, o in zip(ins, outs):
        x, y = read_wav(i)[0], read_wav(o)[0]
        if y.shape != x.shape or not np.isfinite(y).all() or not np.abs(y).max() > 0:
            fail(f"--generate [{name}]: {o} has {y.shape} for {x.shape}, or no finite signal")
    print(f"cli.main --generate [{name}]: {len(outs)} wavs, finite, at the inputs' lengths",
          flush=True)
    return {f"cli_train_{kind}_{name}": train, f"cli_generate_{kind}_{name}": generate}


def prior_phase(device, card, root, corpus, ddpm, priors) -> dict:
    """Phase 8 on the served priors of :func:`prior_nets`; returns the
    launch counts of its paths."""
    card_vs_cpu_f32(device, priors)
    paths = {}
    for name, net in priors.items():
        tr = complex_trainer(device, name, net, root, corpus)
        paths[f"serve_batch_complex_{name}"] = complex_serving(device, name, tr)
        paths.update(prior_ddpm_phase(device, card, root, corpus, name, net, ddpm))
        paths.update(complex_train_phase(device, card, root, corpus, name, net))
        paths.update(complex_cli_phase(root, corpus, name, card))
    return paths


@booked("setup")
def grn_corpus(root: str, corpus: str) -> str:
    """Phase 5's corpus with GRN_TEST - CORPUS[1] more test utterances."""
    import shutil

    from prior_diffuse_tpu_torch.data.synthetic import make_speechlike
    from prior_diffuse_tpu_torch.data.wavio import write_wav

    out = os.path.join(root, "corpus_grn")
    shutil.copytree(corpus, out)
    rng = np.random.default_rng(9)
    for i in range(CORPUS[1], GRN_TEST):
        noisy, clean = make_speechlike(rng, int(rng.integers(*UTTERANCE_LEN)), SR,
                                       float(rng.uniform(0.0, 15.0)))
        for kind, wav in (("noisy", noisy), ("clean", clean)):
            write_wav(os.path.join(out, f"{kind}_testset_wav", f"ste_{i:03d}.wav"), wav, SR)
    return out


def grn_phase(device, card, root: str, corpus: str, net) -> dict:
    """Phase 9a-d: GRN at full width with seeded weights (``net``, of
    :func:`grn_net`; its parameter count; its forward on the card against
    the CPU at [8, 301, 161]), then ``MagTrainer`` of ``conf/grn.yml``: its
    serving batch (K1 = 1, K2 = 1), training at 8 x 48000 (the K1 step
    against the plain-STFT step, the wrong window rejected, a step on each
    train batch, ``evaluate()`` with a ragged last cv batch), and
    ``cli.main --trainer MagTrainer`` for one epoch and ``--generate``;
    returns the launch counts of its paths.  The trainers load copies of
    ``net``'s weights: ``net`` itself stays as seeded."""
    import torch

    n = sum(p.numel() for p in net.parameters())
    print(f"GRN: {n:,} parameters (reference {GRN_PARAMS:,})", flush=True)
    if n != GRN_PARAMS:
        fail(f"GRN has {n} parameters, expected {GRN_PARAMS}")
    g = torch.Generator().manual_seed(60)
    card_vs_cpu(device, [("GRN forward", net, (torch.rand(BATCH, T_FRAMES, 161, generator=g),))])
    corpus = grn_corpus(root, corpus)
    tr = complex_trainer(device, "GRN", net, root, corpus)
    paths = {"serve_batch_mag_GRN": complex_serving(device, "GRN", tr)}
    paths.update(complex_train_phase(device, card, root, corpus, "GRN", net))
    paths.update(complex_cli_phase(root, corpus, "GRN", card, n_test=GRN_TEST))
    return paths


@booked("setup")
def grn_net(device):
    """Phase 9's GRN (``conf/grn.yml``'s model) at full width, seeded."""
    from prior_diffuse_tpu_torch.models.grn import GRN

    return seeded_nets(60, device, (GRN,))[0]


def diffwave_phase(device) -> None:
    """Phase 9e: DiffWave at its default width (64 channels, 30 layers),
    seeded, on the card against the CPU at [2, 48000]."""
    import torch

    from prior_diffuse_tpu_torch.models.diffwave import DiffWave

    net = seeded_nets(61, device, (DiffWave,))[0]
    g = torch.Generator().manual_seed(61)
    args = (torch.randn(2, LENGTH, generator=g), 0.5 * torch.randn(2, LENGTH, generator=g),
            torch.tensor([3, 41]))
    print(f"DiffWave: {sum(p.numel() for p in net.parameters()):,} parameters, "
          f"{net.residual_layers} layers", flush=True)
    card_vs_cpu(device, [("DiffWave forward", net, args)])


def bf16_prior_phase(device, priors, ddpm) -> dict:
    """Phase 9f: each of BF16_PRIORS served in bf16 as the JAX package serves
    it (its serving copy): ``prior_only_server`` in bf16 (K1 = 1, K2 = 1)
    against the plain versions and against f32 on the same weights; the
    bf16 ``Enhancer`` in pirorgrad, plain and ``--sigma`` (K1 = 1, K2 = 1,
    K3-bf16 = 30; :func:`run_main_path`); the bf16 enhancer on the card
    against the CPU at 2 x 0.5 s.  Returns the launch counts of its paths."""
    import torch

    from prior_diffuse_tpu_torch.serving.enhance import prior_only_server
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    wav = speechlike(BATCH, LENGTH, 3)
    paths = {}
    for name in BF16_PRIORS:
        net = priors[name]
        with spent("setup"):
            enh = Enhancer(net, ddpm, mode_config("pirorgrad"), device=device,
                           dtype=torch.bfloat16)
            server = prior_only_server(enh)
        reset_counts()
        out = server.enhance_batch(wav)
        torch.cuda.synchronize()
        paths[f"prior_only_{name}_bf16"] = expect_counts(
            f"prior_only_server [{name}, bf16]", {"stft": 1, "istft": 1})
        with plain_versions():
            plain = server.enhance_batch(wav)
        f32 = prior_only_server(enh, torch.float32).enhance_batch(wav)
        err, vs = rel_rms(out, plain), rel_rms(out, f32)
        lo, hi = BF16_PRIOR_VS_F32_RMS[name]
        print(f"prior_only_server [{name}, bf16] {tuple(out.shape)}: kernels vs plain versions "
              f"rel RMS {err:.3e} (bound {BF16_PRIOR_ONLY_PATH_RMS[name]:g}); vs f32 on the "
              f"same weights {vs:.3e} (bounds {lo:g} .. {hi:g})", flush=True)
        if err > BF16_PRIOR_ONLY_PATH_RMS[name]:
            fail(f"prior_only_server [{name}, bf16] disagrees with its plain-version run")
        if not lo <= vs <= hi:
            fail(f"prior_only_server [{name}, bf16] is {vs:.3e} from f32")
        paths.update(run_main_path(device, net, ddpm, torch.bfloat16))
        bf16_card_vs_cpu(device, net, {"pirorgrad": ddpm}, BF16_PRIOR_CARD_VS_CPU_RMS[name],
                         f"{name} prior, ")
    return paths



# ---- phase 10: bf16 training -------------------------------------------------


def bf16_exp(exp):
    """``exp`` training in bf16 compute (``train.compute_dtype: bfloat16``)."""
    return dataclasses.replace(exp, train=dataclasses.replace(exp.train,
                                                              compute_dtype="bfloat16"))


def step_distance(tr, got: dict, ref: dict) -> dict:
    """Losses (largest relative difference) and each net's gradient
    (relative L2) of two runs of one train step (:func:`one_step`)."""
    import torch

    rel = lambda a, b: float(torch.linalg.vector_norm(a.float() - b.float())
                             / torch.clamp(torch.linalg.vector_norm(b.float()), min=1e-30))
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))}
    out.update({n: rel(got["grad"][n].cpu(), ref["grad"][n].cpu()) for n in tr.nets})
    return out


def held(label: str, dist: dict, loss_rtol: float, grad_rtol: float) -> list:
    """Print ``dist`` against the bounds; return what misses them."""
    print(f"{label}: losses {dist['loss']:.3e} (bound {loss_rtol:g}), gradients " + ", ".join(
        f"{n} {v:.3e}" for n, v in dist.items() if n != "loss") + f" (bound {grad_rtol:g})",
        flush=True)
    misses = [] if finite([dist["loss"]]) and dist["loss"] <= loss_rtol else ["losses"]
    return misses + [f"{n} gradients" for n, v in dist.items()
                     if n != "loss" and not v <= grad_rtol]


@contextmanager
def k1_defect(kind):
    """K1 launched on its table with a defect of its window: ``"symmetric
    Hann window"`` (0.6 % of the spectrum), or the window scaled by
    ``1 + kind`` (a float)."""
    import torch

    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft

    operands = kstft._device_operands

    def wrong(device):
        tab, itab = operands(device)
        tab = tab.clone()
        if kind == "symmetric Hann window":
            tab[:320] = torch.hann_window(320, periodic=False, device=tab.device)
        else:
            tab[:320] *= 1 + kind
        return tab, itab

    with mock.patch.object(kstft, "_device_operands", wrong):
        yield


def bf16_step_through_k1_and_plain(tr, batch, label: str) -> dict:
    """From one state: the bf16 step through K1, through the plain STFT, and
    through K1 with the control's defect, which the check must reject
    (``tools/card_numbers.py`` prints the floor beside them: the plain STFT
    perturbed at float32's rounding).  Returns the K1 step
    (:func:`one_step`)."""
    snap = copy.deepcopy(tr.ckpt_payload())

    def run(ctx=None, plain=False):
        tr.restore_payload(copy.deepcopy(snap))
        if ctx is None:
            return one_step(tr, batch, plain=plain)
        with ctx:
            return one_step(tr, batch)

    reset_counts()
    got = run()
    expect_counts(f"one bf16 train step [{label}]", {"stft": 2})
    ref = run(plain=True)
    misses = held(f"bf16 step [{label}]: K1 vs plain STFT", step_distance(tr, got, ref),
                  BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL)
    if misses:
        fail(f"bf16 step [{label}] K1 vs plain STFT: {', '.join(misses)} disagree")
    control = held(f"bf16 step [{label}]: K1 with the control ({BF16_STEP_CONTROL}) vs plain",
                   step_distance(tr, run(k1_defect(BF16_STEP_CONTROL)), ref),
                   BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL)
    if not control:
        fail(f"the bf16 train-step check [{label}] passed K1 with the control defect")
    tr.restore_payload(copy.deepcopy(snap))
    return got


def bf16_step_card_vs_cpu(device, exp, run) -> None:
    """One bf16 step of the DDPM trainer on the card against the same step
    on the CPU (the branch the tests hold to JAX) at 2 x CARD_VS_CPU_LENGTH
    samples: one batch of the corpus, the same weights, explicit q-sample
    draws."""
    import torch

    from prior_diffuse_tpu_torch.diffusion.qsample import Draws
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    small = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, batch_size=2, chunk_length=CARD_VS_CPU_LENGTH))
    with spent("setup"):
        trainers = [ComplexDDPMTrainer(dataclasses.replace(run, assets=f"{run.assets}_{d}"),
                                       small, device=d) for d in (device, "cpu")]
        for n, net in trainers[1].nets.items():
            trainers[0].nets[n].load_state_dict(net.state_dict())
        b = next(iter(trainers[1].tr_loader))
    g = torch.Generator().manual_seed(12)
    draws = Draws(torch.randint(0, trainers[1].num_steps, (2,), generator=g),
                  torch.randn((2, CARD_VS_CPU_LENGTH // 160 + 1, 161, 2), generator=g))
    runs = []
    for tr in trainers:
        out = tr._train_step(*tr.put_batch(b.noisy, b.clean, b.frame_nums),
                             draws=Draws(*(x.to(tr.device) for x in draws[:2])))
        runs.append({"loss": [float(v) for v in train_losses(out)],
                     "grad": {n: torch.cat([(p.grad if p.grad is not None else
                                             torch.zeros_like(p)).flatten().cpu()
                                            for p in m.parameters()])
                              for n, m in tr.nets.items()}})
    misses = held(f"bf16 step card vs CPU [2 x {CARD_VS_CPU_LENGTH}]",
                  step_distance(trainers[0], *runs), *BF16_STEP_CARD_VS_CPU)
    if misses:
        fail(f"bf16 step card vs CPU: {', '.join(misses)} disagree")


def bf16_ddpm_phase(device, card, root: str, corpus: str) -> dict:
    """Phase 10a: ``conf/diff.yml`` trained in bf16 compute, ``--joint
    --sigma``, batch 6 x 48000: the K1 step against the plain-STFT step
    (the control rejected), against the f32 step on the same weights,
    batch and draws, and on the card against the CPU; a step of each
    dtype on each train batch; ``evaluate()`` (the bf16-compute path: K1
    and K2, no K3); a checkpoint restored into a fresh trainer; ``cli.main``
    for one epoch and ``--generate``."""
    import torch

    from prior_diffuse_tpu_torch import cli
    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.data.wavio import read_wav
    from prior_diffuse_tpu_torch.serving.enhancer import ComputeEnhancer
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    exp32 = load_experiment(os.path.join(ROOT, "conf", "diff.yml"))
    exp = bf16_exp(exp32)
    run = RunConfig(seed=7, joint=True, sigma=True, data_root=corpus,
                    assets=os.path.join(root, "assets_bf16"))
    with spent("setup"):
        tr = ComplexDDPMTrainer(run, exp, device=device)
        batches = [tr.put_batch(b.noisy, b.clean, b.frame_nums) for b in tr.tr_loader]
    if not (tr.compute_dtype == torch.bfloat16 and tr.fused_train
            and isinstance(tr.enhancer, ComputeEnhancer)):
        fail("the bf16 trainer does not train in bf16 through the dual forward")
    got = bf16_step_through_k1_and_plain(tr, batches[0], "DDPM, conf/diff.yml")
    with spent("setup"):  # fresh: the f32 step from the bf16 trainer's initial weights
        tr32 = ComplexDDPMTrainer(dataclasses.replace(run, assets=run.assets + "_f32"), exp32,
                                  device=device)
    ref32 = one_step(tr32, batches[0])  # the same initial weights and draws
    dist = step_distance(tr, got, ref32)
    lo, hi = BF16_VS_F32_STEP_GRAD
    print(f"bf16 step vs f32 step (same weights, batch, draws): losses {dist['loss']:.3e} "
          f"(bound {BF16_VS_F32_STEP_LOSS:g}), gradients " + ", ".join(
              f"{n} {dist[n]:.3e}" for n in tr.nets) + f" (between {lo:g} and {hi:g})",
          flush=True)
    if not (dist["loss"] <= BF16_VS_F32_STEP_LOSS and all(lo <= dist[n] <= hi for n in tr.nets)):
        fail("the bf16 step is not near the f32 step, or equal to it")
    bf16_step_card_vs_cpu(device, exp, run)

    checked_steps(tr32, batches, "f32, joint, sigma")
    paths = {"train_step_bf16": checked_steps(tr, batches, "bf16, joint, sigma")}
    for n, opt in tr.opts.items():
        if not opt.state or not all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
                                    for s in opt.state.values()):
            fail(f"{n}: Adam state not float32")
    if not all(p.dtype == torch.float32 for m in tr.nets.values() for p in m.parameters()):
        fail("bf16 training changed the parameters' dtype")
    del tr32

    n_cv = len(tr.cv_loader)
    reset_counts()
    t0 = time.perf_counter()
    cv_loss = tr.evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["evaluate_cv_batch_bf16"] = expect_counts(
        f"bf16 evaluate() over {n_cv} cv batch(es)", {"stft": 2 * n_cv, "istft": 2 * n_cv})
    if not finite([cv_loss]):
        fail("non-finite bf16 evaluation")
    print(f"bf16 evaluate(): cv loss {cv_loss:.5f}; {wall / n_cv * 1e3:.1f} ms wall per cv "
          f"batch incl. host scoring; card {card}", flush=True)
    resume_check(tr, run, exp, batches[1])

    with open(os.path.join(ROOT, "conf", "diff.yml")) as f:
        text = f.read()
    if "n_epochs: 50" not in text or "  lam: 1\n" not in text:
        fail("conf/diff.yml has no 'n_epochs: 50' or 'lam: 1' line")
    conf = os.path.join(root, "diff_bf16.yml")
    with open(conf, "w") as f:
        f.write(text.replace("n_epochs: 50", "n_epochs: 1").replace(
            "  lam: 1\n", "  lam: 1\n  compute_dtype: bfloat16\n"))
    assets = os.path.join(root, "cli_bf16")
    args = ["--config", conf, "--joint", "--sigma", "--data-root", corpus, "--assets",
            assets, "--seed", "11"]
    n_steps, n_cv = CORPUS[0] // TRAIN_BATCH, CORPUS[1] // TRAIN_BATCH
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["cli_train_bf16"] = expect_counts("cli.main, bf16 yml (1 epoch)", {
        "stft": 2 * (n_steps + n_cv), "istft": 2 * n_cv})
    steps = [r for r in metric_records(os.path.join(assets, "log", "diff")) if "loss_sum" in r]
    if len(steps) != n_steps or not finite(r["loss_sum"] for r in steps):
        fail(f"bf16 cli log: {len(steps)} train records")
    print(f"cli.main (bf16 yml): {n_steps} steps and an evaluation in {wall:.1f} s wall; "
          f"step to step {np.median(logged_step_ms(steps, 'bf16 cli log')):.3f} ms median on "
          f"the host clock; card {card}", flush=True)
    reset_counts()
    cli.main(args + ["--generate"])
    torch.cuda.synchronize()
    n_gen = -(-CORPUS[1] // TRAIN_BATCH)
    paths["cli_generate_bf16"] = expect_counts("cli.main --generate, bf16 yml",
                                               {"stft": n_gen, "istft": n_gen})
    ins = sorted(glob.glob(os.path.join(corpus, "noisy_testset_wav", "*.wav")))
    outs = sorted(glob.glob(os.path.join(assets, "wav", "diff", "*.wav")))
    if [os.path.basename(p) for p in outs] != [os.path.basename(p) for p in ins] or not all(
            np.isfinite(read_wav(o)[0]).all() for o in outs):
        fail(f"bf16 --generate wrote {len(outs)} wavs for {len(ins)} inputs, or non-finite")
    return paths


def bf16_prior_train_phase(device, card, root: str, corpus: str, priors: dict) -> dict:
    """Phase 10b: ``ComplexTrainer`` (GCRN at 8 x 48000,
    ``aia_complex_trans_ri`` at 4 x 48000) and ``MagTrainer`` (GRN at 8 x
    48000) in bf16 compute: the K1 step against the plain-STFT step, a step
    on each train batch, and ``enhance_batch`` on the batch of phase 3 (K1 =
    1, K2 = 1)."""
    import torch

    paths = {}
    wav = speechlike(BATCH, LENGTH, 3)
    for name in BF16_TRAIN_PRIORS:
        tr = complex_trainer(device, name, priors[name], root, corpus, tag="_bf16", bf16=True)
        trainer, kind = type(tr).__name__, "mag" if name == "GRN" else "complex"
        if tr.compute_dtype != torch.bfloat16 or tr.model_train is tr.model:
            fail(f"{trainer} [{name}] does not train in bf16")
        with spent("setup"):
            batches = [tr.put_batch(b.noisy, b.clean, b.frame_nums) for b in tr.tr_loader]
        bf16_step_through_k1_and_plain(tr, batches[0], f"{trainer}, {name}")
        paths[f"train_step_bf16_{kind}_{name}"] = checked_steps(
            tr, batches, f"{trainer}, {name}, bf16")
        reset_counts()
        out = tr.enhance_batch(wav)
        torch.cuda.synchronize()
        paths[f"serve_batch_bf16_{kind}_{name}"] = expect_counts(
            f"{trainer}.enhance_batch [{name}, bf16-trained]", {"stft": 1, "istft": 1})
        if out.shape != (BATCH, LENGTH) or out.dtype != torch.float32 or not bool(
                torch.isfinite(out).all()):
            fail(f"{trainer}.enhance_batch [{name}, bf16]: {tuple(out.shape)} {out.dtype}")
    return paths


def bf16_train_phase(device, card, root: str, corpus: str, priors: dict) -> dict:
    """Phase 10; returns the launch counts of its paths."""
    paths = bf16_ddpm_phase(device, card, root, corpus)
    paths.update(bf16_prior_train_phase(device, card, root, corpus, priors))
    return paths

def native_batch_np(ds, idx, starts):
    """The native runtime's batch re-derived in numpy from ``read_wav``:
    crop at ``start % (len - chunk + 1)``, a float32 RMS scale from a
    sequential double energy (1 for an all-zero crop), float32 products."""
    from prior_diffuse_tpu_torch.data.dataset import Batch
    from prior_diffuse_tpu_torch.data.wavio import read_wav

    b, chunk = len(idx), ds.chunk_length
    out = [np.zeros((b, chunk), np.float32), np.zeros((b, chunk), np.float32),
           np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, np.float32)]
    for i, j in enumerate(idx):
        nz = read_wav(os.path.join(ds.noisy_root, ds.names[j]))[0]
        cl = read_wav(os.path.join(ds.clean_root, ds.names[j]))[0]
        n, s = min(len(nz), len(cl)), 0
        if n > chunk:
            s, n = int(starts[i]) % (n - chunk + 1), chunk
        energy = np.cumsum(nz[s:s + n].astype(np.float64) ** 2)[-1]
        c = np.float32(np.sqrt(n / energy) if energy > 0 else 1.0)
        out[0][i, :n], out[1][i, :n] = nz[s:s + n] * c, cl[s:s + n] * c
        out[2][i], out[3][i], out[4][i] = n // 160 + 1, n, c
    return Batch(*out)


def native_loader_check(corpus: str, card) -> None:
    """Phase 11a: the native train loader (the trainers' default) builds,
    serves every batch of an epoch at 6 x 48000, and its batches equal the
    numpy re-derivation of its crops bit for bit; its ms a batch (the
    Python path's is ``tools/card_numbers.py``'s)."""
    from prior_diffuse_tpu_torch.data.dataset import PairedWavDataset, TrainLoader
    from prior_diffuse_tpu_torch.runtime import native

    if not native.available():
        fail("the native runtime did not build or load (g++)")
    ds = PairedWavDataset(f"{corpus}/noisy_trainset_wav", f"{corpus}/clean_trainset_wav",
                          chunk_length=LENGTH)
    seed = 11
    loader = TrainLoader(ds, TRAIN_BATCH, seed=seed)
    t0 = time.perf_counter()
    got = list(loader)
    ms = (time.perf_counter() - t0) * 1e3 / max(len(got), 1)
    served = loader.native_batches
    n = CORPUS[0] // TRAIN_BATCH
    if len(got) != n or served != n:
        fail(f"the native loader served {served} of {len(got)} batches, expected {n} of {n}")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ds))
    for k, b in enumerate(got):
        want = native_batch_np(ds, order[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH],
                               rng.integers(0, 2**62, size=TRAIN_BATCH))
        for f in ("noisy", "clean", "frame_nums", "wav_lens", "scales"):
            a, w = getattr(b, f), getattr(want, f)
            if a.dtype != w.dtype or not np.array_equal(a, w):
                fail(f"native batch {k}: {f} differs from the numpy re-derivation")
    print(f"native train loader: {native.library_path().name}, {n} of {n} batches of "
          f"{TRAIN_BATCH} x {LENGTH} served natively, equal to the numpy re-derivation bit "
          f"for bit; {ms:.2f} ms a batch (host clock, one epoch, prefetch thread included); "
          f"card {card}", flush=True)


def trace_steps(trace_dir: str) -> tuple:
    """``(kernel names, kernels launched in each step, launch calls, memsets
    and copies)`` of the one Chrome trace under ``trace_dir``: a kernel
    belongs to the step in whose host window it was launched (its launch
    call shares its correlation id), a joint step ending with its second
    ``Adam.step``."""
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"{trace_dir}: {len(files)} trace files, expected 1")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ends = sorted(e["ts"] + e["dur"] for e in events if e.get("cat") == "user_annotation"
                  and e["name"].startswith("Optimizer.step#Adam.step"))[1::2]
    kernels = [(e["name"], launch.get(e.get("args", {}).get("correlation"))) for e in events
               if e.get("cat") == "kernel"]
    per_step = [sum(t is not None and lo < t <= hi for _, t in kernels)
                for lo, hi in zip([float("-inf")] + ends[:-1], ends)]
    calls = sum(e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in e.get("name", "")
                for e in events)
    copies = sum(e.get("cat") in ("gpu_memset", "gpu_memcpy") for e in events)
    return [name for name, _ in kernels], per_step, calls, copies


def tooling_phase(device, card, root: str, corpus: str) -> dict:
    """Phase 11: the native train loader, the CLI with ``--profile-steps``
    (in a process of its own), ``--draw`` (its eval batch and ``spec_db``
    on the card; the figures need matplotlib, which this machine may not
    have, so the figure call is replaced by a recorder) and the
    ``metrics.compare`` command line; returns the launch counts of the draw
    batch.  The two command lines run in processes of their own while this
    one checks the native loader and ``--draw``; every process it starts is
    gone when it returns or fails."""
    with open(os.path.join(ROOT, "conf", "diff.yml")) as f:
        text = f.read()
    conf = os.path.join(root, "diff_1_epoch.yml")
    with open(conf, "w") as f:
        f.write(text.replace("n_epochs: 50", "n_epochs: 1"))
    assets = os.path.join(root, "cli_profile")
    args = ["--config", conf, "--joint", "--sigma", "--data-root", corpus, "--assets",
            assets, "--seed", "11"]
    traced = 2
    ref, deg = os.path.join(corpus, "clean_testset_wav"), os.path.join(root, "cli", "wav", "diff")
    log = lambda name, kind: os.path.join(root, f"{name}.{kind}")  # noqa: E731
    # a process of its own, as a user runs it: in this long-lived process,
    # after many profiler sessions, torch.profiler once lost kernel records
    # of a trace's first step (PERF.md)
    t0 = time.perf_counter()
    procs = [run_session([sys.executable, "-m", "prior_diffuse_tpu_torch.cli", *args,
                          "--profile-steps", str(traced)], log("profile", "out"), 900,
                         log("profile", "err")),
             run_session([sys.executable, "-m", "prior_diffuse_tpu_torch.metrics.compare", ref,
                          deg], log("compare", "out"), 600, log("compare", "err"))]
    try:
        paths = tooling_checks(device, card, corpus, args, assets, traced, procs, t0)
    finally:
        kill_sessions(procs)
    return paths


def tooling_checks(device, card, corpus: str, args: list, assets: str, traced: int,
                   procs: list, t0: float) -> dict:
    """Phase 11's checks while its two command lines (``procs``: the
    ``--profile-steps`` run, the compare, started at ``t0``) run; returns
    the launch counts of the draw batch."""
    import re

    import torch

    from prior_diffuse_tpu_torch import cli, viz

    native_loader_check(corpus, card)
    profile, compare = procs
    (code,) = finish_sessions([profile])
    if code != 0:
        fail(f"cli --profile-steps: exit {code}\n{tail(profile.err_path, 3000)}")
    wall = time.perf_counter() - t0
    kernels, per_step, calls, copies = trace_steps(os.path.join(assets, "log", "diff", "trace"))
    steps = [r for r in metric_records(os.path.join(assets, "log", "diff")) if "loss_sum" in r]
    if len(steps) != CORPUS[0] // TRAIN_BATCH or not finite(r["loss_sum"] for r in steps):
        fail(f"cli --profile-steps: {len(steps)} train records")
    # K1's demangled name: "(anonymous namespace)::stft_kernel(float const*, ...)"
    k1 = sum(bool(re.search(r"(^|::|void )stft_kernel\(", k)) for k in kernels)
    if (k1 != 2 * traced or len(per_step) != traced or sum(per_step) != len(kernels)
            or calls != len(kernels)):
        fail(f"the trace holds {k1} K1 launches, expected {2 * traced}, {per_step} kernels "
             f"in its steps, {len(kernels)} kernel records for {calls} launch calls")
    print(f"python -m prior_diffuse_tpu_torch.cli ... --profile-steps {traced} ({wall:.1f} s "
          f"wall, one epoch): the trace holds {len(kernels)} kernel launches, one record for "
          f"each launch call, {per_step} in its {traced} steps (step 0 also takes the group "
          f"gradient norms), K1 {k1}, and {copies} memsets and copies (tools/card_numbers.py "
          f"counts a step without the norms by the profiler); card {card}", flush=True)
    paths = {}

    drawn = []
    reset_counts()
    with mock.patch.object(viz, "draw_comparison",
                           lambda wavs, titles, **kw: drawn.append((list(wavs), kw))):
        cli.main(args + ["--draw", "--retrain"])
    torch.cuda.synchronize()
    paths["cli_draw"] = expect_counts("cli.main --draw (one cv batch, figures recorded)",
                                      {"stft": 2, "istft": 2, "enc_stage": 35})
    draw = [r for r in metric_records(os.path.join(assets, "log", "diff")) if "draw_loss" in r]
    if (len(drawn) != TRAIN_BATCH or len(draw) != 1 or not finite(
            draw[0][k] for k in draw[0] if k.startswith("draw_"))):
        fail(f"--draw: {len(drawn)} figures, {len(draw)} draw records")
    for wavs, kw in drawn:
        if (len(wavs) != 3 or torch.device(kw["device"]).type != "cuda" or not os.path.basename(
                kw.get("path", "")).startswith("draw_b0_")
                or not all(np.isfinite(w).all() and len(w) > 160 for w in wavs)):
            fail("--draw: a figure's waveforms, device or path are wrong")
    reset_counts()
    worst_mag = worst_db = 0.0
    for w in drawn[0][0]:
        got, want = viz.spec_db(w, device=device), viz.spec_db(w, device="cpu")
        mag_got, mag_want = 10 ** (got / 20), 10 ** (want / 20)
        worst_mag = max(worst_mag, float(np.abs(mag_got - mag_want).max() / mag_want.max()))
        near = want > want.max() - 60
        worst_db = max(worst_db, float(np.abs(got - want)[near].max()))
    expect_counts("spec_db of one figure's 3 waveforms on the card", {"stft": 3})
    print(f"--draw: {len(drawn)} figures recorded, draw loss {draw[0]['draw_loss']:.5f}, "
          f"stoi {draw[0]['draw_mean_stoi']:.3f}; spec_db on the card (K1) vs the CPU (plain): "
          f"magnitudes {worst_mag:.2e} of the peak (bound {KERNEL_RTOL:g}), {worst_db:.2e} dB "
          f"within 60 dB of the peak", flush=True)
    if worst_mag > KERNEL_RTOL:
        fail("spec_db on the card is off the CPU's")

    (code,) = finish_sessions([compare])
    with open(compare.log_path) as f:
        stdout = f.read()
    line = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    values = re.findall(r"(csig|cbak|covl|pesq|ssnr|stoi):\s*(\S+)", line)
    if code != 0 or len(values) != 6 or not finite(float(v) for _, v in values):
        fail(f"metrics.compare: exit {code}, last line {line!r}, {tail(compare.err_path, 2000)}")
    print(f"python -m prior_diffuse_tpu_torch.metrics.compare (clean test set vs phase 6's "
          f"--generate): {line}", flush=True)
    return paths


# ---- phase 12: data parallelism ----------------------------------------------

# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device).  Their global batches: conf/diff.yml's 6 (3 rows a rank) and a
# ragged 5, which JAX pads to 6 with a zero row whose frame_nums is 0
# (BatchNorm's statistics see it, the losses mask it), so the one-process
# step it is held to takes that padded batch.  The bounds are the CPU
# tests' (tests/test_torch_dp_trainer.py's slice, after
# tests/test_torch_train_step.py): losses and BN running statistics 1e-5;
# group norms 1e-3 with an atol of 1e-5 of the net's largest, and the
# updates within 2 lr, at most 1e-3 of the gradient's norm at elements of
# opposite sign and 1e-3 relative L2 over the steady same-sign elements
# (the step's own rounding floor at a padded batch: python3
# tools/dp_probe.py).  At this width the floor can be higher: the same
# one-process step with the noisy and the clean batch times 1 + 1e-7
# N(0, 1) gives each distance's floor in this run, and a bound below
# DP_FLOOR times it is raised to that (printed).  The control: the ranks' step with per-rank
# BatchNorm statistics (what DDP does without SyncBatchNorm) must miss.
# The evaluation's loss and diagnostics as the CPU tests' eval step, its
# metrics relative.
DP_WORLD, DP_RAGGED = 2, 5
DP_LOSS_RTOL, DP_NORM_RTOL, DP_STATS_RTOL, DP_UPDATE_RTOL = 1e-5, 1e-3, 1e-5, 1e-3
DP_FLOOR = 4.0
DP_EVAL_RTOL, DP_METRIC_RTOL = 2.5e-4, 1e-3
DP_TIMEOUT = 300  # seconds for each group of processes


def run_session(cmd: list, log_path: str, timeout: float = DP_TIMEOUT,
                err_path: str = None) -> subprocess.Popen:
    """Start ``cmd`` from the checkout in a session of its own, its output
    to ``log_path`` (its errors too, or to ``err_path``); wait with
    :func:`wait_sessions` or :func:`finish_sessions`, which kill it at
    ``timeout`` seconds from now."""
    log = open(log_path, "w")
    err = open(err_path, "w") if err_path else None
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=err or subprocess.STDOUT,
                            env={**os.environ, "PYTHONPATH": ROOT}, start_new_session=True)
    proc.log_path, proc.err_path = log_path, err_path or log_path
    proc.deadline = time.monotonic() + timeout
    log.close()
    if err:
        err.close()
    return proc


def kill_sessions(procs: list) -> None:
    """Kill each process of ``procs`` with all it started (its session:
    torchrun's worker too) and reap it; a session already gone is left."""
    import signal

    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()


@booked("subprocess")
def finish_sessions(procs: list) -> list:
    """Wait for every process of ``procs``; at the first deadline kill them
    all (:func:`kill_sessions`); returns their exit codes."""
    try:
        for p in procs:
            p.wait(timeout=max(1.0, p.deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        kill_sessions(procs)
    return [p.returncode for p in procs]


def wait_sessions(procs: list, what: str) -> None:
    """:func:`finish_sessions`, then fail unless each exited 0."""
    for i, (p, code) in enumerate(zip(procs, finish_sessions(procs))):
        if code != 0:
            with open(p.log_path) as f:
                fail(f"{what} [{i}] exited {code}:\n{f.read()[-3000:]}")


def tail(path: str, n: int) -> str:
    with open(path) as f:
        return f.read()[-n:]


def dp_trainer(inp: dict, parallel=None):
    """Phase 12's ``ComplexDDPMTrainer``: conf/diff.yml, ``--joint --sigma``,
    seed 7, phase 5's corpus; one process's, or one rank's."""
    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    tag = "one" if parallel is None else f"rank{parallel.rank}"
    exp = load_experiment(inp["conf"])
    run = RunConfig(seed=7, joint=True, sigma=True, data_root=inp["corpus"],
                    assets=os.path.join(inp["root"], f"dp_{tag}"))
    return ComplexDDPMTrainer(run, exp, device=inp["rank_devices"][0], parallel=parallel)


@booked("measure")
def dp_ms(fn, device) -> float:
    """ms a call of ``fn``: CUDA events on the card (5 calls after 1), the
    host clock in a CPU rehearsal."""
    if device.type == "cuda":
        return cuda_ms(fn, iters=5, warmup=1)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def dp_step(tr, batch) -> dict:
    """One train step with its group norms: the losses and norms (the global
    batch's), the launches, a hash of the nets after it and, on rank 0 or
    alone, each net's flat gradient, update and BN running statistics."""
    import hashlib

    import torch

    before = {n: torch.cat([p.detach().flatten() for p in m.parameters()])
              for n, m in tr.nets.items()}
    reset_counts()
    *losses, gnorms = tr._train_step(*batch)
    rec = {"loss": [float(v) for v in losses], "counts": read_counts(),
           "gnorms": {k: float(v) for k, v in gnorms.items()}}
    digest = hashlib.sha256()
    for m in tr.nets.values():
        for t in (*m.parameters(), *m.buffers()):
            digest.update(t.detach().cpu().numpy().tobytes())
    rec["digest"] = digest.hexdigest()
    if tr.is_main:
        flat = lambda ts: torch.cat([t.detach().flatten().float() for t in ts]).cpu()
        rec["grad"] = {n: flat(p.grad if p.grad is not None else torch.zeros_like(p)
                               for p in m.parameters()) for n, m in tr.nets.items()}
        rec["update"] = {n: flat(m.parameters()) - before[n].cpu() for n, m in tr.nets.items()}
        rec["stats"] = {n: flat(b for k, b in m.named_buffers() if "running" in k)
                        for n, m in tr.nets.items()}
    return rec


def dp_run(tr, batches: dict, local_stats: tuple = (), timed: bool = False) -> dict:
    """From one state: a step on each global batch (``batches``: name -> this
    process's rows on the device; those named in ``local_stats`` with each
    rank's own BatchNorm statistics, the control), if ``timed`` the ms of a
    step on ``batches["full"]``, and ``evaluate()`` with its records and
    launches (rank 0 scores and writes)."""
    from prior_diffuse_tpu_torch.models import layers

    snap = copy.deepcopy(tr.ckpt_payload())
    out = {"steps": {}}
    for name, batch in batches.items():
        tr.restore_payload(copy.deepcopy(snap))
        if name in local_stats:
            with mock.patch.object(layers, "current_parallel", lambda: None):
                out["steps"][name] = dp_step(tr, batch)
        else:
            out["steps"][name] = dp_step(tr, batch)
    if timed:
        tr.restore_payload(copy.deepcopy(snap))
        out["ms"] = dp_ms(lambda: tr._train_step(*batches["full"], norms=False), tr.device)
    tr.restore_payload(copy.deepcopy(snap))
    reset_counts()
    t0 = time.perf_counter()
    out["cv_loss"] = tr.evaluate()
    out["eval_wall"] = time.perf_counter() - t0
    out["eval_counts"] = read_counts()
    # what the trainer's metrics logger wrote: evaluate()'s records, rank 0's alone
    written = os.path.exists(os.path.join(tr.run.log_dir, "metrics.jsonl"))
    out["records"] = [{k: v for k, v in r.items() if k not in ("time", "step")}
                      for r in (metric_records(tr.run.log_dir) if written else [])]
    return out


def dp_rank_main(rank: int, world: int, tmp: str) -> None:
    """One rank of a phase-12 group, ``chip_smoke.py --dp-rank RANK WORLD
    DIR``: the inputs of ``DIR/in.pt`` (its backend and each rank's device),
    the results to ``DIR/out_<RANK>.pt``."""
    import torch

    sys.path.insert(0, ROOT)
    from prior_diffuse_tpu_torch.parallel import distributed
    from prior_diffuse_tpu_torch.parallel.mesh import DataParallel

    inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=True)
    device = torch.device(inp["rank_devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    distributed.initialize(backend=inp["backend"], rank=rank, world_size=world,
                           init_method=f"file://{os.path.join(tmp, 'pg')}", device=device)
    try:
        dp = DataParallel(device)
        tr = dp_trainer(inp, dp)
        # the sharded loader's first batch is this rank's rows of the global one
        rows = next(iter(tr.tr_loader))
        loader_equal = all(np.array_equal(a, dp.shard_rows(b).numpy()) for a, b in zip(
            (rows.noisy, rows.clean, rows.frame_nums), inp["batch"]))
        full = tr.put_batch(*inp["batch"])
        out = dp_run(tr, {"full": full, "control": full,
                          "ragged": tr.put_batch(*(a[:DP_RAGGED] for a in inp["batch"]))},
                     local_stats=("control",), timed=inp["timed"])
        out["loader_equal"] = loader_equal
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def dp_distances(got: dict, ref: dict, lrs: dict) -> dict:
    """How far a step (``got``) sits from the one-process step (``ref``): the
    losses (the largest relative difference), the group norms (the largest
    ``|a - b| / (|b| + 1e-2 x the net's largest)``: an rtol whose atol is
    1e-2 of it times that), and, where ``got`` has them (rank 0), each net's
    BN running statistics (the largest ``|a - b| / (|b| + 1e-2)``), gradient
    (relative L2) and update: relative L2 over the steady elements whose
    gradient has the same sign in both, the largest difference in units of
    lr, and the share of the gradient's norm at elements of opposite sign."""
    import torch

    rel = lambda a, b: float(torch.linalg.vector_norm(a - b)
                             / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))
    net_max = {}
    for k, v in ref["gnorms"].items():
        net_max[k.split("/")[0]] = max(v, net_max.get(k.split("/")[0], 0.0))
    d = {"loss": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
         "norms": max(abs(got["gnorms"].get(k, float("inf")) - b)
                      / (b + 1e-2 * net_max[k.split("/")[0]]) for k, b in ref["gnorms"].items()),
         "nets": {}}
    for n in ref["grad"] if "grad" in got else ():
        g, g_ref = got["grad"][n], ref["grad"][n]
        du, ref_u = got["update"][n], ref["update"][n]
        flips = torch.sign(g) != torch.sign(g_ref)
        steady = ~flips & (g_ref.abs() >= STEADY_GRAD)
        s, s_ref = got["stats"][n], ref["stats"][n]
        d["nets"][n] = {"stats": float(((s - s_ref).abs() / (s_ref.abs() + 1e-2)).max()),
                        "grad": rel(g, g_ref), "update": rel(du[steady], ref_u[steady]),
                        "update_max": float((du - ref_u).abs().max()) / lrs[n],
                        "flips": rel(torch.where(flips, 0.0, g_ref), g_ref)}
    return d


def dp_check(label: str, d: dict, floor: dict) -> list:
    """Each distance of :func:`dp_distances` against the larger of its CPU
    bound and DP_FLOOR times the same distance of the one-process step on the
    perturbed batch (``floor``); the update's largest element (2 lr) and the
    opposite-sign share (1e-3) against their fixed bounds.  Prints them all;
    returns what misses."""
    misses, parts = [], []

    def held(name, value, cpu_bound, floor_value=0.0):
        bound = max(cpu_bound, DP_FLOOR * floor_value)
        parts.append(f"{name} {value:.3e} (bound {bound:.3e})")
        if not value <= bound:
            misses.append(name)

    held("losses", d["loss"], DP_LOSS_RTOL, floor["loss"])
    held("group norms", d["norms"], DP_NORM_RTOL, floor["norms"])
    for n, x in d["nets"].items():
        f = floor["nets"][n]
        held(f"{n} BN statistics", x["stats"], DP_STATS_RTOL, f["stats"])
        held(f"{n} same-sign updates", x["update"], DP_UPDATE_RTOL, f["update"])
        held(f"{n} largest update difference (lr)", x["update_max"], 2.0)
        held(f"{n} opposite-sign share", x["flips"], 1e-3)
        parts.append(f"{n} gradient rel L2 {x['grad']:.3e} (floor {f['grad']:.3e}, printed)")
    print(f"{label}: " + ", ".join(parts), flush=True)
    return misses


def dp_eval_held(got: dict, ref: dict) -> list:
    """Rank 0's evaluation records against the one process's."""
    want = {k: v for r in ref["records"] for k, v in r.items()}
    have = {k: v for r in got["records"] for k, v in r.items()}
    misses = [] if sorted(have) == sorted(want) else [f"record keys {sorted(have)}"]
    for k, w in want.items():
        v = have.get(k)
        if isinstance(w, str):
            ok = v == w
        elif k.endswith("res_cos"):
            ok = abs(v - w) <= DP_EVAL_RTOL
        elif k.startswith("test_mean_"):
            ok = abs(v - w) <= DP_METRIC_RTOL * max(abs(w), 1.0)
        else:
            ok = abs(v - w) <= DP_EVAL_RTOL * abs(w)
        if not ok:
            misses.append(f"{k} {v} vs {w}")
    return misses


def dp_inputs(device, root: str, corpus: str, world: int, backend: str, conf: str,
              timed: bool) -> tuple:
    """``(inputs, trainer)``: phase 12's inputs for ``world`` ranks (the
    backend, each rank's device, the yml, the first global batch of the
    corpus, whether a rank times its step) and the one process's trainer
    that drew that batch."""
    import torch

    devices = [str(device)] * world if backend == "gloo" else [f"cuda:{r}" for r in range(world)]
    inp = {"corpus": corpus, "root": root, "backend": backend, "rank_devices": devices,
           "conf": conf or os.path.join(ROOT, "conf", "diff.yml"), "timed": timed}
    with spent("setup"):
        one = dp_trainer(inp)
        b = next(iter(one.tr_loader))
    inp["batch"] = [torch.from_numpy(a) for a in (b.noisy, b.clean, b.frame_nums)]
    return inp, one


def dp_spawn(inp: dict, root: str) -> dict:
    """Start the ranks of ``inp``, each a process of its own
    (:func:`dp_rank_main`); :func:`dp_outputs` collects them."""
    import torch

    world = len(inp["rank_devices"])
    tmp = os.path.join(root, f"dp_{inp['backend']}_{world}")
    os.makedirs(tmp)
    torch.save(inp, os.path.join(tmp, "in.pt"))
    return {"tmp": tmp, "backend": inp["backend"], "t0": time.perf_counter(),
            "procs": [run_session([sys.executable, os.path.abspath(__file__), "--dp-rank",
                                   str(r), str(world), tmp], os.path.join(tmp, f"rank{r}.log"))
                      for r in range(world)]}


def dp_outputs(group: dict) -> tuple:
    """``(outputs, seconds)``: each rank's results of :func:`dp_spawn`'s
    ``group`` (failing unless every rank exited 0) and the group's wall
    time."""
    import torch

    wait_sessions(group["procs"], f"{group['backend']} rank")
    wall = time.perf_counter() - group["t0"]
    return [torch.load(os.path.join(group["tmp"], f"out_{r}.pt"), weights_only=True)
            for r in range(len(group["procs"]))], wall


def dp_ranks_phase(device, card, root: str, corpus: str, world: int = DP_WORLD,
                   backend: str = "gloo", conf: str = None, timed: bool = True) -> dict:
    """Phase 12a: the one-process run on this process (with its steps on the
    perturbed batches, the floors), then the same run on ``world`` ranks,
    held to it; returns the ranks' launch counts.  gloo ranks share
    ``device``; NCCL ranks take a card each (``tools/dp_cards.py``).
    ``conf`` (default conf/diff.yml) sets the global batch; with ``timed``
    each run also times its step (``chip_smoke.py`` leaves that to
    ``tools/card_numbers.py``).  :func:`dp_ranks_start`, then
    :func:`dp_ranks_finish`."""
    return dp_ranks_finish(dp_ranks_start(device, card, root, corpus, world, backend, conf,
                                          timed))


def dp_ranks_start(device, card, root: str, corpus: str, world: int = DP_WORLD,
                   backend: str = "gloo", conf: str = None, timed: bool = True) -> dict:
    """Phase 12a's first half (:func:`dp_ranks_phase`): the one-process run,
    then the ranks started; returns what :func:`dp_ranks_finish` holds them
    to."""
    import torch

    inp, one = dp_inputs(device, root, corpus, world, backend, conf, timed)
    rows = len(inp["batch"][0])
    if rows % world:  # the one process's cv batch is unpadded: its draws are the ranks' only so
        fail(f"{world} ranks do not divide the global batch of {rows}")

    def padded(a, n):  # the first n rows, padded as the ranks pad them
        return torch.cat([a[:n], a.new_zeros((-(-n // world) * world - n, *a.shape[1:]))])

    cases = {"full": [padded(a, rows) for a in inp["batch"]],
             "ragged": [padded(a, DP_RAGGED) for a in inp["batch"]]}
    g = torch.Generator().manual_seed(12)
    jitter = lambda a: a * (1 + 1e-7 * torch.randn(a.shape, generator=g))
    batches = {}
    for name, (noisy, clean, frames) in cases.items():
        batches[name] = one.put_batch(noisy, clean, frames)
        batches[f"{name}_floor"] = one.put_batch(jitter(noisy), jitter(clean), frames)
    ref = dp_run(one, batches, timed=timed)
    lrs = {n: opt_of(one, n).param_groups[0]["lr"] for n in one.nets}
    del one, batches
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"group": dp_spawn(inp, root), "ref": ref, "lrs": lrs, "rows": rows,
            "world": world, "backend": backend, "card": card, "timed": timed}


def dp_ranks_finish(run: dict) -> dict:
    """Phase 12a's second half (:func:`dp_ranks_phase`): the ranks of
    :func:`dp_ranks_start`'s ``run`` held to its one-process run; returns
    their launch counts."""
    ref, lrs, rows, world = run["ref"], run["lrs"], run["rows"], run["world"]
    backend, card, timed = run["backend"], run["card"], run["timed"]
    outs, wall = dp_outputs(run["group"])
    if not all(o["loader_equal"] for o in outs):
        fail("a rank's sharded train loader is not its rows of the one-process batch")
    steps = ref["steps"]
    floors = {c: dp_distances(steps[f"{c}_floor"], steps[c], lrs) for c in ("full", "ragged")}
    same = lambda got, want: got == {k: want.get(k, 0) for k in got}
    label = f"{world} {backend} ranks"
    misses, paths = [], {}
    for name, n in (("full", rows), ("ragged", DP_RAGGED)):
        for r, o in enumerate(outs):
            got = o["steps"][name]
            misses += [f"{name} rank {r}: {m}" for m in dp_check(
                f"{label} vs one process, step on {n} x {LENGTH} [rank {r}]",
                dp_distances(got, steps[name], lrs), floors[name])]
            if not same(got["counts"], {"stft": 2}):
                misses.append(f"{name} rank {r}: launches {got['counts']}")
            paths[f"dp_step_rank{r}"] = got["counts"]
        if len({o["steps"][name]["digest"] for o in outs}) != 1:
            misses.append(f"{name}: the ranks' nets differ after the step")
    control = dp_check("the control, each rank's own BatchNorm statistics [rank 0]",
                       dp_distances(outs[0]["steps"]["control"], steps["full"], lrs),
                       floors["full"])
    if not control:
        fail("the data-parallel step check passed per-rank BatchNorm statistics")
    for r, o in enumerate(outs):
        if abs(o["cv_loss"] - ref["cv_loss"]) > DP_EVAL_RTOL * abs(ref["cv_loss"]):
            misses.append(f"rank {r} cv loss {o['cv_loss']} vs {ref['cv_loss']}")
        if not same(o["eval_counts"], {"stft": 2, "istft": 2 if r == 0 else 0, "enc_stage": 35}):
            misses.append(f"rank {r} evaluate() launches {o['eval_counts']}")
        paths[f"dp_eval_rank{r}"] = o["eval_counts"]
    misses += [f"evaluate(): {m}" for m in dp_eval_held(outs[0], ref)]
    if any(o["records"] for o in outs[1:]):
        misses.append("a rank other than 0 wrote metrics")
    ev = {k: v for rec in outs[0]["records"] for k, v in rec.items()}
    pace = ("the ranks share one card and gloo copies every collective through the host, so "
            "no scaling is claimed" if backend == "gloo" else "a card a rank")
    ms = (f"step {ref['ms']:.3f} ms in one process, {outs[0]['ms']:.3f} ms on {label} (rank 0; "
          f"CUDA events, 5 steps of {rows} x {LENGTH}; {pace}); " if timed else "")
    print(f"the control misses on: {', '.join(control)}; the ranks' nets hash alike after each "
          f"step; launches a step {[o['steps']['full']['counts'] for o in outs]} (one process "
          f"{steps['full']['counts']}); evaluate() of one cv batch of {rows}: cv loss "
          f"{outs[0]['cv_loss']:.6f} (one process {ref['cv_loss']:.6f}), prior_mse "
          f"{ev.get('test_prior_mse', float('nan')):.6f}, pesq "
          f"{ev.get('test_mean_pesq', float('nan')):.3f}, launches per rank "
          f"{[o['eval_counts'] for o in outs]} (one process {ref['eval_counts']}); {ms}"
          f"evaluate() {ref['eval_wall']:.2f} s / {outs[0]['eval_wall']:.2f} s wall; "
          f"{wall:.1f} s for the ranks' processes; card {card}", flush=True)
    if misses:
        fail("data-parallel step or evaluation: " + "; ".join(misses))
    return paths


def dp_nccl_cli_phase(root: str, corpus: str, card, nproc: int = 1, conf: str = None) -> None:
    """Phase 12b: ``python -m torch.distributed.run --standalone
    --nproc_per_node=NPROC -m prior_diffuse_tpu_torch.cli``, NCCL, a card a
    rank: one epoch of ``conf`` (default conf/diff.yml; rank 0 writes the
    log, metrics and checkpoints), then ``--generate``.
    :func:`dp_nccl_cli_start`, then :func:`dp_nccl_cli_finish`."""
    dp_nccl_cli_finish(dp_nccl_cli_start(root, corpus, card, nproc, conf))


def dp_nccl_cli_start(root: str, corpus: str, card, nproc: int = 1, conf: str = None) -> dict:
    """Phase 12b's first half (:func:`dp_nccl_cli_phase`): the epoch's
    ``torch.distributed.run`` started in a session of its own; returns what
    :func:`dp_nccl_cli_finish` needs."""
    from prior_diffuse_tpu_torch.config import load_experiment

    with open(conf or os.path.join(ROOT, "conf", "diff.yml")) as f:
        text = f.read()
    conf = os.path.join(root, f"diff_dp{nproc}_1_epoch.yml")
    with open(conf, "w") as f:
        f.write(text.replace("n_epochs: 50", "n_epochs: 1"))
    assets = os.path.join(root, f"cli_nccl{nproc}")
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}", "-m", "prior_diffuse_tpu_torch.cli", "--config", conf,
            "--joint", "--sigma", "--data-root", corpus, "--assets", assets, "--seed", "11"]
    return {"args": args, "assets": assets, "corpus": corpus, "card": card, "nproc": nproc,
            "batch": load_experiment(conf).train.batch_size, "t0": time.perf_counter(),
            "proc": run_session(args, os.path.join(root, f"nccl{nproc}_0.log"))}


def dp_nccl_cli_finish(run: dict) -> None:
    """Phase 12b's second half (:func:`dp_nccl_cli_phase`): the epoch of
    :func:`dp_nccl_cli_start`'s ``run`` waited for, then ``--generate``;
    their logs, metrics, checkpoints and wavs checked."""
    import torch

    from prior_diffuse_tpu_torch.data.wavio import read_wav

    args, assets, corpus, card = run["args"], run["assets"], run["corpus"], run["card"]
    nproc, batch = run["nproc"], run["batch"]
    wait_sessions([run["proc"]], "torch.distributed.run ")
    walls = [time.perf_counter() - run["t0"]]
    t0 = time.perf_counter()
    log = os.path.join(os.path.dirname(run["proc"].log_path), f"nccl{nproc}_1.log")
    wait_sessions([run_session(args + ["--generate"], log)], "torch.distributed.run --generate")
    walls.append(time.perf_counter() - t0)
    log_dir = os.path.join(assets, "log", "diff")
    with open(os.path.join(log_dir, "stdout.txt")) as f:
        log = f.read()
    if "backend nccl" not in log:
        fail("the CLI under torch.distributed.run did not log an NCCL process group")
    recs = metric_records(log_dir)
    steps = [r for r in recs if "loss_sum" in r]
    evals = [r for r in recs if "test_loss" in r]
    n_steps = CORPUS[0] // batch
    if len(steps) != n_steps or len(evals) != 1 or not finite(
            [r["loss_sum"] for r in steps] + [evals[0]["test_loss"]]):
        fail(f"NCCL cli: {len(steps)} train records, {len(evals)} eval records")
    for path in ("epochs/0.pt", "best.pt"):
        if not os.path.exists(os.path.join(assets, "checkpoint", "diff", path)):
            fail(f"NCCL cli: no checkpoint {path}")
    ins = sorted(glob.glob(os.path.join(corpus, "noisy_testset_wav", "*.wav")))
    outs = sorted(glob.glob(os.path.join(assets, "wav", "diff", "*.wav")))
    if [os.path.basename(p) for p in outs] != [os.path.basename(p) for p in ins]:
        fail(f"NCCL --generate wrote {len(outs)} wavs for {len(ins)} inputs")
    for i, o in zip(ins, outs):
        x, y = read_wav(i)[0], read_wav(o)[0]
        if y.shape != x.shape or not np.isfinite(y).all() or not np.abs(y).max() > 0:
            fail(f"NCCL --generate: {o} has {y.shape} for {x.shape}, or no finite signal")
    print(f"python -m torch.distributed.run --standalone --nproc_per_node={nproc} -m "
          f"prior_diffuse_tpu_torch.cli (NCCL {torch.cuda.nccl.version()}): one epoch of "
          f"{n_steps} steps and an evaluation in {walls[0]:.1f} s wall (cv loss "
          f"{evals[0]['test_loss']:.5f}, step to step "
          f"{np.median(logged_step_ms(steps, 'NCCL cli log')):.3f} ms median on the host "
          f"clock), rank 0's log, metrics and checkpoints written; "
          f"--generate: {len(outs)} wavs at the inputs' lengths in {walls[1]:.1f} s wall; "
          f"card {card}", flush=True)


def dp_phase(device, card, root: str, corpus: str) -> dict:
    """Phase 12: data parallelism (12a on gloo, 12b on NCCL); returns the
    gloo ranks' launch counts.  12a's ranks and 12b's command line share
    nothing but the card and the corpus they read, so they run at once,
    each process held to the same checks as when they ran in turn; every
    process this starts is gone when it returns or fails."""
    ranks = dp_ranks_start(device, card, root, corpus, timed=False)
    cli_run = dp_nccl_cli_start(root, corpus, card)
    try:
        paths = dp_ranks_finish(ranks)
        dp_nccl_cli_finish(cli_run)
    finally:
        kill_sessions(ranks["group"]["procs"] + [cli_run["proc"]])
    return paths


# Phase 13: a share above 1 would mean the program ran faster than the
# least time the card could take for its work; 5 % is left for the
# rounding of the counts and of the times.
SHARE_MAX = 1.05


@booked("setup")
def roofline_paths(device, nets, priors, root: str, corpus: str,
                   served: dict | None = None) -> dict:
    """Phase 13's programs, as a user calls them, by name: the serving batch
    of phase 3 (``Enhancer.eager_batch``, the batch op by op, 8 x 3 s,
    fast-6, for its count; into ``served``, if given, the same batch as
    served, ``enhance_batch``, which bf16 replays as a CUDA graph) in f32
    and bf16; ``conf/diff.yml``'s ``--joint --sigma`` train
    step (6 x 48000, group norms off, as on 49 of 50 loop steps) in f32 and
    in bf16 compute, each on a fresh trainer; and the GCRN and ``aia_complex_trans_ri``
    priors alone (``ComplexTrainer``'s ``PriorServer``) on the batch of
    phase 3.  Also ``tools/roofline_enhance.py``'s."""
    import torch

    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.serving.enhance import PriorServer
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    wav = torch.from_numpy(speechlike(BATCH, LENGTH, 3)).to(device)
    gen = torch.Generator(device=device)
    paths = {}
    for dtype in (torch.float32, torch.bfloat16):
        enh = Enhancer(*nets, device=device, dtype=dtype)
        enh.packs()  # packing is not a batch's work
        paths[f"serve_{str(dtype)[6:]}"] = (  # op by op: a count sees no replay's ops
            lambda enh=enh: enh.eager_batch(wav, gen.manual_seed(5)))
        if served is not None:
            served[f"serve_{str(dtype)[6:]}"] = (
                lambda enh=enh: enh.enhance_batch(wav, gen.manual_seed(5)))
    exp = load_experiment(os.path.join(ROOT, "conf", "diff.yml"))
    for tag, e in (("float32", exp), ("bfloat16", bf16_exp(exp))):
        run = RunConfig(seed=7, joint=True, sigma=True, data_root=corpus,
                        assets=os.path.join(root, f"assets_roofline_{tag}"))
        tr = ComplexDDPMTrainer(run, e, device=device)
        batch = [tr.put_batch(b.noisy, b.clean, b.frame_nums) for b in tr.tr_loader][0]
        paths[f"train_step_{tag}"] = (
            lambda tr=tr, batch=batch: tr._train_step(*batch, norms=False))
    for name in BF16_PRIORS:
        server = PriorServer(priors[name], prior_exp(name), device=device)
        paths[f"prior_{name}"] = lambda server=server: server.enhance_batch(wav)
    return paths


def roofline_phase(device, card, nets, priors, root: str, corpus: str) -> None:
    """Phase 13: each program of :func:`roofline_paths` counted by
    ``utils/roofline.py`` on the card (its kernels routed through their
    plain versions by ``analyze``), and counted again under
    :func:`plain_versions` (the same model FLOPs, or the routing failed);
    its ms (CUDA events, mean of 5 after 2) and device ms (profiler), of
    the serving batches as served (bf16: the graph's replay);
    its ceilings and the shares ``attained_fraction`` and ``mfu`` of both
    times, each at most ``SHARE_MAX``, against the card's own entry of
    ``CHIP_SPECS`` (an unknown card fails)."""
    import torch

    from prior_diffuse_tpu_torch.utils.roofline import analyze, chip_spec

    spec = chip_spec(device)
    if spec is None:
        fail(f"no roofline entry for {torch.cuda.get_device_name(device)}")
    served = {}
    for name, fn in roofline_paths(device, nets, priors, root, corpus, served).items():
        rep = analyze(fn)
        with plain_versions():
            plain = analyze(fn)
        torch.cuda.synchronize()
        t = rep.totals(spec)
        if plain.totals(spec)["model_flops"] != t["model_flops"] or not t["model_flops"]:
            fail(f"roofline [{name}]: {t['model_flops']:.0f} model FLOPs through the kernels' "
                 f"entry points, {plain.totals(spec)['model_flops']:.0f} through the plain "
                 "versions")
        run = served.get(name, fn)  # the first warm-up call of a bf16 batch captures its graph
        ms = cuda_ms(run, iters=5, warmup=2)
        dev = device_ms(run, calls=2)
        shares = {clock: rep.totals(spec, v / 1e3) for clock, v in (("event", ms), ("device", dev))
                  if v is not None}
        print(f"roofline [{name}]: {t['model_flops'] / 1e9:.3f} model GFLOP, "
              f"{t['padded_flops'] / 1e9:.3f} padded (occupancy {t['lane_occupancy']:.4f}); "
              f"product bytes {t['mxu_bytes'] / 1e9:.4f} GB, elementwise bracket "
              f"{t['elementwise_bytes'] / 1e9:.4f} GB; ceiling {t['attainable_s_fused'] * 1e3:.4f} "
              f"ms fused ({t['bound_by']}-bound) - {t['attainable_s_unfused'] * 1e3:.4f} ms "
              f"unfused; f32 products on CUDA cores "
              f"{t['attainable_s_fused_f32_cuda_cores'] * 1e3:.4f} ms; {ms:.4f} event ms, "
              f"{fmt(dev)} device ms; " + "; ".join(
                  f"{clock}: attained_fraction {v['attained_fraction']:.5f}, mfu {v['mfu']:.5f}"
                  for clock, v in shares.items()) + f"; card {card}", flush=True)
        for clock, v in shares.items():
            if max(v["attained_fraction"], v["mfu"]) > SHARE_MAX:
                fail(f"roofline [{name}]: a share of {clock} ms above {SHARE_MAX}: "
                     f"attained_fraction {v['attained_fraction']:.4f}, mfu {v['mfu']:.4f}")


# ---- phase 14: the research drivers ------------------------------------------
# train_demo's two stages at full width (DiffUNet + DiffUNet1, 6 x 48000,
# --sigma, JAX's corpus of 48 + 8 speech-like utterances), in f32 and in bf16
# compute from one seed: STEPS_A joint steps (evaluated at their end), then
# STEPS_B DDPM-only steps; the prior's cv MSE must fall over stage A (on an
# H100 it fell 2.43 -> 0.49 in 60 steps; 40 + 10 keep the whole script
# inside its time limit).
STEPS_A, STEPS_B = 40, 10
DEMO_LOG_EVERY = 10
SWEEP_REPS = 1
PROBE_STEPS = 4


@contextmanager
def per_call_counts(log: list, targets):
    """Wrap each ``(owner, attribute, label)`` of ``targets`` so that every
    call appends ``(label, self, launches in that call)`` to ``log`` (the
    counters read before and after; nothing is reset, so the path's total
    stays whole)."""
    import functools

    patches = []
    for owner, attr, label in targets:
        orig = getattr(owner, attr)

        def wrap(orig=orig, label=label):
            @functools.wraps(orig)
            def counted(*args, **kwargs):
                before = read_counts()
                out = orig(*args, **kwargs)
                log.append((label, args[0] if args else None,
                            {k: v - before[k] for k, v in read_counts().items()}))
                return out
            return counted
        patches.append(mock.patch.object(owner, attr, wrap()))
    for p in patches:
        p.start()
    try:
        yield
    finally:
        for p in reversed(patches):
            p.stop()


def expect_calls(what: str, log: list, label: str, want, n: int = None) -> int:
    """Fail unless each logged call ``label`` launched ``want(self)`` (a
    dict, or a list of the dicts it may match; a kernel a dict leaves out:
    0), and (if given) there were ``n``."""
    calls = [(s, d) for lab, s, d in log if lab == label]
    if n is not None and len(calls) != n:
        fail(f"{what}: {len(calls)} calls of {label}, expected {n}")
    for s, d in calls:
        w = want(s)
        w = [{k: x.get(k, 0) for k in d} for x in (w if isinstance(w, list) else [w])]
        if d not in w:
            fail(f"{what}: a call of {label} launched {d}, expected one of {w}")
    return len(calls)


def untouched_since(t0: float) -> list:
    """Files under ROOT modified since ``t0``, outside hidden directories,
    caches and the directories ``.gitignore`` lists (build outputs)."""
    ignored = {"__pycache__"}
    if os.path.isfile(os.path.join(ROOT, ".gitignore")):
        with open(os.path.join(ROOT, ".gitignore")) as f:
            ignored |= {line.strip().strip("/") for line in f if line.strip().endswith("/")}
    out = []
    for dirpath, dirnames, filenames in os.walk(ROOT):
        dirnames[:] = [d for d in dirnames if not d.startswith(".") and d not in ignored]
        out += [os.path.join(dirpath, f) for f in filenames
                if os.path.getmtime(os.path.join(dirpath, f)) >= t0]
    return out


def demo_run(device, card, root: str, bf16: bool) -> tuple:
    """Phase 14a: ``train_demo.main`` for one dtype; returns the launch
    counts of the run, its final record and its metrics records."""
    import torch

    from prior_diffuse_tpu_torch.scripts import _setup, train_demo
    from prior_diffuse_tpu_torch.serving.enhance import PriorServer
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    tag = "bf16" if bf16 else "f32"
    assets = os.path.join(root, f"demo_{tag}")
    argv = ["--steps", str(STEPS_A), "--ddpm-steps", str(STEPS_B), "--sigma",
            "--eval-every", str(STEPS_A), "--log-every", str(DEMO_LOG_EVERY),
            "--assets", assets, "--device", "cuda"] + (["--bf16"] if bf16 else [])
    args = train_demo.parse_args(argv)
    with spent("setup"):
        train_demo.write_corpus(args)
        # the prior's cv MSE at step 0: a trainer of stage A's seed and config
        fresh = _setup.trainer(os.path.join(root, f"step0_{tag}"), "demo",
                               train_demo.experiment(args), device, joint=True, sigma=True,
                               data_root=_setup.corpus_dir(assets))
    b = next(iter(fresh.cv_loader))
    prior0 = float(fresh._eval_step(*fresh.put_batch(b.noisy, b.clean, b.frame_nums))[3][
        "prior_mse"])
    n_cv = len(fresh.cv_loader)
    del fresh

    stages = []
    orig_stage = train_demo.run_stage

    def stage(tr, until, args, t0):
        snap = {n: [p.detach().clone() for p in m.parameters()] for n, m in tr.nets.items()}
        out = orig_stage(tr, until, args, t0)
        moved = {n: any(not torch.equal(a, p) for a, p in zip(snap[n], m.parameters()))
                 for n, m in tr.nets.items()}
        stages.append((tr.run.joint, moved, out))
        return out

    log = []
    k3 = "enc_stage"  # a bf16-compute trainer serves without K3 or K3-bf16
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(train_demo, "run_stage", stage), per_call_counts(log, [
            (ComplexDDPMTrainer, "_train_step", "step"),
            (ComplexDDPMTrainer, "evaluate", "evaluate"),
            (Enhancer, "enhance_batch", "enhance"),
            (PriorServer, "enhance_batch", "prior_only")]):
        rec = train_demo.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"train_demo [{tag}]: {wall:.1f} s, launches {counts}", flush=True)

    expect_calls(f"train_demo [{tag}]", log, "step", lambda s: {"stft": 2},
                 STEPS_A + STEPS_B)
    per_cv = {"stft": 2, "istft": 2, k3: 0 if bf16 else 35}
    n_eval = expect_calls(f"train_demo [{tag}]", log, "evaluate",
                          lambda s: {k: n_cv * v for k, v in per_cv.items()}, 2)
    n_enh = expect_calls(f"train_demo [{tag}]", log, "enhance",
                         lambda s: {"stft": 1, "istft": 1, k3: 0 if bf16 else 35})
    n_prior = expect_calls(f"train_demo [{tag}]", log, "prior_only",
                           lambda s: {"stft": 1, "istft": 1})
    if not n_enh or n_enh != n_prior:
        fail(f"train_demo [{tag}]: {n_enh} served batches, {n_prior} prior-only batches")
    want = {"stft": 2 * (STEPS_A + STEPS_B) + n_eval * 2 * n_cv + n_enh + n_prior,
            "istft": n_eval * 2 * n_cv + n_enh + n_prior,
            "enc_stage": 0 if bf16 else n_eval * 35 * n_cv + 35 * n_enh}
    expect_counts(f"train_demo [{tag}]", want)

    # stage A moves both nets; stage B the DDPM alone, the prior bit for bit
    if [(j, m) for j, m, _ in stages] != [(True, {"dis": True, "ddpm": True}),
                                          (False, {"dis": False, "ddpm": True})]:
        fail(f"train_demo [{tag}]: stages (joint, parameters moved): "
             f"{[(j, m) for j, m, _ in stages]}")
    print(f"train_demo [{tag}]: stage B left the prior's parameters unchanged bit for bit "
          f"and moved the DDPM's; steps/s (host clock, evaluations and checkpoints out): "
          f"stage A {stages[0][2]['steps_per_s']:.3f}, stage B "
          f"{stages[1][2]['steps_per_s']:.3f}; card {card}", flush=True)

    recs = metric_records(os.path.join(assets, "log", "demo"))
    losses = [r for r in recs if "loss_sum" in r]
    diags = [r for r in recs if "test_prior_mse" in r]
    if [r["step"] for r in losses] != list(range(DEMO_LOG_EVERY, STEPS_A + STEPS_B + 1,
                                                 DEMO_LOG_EVERY)):
        fail(f"train_demo [{tag}]: loss records at steps {[r['step'] for r in losses]}")
    if not finite(v for r in losses for k, v in r.items() if k != "time"):
        fail(f"train_demo [{tag}]: a non-finite loss or gradient norm")
    if [r["step"] for r in diags] != [STEPS_A, STEPS_A + STEPS_B]:
        fail(f"train_demo [{tag}]: evaluations at steps {[r['step'] for r in diags]}")
    prior_a = diags[0]["test_prior_mse"]
    print(f"train_demo [{tag}]: cv prior_mse {prior0:.5f} at step 0, {prior_a:.5f} after "
          f"stage A (step {STEPS_A})", flush=True)
    if not prior_a < prior0:
        fail(f"train_demo [{tag}]: the prior's cv MSE did not fall over stage A "
             f"({prior0} -> {prior_a})")
    for r in diags:
        print(f"train_demo [{tag}] evaluate() at step {r['step']}: " + ", ".join(
            f"{k[5:]} {r[k]:.5f}" for k in ("test_prior_mse", "test_chain_mse",
                                            "test_res_energy_true",
                                            "test_res_energy_sampled", "test_res_cos")),
              flush=True)
    if not finite(v for part in ("floor", "prior_only", "enhanced") for v in rec[part].values()):
        fail(f"train_demo [{tag}]: non-finite metrics {rec}")
    if rec["step"] != STEPS_A + STEPS_B or not os.path.isfile(
            os.path.join(assets, "demo_speechlike.md")):
        fail(f"train_demo [{tag}]: step {rec['step']}, or no report under {assets}")
    for part in ("floor", "prior_only", "enhanced"):
        print(f"train_demo [{tag}] {part}: " + " ".join(
            f"{k} {v:.3f}" for k, v in rec[part].items()) + f" (pesq {rec['pesq_mode']})",
              flush=True)
    return counts, rec, losses


def sweep_run(device, card, assets: str, bf16: bool) -> dict:
    """Phase 14b: ``eval_schedules.main`` on the f32 demo's checkpoint in one
    serving dtype; then full-50's batch through the kernels against the
    plain versions; returns the sweep's launch counts."""
    import torch

    from prior_diffuse_tpu_torch.scripts import eval_schedules
    from prior_diffuse_tpu_torch.serving.enhance import PriorServer
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    tag = "bf16" if bf16 else "f32"
    k3 = "enc_stage_bf16" if bf16 else "enc_stage"
    log = []
    reset_counts()
    with per_call_counts(log, [(Enhancer, "enhance_batch", "enhance"),
                               (PriorServer, "enhance_batch", "prior_only")]):
        rows = eval_schedules.main(["--assets", assets, "--doc", "demo", "--sigma",
                                    "--reps", str(SWEEP_REPS), "--device", "cuda"]
                                   + (["--bf16"] if bf16 else []))
    torch.cuda.synchronize()
    counts = read_counts()
    servers = {}
    for label, s, _ in log:
        servers.setdefault(0 if label == "prior_only" else s.sched.num_steps, s)
    per_batch = lambda s: {"stft": 1, "istft": 1, k3: 5 * (1 + s.sched.num_steps)}  # noqa: E731
    # bf16 on the card: a shape's first batch runs eagerly and captures its
    # graph (each wrapper called twice), a replay calls none (phase 4c counts
    # a replay's kernels on the device)
    expect_calls(f"eval_schedules [{tag}]", log, "enhance",
                 lambda s: [{k: 2 * v for k, v in per_batch(s).items()}, {}] if s._graphs
                 else per_batch(s))
    expect_calls(f"eval_schedules [{tag}]", log, "prior_only",
                 lambda s: {"stft": 1, "istft": 1})
    if [r["steps"] for r in rows] != [0, 2, 3, 4, 6, 8, 50] or sorted(servers) != [
            0, 2, 3, 4, 6, 8, 50]:
        fail(f"eval_schedules [{tag}]: rows of {[r['steps'] for r in rows]} steps")
    keys = ["ms_per_batch", "rtf", "utt_per_s", "csig", "cbak", "covl", "pesq", "ssnr", "stoi"]
    for r in rows:
        if not finite(r[k] for k in keys):
            fail(f"eval_schedules [{tag}]: non-finite row {r}")
        per = 5 * (1 + r["steps"]) if r["steps"] else 0
        print(f"eval_schedules [{tag}] {r['variant']}: {r['steps']} steps, served "
              f"{r['served']}, {r['ms_per_batch']} ms a batch of 8 x 3 s (CUDA events, mean "
              f"of {SWEEP_REPS}), RTF {r['rtf']}, {r['utt_per_s']} utt/s; CSIG {r['csig']} "
              f"CBAK {r['cbak']} COVL {r['covl']} PESQ {r['pesq']} SSNR {r['ssnr']} STOI "
              f"{r['stoi']}; a batch launches K1 1, K2 1, {k3} {per}; card {card}", flush=True)
    print(f"eval_schedules [{tag}]: launches {counts}", flush=True)

    # the deepest K3 chain of any phase: full-50's batch against the plain versions
    enh = servers[50]
    wav = torch.from_numpy(speechlike(BATCH, LENGTH, 31)).to(device)
    g = torch.Generator(device=device).manual_seed(32)
    x_T = torch.randn((1, BATCH, T_FRAMES, 161, 2), generator=g, device=device)
    reset_counts()
    got = enh.enhance_batch(wav, x_T=x_T)
    want = {"stft": 1, "istft": 1, k3: 255}
    if enh._graphs:  # a first batch of its shape runs eagerly and is captured, a replay calls none
        got_counts = read_counts()
        print(f"launches in full-50 [{tag}] batch: {got_counts}", flush=True)
        if got_counts not in ({k: 2 * want.get(k, 0) for k in got_counts},
                              {k: 0 for k in got_counts}):
            fail(f"launch counts in full-50 [{tag}] batch: {got_counts}, expected twice "
                 f"{want} (a capture) or none (a replay)")
    else:
        expect_counts(f"full-50 [{tag}] batch", want)
    with plain_versions():
        want = enh.eager_batch(wav, x_T=x_T)
    if bf16:
        err = rel_rms(got, want)
        print(f"full-50 [bf16] batch through the kernels vs the plain versions: relative "
              f"RMS {err:.3e} (bound {BF16_PATH_RMS:g})", flush=True)
        if err > BF16_PATH_RMS:
            fail("full-50 [bf16]: kernels disagree with the plain versions")
    else:
        expect_close("full-50 [f32] batch through the kernels vs the plain versions", got,
                     want, PATH_RTOL)
    return counts


def diagnose_run(device, assets: str) -> dict:
    """Phase 14c: ``diagnose_ddpm.main`` on the f32 demo's checkpoint, both
    BatchNorm modes; the trainer's buffers unchanged bit for bit by each
    probe; returns its launch counts."""
    import torch

    from prior_diffuse_tpu_torch.scripts import diagnose_ddpm

    orig = diagnose_ddpm.probe
    probes = []

    def probe(tr, *args, **kwargs):
        snap = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in tr.nets.items()}
        out = orig(tr, *args, **kwargs)
        probes.append(all(torch.equal(snap[n][k], v) for n, m in tr.nets.items()
                          for k, v in m.state_dict().items()))
        return out

    reset_counts()
    with mock.patch.object(diagnose_ddpm, "probe", probe):
        recs = diagnose_ddpm.main(["--assets", assets, "--sigma", "--device", "cuda"])
    counts = read_counts()
    if [r["bn"] for r in recs] != ["running", "batch"] or probes != [True, True]:
        fail(f"diagnose_ddpm: modes {[r['bn'] for r in recs]}, buffers kept {probes}")
    for r in recs:
        vals = [r[k] for k in ("prior_mse", "chain_mse", "res_energy_true",
                               "res_energy_sampled", "res_cos")]
        vals += [s[k] for s in r["eps_mse_per_step"] for k in ("model", "trivial")]
        if len(r["eps_mse_per_step"]) != 6 or not finite(vals):
            fail(f"diagnose_ddpm: {r}")
        print(f"diagnose_ddpm [{r['bn']} BN]: prior_mse {r['prior_mse']:.5f} chain_mse "
              f"{r['chain_mse']:.5f} e_true {r['res_energy_true']:.6f} e_samp "
              f"{r['res_energy_sampled']:.6f} cos {r['res_cos']:.4f}; eps MSE model / trivial "
              "per step " + ", ".join(f"{s['model']:.4f}/{s['trivial']:.4f}"
                                      for s in r["eps_mse_per_step"]), flush=True)
    print(f"diagnose_ddpm: the trainer's parameters and BN buffers unchanged bit for bit by "
          f"both probes; launches {counts}", flush=True)
    return counts


def probe_run(assets: str) -> dict:
    """Phase 14d: ``probe_predictability.main``, a few regressor steps at
    full width; returns its launch counts."""
    from prior_diffuse_tpu_torch.scripts import probe_predictability

    reset_counts()
    rec = probe_predictability.main(["--assets", assets, "--sigma", "--steps",
                                     str(PROBE_STEPS), "--eval-every", str(PROBE_STEPS),
                                     "--device", "cuda"])
    counts = read_counts()
    if rec["step"] != PROBE_STEPS or not finite(
            rec[k] for k in ("val_mse", "val_cos", "e_pred", "e_true")) or not os.path.isfile(
            os.path.join(assets, "probe_predictability_cond.json")):
        fail(f"probe_predictability: {rec}")
    print(f"probe_predictability: {rec}; launches {counts}", flush=True)
    return counts


def drivers_phase(device, card, root: str) -> dict:
    """Phase 14: the research drivers (``prior_diffuse_tpu_torch/scripts``):
    ``train_demo`` in f32 and in bf16 compute (the loss curves side by side),
    ``eval_schedules`` on the f32 run's checkpoint in f32 and bf16 serving,
    ``diagnose_ddpm`` and ``probe_predictability``; each from an empty
    working directory, which stays empty, and no file of the checkout is
    touched.  Returns the launch counts of each path."""
    base = os.path.join(root, "drivers")
    cwd = os.path.join(base, "cwd")
    os.makedirs(cwd)
    t_start = time.time()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        paths, curves = {}, {}
        for bf16 in (False, True):
            tag = "bf16" if bf16 else "f32"
            paths[f"drivers_demo_{tag}"], _, curves[tag] = demo_run(device, card, base, bf16)
        print("train_demo loss curves (loss_sum / dis_loss / ddpm_loss), f32 | bf16:",
              flush=True)
        for a, b in zip(curves["f32"], curves["bf16"]):
            print(f"  step {a['step']}: {a['loss_sum']:.5f} / {a['dis_loss']:.5f} / "
                  f"{a['ddpm_loss']:.5f} | {b['loss_sum']:.5f} / {b['dis_loss']:.5f} / "
                  f"{b['ddpm_loss']:.5f}", flush=True)
        assets = os.path.join(base, "demo_f32")
        for bf16 in (False, True):
            paths[f"drivers_sweep_{'bf16' if bf16 else 'f32'}"] = sweep_run(
                device, card, assets, bf16)
        paths["drivers_diagnose"] = diagnose_run(device, assets)
        paths["drivers_probe"] = probe_run(assets)
    finally:
        os.chdir(here)
    stray = os.listdir(cwd) + untouched_since(t_start)
    if stray:
        fail(f"the drivers wrote outside their assets: {stray[:10]}")
    print("the drivers wrote under their --assets only (the working directory stayed "
          "empty; no file of the checkout changed)", flush=True)
    return paths


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

    with spent("setup"):
        b = build.build()
        build.library()
    print(f"build: {b.path.name} in {b.seconds:.2f} s", flush=True)
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)

    from prior_diffuse_tpu_torch.models.diffunet import Nocon

    t0 = time.perf_counter()

    def mark(phase) -> None:
        ACCOUNTS.phase(str(phase))
        print(f"[{time.perf_counter() - t0:.1f} s] phase {phase}", flush=True)

    # one set of seeded nets for every phase: no phase trains them (the
    # trainers hold copies of their weights)
    nets = seeded_nets(0, device)
    denoisers = {"deltamu": seeded_nets(1, device, (Nocon,))[0], "conditional": nets[1]}
    mark(2)
    rows = check_kernels(device, nets)
    check_edge_shapes(device, nets)
    paths = {}
    mark(3)
    for dtype in (torch.float32, torch.bfloat16):
        paths.update(run_main_path(device, *nets, dtype))
    mark(4)
    serve_requests(device, nets, torch.float32)
    serve_requests(device, nets, torch.bfloat16)
    paths.update(serve_long(device, nets, card))
    paths.update(serve_recording(device, nets, card))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        mark(5)
        corpus = write_train_corpus(root)
        paths["train_step"], paths["evaluate_cv_batch"], train_rows = \
            train_phase(device, card, root, corpus)
        mark(6)
        paths["cli_train"], paths["cli_generate"] = cli_phase(root, corpus, card)
        mark(7)
        for mode, ddpm in denoisers.items():
            for dtype in (torch.float32, torch.bfloat16):
                paths.update(run_main_path(device, nets[0], ddpm, dtype, mode,
                                           (False, True) if mode == "deltamu" else (False,)))
        bf16_card_vs_cpu(device, nets[0], {"pirorgrad": nets[1], **denoisers})
        for mode in MODES:
            paths[f"train_step_{mode}"], paths[f"evaluate_cv_batch_{mode}"] = \
                train_mode_phase(device, card, root, corpus, mode)
        mark(8)
        priors = prior_nets(device)
        paths.update(prior_phase(device, card, root, corpus, nets[1], priors))
        mark(9)
        grn = grn_net(device)
        paths.update(grn_phase(device, card, root, corpus, grn))
        diffwave_phase(device)
        paths.update(bf16_prior_phase(device, priors, nets[1]))
        mark(10)
        paths.update(bf16_train_phase(device, card, root, corpus, {**priors, "GRN": grn}))
        mark(11)
        paths.update(tooling_phase(device, card, root, corpus))
        mark(12)
        paths.update(dp_phase(device, card, root, corpus))
        mark(13)
        roofline_phase(device, card, nets, priors, root, corpus)
        mark(14)
        paths.update(drivers_phase(device, card, root))
        mark("14 done")

    # (route, source, replaces, the path whose run "launches" counts)
    meta = {
        "stft": ("cuda", "prior_diffuse_tpu_torch/csrc/stft.cu",
                 "prior_diffuse_tpu/ops/pallas/stft_kernel.py:44", "cli"),
        "istft": ("cuda", "prior_diffuse_tpu_torch/csrc/stft.cu",
                  "prior_diffuse_tpu/ops/pallas/stft_kernel.py:106", "cli"),
        "enc_stage": ("cuda", "prior_diffuse_tpu_torch/csrc/enc_chain.cu",
                      "prior_diffuse_tpu/ops/pallas/convblock_kernel.py:109", "cli"),
        "enc_stage_bf16": ("cuda", "prior_diffuse_tpu_torch/csrc/enc_chain_bf16.cu",
                           "prior_diffuse_tpu/ops/pallas/convblock_kernel.py:109 (dtype=bf16)",
                           "serve_batch_bf16"),
    }
    # launches: the entry point's run (cli.main: 2 epochs, then --generate)
    # for the f32 slices' kernels, one bf16 serving batch for K3-bf16; rows:
    # the serving shapes (batch 8 x 3 s), then (f32) the training slice's
    count = lambda path, name: sum(paths[p].get(name, 0) for p in
                                   (("cli_train", "cli_generate") if path == "cli" else (path,)))
    # (the bf16 batch's count is its first call's: its eager run and its capture)
    per_batch = lambda name: (paths["serve_batch_bf16"][name] // 2 if name == "enc_stage_bf16"
                              else paths["serve_batch"][name])
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": count(path, name), "launches_path": path,
                "launches_per_batch": per_batch(name),
                "launches_by_path": {p: c.get(name, 0) for p, c in paths.items()},
                **rows[name], **({"train_slice": train_rows[name]} if name in train_rows else {})}
               for name, (route, src, rep, path) in meta.items()]
    print(json.dumps(ACCOUNTS.line()), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 12's group, started by dp_ranks_phase
        dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
