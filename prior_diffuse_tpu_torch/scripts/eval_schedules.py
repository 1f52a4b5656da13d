"""Sampler-schedule quality against latency on a trained run.

The counterpart of the repository's ``scripts/eval_schedules.py``.  It
loads a ``train_demo`` run's checkpoint and sweeps

    prior-only (0 steps) .. fast-2/3/4 .. fast-6 (reference default)
    .. fast-8 .. full-50 (``fast_sampling: false``)

scoring all six metrics on the run's test set and timing each schedule's
serving batch.  Every beta list embeds into the 50-step training grid
(``diffusion/schedule.py::inference_schedule`` raises otherwise).

Each variant serves through its own ``serving.enhancer.Enhancer`` on the
trainer's nets, built from the run's experiment with the variant's
diffusion section (the JAX script resets its trainer's traced
``enhance_batch`` instead): K1, K3 in ``5 x (1 + steps)`` encoder stages a
batch (K3-bf16 with ``--bf16``, the bf16 serving path), K2.  The prior-only
row is ``serving/enhance.py::prior_only_server`` (K1, the prior's module
forward, K2).  A row's time is the mean of ``--reps`` batches of
``--batch`` x ``--seconds`` after two warm-up batches, from CUDA events on
the card (the host clock on the CPU); ``--reps 0`` skips timing.  The
``served`` column names what ran: the dtype and ``fused`` (K3 encoder, two
decoders) or ``dual`` (K3-bf16 encoder, the dual decoder), or the
prior-only server's dtype.

Output: a markdown table (``--report``, default
``<assets>/schedule_tradeoff_<f32|bf16>.md``) and a JSON sidecar; the
enhanced wavs under ``<assets>/sched_eval/<f32|bf16>/<variant>``.

Usage (after a train_demo run)::

    python -m prior_diffuse_tpu_torch.scripts.eval_schedules \\
        --assets assets/speech_demo --doc demo --sigma [--bf16]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import time

import numpy as np
import torch

from prior_diffuse_tpu_torch.scripts import _report, _setup

# Short fast schedules: every beta list must embed into the 50-step
# linspace(1e-4, 0.05) training grid (inference_schedule raises if its
# alpha_cum leaves the training cumprod range [0.2857, 0.9999]).
VARIANTS = [
    ("prior-only", None),
    ("fast-2", [1e-2, 0.5]),
    ("fast-3", [1e-3, 0.05, 0.5]),
    ("fast-4", [1e-3, 0.01, 0.1, 0.5]),
    ("fast-6 (default)", "default"),
    ("fast-8", [1e-4, 5e-4, 2e-3, 8e-3, 0.03, 0.1, 0.25, 0.5]),
    ("full-50", "full"),
]

WARMUP = 2


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--assets", required=True)
    ap.add_argument("--doc", required=True, help="checkpoint namespace under --assets")
    ap.add_argument("--report", default=None,
                    help="report path (default: <assets>/schedule_tradeoff_<f32|bf16>.md)")
    ap.add_argument("--sigma", action="store_true")
    ap.add_argument("--cond-noisy", action="store_true")
    ap.add_argument("--predict-x0", action="store_true")
    ap.add_argument("--n-avg", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bf16", action="store_true",
                    help="serve in bfloat16 (the bf16 serving path)")
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="timing-batch utterance length")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed batches per schedule (0 skips timing)")
    ap.add_argument("--variants", default="",
                    help="comma-separated variant-name prefixes to run (default: all)")
    _setup.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.report is None:
        args.report = os.path.join(args.assets,
                                   f"schedule_tradeoff_{'bf16' if args.bf16 else 'f32'}.md")
    return args


def variant_diffusion(base, sched):
    """The run's diffusion section with the variant's schedule."""
    if sched == "full":
        return dataclasses.replace(base, fast_sampling=False)
    if sched == "default":
        return base
    return dataclasses.replace(base, inference_noise_schedule=list(sched))


def served(server) -> str:
    """What a server runs: ``prior_only:<dtype>``, or the enhancer's dtype
    and decoder route from its packs (``fused``: two ``Decoder``s after the
    K3 encoder; ``dual``: the dual decoder)."""
    name = str(server.dtype).split(".")[-1]
    if not hasattr(server, "packs"):
        return f"prior_only:{name}"
    return f"{name}:{'dual' if server.packs()[1]['dual'] is not None else 'fused'}"


def time_enhance(server, batch: torch.Tensor, reps: int, seed: int = 3) -> float:
    """Mean ms of ``server.enhance_batch(batch)`` over ``reps`` batches after
    ``WARMUP``: CUDA events on the card, the host clock on the CPU; NaN
    when ``reps`` is 0."""
    if reps <= 0:
        return float("nan")
    gen = torch.Generator(device=batch.device).manual_seed(seed)
    for _ in range(WARMUP):
        server.enhance_batch(batch, gen)
    if batch.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            server.enhance_batch(batch, gen)
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(batch.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        server.enhance_batch(batch, gen)
    end.record()
    torch.cuda.synchronize(batch.device)
    return start.elapsed_time(end) / reps


def timing_batch(wavs, rows: int, length: int, dev) -> torch.Tensor:
    """The fixed timing batch ``[rows, length]``: the test wavs' first
    ``length`` samples, each RMS-normalised, cycled over the rows."""
    tbatch = np.zeros((rows, length), np.float32)
    for i in range(rows):
        seg = wavs[i % len(wavs)][:length]
        c = max(float(np.sqrt(np.mean(seg.astype(np.float64) ** 2))), 1e-12)
        tbatch[i, : len(seg)] = seg / c
    return torch.from_numpy(tbatch).to(dev)


def run_variant(tr, name: str, sched, args, wavs, paths, tbatch, dtype) -> dict:
    """One row: enhance the test set with the variant's server, score it,
    time it."""
    from prior_diffuse_tpu_torch.data.wavio import write_wav
    from prior_diffuse_tpu_torch.serving.enhance import enhance_files, prior_only_server
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    exp = tr.exp
    if sched is None:
        server = prior_only_server(Enhancer(tr.dis, tr.ddpm, exp, tr.device, args.sigma,
                                            dtype))
        steps = 0
    else:
        exp = dataclasses.replace(exp, diffusion=variant_diffusion(exp.diffusion, sched))
        server = Enhancer(tr.dis, tr.ddpm, exp, tr.device, args.sigma, dtype)
        steps = server.sched.num_steps
    print(f"[{name}] enhancing {len(wavs)} files ...", flush=True)
    out_dir = os.path.join(args.assets, "sched_eval", "bf16" if args.bf16 else "f32",
                           name.split()[0].replace("-", "_"))
    os.makedirs(out_dir, exist_ok=True)
    outs = enhance_files(server, wavs, torch.Generator(device=tr.device).manual_seed(17))
    sr = tr.cfg.sample_rate
    for p, w in zip(paths, outs):
        write_wav(os.path.join(out_dir, os.path.basename(p)), w, sr)
    clean_dir = os.path.join(tr.run.data_root, "clean_testset_wav")
    res = _report.mean_scores(clean_dir, out_dir)
    ms = time_enhance(server, tbatch, args.reps)
    audio_sec = args.batch * args.seconds
    row = {"variant": name, "steps": steps, "served": served(server),
           "ms_per_batch": round(ms, 2),
           "rtf": round(audio_sec / (ms / 1e3), 1),
           "utt_per_s": round(args.batch / (ms / 1e3), 1),
           **{k.lower(): round(float(v), 3) for k, v in zip(_report.NAMES, res)}}
    print(f"[{name}] {ms:.1f} ms/batch, pesq {res[3]:.3f} ssnr {res[4]:.3f}", flush=True)
    return row


def write_report(args, tr, rows, n_files: int, mode: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        f.write("# Sampler-schedule tradeoff (serving)\n\n")
        f.write(f"Run: `{args.assets}` doc `{args.doc}` (step {tr.step}), "
                f"{'bf16' if args.bf16 else 'f32'} serving, "
                f"batch {args.batch} x {args.seconds:g} s timing shape, "
                f"{n_files}-file test set.\n\n"
                f"**PESQ regime: `{mode}`** — CSIG/CBAK/COVL inherit this "
                "regime; values are comparable only within it.\n\n")
        f.write("| schedule | steps | served | ms/batch | RTF | utt/s/chip | CSIG | "
                "CBAK | COVL | PESQ | SSNR | STOI |\n")
        f.write("|---|---|---|---|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['variant']} | {r['steps']} | {r['served']} "
                    f"| {r['ms_per_batch']} | {r['rtf']} | {r['utt_per_s']} "
                    f"| {_report.cell('csig', r['csig'])} | {_report.cell('cbak', r['cbak'])} "
                    f"| {_report.cell('covl', r['covl'])} | {r['pesq']} "
                    f"| {r['ssnr']} | {r['stoi']} |\n")
        clock = "CUDA events" if tr.device.type == "cuda" else "the host clock"
        f.write(f"\nLatency is the mean of {args.reps} serving batches after {WARMUP} "
                f"warm-up batches ({clock}); quality is the six-metric mean "
                "over the run's test set, same files for every row. "
                "`prior-only` skips the residual DDPM entirely — its "
                "deltas to the other rows are the measured cost/benefit "
                "of each reverse-step budget.\n")
    with open(os.path.splitext(args.report)[0] + ".json", "w") as f:
        json.dump({"assets": args.assets, "doc": args.doc, "step": tr.step,
                   "serve_dtype": "bf16" if args.bf16 else "f32",
                   "pesq_mode": mode, "rows": rows}, f, indent=1)


def main(argv=None) -> list:
    """Sweep the variants; returns the rows."""
    args = parse_args(argv)
    dev = _setup.device(args.device)
    _setup.approx_pesq()
    with _setup.logging_to(os.path.join(args.assets, "log")):
        return _main(args, dev)


def _main(args, dev) -> list:
    from prior_diffuse_tpu_torch.config import DiffusionConfig
    from prior_diffuse_tpu_torch.data.wavio import read_wav
    from prior_diffuse_tpu_torch.metrics.pesq import pesq_mode

    exp = _setup.experiment(args.batch, lr=5e-4, lr_ddpm=5e-4, bf16=args.bf16,
                            diffusion=DiffusionConfig(
                                cond_noisy=args.cond_noisy, n_avg=args.n_avg,
                                predict="x0" if args.predict_x0 else "eps"))
    tr = _setup.trainer(args.assets, args.doc, exp, dev, joint=False, sigma=args.sigma)
    if tr.step == 0:
        raise SystemExit(f"no checkpoint under {args.assets}/{args.doc}")
    print(f"loaded step {tr.step} from {args.assets}/{args.doc}", flush=True)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    noisy_dir = os.path.join(tr.run.data_root, "noisy_testset_wav")
    paths = sorted(glob.glob(os.path.join(noisy_dir, "*.wav")))
    wavs = [read_wav(p, tr.cfg.sample_rate)[0] for p in paths]
    # the fixed timing batch: the serving shape (rows = 8 x 3 s)
    tbatch = timing_batch(wavs, args.batch, int(args.seconds * tr.cfg.sample_rate), dev)

    wanted = [v for v in args.variants.split(",") if v]
    rows = [run_variant(tr, name, sched, args, wavs, paths, tbatch, dtype)
            for name, sched in VARIANTS
            if not wanted or any(name.startswith(w) for w in wanted)]
    write_report(args, tr, rows, len(wavs), pesq_mode())
    print(f"wrote {args.report}", flush=True)
    tr.metrics.close()
    return rows


if __name__ == "__main__":
    main()
