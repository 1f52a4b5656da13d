"""The port's tooling around the train loop against the JAX package (CPU).

* ``utils/profiler.py``: ``train_ddpm`` with ``run.profile_steps = 2``
  writes a Chrome trace of exactly its first 2 steps under
  ``<log_dir>/trace``, and ``spans.json`` of their spans, and takes the
  third untraced; ``flops_estimate`` of a
  product equals JAX's XLA cost analysis of it; ``StepTimer`` gives JAX's
  step times, mean and items/sec on one clock; ``nan_guard`` toggles
  autograd's anomaly detection;
* ``viz.py``: ``spec_db`` equals JAX's on the CPU (see its test for the
  bound) and ``draw_comparison`` writes a PNG;
* ``--draw``: ``cli.main`` scores the first cv batch, writes one figure per
  utterance and a ``draw_*`` record instead of training;
* ``--wandb``: the metrics reach a ``wandb`` module (a stub here: wandb is
  not installed) with JAX's project and steps, and without one the run
  warns and goes on;
* ``metrics.compare``'s command line prints JAX's metric line.

Full-width ``DiffUNet`` + ``DiffUNet1`` on a tiny corpus (8 train
utterances of 0.4-0.6 s, 2 test), batch 2, chunks of 2400 samples.
"""

import glob
import importlib
import json
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch

from prior_diffuse_tpu import viz as jviz
from prior_diffuse_tpu.utils import profiler as jprof
from prior_diffuse_tpu_torch import cli, viz
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.data import synthetic
from prior_diffuse_tpu_torch.data.wavio import write_wav
from prior_diffuse_tpu_torch.metrics import compare as tcompare
from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
from prior_diffuse_tpu_torch.utils import profiler
from prior_diffuse_tpu_torch.utils.logging import MetricsLogger

# the JAX package's metrics/__init__ exports the function ``compare``
jcompare = importlib.import_module("prior_diffuse_tpu.metrics.compare")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 2400

# parallel test workers: cap torch's OpenMP pool (see test_torch_trainer.py)
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return synthetic.write_corpus_speechlike(root, n_train=8, n_test=2, min_len=6400,
                                             max_len=9600, seed=2)


@pytest.fixture
def root_logging():
    """``cli.parse_args`` adds handlers to the root logger: take them off."""
    before = list(logging.getLogger().handlers)
    yield
    for h in logging.getLogger().handlers[:]:
        if h not in before:
            logging.getLogger().removeHandler(h)
            h.close()


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _small_conf(tmp_path):
    """``conf/diff.yml`` with batch 2, chunks of 2400 and one epoch."""
    with open(os.path.join(ROOT, "conf", "diff.yml")) as f:
        text = f.read()
    for old, new in (("batch_size: 6", "batch_size: 2"), ("n_epochs: 50", "n_epochs: 1"),
                     ("chunk_length: 48000", f"chunk_length: {CHUNK}")):
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / "diff.yml"
    path.write_text(text)
    return str(path)


def test_profile_steps_trace_the_first_steps(corpus, tmp_path):
    exp = tcfg.ExperimentConfig(train=tcfg.TrainConfig(batch_size=2, n_epochs=1,
                                                       chunk_length=CHUNK))
    run = tcfg.RunConfig(assets=str(tmp_path), doc="t", data_root=corpus, joint=True,
                         profile_steps=2)
    tr = ComplexDDPMTrainer(run, exp, device="cpu")
    tr.train_ddpm(max_steps=3)
    assert tr.step == 3 and sum("loss_sum" in r for r in _records(run.log_dir)) == 3
    files = glob.glob(os.path.join(run.log_dir, "trace", "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    # each joint step takes one Adam step of each net: 2 steps traced, not 3
    names = [e.get("name", "") for e in events]
    assert sum(n.startswith("Optimizer.step#Adam.step") for n in names) == 4
    assert any(n == "aten::convolution" for n in names)
    # spans.json beside it: the traced steps' phases (the norms on step 0 only)
    with open(os.path.join(run.log_dir, "trace", "spans.json")) as f:
        report = json.load(f)
    calls = {k: v["calls"] for k, v in report["spans"].items()}
    assert calls == {"train.step": 2, "train.features": 2, "train.forward": 2,
                     "train.backward": 2, "train.norms": 1, "train.optimizer": 2}
    for v in report["spans"].values():
        assert 0 <= v["self_host_s"] <= v["host_s"] and v["stream_ms"] is None
        assert v["launches"] == 0 and v["device_busy_s"] == 0  # no CUDA activity
    # one request a step, split by phase; the capture's counters
    assert [(r["name"], "train.norms" in r["spans"]) for r in report["requests"]] == [
        ("train.step", True), ("train.step", False)]
    assert {"kernel.k1", "kernel.k2", "kernel.k3", "kernel.k3_bf16"} <= set(report["counters"])


@pytest.mark.parametrize("shapes", [((8, 16), (16, 4)), ((3, 5, 7), (7, 9))],
                         ids=["matrix", "batched"])
def test_flops_estimate_equals_jax(shapes):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    got = profiler.flops_estimate(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    want = jprof.flops_estimate(jnp.matmul, jnp.asarray(a), jnp.asarray(b))
    assert got == want == 2 * a.size * b.shape[-1]


def test_step_timer_matches_jax(monkeypatch):
    """JAX's ``test_step_timer`` on both timers, then both on one clock:
    the same step times, rolling mean over the window and items/sec."""
    import time

    for timer in (jprof.StepTimer(window=4), profiler.StepTimer(window=4)):
        assert timer.tick() is None and timer.mean == 0.0 and timer.items_per_sec(8) == 0.0
        time.sleep(0.01)
        dt = timer.tick()
        assert dt is not None and dt > 0
        assert timer.mean > 0 and timer.items_per_sec(8) > 0
    readings = [iter([10.0, 10.5, 11.25, 12.0, 14.0]) for _ in range(2)]
    got = []
    for timer, clock in zip((jprof.StepTimer(window=3), profiler.StepTimer(window=3)),
                            readings):
        monkeypatch.setattr(time, "perf_counter", lambda c=clock: next(c))
        got.append(([timer.tick() for _ in range(5)], timer.mean, timer.items_per_sec(6)))
    assert got[0] == got[1]
    assert got[1][0] == [None, 0.5, 0.75, 0.75, 2.0] and got[1][1] == 3.5 / 3


def test_nan_guard_toggles_anomaly_detection():
    try:
        profiler.nan_guard(True)
        assert torch.is_anomaly_enabled()
        x = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()
    finally:
        profiler.nan_guard(False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_db_equals_jax(seed):
    """The two STFTs round their float32 sums apart by an absolute amount
    (measured at most 7.3e-7 of the peak magnitude over seeds 0-5), so
    the dB error grows as a bin falls below the peak: at most 3.3e-4 dB
    within 60 dB of the peak, up to 1.8e-3 dB 80 dB below it.  Held: every
    bin's magnitude within 2e-6 of the peak's, and 1e-3 dB within 60 dB of
    the peak."""
    x, _ = synthetic.make_speechlike(np.random.default_rng(seed), 12000, 16000, 5.0)
    got = viz.spec_db(x, device="cpu")
    want = jviz.spec_db(x)
    assert got.shape == want.shape == (161, 12000 // 160 + 1)
    peak = want.max()
    np.testing.assert_allclose(10 ** (got / 20), 10 ** (want / 20), rtol=0,
                               atol=2e-6 * 10 ** (peak / 20))
    near = want > peak - 60
    assert near.mean() > 0.5
    np.testing.assert_allclose(got[near], want[near], rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="320/160"):
        viz.spec_db(x, n_fft=512, device="cpu")


def test_draw_comparison_writes_a_png(tmp_path):
    rng = np.random.default_rng(3)
    wavs = [synthetic.make_speechlike(rng, 8000, 16000, 5.0)[i] for i in (0, 1)]
    path = str(tmp_path / "cmp.png")
    viz.draw_comparison(wavs, ["noisy", "clean"], path=path, device="cpu")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _cli_draw(corpus, tmp_path, *extra):
    args = ["--config", _small_conf(tmp_path), "--joint", "--data-root", corpus, "--assets",
            str(tmp_path / "assets"), "--doc", "t", "--device", "cpu", "--draw", *extra]
    cli.main(args)
    return str(tmp_path / "assets" / "log" / "t"), str(tmp_path / "assets" / "wav" / "t")


def test_cli_draw_writes_figures_and_warns_without_wandb(corpus, tmp_path, root_logging,
                                                         monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    with caplog.at_level(logging.WARNING):
        log_dir, wav_dir = _cli_draw(corpus, tmp_path, "--wandb")
    assert "wandb requested but not installed" in caplog.text
    pngs = sorted(os.path.basename(p) for p in glob.glob(os.path.join(wav_dir, "draw", "*")))
    assert pngs == ["draw_b0_0.png", "draw_b0_1.png"]  # the one cv batch of 2
    recs = _records(log_dir)
    assert not any("loss_sum" in r for r in recs)  # no training
    (draw,) = [r for r in recs if "draw_loss" in r]
    assert draw["step"] == 0 and np.isfinite(
        [draw[f"draw_mean_{m}"] for m in ("csig", "cbak", "covl", "pesq", "ssnr", "stoi")]).all()
    assert not os.path.exists(os.path.join(log_dir, "trace"))


def test_wandb_mirrors_the_metrics(corpus, tmp_path, root_logging, monkeypatch):
    calls = []
    stub = types.ModuleType("wandb")
    stub.init = lambda project: calls.append(("init", project))
    stub.log = lambda metrics, step=None: calls.append(("log", dict(metrics), step))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    log_dir, _ = _cli_draw(corpus, tmp_path, "--wandb")
    assert calls[0] == ("init", "prior-diffuse-tpu")
    logged = [c for c in calls if c[0] == "log"]
    (draw,) = [c for c in logged if "draw_loss" in c[1]]
    (record,) = [r for r in _records(log_dir) if "draw_loss" in r]
    assert draw[2] == record["step"] == 0
    assert draw[1]["draw_loss"] == record["draw_loss"] and draw[1]["pesq_mode"] == \
        record["pesq_mode"]

    calls.clear()
    MetricsLogger(None).log({"x": 1.0}, step=3)
    assert calls == []  # only when asked


def test_compare_command_line_equals_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(4)
    for i in range(2):
        noisy, clean = synthetic.make_speechlike(rng, 8000 + 800 * i, 16000, 5.0)
        for d, x in (("ref", clean), ("deg", noisy)):
            os.makedirs(tmp_path / d, exist_ok=True)
            write_wav(str(tmp_path / d / f"u{i}.wav"), x)
    ref, deg = str(tmp_path / "ref"), str(tmp_path / "deg")
    tcompare.main([ref, deg])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setenv("PDT_METRIC_WORKERS", "1")  # no process pool under jax
    monkeypatch.setattr(sys, "argv", ["compare", ref, deg])
    jcompare.main()
    want = capsys.readouterr().out.splitlines()
    assert got[0].startswith("time: ") and got[1:] == want[1:] and len(got) == 4
    assert got[3].startswith("csig:") and "nan" not in got[3]
