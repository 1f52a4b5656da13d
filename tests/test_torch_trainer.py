"""The port's trainer loop, checkpoints, metrics and CLI (CPU).

Full-width ``DiffUNet`` + ``DiffUNet1`` on a tiny synthetic corpus (4
train utterances of 0.4-0.6 s, 2 test), batch 2, chunks of 2400 samples,
on the CPU (where every kernel wrapper takes its plain version):

* ``train_ddpm`` trains, evaluates (prior + fast-6 chain + metrics),
  writes the JSONL log under the JAX package's metric names and keeps
  per-epoch and best checkpoints;
* a trainer resumed from the checkpoint (``--retrain``) takes the next
  step exactly as the uninterrupted trainer does, bit for bit: nets,
  BatchNorm statistics, both Adam states, step, generator and plateau
  state all come back;
* ``compare_complex`` and ``PlateauController`` equal the JAX package's;
* ``cli.main`` trains one epoch and ``--generate`` writes one finite wav
  per test utterance at its input length; it no longer refuses
  ``--draw``, ``--profile-steps`` or ``--wandb`` (they reach the data;
  ``tests/test_torch_tooling.py`` runs them); a model of the wrong kind
  (GRN as the DDPM's prior, ``MagTrainer`` with another model)
  ``ValueError``; a
  ``compute_dtype: bfloat16`` experiment trains in bf16 compute with
  float32 parameters and Adam state.
"""

import dataclasses
import glob
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu_torch import cli
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.data import synthetic
from prior_diffuse_tpu_torch.data.wavio import read_wav
from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
from prior_diffuse_tpu_torch.training.plateau import PlateauController

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 2400
GN_DIS = {"gn_dis/core/de_imag", "gn_dis/core/de_real", "gn_dis/core/en",
          "gn_dis/core/tcm1", "gn_dis/core/tcm2", "gn_dis/core/tcm3"}

# The suite runs in parallel worker processes, each of which imports every
# test file. torch's OpenMP pool defaults to one thread per core in each,
# and the spinning threads of several workers then starve one another (the
# port's tests ran ~6x slower in 4 workers than with 2 threads each).
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return synthetic.write_corpus_speechlike(root, n_train=4, n_test=2, min_len=6400,
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


def _exp(**diff):
    return tcfg.ExperimentConfig(
        train=tcfg.TrainConfig(batch_size=2, n_epochs=1, chunk_length=CHUNK),
        optim_ddpm=tcfg.OptimConfig(lr=2e-4),
        diffusion=tcfg.DiffusionConfig(**diff))


def _trainer(corpus, assets, **run_kw):
    run = tcfg.RunConfig(assets=str(assets), doc="t", data_root=corpus, joint=True,
                         sigma=True, **run_kw)
    return ComplexDDPMTrainer(run, _exp(), device="cpu")


def _records(assets):
    with open(os.path.join(assets, "log", "t", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """One epoch of ``train_ddpm`` (2 steps, an evaluation, checkpoints)."""
    assets = tmp_path_factory.mktemp("assets")
    tr = _trainer(corpus, assets)
    tr.train_ddpm()
    return tr, str(assets)


def test_train_ddpm_logs_and_checkpoints(trained):
    tr, assets = trained
    assert (tr.epoch, tr.step) == (1, 2)
    recs = _records(assets)
    steps = [r for r in recs if "loss_sum" in r]
    assert [r["step"] for r in steps] == [0, 1]
    for r in steps:
        assert np.isfinite([r["loss_sum"], r["dis_loss"], r["ddpm_loss"]]).all()
    # step to step, as JAX's StepTimer: nothing on the first step
    assert "step_time_ms" not in steps[0] and "utt_per_sec" not in steps[0]
    assert steps[1]["step_time_ms"] > 0 and steps[1]["utt_per_sec"] > 0
    # group gradient norms on step 0 only (every grad_log_every steps),
    # under the JAX package's names
    gn = {k for k in steps[0] if k.startswith("gn_")}
    assert GN_DIS <= gn and "gn_ddpm/preprocess/kernel" in gn
    assert not any(k.startswith("gn_") for k in steps[1])
    diag = next(r for r in recs if "test_prior_mse" in r)
    assert {"test_res_energy_true", "test_res_energy_sampled", "test_res_cos",
            "test_chain_mse"} <= set(diag)
    ev = next(r for r in recs if "test_loss" in r)
    assert ev["test_loss"] == diag["test_chain_mse"] and ev["pesq_mode"] in (
        "absent", "approx", "p862")
    assert np.isfinite([ev[f"test_mean_{m}"] for m in ("csig", "cbak", "covl", "pesq",
                                                        "ssnr", "stoi")]).all()
    ckpt = os.path.join(assets, "checkpoint", "t")
    assert sorted(os.listdir(os.path.join(ckpt, "epochs"))) == ["0.pt"]
    assert os.path.exists(os.path.join(ckpt, "best.pt"))
    assert tr.plateau.best_loss == ev["test_loss"]


def test_train_ddpm_stops_at_max_steps(corpus, tmp_path):
    """``max_epochs`` overrides ``n_epochs``; ``max_steps`` ends the loop
    before the step that would pass it, after the epochs it completed were
    evaluated and checkpointed (2 steps an epoch here)."""
    tr = _trainer(corpus, tmp_path)
    tr.train_ddpm(max_epochs=3, max_steps=3)
    assert (tr.epoch, tr.step) == (1, 3)
    recs = _records(str(tmp_path))
    assert [r["step"] for r in recs if "loss_sum" in r] == [0, 1, 2]
    assert sum("test_loss" in r for r in recs) == 1
    assert os.listdir(tmp_path / "checkpoint" / "t" / "epochs") == ["0.pt"]


def _fixed_batch(tr):
    batch = next(iter(tr.tr_loader))
    return tr.put_batch(batch.noisy, batch.clean, batch.frame_nums)


def test_resume_reproduces_the_next_step_bit_for_bit(trained, corpus):
    tr, assets = trained
    resumed = _trainer(corpus, assets, retrain=True)
    assert (resumed.epoch, resumed.step) == (1, 2)
    assert resumed.plateau == tr.plateau
    assert torch.equal(resumed.gen.get_state(), tr.gen.get_state())
    noisy, clean, frames = _fixed_batch(tr)
    for t in (tr, resumed):
        t.out = t._train_step(noisy, clean, frames)
    for a, b in zip(tr.out[:3], resumed.out[:3]):
        assert torch.equal(a, b)
    for name in ("dis", "ddpm"):
        sd_a, sd_b = tr.nets[name].state_dict(), resumed.nets[name].state_dict()
        assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a), name
    for name in ("opt_dis", "opt_ddpm"):
        st_a, st_b = tr.opts[name].state_dict()["state"], resumed.opts[name].state_dict()["state"]
        assert st_a.keys() == st_b.keys() and len(st_a) > 0
        for k in st_a:
            assert all(torch.equal(st_a[k][f], st_b[k][f]) for f in st_a[k]), (name, k)


def test_checkpoints_keep_the_newest_three(tmp_path):
    from prior_diffuse_tpu_torch.training.checkpoint import CheckpointStore

    store = CheckpointStore(str(tmp_path))
    assert store.latest_epoch() is None and store.restore_latest() is None
    assert store.restore_best() is None
    for epoch in range(5):
        store.save_epoch(epoch, {"epoch": epoch, "w": torch.full((2,), float(epoch))})
    assert sorted(os.listdir(tmp_path / "epochs")) == ["2.pt", "3.pt", "4.pt"]
    assert store.latest_epoch() == 4 and store.restore_latest()["epoch"] == 4
    store.save_best({"w": torch.ones(1)})
    assert torch.equal(store.restore_best()["w"], torch.ones(1))


def test_compare_complex_equals_jax(trained):
    from prior_diffuse_tpu.metrics.compare import compare_complex as j_compare
    from prior_diffuse_tpu_torch.metrics.compare import compare_complex
    from prior_diffuse_tpu_torch.training.base import spec_features

    tr, _ = trained
    batch = next(iter(tr.cv_loader))
    noisy, clean, _ = tr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    feat, label = spec_features(noisy, tr.cfg), spec_features(clean, tr.cfg)
    got = compare_complex(feat, label, batch.frame_nums, "sqrt")
    want = j_compare(jnp.asarray(feat.numpy()), jnp.asarray(label.numpy()),
                     batch.frame_nums, "sqrt")
    assert np.isfinite(got).all() and len(got) == 6
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_plateau_controller_equals_jax():
    from prior_diffuse_tpu.training.plateau import PlateauController as JPlateau

    losses = [1.0, 0.9, 0.95, 0.97, 0.99, 0.8, 0.85, 0.86, 0.87, 0.9, 0.91]
    for kw in (dict(), dict(half_lr=2, early_stop=4), dict(half_lr=1, early_stop=0)):
        ours, ref = PlateauController(**kw), JPlateau(**kw)
        assert [ours.update(x) for x in losses] == [ref.update(x) for x in losses]
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_halve_lrs_halves_both_optimizers(trained):
    from prior_diffuse_tpu_torch.training.optim import get_lr

    tr, _ = trained
    before = {n: get_lr(o) for n, o in tr.opts.items()}
    tr._halve_lrs()
    assert {n: get_lr(o) for n, o in tr.opts.items()} == {n: v / 2 for n, v in before.items()}


def test_enhance_batch_serves_the_trained_weights(trained):
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    tr, _ = trained
    wav = torch.from_numpy(next(iter(tr.cv_loader)).noisy)
    got = tr.enhance_batch(wav, torch.Generator().manual_seed(1))
    ref = Enhancer(tr.dis, tr.ddpm, tr.exp, device="cpu", sigma=True)
    want = ref.enhance_batch(wav, torch.Generator().manual_seed(1))
    assert got.shape == wav.shape and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_eval_needs_a_cv_batch(corpus, tmp_path):
    run = tcfg.RunConfig(assets=str(tmp_path), doc="t", data_root=corpus)
    exp = dataclasses.replace(_exp(), train=tcfg.TrainConfig(batch_size=3, chunk_length=CHUNK))
    with pytest.raises(RuntimeError, match="no cv batches"):
        ComplexDDPMTrainer(run, exp, device="cpu").evaluate()
    with pytest.raises(RuntimeError, match="NaN"):
        ComplexDDPMTrainer(run, exp, device="cpu").check_nan(float("nan"))


@pytest.mark.parametrize("exp,error", [
    # the modes' combinations that the JAX trainer refuses too
    (_exp(pirorgrad=False, deltamu=True, predict="x0"), ValueError),
    (_exp(pirorgrad=False, cond_noisy=True), ValueError),
    (_exp(pirorgrad=False, deltamu=True, predict="x0", x0_leak_drop=0.5), ValueError),
    (_exp(pirorgrad=False, deltamu=True, cond_noisy=True), ValueError),
    # bf16 training is ported (item 16): that configuration builds and trains
    # in bf16 compute (tests/test_torch_bf16_train_step.py holds it to JAX)
    (dataclasses.replace(_exp(), train=dataclasses.replace(_exp().train,
                                                           compute_dtype="bfloat16")), None),
    # a magnitude model is not a complex-spectrum prior (MagTrainer trains GRN)
    (dataclasses.replace(_exp(), model=tcfg.ModelConfig(name="GRN")), ValueError),
], ids=["deltamu", "conditional", "deltamu-leak_drop", "deltamu-cond_noisy", "bf16", "grn"])
def test_trainer_refuses_what_is_not_ported(exp, error, corpus, tmp_path):
    run = tcfg.RunConfig(assets=str(tmp_path), data_root=corpus, joint=True)
    if error is None:
        check_trains_in_bf16(ComplexDDPMTrainer(run, exp, device="cpu"))
        return
    with pytest.raises(error):
        ComplexDDPMTrainer(run, exp, device="cpu")


def check_trains_in_bf16(tr):
    """``tr`` (any of the three trainers) computes in bf16 on float32
    parameters, and one step leaves its parameters and Adam state float32."""
    assert tr.compute_dtype == torch.bfloat16
    b = next(iter(tr.tr_loader))
    out = tr._train_step(*tr.put_batch(b.noisy, b.clean, b.frame_nums), norms=False)
    assert all(torch.isfinite(v) for v in out if isinstance(v, torch.Tensor))
    for name, net in tr.nets.items():
        assert all(p.dtype == torch.float32 for p in net.parameters()), name
    for name, opt in tr.opts.items():
        if opt.state:
            assert all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
                       for s in opt.state.values()), name
    assert any(opt.state for opt in tr.opts.values())


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


def test_cli_trains_then_generates(corpus, tmp_path, root_logging):
    args = ["--config", _small_conf(tmp_path), "--joint", "--data-root", corpus,
            "--assets", str(tmp_path / "assets"), "--doc", "t", "--device", "cpu"]
    cli.main(args)
    recs = _records(str(tmp_path / "assets"))
    assert sum("loss_sum" in r for r in recs) == 2 and any("test_loss" in r for r in recs)
    ckpt = tmp_path / "assets" / "checkpoint" / "t"
    assert (ckpt / "best.pt").exists() and (ckpt / "epochs" / "0.pt").exists()

    cli.main(args + ["--generate"])
    outs = sorted(glob.glob(str(tmp_path / "assets" / "wav" / "t" / "*.wav")))
    ins = sorted(glob.glob(f"{corpus}/noisy_testset_wav/*.wav"))
    assert [os.path.basename(p) for p in outs] == [os.path.basename(p) for p in ins]
    for i, o in zip(ins, outs):
        x, y = read_wav(i)[0], read_wav(o)[0]
        assert y.shape == x.shape and np.isfinite(y).all() and np.abs(y).max() > 0


@pytest.mark.parametrize("extra,error,match", [
    # ported (tests/test_torch_tooling.py): the flags are taken, and the run
    # stops only at the empty data root
    (["--draw"], FileNotFoundError, "no wavs under"),
    (["--profile-steps", "3"], FileNotFoundError, "no wavs under"),
    (["--wandb"], FileNotFoundError, "no wavs under"),
    # MagTrainer is ported (tests/test_torch_grn.py); it takes GRN, not
    # conf/diff.yml's DiffUNet
    (["--trainer", "MagTrainer"], ValueError, "MagTrainer trains GRN"),
], ids=["draw", "profile", "wandb", "trainer"])
def test_cli_refuses_what_is_not_ported(extra, error, match, tmp_path, root_logging):
    with pytest.raises(error, match=match):
        cli.main(["--assets", str(tmp_path), "--data-root", str(tmp_path), "--device", "cpu",
                  *extra])
