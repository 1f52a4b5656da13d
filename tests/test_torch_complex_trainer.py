"""The port's ComplexTrainer against the JAX ComplexTrainer (CPU).

For GCRN (``conf/gcrn.yml``'s prior) and ``aia_complex_trans_ri``
(``conf/dbaiat.yml``'s), with ``com_mag_mse_loss``: the JAX trainer on a
1-device mesh (``make_mesh(dp=1)``: the default 8-device test mesh would
pad a batch of 2 with rows that enter the BatchNorm statistics) and the
port's, on a tiny synthetic corpus, batch 2 x 1600 samples (11 frames).
The JAX initial state is carried into the port by ``convert.py``; each
family compiles the JAX step once, in a module-scoped fixture:

* one train step: loss rtol 1e-5; group gradient norms rtol 1e-4 (or
  1e-6 x the largest); the new BatchNorm statistics rtol 1e-5; Adam's
  updates within ``2 * lr`` per element and 1e-4 relative L2 over the
  elements whose gradient is at least 1e-6 and has the same sign in both
  packages (those of opposite sign at most 1e-3 of the gradient's norm),
  the moments 1e-3 relative L2 there (``test_torch_train_step.py`` says
  why); for DB-AIAT 1e-3 on the norms and updates and 5e-3 on the
  moments, because JAX's own gradient is off there (``python3
  tools/prior_probe.py tel``): against a float64 run of the port's
  ``TransformerEncoderLayer`` (same weights, input and cotangent), JAX's
  float32 gradient of the reverse-direction GRU sits 1.7e-3..2.1e-3
  relative L2 away (and 1e-4..2.4e-4 for every parameter upstream of
  it), the port's float32 gradient 2e-7..5e-7; alone, JAX's GRU gradient
  is within 4.4e-7.  Measured here (``tools/prior_probe.py step``):
  DB-AIAT group norms up to 8.0e-4 from JAX's, the moments 1.5e-3 /
  1.2e-3, the updates 8.3e-5; GCRN's 2.7e-5, 3.0e-6, 8.7e-6;
* after the step, on JAX's new state: ``evaluate()``'s loss (rtol 1e-5)
  and its six metrics (the same wavs within 2.5e-4, so rtol 1e-3), and
  ``enhance_batch``'s waveform within 2.5e-4 x max|JAX|;
* a checkpoint round trip: a trainer resumed with ``--retrain`` takes the
  next step as the one that saved it, bit for bit;
* ``train()``: its log, checkpoints and plateau state, and its train
  records' keys step by step against the JAX trainer's (``step_time_ms``
  and ``utt_per_sec`` from the second step on); ``cli.main
  --trainer ComplexTrainer`` on a tiny ``conf/gcrn.yml`` trains one epoch
  and ``--generate`` writes one wav per test utterance, and ``--trainer
  ComplexDDPMTrainer`` takes that yml's GCRN as its prior;
* a hazard of the reference: ``com_mag_mse_loss``'s gradient at bins of
  exactly 0 (the padded frames of a magnitude-masking prior's output) is
  NaN in JAX (``jnp.linalg.norm``) and 0 in the port.
"""

import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prior_diffuse_tpu.config as jcfg
from prior_diffuse_tpu.data import synthetic
from prior_diffuse_tpu.parallel.mesh import make_mesh
from prior_diffuse_tpu_torch import cli
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.data.dataset import PairedWavDataset, _collate
from prior_diffuse_tpu_torch.data.wavio import read_wav
from prior_diffuse_tpu_torch.training.complex_trainer import ComplexTrainer
from test_torch_train_step import _adam, _flat, _jax_grad, _np, _rel_l2, _steady
from test_torch_trainer import check_trains_in_bf16
from test_torch_trainer import root_logging  # noqa: F401 (a fixture)

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1600
LR = {"GCRN": 2e-4, "aia_complex_trans_ri": 5e-4}  # conf/gcrn.yml, conf/dbaiat.yml
# group norms and same-sign updates, relative: DB-AIAT's JAX gradient is
# itself ~2e-3 off in its transformers' reverse GRUs (module docstring)
STEP_RTOL = {"GCRN": 1e-4, "aia_complex_trans_ri": 1e-3}
# Adam's moments (the gradient and its square) over the steady elements
MOMENT_RTOL = {"GCRN": 1e-3, "aia_complex_trans_ri": 5e-3}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return synthetic.write_corpus_speechlike(str(root), n_train=4, n_test=2, min_len=2000,
                                             max_len=3000, seed=6)


def _exp(module, name, batch_size=2):
    return module.ExperimentConfig(
        train=module.TrainConfig(batch_size=batch_size, n_epochs=1, chunk_length=CHUNK,
                                 loss="com_mag_mse_loss"),
        model=module.ModelConfig(name), optim=module.OptimConfig(lr=LR[name]))


def _batch(corpus):
    ds = PairedWavDataset(f"{corpus}/noisy_trainset_wav", f"{corpus}/clean_trainset_wav",
                          chunk_length=CHUNK)
    rng = np.random.default_rng(0)
    return _collate([ds.load_pair(j, crop=True, rng=rng) for j in range(2)], CHUNK)


def _torch_batch(batch):
    return (torch.from_numpy(batch.noisy), torch.from_numpy(batch.clean),
            torch.from_numpy(batch.frame_nums).long())


def _trainer(name, corpus, assets, **run_kw):
    run = tcfg.RunConfig(assets=str(assets), doc="t", data_root=corpus, **run_kw)
    return ComplexTrainer(run, _exp(tcfg, name), device="cpu")


@pytest.fixture(scope="module", params=list(LR))
def step_pair(request, corpus, tmp_path_factory):
    """The JAX step and the port's step from one state on one batch."""
    from prior_diffuse_tpu.training import ComplexTrainer as JTrainer

    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    jrun = jcfg.RunConfig(assets=str(tmp / "jax"), doc="t", data_root=corpus)
    jtr = JTrainer(jrun, _exp(jcfg, name), mesh=make_mesh(dp=1))
    tr = _trainer(name, corpus, tmp / "torch")
    state0 = _np(jtr.state["model"])
    tr.model.load_state_dict(flax_to_state_dict(tr.model, state0))

    batch = _batch(corpus)
    arrays = jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    jstate, loss, gnorms = jtr._train_step(jtr.state, *arrays)
    jtr.state = jstate
    got = tr._train_step(*_torch_batch(batch))
    return dict(name=name, jtr=jtr, tr=tr, state0=state0, batch=batch, got=got,
                want=(float(loss), {k: float(v) for k, v in gnorms.items()}),
                after=copy.deepcopy(tr.ckpt_payload()),
                # AHAM's k3 is read by no forward: no gradient, no Adam state
                grads={n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                       for n, p in tr.model.named_parameters()})


def test_loss_matches(step_pair):
    np.testing.assert_allclose(float(step_pair["got"][0]), step_pair["want"][0], rtol=1e-5)


def test_grad_norms_match(step_pair):
    got, want = step_pair["got"][1], step_pair["want"][1]
    assert sorted(got) == sorted(want) and all(k.startswith("gn_model/") for k in want)
    top = max(want.values())
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=STEP_RTOL[step_pair["name"]],
                                   atol=1e-6 * top, err_msg=k)


def test_batch_stats_match(step_pair):
    tr, jstate = step_pair["tr"], step_pair["jtr"].state
    after = step_pair["after"]["state"]["model"]
    got = state_dict_to_flax(tr.model, after)["batch_stats"]
    want = _np(jstate["model"]["batch_stats"])
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    assert (len(flat_w) > 0) == (step_pair["name"] == "GCRN")  # DB-AIAT has no BatchNorm
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=str(path))


def test_param_updates_and_moments_match(step_pair):
    tr, jstate = step_pair["tr"], step_pair["jtr"].state
    lr, payload = LR[step_pair["name"]], step_pair["after"]["state"]
    old = _flat(step_pair["state0"]["params"])
    d_want = _flat(_np(jstate["model"]["params"])) - old
    d_got = _flat(state_dict_to_flax(tr.model, payload["model"])["params"]) - old
    assert np.abs(d_got - d_want).max() <= 2 * lr
    g_want = _jax_grad(jstate["opt"])
    g_got = _flat(state_dict_to_flax(tr.model, step_pair["grads"])["params"])
    flips = np.sign(g_got) != np.sign(g_want)
    assert np.linalg.norm(g_want[flips]) <= 1e-3 * np.linalg.norm(g_want)
    steady = _steady(jstate["opt"]) & ~flips
    assert _rel_l2(d_got[steady], d_want[steady]) <= STEP_RTOL[step_pair["name"]]
    want = _adam(jstate["opt"])
    assert int(want.count) == 1
    names = [n for n, _ in tr.model.named_parameters()]
    opt_state = payload["opt"]["state"]
    for key, jax_tree in (("exp_avg", want.mu), ("exp_avg_sq", want.nu)):
        got = _flat(state_dict_to_flax(tr.model, {
            n: opt_state[i][key] if i in opt_state else torch.zeros_like(step_pair["grads"][n])
            for i, n in enumerate(names)})["params"])
        err = _rel_l2(got[steady], _flat(_np(jax_tree))[steady])
        assert err <= MOMENT_RTOL[step_pair["name"]], (key, err)


@pytest.fixture(scope="module")
def on_jax_state(step_pair):
    """The port's trainer holding the JAX trainer's state after the step."""
    tr, jtr = step_pair["tr"], step_pair["jtr"]
    tr.model.load_state_dict(flax_to_state_dict(tr.model, _np(jtr.state["model"]),
                                                batches_tracked=1))
    return step_pair


def _eval_record(assets):
    with open(os.path.join(assets, "log", "t", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if "test_loss" in line][-1]


def test_evaluate_matches_jax(on_jax_state):
    tr, jtr = on_jax_state["tr"], on_jax_state["jtr"]
    got, want = tr.evaluate(), jtr.evaluate()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    rec_g, rec_w = _eval_record(tr.run.assets), _eval_record(jtr.run.assets)
    for m in ("csig", "cbak", "covl", "pesq", "ssnr", "stoi"):
        key = f"test_mean_{m}"
        assert np.isfinite(rec_g[key])
        np.testing.assert_allclose(rec_g[key], rec_w[key], rtol=1e-3, atol=1e-4, err_msg=m)


def test_enhance_batch_matches_jax(on_jax_state):
    tr, jtr = on_jax_state["tr"], on_jax_state["jtr"]
    wav = on_jax_state["batch"].noisy
    want = np.asarray(jtr.enhance_batch(wav, jax.random.PRNGKey(0)))
    got = tr.enhance_batch(torch.from_numpy(wav)).numpy()
    assert got.shape == wav.shape
    assert np.abs(got - want).max() <= 2.5e-4 * np.abs(want).max()


def test_checkpoint_round_trip(on_jax_state, corpus):
    """Saved, restored into a fresh trainer with ``--retrain``, the next
    step is bit for bit the saving trainer's."""
    tr = on_jax_state["tr"]
    tr.ckpt.save_epoch(0, tr.ckpt_payload())
    resumed = _trainer(on_jax_state["name"], corpus, tr.run.assets, retrain=True)
    assert (resumed.epoch, resumed.step) == (1, tr.step)
    batch = _torch_batch(on_jax_state["batch"])
    outs = [t._train_step(*batch) for t in (tr, resumed)]
    assert torch.equal(outs[0][0], outs[1][0])
    sd_a, sd_b = tr.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    st_a, st_b = tr.opt.state_dict()["state"], resumed.opt.state_dict()["state"]
    assert st_a.keys() == st_b.keys() and len(st_a) > 0
    for k in st_a:
        assert all(torch.equal(st_a[k][f], st_b[k][f]) for f in st_a[k]), k


def test_train_logs_checkpoints_and_halves(corpus, tmp_path):
    tr = _trainer("GCRN", corpus, tmp_path)
    tr.train()
    assert (tr.epoch, tr.step) == (1, 2)
    with open(tmp_path / "log" / "t" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "train_batch_loss" in r]
    assert [r["step"] for r in steps] == [0, 1]
    assert all(np.isfinite(r["train_batch_loss"]) for r in steps)
    # step to step, as JAX's StepTimer: nothing on the first step
    assert "step_time_ms" not in steps[0] and "utt_per_sec" not in steps[0]
    assert steps[1]["step_time_ms"] > 0 and steps[1]["utt_per_sec"] > 0
    assert "gn_model/glstm/lstm1_0" in steps[0] and not any(k.startswith("gn_") for k in steps[1])
    ev = next(r for r in recs if "test_loss" in r)
    assert tr.plateau.best_loss == ev["test_loss"]
    assert os.listdir(tmp_path / "checkpoint" / "t" / "epochs") == ["0.pt"]
    assert (tmp_path / "checkpoint" / "t" / "best.pt").exists()
    lr = tr.opt.param_groups[0]["lr"]
    tr._halve_lrs()
    assert tr.opt.param_groups[0]["lr"] == lr / 2
    assert tr.load_best() and tr.step == 2


def _small_conf(tmp_path, name):
    """``conf/<name>.yml`` with batch 2, chunks of CHUNK and one epoch."""
    with open(os.path.join(ROOT, "conf", f"{name}.yml")) as f:
        text = f.read()
    batch = {"gcrn": "batch_size: 8", "dbaiat": "batch_size: 4"}[name]
    epochs = {"gcrn": "n_epochs: 50", "dbaiat": "n_epochs: 80"}[name]
    for old, new in ((batch, "batch_size: 2"), (epochs, "n_epochs: 1"),
                     ("chunk_length: 48000", f"chunk_length: {CHUNK}")):
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / f"{name}.yml"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("trainer", ["ComplexTrainer", "ComplexDDPMTrainer"])
def test_cli_trains_then_generates(trainer, corpus, tmp_path, root_logging):
    args = ["--trainer", trainer, "--config", _small_conf(tmp_path, "gcrn"), "--joint",
            "--data-root", corpus, "--assets", str(tmp_path / "assets"), "--doc", "t",
            "--device", "cpu"]
    cli.main(args)
    with open(tmp_path / "assets" / "log" / "t" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    loss_key = "train_batch_loss" if trainer == "ComplexTrainer" else "loss_sum"
    assert sum(loss_key in r for r in recs) == 2 and any("test_loss" in r for r in recs)
    assert (tmp_path / "assets" / "checkpoint" / "t" / "best.pt").exists()
    cli.main(args + ["--generate"])
    outs = sorted(glob.glob(str(tmp_path / "assets" / "wav" / "t" / "*.wav")))
    ins = sorted(glob.glob(f"{corpus}/noisy_testset_wav/*.wav"))
    assert [os.path.basename(p) for p in outs] == [os.path.basename(p) for p in ins]
    for i, o in zip(ins, outs):
        x, y = read_wav(i)[0], read_wav(o)[0]
        assert y.shape == x.shape and np.isfinite(y).all() and np.abs(y).max() > 0


def test_trainer_refuses_what_is_not_ported(corpus, tmp_path):
    import dataclasses

    exp = _exp(tcfg, "GCRN")
    run = tcfg.RunConfig(assets=str(tmp_path), data_root=corpus)
    # GRN (a magnitude model) and DiffWave are no complex-spectrum priors
    for bad, error in ((dataclasses.replace(exp, model=tcfg.ModelConfig("GRN")), ValueError),
                       (dataclasses.replace(exp, model=tcfg.ModelConfig("DiffWave")),
                        ValueError),
                       (dataclasses.replace(exp, model=tcfg.ModelConfig("nope")), KeyError)):
        with pytest.raises(error):
            ComplexTrainer(run, bad, device="cpu")
    # bf16 training is ported (item 16): it builds and trains in bf16 compute
    # (tests/test_torch_bf16_train_complex.py holds it to JAX)
    bf16 = dataclasses.replace(exp, train=dataclasses.replace(exp.train, compute_dtype="bfloat16"))
    check_trains_in_bf16(ComplexTrainer(run, bf16, device="cpu"))


def test_mag_loss_gradient_at_zero_bins():
    """A hazard of the reference, not a port fault: at a bin where the
    estimate is exactly 0 (the padded frames of a magnitude-masking
    prior, whose output is the mask times the noisy magnitude) JAX's
    gradient of ``com_mag_mse_loss`` is NaN, the port's is finite."""
    from prior_diffuse_tpu.losses import com_mag_mse_loss as jloss
    from prior_diffuse_tpu_torch.losses import com_mag_mse_loss

    rng = np.random.default_rng(0)
    est = rng.standard_normal((2, 6, 161, 2)).astype(np.float32)
    est[:, 4:] = 0.0  # frames past frame_nums
    label = rng.standard_normal(est.shape).astype(np.float32)
    frames = np.asarray([4, 4])
    g_jax = np.asarray(jax.grad(jloss)(jnp.asarray(est), jnp.asarray(label), jnp.asarray(frames)))
    est_t = torch.from_numpy(est).requires_grad_()
    com_mag_mse_loss(est_t, torch.from_numpy(label), torch.from_numpy(frames)).backward()
    assert np.isnan(g_jax[:, 4:]).all() and np.isfinite(g_jax[:, :4]).all()
    assert torch.isfinite(est_t.grad).all() and not est_t.grad[:, 4:].any()
    np.testing.assert_allclose(est_t.grad[:, :4].numpy(), g_jax[:, :4], rtol=1e-4, atol=1e-9)


def test_servers_need_a_card_and_serve_other_priors_in_f32_only(monkeypatch):
    """No fallback to the CPU on the default device.  A prior other than the
    DiffUNet was served in float32 only until bf16 serving of every prior
    (ROADMAP item 18) landed: now the ``PriorServer`` and the DDPM's
    ``Enhancer`` take GCRN in bf16, through its serving copy
    (``tests/test_torch_bf16_priors.py`` holds it to JAX)."""
    from prior_diffuse_tpu_torch.models import model_class
    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet1
    from prior_diffuse_tpu_torch.serving.enhance import PriorServer
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    exp = _exp(tcfg, "GCRN")
    gcrn = model_class("GCRN")()
    assert PriorServer(gcrn, exp, device="cpu", dtype=torch.bfloat16).net().conv1.conv1 \
        .product.weight.dtype == torch.bfloat16
    enh = Enhancer(gcrn, DiffUNet1(), exp, device="cpu", dtype=torch.bfloat16)
    assert enh.packs()[0] is None and enh.dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        PriorServer(gcrn, exp)


def test_train_log_keys_match_jax(step_pair, corpus, tmp_path, monkeypatch):
    """The train records of one epoch hold the JAX trainer's keys step by
    step: no ``step_time_ms`` / ``utt_per_sec`` on the first step (both
    time from one step to the next), the group norms on step 0.  The
    evaluation is stubbed in both (not compared here); last in the file,
    as it moves the JAX trainer's state on."""
    jtr, name = step_pair["jtr"], step_pair["name"]
    tr = _trainer(name, corpus, tmp_path)
    logs = []
    for trainer, assets in ((jtr, jtr.run.assets), (tr, str(tmp_path))):
        monkeypatch.setattr(trainer, "evaluate", lambda: 1.0)
        trainer.train()
        with open(os.path.join(assets, "log", "t", "metrics.jsonl")) as f:
            logs.append([r for r in map(json.loads, f) if "train_batch_loss" in r])
    want, got = logs
    assert len(want) == len(got) == 2
    assert [set(r) for r in got] == [set(r) for r in want]
    assert "step_time_ms" not in got[0] and "utt_per_sec" in got[1]
