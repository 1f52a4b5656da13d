"""The port's GRN and MagTrainer against the JAX package's (CPU).

``conf/grn.yml``'s system: the GRN magnitude prior (3,131,731 parameters)
trained alone on the compressed magnitude with ``mag_mse_loss``.

* GRN's forward, at full width, B = 2 and T = 12 frames, on flax variables
  (perturbed as ``test_torch_priors.py`` does, BatchNorm statistics
  randomised) carried in by ``convert.py``: in inference mode within 1e-5
  relative L2, and in train mode within 1e-5 of a float64 run and 2e-5 of
  JAX (the test says why), with the new BatchNorm statistics (rtol 1e-5,
  or 1e-5 of the leaf's largest value, at least 1e-7);
  the ``convert.py`` round trip (flax -> port -> flax is the identity);
  the front end's (C, F) grid flattened c-major into ``conv1d_in``, and
  the transposed (f-major) order missing JAX by far.
* ``MagTrainer`` against the JAX ``MagTrainer`` on a 1-device mesh (see
  ``test_torch_complex_trainer.py``), batch 2 x 1600 samples (11 frames),
  on a corpus of 4 + 3 utterances, so the cv loader's last batch is
  ragged (one utterance), the JAX initial state carried into the port:
  one train step (loss rtol 1e-6, group gradient norms rtol 1e-4 or 1e-6
  x the largest, the new BatchNorm statistics as above, Adam's updates
  within ``2 * lr`` per element and 1e-4 relative L2 over the steady
  same-sign elements, the moments 1e-3: ``test_torch_train_step.py``
  says why); then on JAX's new state ``_eval_step`` on the ragged batch
  (the estimate on the noisy phase, the label on the clean phase,
  decompressed as the metrics take them, 1e-5 x max; the loss rtol 1e-5:
  the test says why), ``evaluate()``'s
  loss (rtol 1e-5) and six metrics (rtol 1e-3; CSIG and COVL 3e-2, the
  test says why), and ``enhance_batch`` within 2.5e-4 x max|JAX|
  (``PARITY.md``'s bar).
* A padded batch (a row mostly zeros): the magnitude of exactly silent
  bins is 0, the loss takes no norm of the estimate, and the port's
  gradient is finite, as JAX's is.
* A JAX ``MagTrainer`` checkpoint (``{"model", "opt"}``) through
  ``tools/jax_ckpt_to_torch.py --model GRN`` (orbax, then
  ``convert.py::payload_from_jax``): the restored port trainer takes the
  JAX trainer's next step (loss rtol 1e-6, gradient 1e-4 relative L2).
* ``cli.main --trainer MagTrainer`` on a tiny ``conf/grn.yml`` trains one
  epoch and ``--generate`` writes one wav per test utterance.
"""

import copy
import glob
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prior_diffuse_tpu.config as jcfg
from prior_diffuse_tpu.data import synthetic
from prior_diffuse_tpu.models import grn as jgrn
from prior_diffuse_tpu.parallel.mesh import make_mesh
from prior_diffuse_tpu_torch import cli
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from prior_diffuse_tpu_torch.data.dataset import PairedWavDataset, _collate
from prior_diffuse_tpu_torch.data.wavio import read_wav
from prior_diffuse_tpu_torch.models import grn, model_class
from prior_diffuse_tpu_torch.signal.compress import decompress_spec
from prior_diffuse_tpu_torch.training.mag_trainer import MagTrainer
from test_torch_priors import perturb
from test_torch_train_step import _adam, _flat, _jax_grad, _np, _rel_l2, _steady
from test_torch_trainer import check_trains_in_bf16
from test_torch_trainer import root_logging  # noqa: F401 (a fixture)

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_FRAMES = 12
CHUNK = 1600
LR = 2e-4  # conf/grn.yml
FORWARD_REL_L2 = 1e-5
# BatchNorm statistics: the trunk sums 18 blocks' outputs, so a statistic
# near 0 carries the rounding of its leaf's largest values
STATS_ATOL = 1e-5
LLR_RTOL = {"csig": 3e-2, "covl": 3e-2}  # test_evaluate_matches_jax says why


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def maglike(shape, seed):
    """A compressed-magnitude-like input: |N(0, 1)| with some bins at 0."""
    x = np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    x[:, :, :3] = 0.0
    return x


@pytest.fixture(scope="module")
def grn_pair():
    """(flax GRN, perturbed numpy variables, the port's GRN holding them)."""
    jm = jgrn.GRN()
    variables = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, T_FRAMES, 161))),
                        np.random.default_rng(0))
    tm = model_class("GRN")()
    tm.load_state_dict(flax_to_state_dict(tm, variables))
    return jm, variables, tm


def test_param_count():
    assert sum(p.numel() for p in grn.GRN().parameters()) == 3_131_731


def test_forward_matches_flax(grn_pair):
    jm, variables, tm = grn_pair
    x = maglike((2, T_FRAMES, 161), 1)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert rel_l2(got.numpy(), want) <= FORWARD_REL_L2


def test_train_forward_and_batch_stats_match_flax(grn_pair):
    """Train mode normalises each of the 76 BatchNorms by the statistics of
    24 rows, and both packages' float32 outputs sit ~5e-6 from a float64
    run of the same module (JAX 6.2e-6, the port 5.6e-6 at this input): the
    port is held to 1e-5 from the float64 run and to twice that from JAX
    (they read 1.0e-5 apart)."""
    jm, variables, tm = grn_pair
    x = maglike((2, T_FRAMES, 161), 2)
    want, updated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    exact = copy.deepcopy(tm).double().train()
    tm = copy.deepcopy(tm).train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        exact = exact(torch.from_numpy(x).double())
    assert rel_l2(got.numpy(), exact.numpy()) <= FORWARD_REL_L2
    assert rel_l2(got.numpy(), want) <= 2 * FORWARD_REL_L2
    stats = state_dict_to_flax(tm, tm.state_dict())["batch_stats"]
    flat_g = jax.tree_util.tree_flatten_with_path(stats)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(_np(updated["batch_stats"]))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w] and len(flat_w) == 2 * (1 + 18 * 4 + 3)
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=max(1e-7, STATS_ATOL * np.abs(w).max()),
                                   err_msg=str(path))


def test_convert_round_trip_is_identity(grn_pair):
    _, variables, tm = grn_pair
    back = state_dict_to_flax(tm, tm.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_front_end_flattens_c_major(grn_pair):
    """``conv1d_in``'s input channel ``c 161 + f`` is the front end's
    channel ``c`` at bin ``f``; fed the transposed (f-major) order, the
    port misses JAX by far."""
    jm, variables, tm = grn_pair
    tm = copy.deepcopy(tm).eval()
    seen = {}
    tm.dila4.register_forward_hook(lambda m, args, out: seen.setdefault("grid", out))
    hook = tm.conv1d_in.register_forward_pre_hook(
        lambda m, args: seen.setdefault("flat", args[0]))
    x = maglike((1, T_FRAMES, 161), 3)
    with torch.no_grad():
        tm(torch.from_numpy(x))
    grid = torch.nn.functional.elu(seen["grid"])  # [1, 32, T, 161]
    assert torch.equal(seen["flat"], grid.permute(0, 1, 3, 2).reshape(1, 32 * 161, T_FRAMES))
    hook.remove()
    tm.conv1d_in.register_forward_pre_hook(  # the f-major order
        lambda m, args: (args[0].view(1, 32, 161, -1).transpose(1, 2).reshape(1, 5152, -1),))
    with torch.no_grad():
        transposed = tm(torch.from_numpy(x))
    assert rel_l2(transposed.numpy(), jm.apply(variables, jnp.asarray(x))) > 100 * FORWARD_REL_L2


# ---- MagTrainer ------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return synthetic.write_corpus_speechlike(str(root), n_train=4, n_test=3, min_len=2000,
                                             max_len=3000, seed=8)


def _exp(module, batch_size=2):
    return module.ExperimentConfig(
        train=module.TrainConfig(batch_size=batch_size, n_epochs=1, chunk_length=CHUNK,
                                 loss="mag_mse_loss"),
        model=module.ModelConfig("GRN"), optim=module.OptimConfig(lr=LR))


def _batch(corpus):
    ds = PairedWavDataset(f"{corpus}/noisy_trainset_wav", f"{corpus}/clean_trainset_wav",
                          chunk_length=CHUNK)
    rng = np.random.default_rng(0)
    return _collate([ds.load_pair(j, crop=True, rng=rng) for j in range(2)], CHUNK)


def _torch_batch(batch):
    return (torch.from_numpy(batch.noisy), torch.from_numpy(batch.clean),
            torch.from_numpy(batch.frame_nums).long())


def _trainer(corpus, assets, **run_kw):
    run = tcfg.RunConfig(assets=str(assets), doc="t", data_root=corpus, **run_kw)
    return MagTrainer(run, _exp(tcfg), device="cpu")


def _jax_trainer(corpus, assets):
    from prior_diffuse_tpu.training import MagTrainer as JTrainer

    run = jcfg.RunConfig(assets=str(assets), doc="t", data_root=corpus)
    return JTrainer(run, _exp(jcfg), mesh=make_mesh(dp=1))


def _grads(tr):
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in tr.model.named_parameters()}


@pytest.fixture(scope="module")
def step_pair(corpus, tmp_path_factory):
    """The JAX step and the port's step from one state on one batch."""
    tmp = tmp_path_factory.mktemp("grn")
    jtr = _jax_trainer(corpus, tmp / "jax")
    tr = _trainer(corpus, tmp / "torch")
    state0 = _np(jtr.state["model"])
    tr.model.load_state_dict(flax_to_state_dict(tr.model, state0))
    batch = _batch(corpus)
    arrays = jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums)
    jstate, loss, gnorms = jtr._train_step(jtr.state, *arrays)
    jtr.state = jstate
    jtr.step += 1
    got = tr._train_step(*_torch_batch(batch))
    tr.step += 1
    return dict(jtr=jtr, tr=tr, state0=state0, batch=batch, got=got,
                want=(float(loss), {k: float(v) for k, v in gnorms.items()}),
                after=copy.deepcopy(tr.ckpt_payload()), grads=_grads(tr))


def test_loss_matches(step_pair):
    np.testing.assert_allclose(float(step_pair["got"][0]), step_pair["want"][0], rtol=1e-6)


def test_grad_norms_match(step_pair):
    got, want = step_pair["got"][1], step_pair["want"][1]
    assert sorted(got) == sorted(want) and "gn_model/glu_2_5/left_conv" in want
    top = max(want.values())
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4, atol=1e-6 * top,
                                   err_msg=k)


def test_batch_stats_match(step_pair):
    got = state_dict_to_flax(step_pair["tr"].model,
                             step_pair["after"]["state"]["model"])["batch_stats"]
    want = _np(step_pair["jtr"].state["model"]["batch_stats"])
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=max(1e-7, STATS_ATOL * np.abs(w).max()),
                                   err_msg=str(path))


def test_param_updates_and_moments_match(step_pair):
    tr, jstate, payload = step_pair["tr"], step_pair["jtr"].state, step_pair["after"]["state"]
    old = _flat(step_pair["state0"]["params"])
    d_want = _flat(_np(jstate["model"]["params"])) - old
    d_got = _flat(state_dict_to_flax(tr.model, payload["model"])["params"]) - old
    assert np.abs(d_got - d_want).max() <= 2 * LR
    g_want = _jax_grad(jstate["opt"])
    g_got = _flat(state_dict_to_flax(tr.model, step_pair["grads"])["params"])
    flips = np.sign(g_got) != np.sign(g_want)
    assert np.linalg.norm(g_want[flips]) <= 1e-3 * np.linalg.norm(g_want)
    steady = _steady(jstate["opt"]) & ~flips
    assert _rel_l2(d_got[steady], d_want[steady]) <= 1e-4
    want = _adam(jstate["opt"])
    names = [n for n, _ in tr.model.named_parameters()]
    opt_state = payload["opt"]["state"]
    for key, jax_tree in (("exp_avg", want.mu), ("exp_avg_sq", want.nu)):
        got = _flat(state_dict_to_flax(tr.model, {n: opt_state[i][key]
                                                  for i, n in enumerate(names)})["params"])
        assert _rel_l2(got[steady], _flat(_np(jax_tree))[steady]) <= 1e-3, key


@pytest.fixture(scope="module")
def on_jax_state(step_pair):
    """The port's trainer holding the JAX trainer's state after the step."""
    tr, jtr = step_pair["tr"], step_pair["jtr"]
    tr.model.load_state_dict(flax_to_state_dict(tr.model, _np(jtr.state["model"]),
                                                batches_tracked=1))
    return step_pair


def test_eval_step_matches_jax_on_the_ragged_batch(on_jax_state):
    """The loss, and the estimate and label as the metrics take them,
    decompressed.  At a near-silent bin the STFT is its own float32
    rounding (~1e-7), different in either package: its phase is arbitrary,
    and the compressed magnitude, its square root, differs by up to ~5e-4
    (15 of 16,261 bins here); squared back, that is below 1e-6."""
    tr, jtr = on_jax_state["tr"], on_jax_state["jtr"]
    batches = list(tr.cv_loader)
    assert [b.noisy.shape[0] for b in batches] == [2, 1]
    batch = batches[-1]
    want = jtr._eval_step(jtr.state, *jtr.put_batch(batch.noisy, batch.clean,
                                                    batch.frame_nums))
    got = tr._eval_step(*_torch_batch(batch))
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    for g, w in zip(got[:2], want[:2]):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape
        a, b = decompress_spec(g).numpy(), decompress_spec(w).numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def _eval_record(assets):
    with open(os.path.join(assets, "log", "t", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if "test_loss" in line][-1]


def test_evaluate_matches_jax(on_jax_state):
    """The loss and the six metrics over both cv batches.  CSIG and COVL
    carry the log-likelihood ratio of LPC fits, ill-conditioned on the
    ragged batch's 0.18 s utterance: the two packages' ``compare_complex``
    score JAX's own estimate 3.1e-3 apart there, and the port's estimate
    (its near-silent bins on their own arbitrary phase) 3.1e-2 apart, 1.6e-2
    in the mean; so those two are held to 3e-2, the others to 1e-3."""
    tr, jtr = on_jax_state["tr"], on_jax_state["jtr"]
    np.testing.assert_allclose(tr.evaluate(), jtr.evaluate(), rtol=1e-5)
    rec_g, rec_w = _eval_record(tr.run.assets), _eval_record(jtr.run.assets)
    for m in ("csig", "cbak", "covl", "pesq", "ssnr", "stoi"):
        key = f"test_mean_{m}"
        assert np.isfinite(rec_g[key])
        np.testing.assert_allclose(rec_g[key], rec_w[key], rtol=LLR_RTOL.get(m, 1e-3),
                                   atol=1e-4, err_msg=m)


def test_enhance_batch_matches_jax(on_jax_state):
    tr, jtr = on_jax_state["tr"], on_jax_state["jtr"]
    wav = on_jax_state["batch"].noisy
    want = np.asarray(jtr.enhance_batch(wav, jax.random.PRNGKey(0)))
    got = tr.enhance_batch(torch.from_numpy(wav)).numpy()
    assert got.shape == wav.shape
    assert np.abs(got - want).max() <= 2.5e-4 * np.abs(want).max()


def test_padded_batch_has_a_finite_gradient(on_jax_state, tmp_path):
    """A row that is 90 % zero padding: its silent bins have magnitude 0
    (and an arbitrary phase); the loss is finite and so is every
    gradient."""
    tr = _trainer(on_jax_state["jtr"].run.data_root, tmp_path)
    tr.model.load_state_dict(on_jax_state["tr"].model.state_dict())
    noisy, clean, frames = _torch_batch(on_jax_state["batch"])
    noisy[1, CHUNK // 10:] = 0.0
    clean[1, CHUNK // 10:] = 0.0
    frames[1] = CHUNK // 10 // 160 + 1
    loss, _ = tr._train_step(noisy, clean, frames)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in tr.model.parameters() if p.grad is not None)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(ROOT, "tools", "jax_ckpt_to_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_jax_checkpoint_takes_the_same_next_step(on_jax_state, corpus, tmp_path):
    """The JAX trainer's checkpoint after its step, converted by
    ``tools/jax_ckpt_to_torch.py --model GRN`` (orbax without a template,
    then ``convert.py::payload_from_jax``): the port's trainer restores it
    with ``load_best`` and takes the JAX trainer's next step."""
    jtr, batch = on_jax_state["jtr"], on_jax_state["batch"]
    jtr.ckpt.save_best(jtr.ckpt_payload())
    tr = _trainer(corpus, tmp_path)
    with pytest.raises(ValueError, match="--model"):
        _tool().main([jtr.run.checkpoint_dir, tr.run.checkpoint_dir])
    _tool().main([jtr.run.checkpoint_dir, tr.run.checkpoint_dir, "--model", "GRN"])
    assert tr.load_best() and tr.step == jtr.step == 1
    payload = _tool().restore_jax(jtr.run.checkpoint_dir, "best")[0]
    assert set(payload["state"]) == {"model", "opt"}
    # the next step's gradient from JAX's moments: m2 = 0.9 m1 + 0.1 (g2 + l2 w1)
    w1 = _flat(_np(jtr.state["model"]["params"]))
    m1 = _flat(_np(_adam(jtr.state["opt"]).mu))
    jstate, loss, _ = jtr._train_step(jtr.state, *jtr.put_batch(
        batch.noisy, batch.clean, batch.frame_nums))
    got, _ = tr._train_step(*_torch_batch(batch))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
    g_want = (_flat(_np(_adam(jstate["opt"]).mu)) - 0.9 * m1) / 0.1
    l2 = tr.opt.param_groups[0]["weight_decay"]
    g_got = _flat(state_dict_to_flax(tr.model, _grads(tr))["params"]) + l2 * w1
    assert _rel_l2(g_got, g_want) <= 1e-4


def _small_conf(tmp_path):
    """``conf/grn.yml`` with batch 2, chunks of CHUNK and one epoch."""
    with open(os.path.join(ROOT, "conf", "grn.yml")) as f:
        text = f.read()
    for old, new in (("batch_size: 8", "batch_size: 2"), ("n_epochs: 50", "n_epochs: 1"),
                     ("chunk_length: 48000", f"chunk_length: {CHUNK}")):
        assert old in text
        text = text.replace(old, new)
    path = tmp_path / "grn.yml"
    path.write_text(text)
    return str(path)


def test_cli_trains_then_generates(corpus, tmp_path, root_logging):  # noqa: F811
    args = ["--trainer", "MagTrainer", "--config", _small_conf(tmp_path), "--data-root",
            corpus, "--assets", str(tmp_path / "assets"), "--doc", "t", "--device", "cpu"]
    cli.main(args)
    with open(tmp_path / "assets" / "log" / "t" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert sum("train_batch_loss" in r for r in recs) == 2 and any("test_loss" in r for r in recs)
    steps = [r for r in recs if "train_batch_loss" in r]  # MagTrainer: step to step
    assert "step_time_ms" not in steps[0] and steps[1]["utt_per_sec"] > 0
    assert (tmp_path / "assets" / "checkpoint" / "t" / "best.pt").exists()
    cli.main(args + ["--generate"])
    outs = sorted(glob.glob(str(tmp_path / "assets" / "wav" / "t" / "*.wav")))
    ins = sorted(glob.glob(f"{corpus}/noisy_testset_wav/*.wav"))
    assert [os.path.basename(p) for p in outs] == [os.path.basename(p) for p in ins]
    for i, o in zip(ins, outs):
        x, y = read_wav(i)[0], read_wav(o)[0]
        assert y.shape == x.shape and np.isfinite(y).all() and np.abs(y).max() > 0


def test_mag_trainer_takes_a_magnitude_prior_in_f32_only(corpus, tmp_path):
    """A magnitude prior only; in float32, and since bf16 training landed
    (item 16) in bf16 compute too (``tests/test_torch_bf16_train_complex.py``
    holds that to JAX): the name is the test's from before."""
    import dataclasses

    run = tcfg.RunConfig(assets=str(tmp_path), data_root=corpus)
    exp = _exp(tcfg)
    for bad, error in ((dataclasses.replace(exp, model=tcfg.ModelConfig("GCRN")), ValueError),
                       (dataclasses.replace(exp, model=tcfg.ModelConfig("DiffWave")),
                        ValueError)):
        with pytest.raises(error):
            MagTrainer(run, bad, device="cpu")
    bf16 = dataclasses.replace(exp, train=dataclasses.replace(exp.train, compute_dtype="bfloat16"))
    check_trains_in_bf16(MagTrainer(run, bf16, device="cpu"))
