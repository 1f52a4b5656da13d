"""The deltamu and conditional diffusion modes of the port against the JAX
package (CPU).

* ``Nocon``, the deltamu mode's unconditional denoiser: its parameter
  count (``PARITY.md``), the ``convert.py`` round trip, and its forward
  against flax ``Nocon.apply`` on converted variables (random init,
  randomised BN statistics), conv by conv and as the serving forward
  (``fused_unet_forward`` with ``x_init=None``: two ``Decoder`` modules or
  the dual decoder in f32; the dual decoder in bf16 against JAX's
  ``fused_unet_forward(..., dual_decoder=True)`` with Pallas in interpret
  mode);
* ``reverse_sample`` in each mode against JAX's, on the linear model and
  JAX's own draws of ``tests/test_torch_sampler.py`` (plain and sigma,
  ``n_avg`` 1 and 3, ``zero_init``);
* ``Enhancer.enhance_batch`` in deltamu and conditional mode, plain and
  ``--sigma``, against the JAX ``enhance_batch`` impl (``_jax_enhance``
  of ``test_torch_enhance.py`` and ``_jax_enhance_bf16`` of
  ``test_torch_bf16.py``, both in the mode), f32 and bf16;
* the trainer's net per mode, ``read_yaml`` of the modes, and the CLI in
  each of the two modes: one epoch, then ``--generate``.

The train step in each mode is held against JAX's in
``test_torch_train_step.py``; the refusals are cases of
``test_torch_enhance.py::test_enhancer_rejects_what_it_does_not_serve``
and ``test_torch_trainer.py::test_trainer_refuses_what_is_not_ported``.

Bounds: forwards and the sampler 1e-5 x max|ref|; the f32 batch 2.5e-4 x
max|ref| (``test_torch_enhance.py``); the bf16 forward and batch 2e-2
relative RMS (``test_torch_bf16.py``).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.config import DiffusionConfig as JDiffusionConfig
from prior_diffuse_tpu.diffusion import inference_schedule as j_inference_schedule
from prior_diffuse_tpu.diffusion import reverse_sample as j_reverse_sample
from prior_diffuse_tpu.models import fused_forward as jff
from prior_diffuse_tpu_torch import cli
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.convert import state_dict_to_flax
from prior_diffuse_tpu_torch.data import synthetic
from prior_diffuse_tpu_torch.data.wavio import read_wav
from prior_diffuse_tpu_torch.diffusion.qsample import sigma_mask
from prior_diffuse_tpu_torch.diffusion.sampler import reverse_sample
from prior_diffuse_tpu_torch.diffusion.schedule import inference_schedule
from prior_diffuse_tpu_torch.models import fused_forward as ff
from prior_diffuse_tpu_torch.models.diffunet import DiffUNet, DiffUNet1, Nocon
from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
from test_torch_bf16 import _jax_enhance_bf16, tb
from test_torch_enhance import _jax_enhance, _speechlike
from test_torch_models import T_FRAMES, make_pair
from test_torch_sampler import SHAPE, _chains, _close_rel, _linear
from test_torch_trainer import _small_conf, root_logging  # noqa: F401 (a fixture)

torch.set_num_threads(min(2, torch.get_num_threads()))

LENGTH = 2400
MODES = {"deltamu": dict(pirorgrad=False, deltamu=True), "conditional": dict(pirorgrad=False)}


@pytest.fixture(scope="module")
def nocon():
    return make_pair("Nocon", seed=6)


# ------------------------------------------------------------------ Nocon

def test_nocon_param_count():
    """``PARITY.md``: 2,780,263, DiffUNet1's 2,780,273 less its preprocess."""
    counts = [sum(p.numel() for p in m.parameters()) for m in (Nocon(), DiffUNet1())]
    assert counts == [2_780_263, 2_780_273]


def test_nocon_convert_round_trip_is_identity(nocon):
    _, variables, tm = nocon
    back = state_dict_to_flax(tm, tm.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def _nocon_inputs(seed):
    g = np.random.default_rng(seed)
    x = g.standard_normal((2, T_FRAMES, 161, 2)).astype(np.float32)
    return x, np.asarray([3.7, 21.0], np.float32)


@pytest.mark.parametrize("form", ["modules", "two_decoders", "dual"])
def test_nocon_forward_matches_flax(nocon, form):
    jm, variables, tm = nocon
    x, t = _nocon_inputs(1)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(t), train=False)
    with torch.no_grad():
        if form == "modules":
            got = tm(torch.from_numpy(x), torch.from_numpy(t))
        else:
            packed = ff.pack_unet(tm, dual_decoder=form == "dual")
            got = ff.fused_unet_forward(packed, torch.from_numpy(x), None, torch.from_numpy(t))
    _close_rel(got.numpy(), want)


def test_nocon_forward_bf16_matches_jax(nocon):
    """The bf16 serving forward (the dual decoder) against JAX's with the
    K3 stages in Pallas interpret mode."""
    _, variables, tm = nocon
    x, _ = _nocon_inputs(2)
    x, t = tb(x), tb(np.asarray([35.75, 7.5], np.float32))
    want = jff.fused_unet_forward(jff.pack_unet(variables), jnp.asarray(x.float().numpy(),
                                                                        jnp.bfloat16),
                                  None, jnp.asarray(t.float().numpy(), jnp.bfloat16),
                                  dtype=jnp.bfloat16, use_pallas=True, dual_decoder=True,
                                  interpret=True)
    with torch.no_grad():
        got = ff.fused_unet_forward(ff.pack_unet(tm, torch.bfloat16, dual_decoder=True),
                                    x, None, t)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    err = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    assert np.isfinite(got).all() and err <= 2e-2, f"rel RMS {err:.3g}"


def test_fused_forward_takes_a_conditioner_exactly_with_a_preprocess(nocon):
    """A conditioner passed to a Nocon pack, or missing for a DiffUNet1
    pack, is refused rather than dropped or failed on."""
    _, _, tm = nocon
    x, t = torch.zeros(1, 4, 161, 2), torch.zeros(1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="conditioner"):
            ff.fused_unet_forward(ff.pack_unet(tm), x, x, t)
        with pytest.raises(ValueError, match="conditioner"):
            ff.fused_unet_forward(ff.pack_unet(DiffUNet1().eval()), x, None, t)


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("mode", ["deltamu", "conditional"])
@pytest.mark.parametrize("sigma", [False, True], ids=["plain", "sigma"])
@pytest.mark.parametrize("n_avg", [1, 3])
def test_reverse_sample_in_mode_matches_jax(rng, mode, sigma, n_avg):
    x_init = rng.standard_normal(SHAPE).astype(np.float32)
    sig = sigma_mask(torch.from_numpy(x_init)) if sigma else None
    key = jax.random.PRNGKey(7)
    want = j_reverse_sample(
        _linear, key, jnp.asarray(x_init), SHAPE, j_inference_schedule(JDiffusionConfig()),
        mode, sig_mask=None if sig is None else jnp.asarray(sig.numpy()), n_avg=n_avg)
    got = reverse_sample(_linear, torch.from_numpy(x_init),
                         torch.from_numpy(_chains(key, n_avg)),
                         inference_schedule(tcfg.DiffusionConfig()), sig_mask=sig, mode=mode)
    _close_rel(got.numpy(), want)


@pytest.mark.parametrize("mode", ["pirorgrad", "deltamu", "conditional"])
def test_reverse_sample_zero_init_in_mode_matches_jax(rng, mode):
    """``zero_init`` starts from zeros, and in deltamu from ``x_init``."""
    x_init = rng.standard_normal(SHAPE).astype(np.float32)
    want = j_reverse_sample(_linear, jax.random.PRNGKey(3), jnp.asarray(x_init), SHAPE,
                            j_inference_schedule(JDiffusionConfig()), mode, zero_init=True)
    got = reverse_sample(_linear, torch.from_numpy(x_init), None,
                         inference_schedule(tcfg.DiffusionConfig()), zero_init=True, mode=mode)
    _close_rel(got.numpy(), want)


def test_reverse_sample_refuses_an_unknown_mode():
    x_init = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="mode"):
        reverse_sample(_linear, x_init, x_init[None], inference_schedule(tcfg.DiffusionConfig()),
                       mode="pirorgard")


# ------------------------------------------------------------ the batch

@pytest.fixture(scope="module")
def serving_nets(nocon):
    return {"dis": make_pair("DiffUNet", seed=3), "deltamu": nocon,
            "conditional": make_pair("DiffUNet1", seed=4)}


def _wav():
    wav = _speechlike(2, LENGTH, 0)
    return wav / np.sqrt(np.mean(wav.astype(np.float64) ** 2, axis=1, keepdims=True)
                         ).astype(np.float32)


@pytest.mark.parametrize("sigma", [False, True], ids=["plain", "sigma"])
@pytest.mark.parametrize("mode", ["deltamu", "conditional"])
def test_enhance_batch_in_mode_matches_jax(serving_nets, mode, sigma):
    (_, dis_vars, dis), (_, ddpm_vars, ddpm) = serving_nets["dis"], serving_nets[mode]
    wav, rng = _wav(), jax.random.PRNGKey(21)
    want = np.asarray(_jax_enhance(dis_vars, ddpm_vars, jnp.asarray(wav), rng, sigma=sigma,
                                   cond_noisy=False, mode=mode))
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0],
                                     (2, LENGTH // 160 + 1, 161, 2)))[None]
    cfg = tcfg.ExperimentConfig(diffusion=tcfg.DiffusionConfig(**MODES[mode]))
    enh = Enhancer(dis, ddpm, cfg, device="cpu", sigma=sigma)
    assert enh.mode == mode
    got = enh.enhance_batch(wav, x_T=torch.from_numpy(x_T)).numpy()
    assert got.shape == want.shape == wav.shape and np.isfinite(got).all()
    err, bound = np.abs(got - want).max(), 2.5e-4 * np.abs(want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("sigma", [False, True], ids=["plain", "sigma"])
@pytest.mark.parametrize("mode", ["deltamu", "conditional"])
def test_enhance_batch_bf16_in_mode_matches_jax(serving_nets, mode, sigma):
    (_, dis_vars, dis), (_, ddpm_vars, ddpm) = serving_nets["dis"], serving_nets[mode]
    wav, rng = _wav(), jax.random.PRNGKey(21)
    want = np.asarray(_jax_enhance_bf16(dis_vars, ddpm_vars, jnp.asarray(wav), rng,
                                        sigma=sigma, mode=mode))
    x_T = jax.random.normal(jax.random.split(rng)[0], (2, LENGTH // 160 + 1, 161, 2),
                            jnp.bfloat16)
    cfg = tcfg.ExperimentConfig(diffusion=tcfg.DiffusionConfig(**MODES[mode]))
    enh = Enhancer(dis, ddpm, cfg, device="cpu", sigma=sigma, dtype=torch.bfloat16)
    got = enh.enhance_batch(wav, x_T=tb(x_T)[None]).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    assert err <= 2e-2, f"rel RMS {err:.3g}"


# ------------------------------------------------- config, trainer, CLI

_MODE_YAML = "diffusion:\n  pirorgrad: false\n  deltamu: {}\n"


@pytest.mark.parametrize("deltamu,mode", [(True, "deltamu"), (False, "conditional")])
def test_yaml_names_the_mode(tmp_path, deltamu, mode):
    path = tmp_path / "mode.yml"
    path.write_text(_MODE_YAML.format("true" if deltamu else "false"))
    diff = tcfg.load_experiment(str(path)).diffusion
    assert (diff.pirorgrad, diff.deltamu) == (False, deltamu)
    assert Enhancer(DiffUNet(), Nocon() if deltamu else DiffUNet1(),
                    tcfg.ExperimentConfig(diffusion=diff), device="cpu").mode == mode


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return synthetic.write_corpus_speechlike(root, n_train=4, n_test=2, min_len=6400,
                                             max_len=9600, seed=3)


@pytest.mark.parametrize("diff,net,cond", [
    (dict(pirorgrad=False, deltamu=True), Nocon, None),
    (dict(pirorgrad=False), DiffUNet1, 2),
    (dict(cond_noisy=True), DiffUNet1, 4),
], ids=["deltamu", "conditional", "cond_noisy"])
def test_the_mode_picks_the_denoiser(corpus, tmp_path, diff, net, cond):
    """The mode, not the config's name, picks the DDPM (JAX
    ``ddpm_trainer.py:156-160``); the conditional DDPM conditions on the
    2-channel noisy spectrum."""
    run = tcfg.RunConfig(assets=str(tmp_path), doc="t", data_root=corpus)
    exp = tcfg.ExperimentConfig(train=tcfg.TrainConfig(batch_size=2, chunk_length=2400),
                                diffusion=tcfg.DiffusionConfig(**diff))
    tr = ComplexDDPMTrainer(run, exp, device="cpu")
    assert type(tr.ddpm) is net and tr.enhancer.ddpm is tr.ddpm
    if cond is not None:
        assert tr.ddpm.preprocess.weight.shape[1] == 2 + cond


@pytest.mark.parametrize("mode", ["deltamu", "conditional"])
def test_cli_trains_then_generates_in_mode(corpus, tmp_path, root_logging, mode):
    """The mode comes from the yaml's ``diffusion:`` section, no flag."""
    conf = _small_conf(tmp_path)
    with open(conf, "a") as f:
        f.write("\n" + _MODE_YAML.format("true" if mode == "deltamu" else "false"))
    assets = tmp_path / "assets"
    args = ["--config", conf, "--joint", "--sigma", "--data-root", corpus,
            "--assets", str(assets), "--doc", "t", "--device", "cpu"]
    cli.main(args)
    best = torch.load(assets / "checkpoint" / "t" / "best.pt", weights_only=True)
    ddpm = best["state"]["ddpm"]
    assert "time_embedding.proj1.weight" in ddpm
    if mode == "deltamu":  # Nocon
        assert "preprocess.weight" not in ddpm
    else:  # DiffUNet1 on [x_t, feat / c]
        assert tuple(ddpm["preprocess.weight"].shape) == (2, 4, 1, 1)

    cli.main(args + ["--generate"])
    outs = sorted(glob.glob(str(assets / "wav" / "t" / "*.wav")))
    ins = sorted(glob.glob(f"{corpus}/noisy_testset_wav/*.wav"))
    assert [os.path.basename(p) for p in outs] == [os.path.basename(p) for p in ins]
    for i, o in zip(ins, outs):
        x, y = read_wav(i)[0], read_wav(o)[0]
        assert y.shape == x.shape and np.isfinite(y).all() and np.abs(y).max() > 0
