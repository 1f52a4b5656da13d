"""The port's serving path as a whole against the JAX chain (CPU).

Reference: the JAX functions of ``ComplexDDPMTrainer.enhance_batch``
(``training/ddpm_trainer.py``, its ``impl``) composed in the same order
and jitted — spec_features, DiffUNet, /c, sigma_mask, reverse_sample with
DiffUNet1, *c, decompress, istft — on the same converted weights (random
init, randomised BN statistics) and the same initial draw ``x_T``
(``jax.random.split(rng)[0]``, recomputed and handed to the port).  The
port's ``Enhancer`` runs every kernel's plain version here.  Bound:
max|diff| <= 2.5e-4 * max|ref|, the bar the JAX package meets against the
original PyTorch code (PARITY.md, system-level parity).
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.config import DiffusionConfig as JDiffusionConfig
from prior_diffuse_tpu.config import TrainConfig as JTrainConfig
from prior_diffuse_tpu.diffusion import inference_schedule, reverse_sample, sigma_mask
from prior_diffuse_tpu.signal.compress import decompress_spec
from prior_diffuse_tpu.signal.stft import istft
from prior_diffuse_tpu.training.base import spec_features
from prior_diffuse_tpu_torch.config import DiffusionConfig, ExperimentConfig, TrainConfig
from prior_diffuse_tpu_torch.serving.enhance import enhance_files, enhance_waveform
from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
from test_torch_models import make_pair

LENGTH = 2400


@pytest.fixture(scope="module")
def nets():
    return make_pair("DiffUNet", seed=3), make_pair("DiffUNet1", seed=4)


@partial(jax.jit, static_argnames=("sigma", "cond_noisy", "zero_init", "mode"))
def _jax_enhance(dis_vars, ddpm_vars, wav, rng, *, sigma, cond_noisy, zero_init=False,
                 mode="pirorgrad"):
    """``ComplexDDPMTrainer.enhance_batch``'s impl on explicit variables
    (f32, flax forwards, the default diffusion config but ``cond_noisy``,
    ``zero_init`` and the ``mode``: ``Nocon`` in deltamu, else
    ``DiffUNet1``)."""
    from prior_diffuse_tpu.models.diffunet import DiffUNet, DiffUNet1, Nocon

    cfg, diff = JTrainConfig(), JDiffusionConfig(cond_noisy=cond_noisy, zero_init=zero_init)
    c = diff.scale_c
    feat = spec_features(wav, cfg)
    x_init = DiffUNet().apply(dis_vars, feat, train=False)
    x_init = x_init / jnp.asarray(c, jnp.float32)
    sig = sigma_mask(x_init) if sigma else None
    sched = inference_schedule(diff)
    # ComplexDDPMTrainer._cond
    feat_sc = feat / jnp.asarray(c, jnp.float32)
    cond = (feat_sc if mode == "conditional" else
            jnp.concatenate([x_init, feat_sc], axis=-1) if cond_noisy else x_init)

    def model_fn(x, t):
        if mode == "deltamu":
            return Nocon(num_steps=diff.num_steps).apply(ddpm_vars, x, t, train=False)
        return DiffUNet1(num_steps=diff.num_steps).apply(
            ddpm_vars, x, cond, t, train=False)

    audio = reverse_sample(model_fn, rng, x_init, x_init.shape, sched,
                           mode, sig, dtype=jnp.float32,
                           n_avg=diff.n_avg, zero_init=diff.zero_init,
                           predict=diff.predict)
    spec = decompress_spec(audio.astype(jnp.float32) * c, cfg.feat_type)
    return istft(spec, length=wav.shape[-1], fft_num=cfg.fft_num,
                 win_size=cfg.win_size, win_shift=cfg.win_shift)


def _speechlike(n_rows, length, seed):
    g = np.random.default_rng(seed)
    t = np.arange(length) / 16000.0
    rows = [(np.sin(2 * np.pi * (150 + 50 * r) * t)
             * (0.5 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
             + 0.05 * g.standard_normal(length)) for r in range(n_rows)]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("sigma,cond_noisy", [(False, False), (True, False), (False, True)],
                         ids=["plain", "sigma", "cond_noisy"])
def test_enhance_batch_matches_jax_chain(nets, sigma, cond_noisy):
    (_, dis_vars, dis), (_, ddpm_vars, ddpm) = nets
    if cond_noisy:  # DiffUNet1 conditioned on [x_init, feat / c]
        _, ddpm_vars, ddpm = make_pair("DiffUNet1", seed=5, cond_channels=4)
    wav = _speechlike(2, LENGTH, 0)
    wav /= np.sqrt(np.mean(wav.astype(np.float64) ** 2, axis=1, keepdims=True)
                   ).astype(np.float32)
    rng = jax.random.PRNGKey(21)
    want = np.asarray(_jax_enhance(dis_vars, ddpm_vars, jnp.asarray(wav), rng,
                                   sigma=sigma, cond_noisy=cond_noisy))
    t_frames = LENGTH // 160 + 1
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0],
                                     (2, t_frames, 161, 2)))[None]
    cfg = ExperimentConfig(diffusion=DiffusionConfig(cond_noisy=cond_noisy))
    enh = Enhancer(dis, ddpm, cfg, device="cpu", sigma=sigma)
    got = enh.enhance_batch(wav, x_T=torch.from_numpy(x_T)).numpy()
    assert got.shape == want.shape == wav.shape
    assert np.isfinite(got).all()
    err, bound = np.abs(got - want).max(), 2.5e-4 * np.abs(want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def test_enhancer_repacks_after_a_weight_change(nets):
    """The packed encoder operands follow an in-place weight update: the
    next batch equals a fresh Enhancer's on the new weights."""
    dis, ddpm = (copy.deepcopy(net) for (_, _, net) in nets)
    wav = _speechlike(2, 1600, 1)
    enh = Enhancer(dis, ddpm, device="cpu")
    draw = lambda: torch.Generator().manual_seed(9)
    before = enh.enhance_batch(wav, draw())
    with torch.no_grad():
        dis.core.en.conv2.l.weight.mul_(1.5)
        ddpm.core.en.bn1.running_var.add_(0.5)
    after = enh.enhance_batch(wav, draw())
    fresh = Enhancer(dis, ddpm, device="cpu").enhance_batch(wav, draw())
    assert not torch.allclose(before, after)
    assert torch.equal(after, fresh)


class _Identity:
    """Enhancer stand-in whose enhancement is the identity: what comes back
    from ``enhance_files`` must then be the input, exactly de-normalised."""

    cfg = ExperimentConfig(train=TrainConfig(batch_size=2))

    def __init__(self):
        self.shapes = []

    def enhance_batch(self, batch, generator):
        self.shapes.append(batch.shape)
        return torch.from_numpy(batch)


def test_enhance_files_restores_lengths_and_scale():
    wavs = [_speechlike(1, n, n)[0] * s for n, s in
            [(1700, 0.3), (4000, 2.0), (2600, 0.01)]]
    ident = _Identity()
    outs = enhance_files(ident, wavs, None, bucket_samples=1600)
    assert ident.shapes == [(2, 3200), (1, 4800)]
    for w, o in zip(wavs, outs):
        assert o.shape == w.shape and o.dtype == np.float32
        np.testing.assert_allclose(o, w, rtol=1e-6, atol=1e-7 * np.abs(w).max())


def test_enhance_files_real_model(nets):
    """Mixed lengths through the real chain: lengths, finiteness, and the
    RMS normalisation undone (the result scales with the input)."""
    (_, _, dis), (_, _, ddpm) = nets
    enh = Enhancer(dis, ddpm, ExperimentConfig(train=TrainConfig(batch_size=2)),
                   device="cpu")
    wavs = [_speechlike(1, n, n)[0] for n in (1700, 4000, 2600)]
    outs = enhance_files(enh, wavs, torch.Generator().manual_seed(5),
                         bucket_samples=1600)
    assert [o.shape for o in outs] == [w.shape for w in wavs]
    assert all(np.isfinite(o).all() for o in outs)
    one = enhance_waveform(enh, wavs[1], torch.Generator().manual_seed(6))
    scaled = enhance_waveform(enh, 7.0 * wavs[1], torch.Generator().manual_seed(6))
    np.testing.assert_allclose(scaled, 7.0 * one, rtol=0,
                               atol=1e-4 * 7.0 * np.abs(one).max())


@pytest.mark.parametrize("cfg", [
    # what the JAX trainer refuses too: cond_noisy outside pirorgrad, and
    # predict="x0" in deltamu (no clean x0 target)
    ExperimentConfig(diffusion=DiffusionConfig(pirorgrad=False, cond_noisy=True)),
    ExperimentConfig(diffusion=DiffusionConfig(pirorgrad=False, deltamu=True,
                                               cond_noisy=True)),
    ExperimentConfig(diffusion=DiffusionConfig(pirorgrad=False, deltamu=True, predict="x0")),
    ExperimentConfig(diffusion=DiffusionConfig(predict="v")),
    ExperimentConfig(train=TrainConfig(fft_num=512, win_size=512, win_shift=256)),
], ids=["not-pirorgrad", "deltamu-cond_noisy", "deltamu-x0", "predict", "framing"])
def test_enhancer_rejects_what_it_does_not_serve(nets, cfg):
    (_, _, dis), (_, _, ddpm) = nets
    with pytest.raises(ValueError):
        Enhancer(dis, ddpm, cfg, device="cpu")


def test_enhance_batch_needs_a_generator(nets):
    """No global RNG: without a generator or ``x_T`` there is nothing to draw from."""
    (_, _, dis), (_, _, ddpm) = nets
    with pytest.raises(ValueError):
        Enhancer(dis, ddpm, device="cpu").enhance_batch(_speechlike(1, 800, 0))
