"""The port's ``prior_only_server`` and ``enhance_long`` against the JAX
package's (CPU), and the streaming properties of ``tests/test_serving.py``.

The JAX side is its own ``serving.enhance.prior_only_server`` and
``serving.streaming.enhance_long``, driven through a minimal stand-in for
its trainer (``cfg``, ``state``, ``put_batch``, ``_dis_apply``: the flax
``DiffUNet`` forward) on the same converted weights; the port's side an
``Enhancer`` on the CPU.  Both packages' prior-only servers compute one
function: the net's forward on the parameters and BN statistics cast to
the dtype.  Bounds: in f32 max|diff| <= 2.5e-4 max|ref| (the system-level
bar of ``test_torch_enhance.py``); in bf16 the prior's estimate within
2e-2 relative RMS.  The bf16 waveforms are held to 4e-2: the ISTFT of
these random nets' estimates cancels ~99 % of their energy in the
overlap-add (the estimate is mostly the biases, the same in every frame),
while it passes independent rounding differences at the rate of noise,
~50x more of their energy, so an estimate that agrees within 2.4e-3 gives
waveforms ~2.7e-2 apart (JAX's own bf16 and f32 waveforms sit 2.3e-2
apart).  The full chain is compared with ``DiffusionConfig(zero_init=True)``,
which draws nothing, so both packages compute one deterministic chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.config import TrainConfig as JTrainConfig
from prior_diffuse_tpu.models.diffunet import DiffUNet as JDiffUNet
from prior_diffuse_tpu.serving.enhance import enhance_files as j_enhance_files
from prior_diffuse_tpu.serving.enhance import prior_only_server as j_prior_only_server
from prior_diffuse_tpu.serving.streaming import enhance_long as j_enhance_long
from prior_diffuse_tpu_torch.config import DiffusionConfig, ExperimentConfig, TrainConfig
from prior_diffuse_tpu_torch.serving.enhance import enhance_files, prior_only_server
from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
from prior_diffuse_tpu_torch.serving.streaming import enhance_long
from test_torch_enhance import _jax_enhance, _speechlike
from test_torch_models import make_pair

torch.set_num_threads(2)

BATCH = 2
SEGMENT, OVERLAP = 8000, 1600
F32_MAX_REL = 2.5e-4
BF16_PRIOR_REL_RMS = 2e-2
BF16_WAVE_REL_RMS = 4e-2  # the ISTFT amplifies the rounding (module docstring)


class _JaxTrainer:
    """What ``prior_only_server`` and ``enhance_long`` read of a JAX
    trainer; with ``ddpm_vars`` its ``enhance_batch`` is the f32 chain of
    ``test_torch_enhance._jax_enhance`` (``zero_init``)."""

    def __init__(self, dis_vars, ddpm_vars=None):
        self.cfg = JTrainConfig(batch_size=BATCH)
        self.state = {"dis": dis_vars}
        self.ddpm_vars = ddpm_vars

    def _dis_apply(self, variables, feat, train):
        return JDiffUNet().apply(variables, feat, train=False), variables["batch_stats"]

    def put_batch(self, *arrays):
        return tuple(jnp.asarray(a) for a in arrays)

    def enhance_batch(self, wav, rng):
        return _jax_enhance(self.state["dis"], self.ddpm_vars, jnp.asarray(wav), rng,
                            sigma=False, cond_noisy=False, zero_init=True)


@pytest.fixture(scope="module")
def nets():
    return make_pair("DiffUNet", seed=3), make_pair("DiffUNet1", seed=4)


def _enhancer(nets, dtype=torch.float32, **diffusion):
    (_, _, dis), (_, _, ddpm) = nets
    cfg = ExperimentConfig(train=TrainConfig(batch_size=BATCH),
                           diffusion=DiffusionConfig(**diffusion))
    return Enhancer(dis, ddpm, cfg, device="cpu", dtype=dtype)


def _long_wav(n=20_000, seed=3):
    g = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    wav = np.sin(2 * np.pi * 220 * t) * (0.5 + 0.3 * np.sin(2 * np.pi * 1.7 * t))
    return (wav + 0.05 * g.standard_normal(n)).astype(np.float32)


def _rel_rms(a, b, mask=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if mask is not None:
        a, b = a[mask], b[mask]
    return np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b ** 2)), 1e-9)


def _check(got, want, dtype, bf16_bound=BF16_WAVE_REL_RMS):
    """The port against JAX at ``dtype``'s bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == torch.float32:
        err, bound = np.abs(got - want).max(), F32_MAX_REL * np.abs(want).max()
        assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"
        return
    err = _rel_rms(got, want)
    assert err <= bf16_bound, f"rel RMS {err:.3g}"


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16"])
def test_prior_only_server_matches_jax(nets, dtype, jdtype):
    (_, dis_vars, _), _ = nets
    wav = _speechlike(BATCH, 2400, 0)
    want = j_prior_only_server(_JaxTrainer(dis_vars), jdtype).enhance_batch(wav, None)
    server = prior_only_server(_enhancer(nets, dtype))
    assert server.dtype == dtype and server.cfg.train.batch_size == BATCH
    got = server.enhance_batch(wav)
    assert got.dtype == torch.float32
    _check(got.numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16"])
def test_prior_only_estimate_matches_jax(nets, dtype, jdtype):
    """The prior's estimate, before the ISTFT: JAX's ``_dis_apply`` on the
    variables cast as its server casts them."""
    (_, dis_vars, _), _ = nets
    feat = np.random.default_rng(2).standard_normal((BATCH, 15, 161, 2)).astype(np.float32)
    feat = np.asarray(torch.from_numpy(feat).to(dtype).float())  # the same values both sides
    variables = jax.tree.map(lambda p: p.astype(jdtype), dis_vars)
    want = np.asarray(_JaxTrainer(dis_vars)._dis_apply(
        variables, jnp.asarray(feat, jdtype), False)[0], np.float32)
    got = prior_only_server(_enhancer(nets, dtype)).prior(torch.from_numpy(feat))
    assert got.dtype == dtype
    _check(got.float().numpy(), want, dtype, BF16_PRIOR_REL_RMS)


def test_prior_only_server_takes_its_own_dtype(nets):
    """A bf16 prior-only server on an f32 enhancer runs a bf16 copy of
    the prior, BN statistics included, and leaves the enhancer's f32."""
    enh = _enhancer(nets)
    wav = _speechlike(1, 1600, 1)
    f32 = prior_only_server(enh).enhance_batch(wav)
    server = prior_only_server(enh, torch.bfloat16)
    bf16 = server.enhance_batch(wav)
    bn = server.net().core.tcm1.residual1.main_bn
    assert bn.running_var.dtype == bn.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in server.net().parameters())
    assert all(p.dtype == torch.float32 for p in enh.dis.parameters())
    assert server.net() is server.net() and not enh._packs  # cast once, no K3 operands
    rel = float(torch.sqrt(torch.mean((bf16 - f32) ** 2) / torch.mean(f32 ** 2)))
    assert 0 < rel < 0.05


def test_prior_only_server_recasts_on_a_weight_change(nets):
    """A weight updated in place reaches the bf16 copy, as JAX's server
    casts again for a new trainer state."""
    import copy

    (_, _, dis), (_, _, ddpm) = nets
    enh = Enhancer(copy.deepcopy(dis), ddpm, ExperimentConfig(), device="cpu")
    server = prior_only_server(enh, torch.bfloat16)
    wav = _speechlike(1, 1600, 3)
    before, net = server.enhance_batch(wav), server.net()
    with torch.no_grad():
        enh.dis.core.en.bn2.running_mean.add_(0.25)
    assert server.net() is not net
    after = server.enhance_batch(wav)
    assert not torch.equal(before, after)
    assert torch.equal(after, prior_only_server(enh, torch.bfloat16).enhance_batch(wav))


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16"])
def test_enhance_long_prior_only_matches_jax(nets, dtype, jdtype):
    """20,000 samples in segments of 8,000 overlapping by 1,600: three
    segments, batched 2 + 1."""
    (_, dis_vars, _), _ = nets
    wav = _long_wav()
    run = lambda jdt: j_enhance_long(j_prior_only_server(_JaxTrainer(dis_vars), jdt), wav,
                                     jax.random.PRNGKey(0), segment=SEGMENT, overlap=OVERLAP)
    got = enhance_long(prior_only_server(_enhancer(nets, dtype)), wav, None,
                       segment=SEGMENT, overlap=OVERLAP)
    assert got.dtype == np.float32
    _check(got, run(jdtype), dtype)


def test_enhance_long_full_chain_matches_jax(nets):
    """The full chain with ``zero_init`` (deterministic in both packages)."""
    (_, dis_vars, _), (_, ddpm_vars, _) = nets
    wav = _long_wav(17_000, 4)
    want = j_enhance_long(_JaxTrainer(dis_vars, ddpm_vars), wav, jax.random.PRNGKey(0),
                          segment=SEGMENT, overlap=OVERLAP)
    got = enhance_long(_enhancer(nets, zero_init=True), wav, None,
                       segment=SEGMENT, overlap=OVERLAP)
    _check(got, want, torch.float32)


# ------------------------------------------- properties (tests/test_serving.py)

class _Identity:
    """A server whose enhancement is the identity."""

    cfg = ExperimentConfig(train=TrainConfig(batch_size=4))

    def __init__(self):
        self.rows = []

    def enhance_batch(self, batch, generator):
        self.rows.append(batch.shape[0])
        return torch.from_numpy(batch)


def test_streaming_identity_reconstruction():
    """Complementary ramps: a perfect enhancer gives the input back."""
    wav = np.random.default_rng(1).standard_normal(130_000).astype(np.float32) * 0.2
    ident = _Identity()
    out = enhance_long(ident, wav, None, segment=48000, overlap=4800)
    assert out.shape == wav.shape
    np.testing.assert_allclose(out, wav, atol=2e-6)
    assert ident.rows == [3]  # three segments, one block of batch_size 4


def test_streaming_short_file_passthrough():
    wav = np.random.default_rng(2).standard_normal(10_000).astype(np.float32) * 0.2
    out = enhance_long(_Identity(), wav, None)
    assert out.shape == wav.shape
    np.testing.assert_allclose(out, wav, atol=1e-5)  # RMS scale round trip


def test_streaming_rejects_bad_overlap():
    for overlap in (0, 48000):
        with pytest.raises(ValueError):
            enhance_long(_Identity(), np.zeros(100_000, np.float32), None, overlap=overlap)


def _away_from_seams(n, hop):
    mid = np.ones(n, bool)
    for s in range(hop, n, hop):
        mid[max(s - OVERLAP, 0): s + OVERLAP] = False
    return mid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_streaming_prior_only_tracks_whole_file(nets, dtype):
    """The deterministic prior: streaming equals whole-file enhancement
    away from the seams, and is close overall (edge context only)."""
    server = prior_only_server(_enhancer(nets, dtype))
    wav = _long_wav(40_000, 5)
    stream = enhance_long(server, wav, None, segment=SEGMENT, overlap=OVERLAP)
    whole = enhance_files(server, [wav], None)[0]
    mid = _away_from_seams(len(wav), SEGMENT - OVERLAP)
    assert _rel_rms(stream, whole, mid) < (1e-3 if dtype == torch.float32 else 2e-2)
    assert _rel_rms(stream, whole) < 0.05


def test_streaming_full_chain_is_seam_free(nets):
    """The bf16 chain draws its own x_T per segment (one generator across
    the blocks): the output is finite, and the jumps inside the
    crossfades are no larger than the signal's own."""
    enh = _enhancer(nets, torch.bfloat16)
    wav = _long_wav(40_000, 6)
    gen = torch.Generator().manual_seed(5)
    stream = enhance_long(enh, wav, gen, segment=SEGMENT, overlap=OVERLAP)
    assert stream.shape == wav.shape and np.isfinite(stream).all()
    hop = SEGMENT - OVERLAP
    jumps = np.abs(np.diff(stream))
    seam = np.zeros(len(jumps), bool)
    for s in range(hop, len(wav) - 1, hop):
        seam[max(s - OVERLAP, 0): s + 1] = True
    assert jumps[seam].max() <= 4.0 * jumps[~seam].max()
    again = enhance_long(enh, wav, torch.Generator().manual_seed(5), segment=SEGMENT,
                         overlap=OVERLAP)
    np.testing.assert_array_equal(stream, again)  # the generator is the only source


def test_jax_and_port_whole_file_prior_agree(nets):
    """``enhance_files`` of both packages on the prior-only servers (f32)."""
    (_, dis_vars, _), _ = nets
    wav = _long_wav(7_000, 7)
    want = j_enhance_files(j_prior_only_server(_JaxTrainer(dis_vars)), [wav],
                           jax.random.PRNGKey(0))[0]
    got = enhance_files(prior_only_server(_enhancer(nets)), [wav], None)[0]
    _check(got, want, torch.float32)
