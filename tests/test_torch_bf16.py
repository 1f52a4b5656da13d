"""The port's bfloat16 serving path against the JAX package's (CPU).

Module by module and as a whole, on the same inputs (made with numpy, or
JAX's own bf16 draws handed over), the JAX side as its serving path runs
it on the CPU (Pallas in interpret mode):

* the reverse chain in bf16 over ``tests/test_sampler_dtypes.py``'s matrix
  (predict eps/x0, fast-2/3/6/8 and full-50, sigma on/off): max|diff| <=
  2^-6 max|ref|;
* ``TimeEmbedding`` of a bf16 ``t``;
* the plain K3-bf16 chain against ``_chain_pallas(dtype=bf16,
  interpret=True)`` on the same stage input and operands, at all five
  stages of both encoders, and the whole stage (conv1 and the time
  projection included, K3-bf16's contract) against ``fused_enc_stage(dtype=
  bf16)`` on JAX's own packing, through XLA and through the Pallas kernel
  in interpret mode: max|diff| <= 2^-7 max|ref|,
  one bf16 step at the top of the range; and a negative control: a chain
  that rounds ``y`` to bf16 before the cross gate misses that bound on a
  stage whose gate halves cancel;
* the dual decoder in f32 (<= 1e-4 relative L2 against JAX and against
  the port's two ``Decoder`` modules) and bf16;
* ``fused_unet_forward`` in bf16 (dual decoder) for both nets: <= 2e-2
  relative L2 (JAX holds its own bf16 forward to f32 at 5e-2);
* ``Enhancer(dtype=bfloat16).enhance_batch`` against the JAX ``impl`` at
  ``serve_dtype=bf16`` and route ``dual``, plain and ``--sigma``: relative
  RMS <= 2e-2.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.config import DiffusionConfig as JDiffusionConfig
from prior_diffuse_tpu.config import TrainConfig as JTrainConfig
from prior_diffuse_tpu.diffusion import inference_schedule as j_inference_schedule
from prior_diffuse_tpu.diffusion import reverse_sample as j_reverse_sample
from prior_diffuse_tpu.diffusion import sigma_mask as j_sigma_mask
from prior_diffuse_tpu.models import fused_forward as jff
from prior_diffuse_tpu.models import layers as jlayers
from prior_diffuse_tpu.ops.pallas import convblock_kernel as jcb
from prior_diffuse_tpu.signal.compress import decompress_spec as j_decompress_spec
from prior_diffuse_tpu.signal.stft import istft as j_istft
from prior_diffuse_tpu.training.base import spec_features as j_spec_features
from prior_diffuse_tpu_torch.config import DiffusionConfig
from prior_diffuse_tpu_torch.diffusion.sampler import reverse_sample
from prior_diffuse_tpu_torch.diffusion.schedule import inference_schedule
from prior_diffuse_tpu_torch.models import fused_forward as ff
from prior_diffuse_tpu_torch.ops.cuda import convblock as cb
from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
from test_torch_enhance import _speechlike
from test_torch_models import make_pair

torch.set_num_threads(2)

BF16 = jnp.bfloat16
KERNEL_REL = 2.0 ** -7  # one bf16 step at the top of the range
SAMPLER_REL = 2.0 ** -6
FORWARD_REL_L2 = 2e-2
PATH_REL_RMS = 2e-2


def tb(a) -> torch.Tensor:
    """A numpy / JAX array (bf16 values allowed) as a torch bf16 tensor."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def f32(a) -> np.ndarray:
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _max_rel(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l2(got, want):
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- (a) sampler

SHAPE = (2, 6, 8, 2)
SCHEDULES = {  # tests/test_sampler_dtypes.py
    "fast-2": [1e-2, 0.5],
    "fast-3": [1e-3, 0.05, 0.5],
    "fast-6": None,
    "fast-8": [1e-4, 5e-4, 2e-3, 8e-3, 0.03, 0.1, 0.25, 0.5],
    "full-50": "full",
}


def _schedules(name):
    spec = SCHEDULES[name]
    cfgs = JDiffusionConfig(), DiffusionConfig()
    if spec == "full":
        return (j_inference_schedule(cfgs[0], fast_sampling=False),
                inference_schedule(cfgs[1], fast_sampling=False))
    if spec is not None:
        cfgs = [dataclasses.replace(c, inference_noise_schedule=spec) for c in cfgs]
    return j_inference_schedule(cfgs[0]), inference_schedule(cfgs[1])


@pytest.mark.parametrize("sigma", [False, True], ids=["nosig", "sig"])
@pytest.mark.parametrize("sched_name", sorted(SCHEDULES))
@pytest.mark.parametrize("predict", ["eps", "x0"])
def test_sampler_bf16_matches_jax(predict, sched_name, sigma):
    """The chain of ``test_sampler_dtypes.py::_chain`` in bf16 (affine
    model, JAX's bf16 initial draw handed over)."""
    sched_j, sched = _schedules(sched_name)
    key = jax.random.PRNGKey(7)
    x_init = (0.3 * jax.random.normal(key, SHAPE)).astype(BF16)
    sig = jnp.full(SHAPE, 0.8, BF16) if sigma else None
    m = 0.2 * jax.random.normal(jax.random.fold_in(key, 1), SHAPE)
    m_t = torch.from_numpy(np.asarray(m))
    if predict == "x0":
        j_model = lambda x, t: m.astype(x.dtype)
        t_model = lambda x, t: m_t.to(x.dtype)
    else:  # 0.1 * x rounds to bf16, then the f32 m is subtracted and the sum rounded
        j_model = lambda x, t: (0.1 * x - m).astype(x.dtype)
        t_model = lambda x, t: ((0.1 * x).float() - m_t).to(x.dtype)
    rng = jax.random.fold_in(key, 2)
    want = j_reverse_sample(j_model, rng, x_init, SHAPE, sched_j, "pirorgrad",
                            sig_mask=sig, dtype=BF16, predict=predict)
    x_T = jax.random.normal(jax.random.split(rng)[0], SHAPE, BF16)
    got = reverse_sample(t_model, tb(x_init), tb(x_T)[None], sched,
                         sig_mask=None if sig is None else tb(sig), predict=predict)
    assert got.dtype == torch.bfloat16
    err = _max_rel(got, want)
    assert err <= SAMPLER_REL, f"max|diff| {err:.3g} x max|ref| > {SAMPLER_REL:.3g}"


def test_sampler_feeds_the_bf16_t():
    """In bf16 the fast-6 T values reach the model rounded to bf16 (a
    spacing of 0.25 between 32 and 64), as JAX feeds them."""
    _, sched = _schedules("fast-6")
    seen = []
    x = torch.zeros(SHAPE, dtype=torch.bfloat16)
    reverse_sample(lambda x, t: seen.append(t) or x, x, x[None], sched)
    want = np.asarray(jnp.asarray(sched.T, BF16), np.float32)[::-1]
    got = np.asarray([float(t[0]) for t in seen], np.float32)
    assert all(t.dtype == torch.bfloat16 for t in seen)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.asarray(sched.T, np.float32)[::-1])


def test_sampler_refuses_mixed_dtypes():
    _, sched = _schedules("fast-6")
    x = torch.zeros(SHAPE, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        reverse_sample(lambda x, t: x, x, x.float()[None], sched)


# ------------------------------------------------------- (b) time embedding

def test_time_embedding_of_a_bf16_t_matches_flax():
    _, variables, tm = make_pair("DiffUNet1", seed=2)
    te_vars = {"params": variables["params"]["time_embedding"]}
    _, sched = _schedules("fast-6")
    t = np.concatenate([sched.T, [0.0, 3.7, 21.0, 48.93]]).astype(np.float32)
    want = jlayers.TimeEmbedding(50).apply(te_vars, jnp.asarray(t, BF16))
    with torch.no_grad():
        got = tm.time_embedding(tb(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


# ------------------------------------------------------- (c) K3 in bf16

T_STAGE = 8


def _chain_pallas_bf16(xin, ops, bias_b, pad):
    """``_chain_pallas(dtype=bf16, interpret=True)`` on the im2col of the
    port's stage input, with the port's operands (their bf16 values)."""
    x = jnp.asarray(f32(xin), BF16)
    xp = jnp.pad(x, ((0, 0), (pad, 0), (0, 0), (0, 0)))
    k = ops["kernel_f"]
    b, t = xp.shape[0], xp.shape[1] - 1
    fo = (xp.shape[2] - k) // 2 + 1
    col = jcb._im2col(xp, k, fo).reshape(b, t * fo, -1)
    j = lambda name: jnp.asarray(f32(ops[name]))
    out = jcb._chain_pallas(col, j("wmain"), jnp.asarray(f32(bias_b))[:, None, :], j("wg"),
                            j("bg"), j("w2"), j("b2"), j("alpha").reshape(()),
                            tile_r=128, dtype=BF16, interpret=True)
    return out.reshape(b, t, fo, -1)


@pytest.fixture(scope="module", params=["DiffUNet", "DiffUNet1"])
def encoder_stages(request):
    """Per stage: the port's bf16 stage inputs ``(xin, bias_b, pad)``,
    operands, JAX's stage input, packing and ``tproj``, along the port's
    bf16 chain (so both sides see one input at every stage)."""
    name = request.param
    _, variables, tm = make_pair(name, seed=6)
    rng = np.random.default_rng(3)
    x = tb(rng.standard_normal((2, T_STAGE, 161, 2)))
    temb = None
    if name == "DiffUNet1":
        temb = tb(rng.standard_normal((2, 512)))
    en_p, en_s = variables["params"]["core"]["en"], variables["batch_stats"]["core"]["en"]
    jpacked = jcb.pack_encoder(en_p, en_s)
    stages = []
    with torch.no_grad():
        for (ops, tp), (jops, jtp) in zip(cb.pack_encoder(tm.core.en, torch.bfloat16), jpacked):
            xin, bias_b, pad = cb.stage_inputs(x, ops, tp, temb)
            jtproj = None if jtp is None else (
                jnp.dot(jnp.asarray(f32(temb), BF16), jtp[0].astype(BF16)) + jtp[1])
            stages.append((xin, bias_b, pad, ops, tp, x, jops, jtproj))
            x = cb.enc_stage_plain(xin, ops, bias_b, pad)
    return name, temb, stages


@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
def test_k3_bf16_plain_matches_chain_pallas(encoder_stages, stage):
    _, _, stages = encoder_stages
    xin, bias_b, pad, ops, *_ = stages[stage]
    assert xin.dtype == torch.bfloat16 and ops["wmain"].dtype == torch.bfloat16
    got = cb.enc_stage_plain(xin, ops, bias_b, pad)
    assert got.dtype == torch.bfloat16
    err = _max_rel(got, _chain_pallas_bf16(xin, ops, bias_b, pad))
    assert err <= KERNEL_REL, f"max|diff| {err:.3g} x max|ref| > 2^-7"


@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
def test_k3_bf16_stage_matches_fused_enc_stage(encoder_stages, stage):
    """The whole stage on the port's packing (conv1, the time projection,
    the chain) against ``fused_enc_stage`` on JAX's packing, in bf16."""
    _, temb, stages = encoder_stages
    _, _, _, ops, tp, x, jops, jtproj = stages[stage]
    want = jcb.fused_enc_stage(jnp.asarray(f32(x), BF16), jops, jtproj,
                               kernel_f=cb.ENC_KERNELS[stage], dtype=BF16,
                               use_pallas=False)
    with torch.no_grad():
        got, _ = cb.encoder_fused(x, [(ops, tp)], temb)
    err = _max_rel(got, want)
    assert err <= KERNEL_REL, f"max|diff| {err:.3g} x max|ref| > 2^-7"


def _cancelling_stage(c, kf, seed):
    """A bf16 stage whose left and right window halves carry biases of
    +48 and -48 and whose gates are constant (wg = 0, bg = 0): y is large,
    the cross gate y_l / 2 + y_r / 2 is small.  Inputs and weights lie on
    coarse binary grids, so every product and sum up to the gates is exact
    in f32 whatever the summation order."""
    g = np.random.default_rng(seed)
    k = 2 * kf * c
    ops = {"kernel_f": kf, "pre": None, "wcsum": None,
           "wmain": tb(g.integers(-4, 5, (k, 64)) / 16.0),
           "wg": torch.zeros(64, 64, dtype=torch.bfloat16), "bg": torch.zeros(64),
           "w2": tb(g.integers(-8, 9, (32, 64)) / 16.0),
           "b2": torch.zeros(64), "alpha": torch.tensor([0.25])}
    x = tb(g.integers(-8, 9, (2, 5, 161 if c == 2 else 39, c)) / 8.0)
    bias_b = torch.cat([torch.full((2, 32), 48.0), torch.full((2, 32), -48.0)], dim=1)
    return x, ops, bias_b


def _plain_y_in_bf16(x, ops, bias_b, pad):
    """``enc_stage_plain`` with ``y`` rounded to bf16 before the cross gate:
    a kernel that keeps y in bf16 throughout computes this."""
    k = ops["kernel_f"]
    b, t, fo = cb._out_shape(x, k, pad)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, pad, 0))
    col = torch.cat([xp[:, kt:kt + t, kf:kf + 2 * (fo - 1) + 1:2, :]
                     for kt in range(2) for kf in range(k)], dim=-1)
    y = torch.matmul(col.float(), ops["wmain"].float()) + bias_b[:, None, None, :]
    y = y.to(torch.bfloat16).float()
    m = torch.matmul(y, ops["wg"].float()) + ops["bg"]
    comb = y[..., :32] * torch.sigmoid(m[..., 32:]) + y[..., 32:] * torch.sigmoid(m[..., :32])
    y2 = torch.matmul(comb.to(torch.bfloat16).float(), ops["w2"].float()) + ops["b2"]
    return torch.where(y2 >= 0, y2, ops["alpha"] * y2).to(torch.bfloat16)


@pytest.mark.parametrize("geometry", [(2, 5, 1), (32, 3, 0)], ids=["C2", "C32"])
def test_k3_bf16_keeps_y_f32_for_the_gate(geometry):
    """On a stage whose gate halves cancel, the plain K3-bf16 meets the
    2^-7 bound against ``_chain_pallas``; the negative control (y in bf16
    before the combine) misses it."""
    c, kf, pad = geometry
    x, ops, bias_b = _cancelling_stage(c, kf, 4 + c)
    want = _chain_pallas_bf16(x, ops, bias_b, pad)
    err = _max_rel(cb.enc_stage_plain(x, ops, bias_b, pad), want)
    assert err <= KERNEL_REL, f"max|diff| {err:.3g} x max|ref| > 2^-7"
    err_bf16_y = _max_rel(_plain_y_in_bf16(x, ops, bias_b, pad), want)
    assert err_bf16_y > 4 * KERNEL_REL, f"the y-in-bf16 chain passes ({err_bf16_y:.3g})"


def test_k3_bf16_wrapper_takes_plain_path_on_cpu(encoder_stages):
    _, temb, stages = encoder_stages
    ops, tp, x = stages[1][3:6]
    bias_b, bias1 = cb.stage_biases(x, ops, tp, temb)
    before = (cb.enc_stage.launches, cb.enc_stage_bf16.launches)
    got = cb.enc_stage_bf16(x, ops, bias_b, bias1)
    assert torch.equal(got, cb.enc_stage_bf16_plain(x, ops, bias_b, bias1))
    assert (cb.enc_stage.launches, cb.enc_stage_bf16.launches) == before
    with pytest.raises(ValueError):
        cb.pack_encoder(make_pair("DiffUNet")[2].core.en, torch.float16)


@pytest.mark.parametrize("stage", range(1, 5), ids=[f"stage{i + 1}" for i in range(1, 5)])
def test_k3_bf16_plain_is_stage_inputs_and_chain(encoder_stages, stage):
    """K3-bf16's plain version on the 64-channel stage input (conv1 and its
    pad frame inside) equals ``stage_inputs`` + ``enc_stage_plain`` bit for
    bit, with (DiffUNet1) and without (DiffUNet) a time projection."""
    _, temb, stages = encoder_stages
    ops, tp, x = stages[stage][3:6]
    assert x.shape[-1] == 64 and ops["pre"] is not None
    bias_b, bias1 = cb.stage_biases(x, ops, tp, temb)
    assert bias1.dtype == torch.float32 and bias1.shape == (2, 32)
    got = cb.enc_stage_bf16_plain(x, ops, bias_b, bias1)
    assert torch.equal(got, cb.enc_stage_plain(*stage_inputs_chain(x, ops, tp, temb)))


def stage_inputs_chain(x, ops, tp, temb):
    xin, bias_b, pad = cb.stage_inputs(x, ops, tp, temb)
    return xin, ops, bias_b, pad


@pytest.mark.parametrize("stage", range(5), ids=[f"stage{i + 1}" for i in range(5)])
def test_k3_bf16_stage_matches_pallas_interpret(encoder_stages, stage):
    """The whole K3-bf16 stage (``enc_stage_bf16`` on the CPU: its plain
    version) on the port's packing against ``fused_enc_stage(dtype=bf16,
    use_pallas=True, interpret=True)`` on JAX's, at B = 2, T = 8."""
    _, temb, stages = encoder_stages
    ops, tp, x, jops, jtproj = stages[stage][3:8]
    want = jcb.fused_enc_stage(jnp.asarray(f32(x), BF16), jops, jtproj,
                               kernel_f=cb.ENC_KERNELS[stage], dtype=BF16, tile_r=128,
                               use_pallas=True, interpret=True)
    with torch.no_grad():
        got = cb.enc_stage_bf16(x, ops, *cb.stage_biases(x, ops, tp, temb))
    err = _max_rel(got, want)
    assert err <= KERNEL_REL, f"max|diff| {err:.3g} x max|ref| > 2^-7"


# --------------------------------------------------- (d) the dual decoder

T_NET = 11
DEC_F = (79, 39, 19, 9, 4)  # the encoder's stage widths


def _decoder_inputs(dtype, seed):
    g = np.random.default_rng(seed)
    x = g.standard_normal((2, T_NET, 4, 64)).astype(np.float32)
    skips = [g.standard_normal((2, T_NET, f, 64)).astype(np.float32) for f in DEC_F]
    temb = g.standard_normal((2, 512)).astype(np.float32)
    if dtype == torch.bfloat16:  # both sides take the same bf16 values
        x, temb = f32(tb(x)), f32(tb(temb))
        skips = [f32(tb(s)) for s in skips]
    return x, skips, temb


@pytest.mark.parametrize("name", ["DiffUNet", "DiffUNet1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dual_decoder_matches_jax(name, dtype):
    _, variables, tm = make_pair(name, seed=8)
    x, skips, temb = _decoder_inputs(dtype, 1)
    temb = temb if name == "DiffUNet1" else None
    jdt = jnp.float32 if dtype == torch.float32 else BF16
    stages = jff.pack_dual_decoder(variables["params"]["core"], variables["batch_stats"]["core"])
    want = jff.dual_decoder_forward(
        stages, jnp.asarray(x, jdt), [jnp.asarray(s, jdt) for s in skips],
        None if temb is None else jnp.asarray(temb, jdt), dtype=jdt)
    to = lambda a: torch.from_numpy(a).to(dtype)
    with torch.no_grad():
        got = ff.dual_decoder_forward(ff.pack_dual_decoder(tm.core, dtype), to(x),
                                      [to(s) for s in skips], None if temb is None else to(temb))
    assert got.dtype == dtype and got.shape == (2, T_NET, 161, 2)
    err = _rel_l2(got, want)
    assert err <= (1e-4 if dtype == torch.float32 else FORWARD_REL_L2), f"rel L2 {err:.3g}"


@pytest.mark.parametrize("name", ["DiffUNet", "DiffUNet1"])
def test_dual_decoder_matches_two_decoders(name):
    """In f32 the dual chain is the two ``Decoder`` modules side by side."""
    _, _, tm = make_pair(name, seed=9)
    x, skips, temb = _decoder_inputs(torch.float32, 2)
    temb = torch.from_numpy(temb) if name == "DiffUNet1" else None
    x, skips = torch.from_numpy(x), [torch.from_numpy(s) for s in skips]
    with torch.no_grad():
        got = ff.dual_decoder_forward(ff.pack_dual_decoder(tm.core), x, skips, temb)
        xn, sn = x.permute(0, 3, 1, 2), [s.permute(0, 3, 1, 2) for s in skips]
        want = torch.cat([tm.core.de_real(xn, sn, temb), tm.core.de_imag(xn, sn, temb)],
                         dim=1).permute(0, 2, 3, 1)
    err = _rel_l2(got, want)
    assert err <= 1e-4, f"rel L2 {err:.3g}"


# --------------------------------------------------- (e) the whole forward

def _net_inputs(name, seed):
    g = np.random.default_rng(seed)
    x = f32(tb(g.standard_normal((2, T_NET, 161, 2))))
    if name == "DiffUNet":
        return x, None, None
    xi = f32(tb(g.standard_normal((2, T_NET, 161, 2))))
    return x, xi, np.asarray([35.75, 7.5], np.float32)  # bf16 values of t


@pytest.mark.parametrize("name", ["DiffUNet", "DiffUNet1"])
def test_fused_unet_forward_bf16_matches_jax(name):
    _, variables, tm = make_pair(name, seed=10)
    x, xi, t = _net_inputs(name, 3)
    jargs = [jnp.asarray(x, BF16)] + ([] if xi is None else [jnp.asarray(xi, BF16),
                                                            jnp.asarray(t, BF16)])
    want = jff.fused_unet_forward(jff.pack_unet(variables), *jargs, dtype=BF16,
                                  use_pallas=True, dual_decoder=True, interpret=True)
    packed = ff.pack_unet(tm, torch.bfloat16, dual_decoder=True)
    targs = [tb(x)] + ([] if xi is None else [tb(xi), tb(t)])
    with torch.no_grad():
        got = ff.fused_unet_forward(packed, *targs)
    assert got.dtype == torch.bfloat16
    err = _rel_l2(got, want)
    assert err <= FORWARD_REL_L2, f"rel L2 {err:.3g}"


@pytest.mark.parametrize("name", ["DiffUNet", "DiffUNet1"])
def test_fused_unet_forward_bf16_two_decoders_matches_jax(name):
    """bf16 with the two ``Decoder`` modules (``dual_decoder=False``)
    against JAX's flax ``Decoder(dtype=bf16)`` route."""
    _, variables, tm = make_pair(name, seed=11)
    x, xi, t = _net_inputs(name, 4)
    jargs = [jnp.asarray(x, BF16)] + ([] if xi is None else [jnp.asarray(xi, BF16),
                                                            jnp.asarray(t, BF16)])
    want = jff.fused_unet_forward(jff.pack_unet(variables), *jargs, dtype=BF16,
                                  use_pallas=False, dual_decoder=False)
    targs = [tb(x)] + ([] if xi is None else [tb(xi), tb(t)])
    with torch.no_grad():
        got = ff.fused_unet_forward(ff.pack_unet(tm, torch.bfloat16), *targs)
    err = _rel_l2(got, want)
    assert err <= FORWARD_REL_L2, f"rel L2 {err:.3g}"


@pytest.mark.parametrize("dual", [False, True], ids=["two_decoders", "dual"])
def test_fused_unet_forward_f32_is_the_module_forward(dual):
    """In f32 the fused forward is the net's conv-by-conv forward (the
    encoder as products, the preprocess as a product, sums in another
    order)."""
    _, _, tm = make_pair("DiffUNet1", seed=12)
    x, xi, t = (torch.from_numpy(a) for a in _net_inputs("DiffUNet1", 5))
    with torch.no_grad():
        got = ff.fused_unet_forward(ff.pack_unet(tm, dual_decoder=dual), x, xi, t)
        want = tm(x, xi, t)
    err = _rel_l2(got, want)
    assert err <= 1e-5, f"rel L2 {err:.3g}"


def test_fused_unet_forward_is_inference_only():
    _, _, tm = make_pair("DiffUNet", seed=12)
    x = torch.zeros(1, 4, 161, 2)
    packed = ff.pack_unet(tm)
    tm.train()
    with pytest.raises(ValueError):
        ff.fused_unet_forward(packed, x)


# --------------------------------------------------- (f) the serving batch

LENGTH = 2400


@partial(jax.jit, static_argnames=("sigma", "mode"))
def _jax_enhance_bf16(dis_vars, ddpm_vars, wav, rng, *, sigma, mode="pirorgrad"):
    """``ComplexDDPMTrainer.enhance_batch``'s ``impl`` at ``serve_dtype =
    bfloat16`` and route ``dual`` (``_resolve_fused("", bf16)``) on
    explicit variables, in ``mode`` (``ddpm_vars`` a ``Nocon``'s in
    deltamu): the JAX package's bf16 serving path."""
    cfg, diff = JTrainConfig(), JDiffusionConfig()
    dt, c = BF16, diff.scale_c
    feat = j_spec_features(wav, cfg)
    packed = {"dis": jff.pack_unet(dis_vars), "ddpm": jff.pack_unet(ddpm_vars)}
    fused = partial(jff.fused_unet_forward, dtype=dt, use_pallas=False,
                    dual_decoder=True, dual_split=False, interpret=True)
    x_init = fused(packed["dis"], feat.astype(dt))
    x_init = x_init.astype(dt) / jnp.asarray(c, dt)
    sig = j_sigma_mask(x_init) if sigma else None
    # _cond; the deltamu forward takes no conditioner
    cond = {"pirorgrad": x_init, "deltamu": None,
            "conditional": feat.astype(dt) / jnp.asarray(c, dt)}[mode]

    def model_fn(x, t):
        return fused(packed["ddpm"], x.astype(dt), cond, t.astype(dt),
                     num_steps=diff.num_steps).astype(dt)

    audio = j_reverse_sample(model_fn, rng, x_init, x_init.shape, j_inference_schedule(diff),
                             mode, sig, dtype=dt, n_avg=diff.n_avg,
                             zero_init=diff.zero_init, predict=diff.predict)
    spec = j_decompress_spec(audio.astype(jnp.float32) * c, cfg.feat_type)
    return j_istft(spec, length=wav.shape[-1], fft_num=cfg.fft_num, win_size=cfg.win_size,
                   win_shift=cfg.win_shift)


@pytest.fixture(scope="module")
def serving_nets():
    return make_pair("DiffUNet", seed=3), make_pair("DiffUNet1", seed=4)


@pytest.mark.parametrize("sigma", [False, True], ids=["plain", "sigma"])
def test_enhance_batch_bf16_matches_jax(serving_nets, sigma):
    (_, dis_vars, dis), (_, ddpm_vars, ddpm) = serving_nets
    wav = _speechlike(2, LENGTH, 0)
    wav /= np.sqrt(np.mean(wav.astype(np.float64) ** 2, axis=1, keepdims=True)
                   ).astype(np.float32)
    rng = jax.random.PRNGKey(21)
    want = np.asarray(_jax_enhance_bf16(dis_vars, ddpm_vars, jnp.asarray(wav), rng,
                                        sigma=sigma))
    x_T = jax.random.normal(jax.random.split(rng)[0], (2, LENGTH // 160 + 1, 161, 2), BF16)
    enh = Enhancer(dis, ddpm, device="cpu", sigma=sigma, dtype=torch.bfloat16)
    assert enh.packs()[0]["dual"] is not None  # the bf16 route: the dual decoder
    got = enh.enhance_batch(wav, x_T=tb(x_T)[None])
    assert got.dtype == torch.float32 and got.shape == wav.shape
    err = np.sqrt(np.mean((f32(got) - want) ** 2) / np.mean(want ** 2))
    assert np.isfinite(f32(got)).all() and err <= PATH_REL_RMS, f"rel RMS {err:.3g}"


def test_enhance_batch_bf16_is_not_the_f32_batch(serving_nets):
    """On one x_T the bf16 batch sits between a floor and a ceiling of
    the f32 batch (``chip_smoke.py``'s bounds): a path that quietly stayed
    in f32 falls under the floor."""
    (_, _, dis), (_, _, ddpm) = serving_nets
    wav = _speechlike(2, LENGTH, 4)
    x_T = torch.randn((1, 2, LENGTH // 160 + 1, 161, 2), generator=torch.Generator().manual_seed(6))
    got = {dt: Enhancer(dis, ddpm, device="cpu", dtype=dt).enhance_batch(wav, x_T=x_T)
           for dt in (torch.float32, torch.bfloat16)}
    err = float(torch.sqrt(torch.mean((got[torch.bfloat16] - got[torch.float32]) ** 2)
                           / torch.mean(got[torch.float32] ** 2)))
    assert 1e-3 < err <= 3e-2, f"bf16 vs f32 rel RMS {err:.3g}"


def test_enhancer_bf16_draws_and_repacks(serving_nets):
    """The bf16 chain draws its x_T in bf16 from the generator, and a
    weight change repacks the operands (bf16 here, f32 for an f32
    enhancer)."""
    import copy

    (_, _, dis), (_, _, ddpm) = serving_nets
    dis, ddpm = copy.deepcopy(dis), copy.deepcopy(ddpm)
    enh = Enhancer(dis, ddpm, device="cpu", dtype=torch.bfloat16)
    wav = _speechlike(1, 1600, 2)
    draw = lambda: torch.Generator().manual_seed(3)
    out = enh.enhance_batch(wav, draw())
    x_T = torch.randn((1, 1, 11, 161, 2), generator=draw(), dtype=torch.bfloat16)
    assert torch.equal(out, enh.enhance_batch(wav, x_T=x_T))
    f32_enh = Enhancer(dis, ddpm, device="cpu")
    f32_pack, bf16_pack = f32_enh.packs(), enh.packs()
    assert bf16_pack[0]["enc"][0][0]["wmain"].dtype == torch.bfloat16
    assert f32_pack[0]["enc"][0][0]["wmain"].dtype == torch.float32
    assert f32_pack[0]["dual"] is None  # the f32 route: the two Decoders
    assert enh.packs() is bf16_pack and f32_enh.packs() is f32_pack
    with torch.no_grad():
        ddpm.core.tcm2.residual3.out_bn.running_var.add_(0.5)
    assert enh.packs() is not bf16_pack and f32_enh.packs() is not f32_pack
    fresh = Enhancer(dis, ddpm, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(enh.enhance_batch(wav, draw()), fresh.enhance_batch(wav, draw()))


def test_enhancer_needs_a_card_by_default(serving_nets, monkeypatch):
    """No fallback: on its default device the enhancer runs on the card,
    and without one it raises instead of serving on the CPU."""
    (_, _, dis), (_, _, ddpm) = serving_nets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Enhancer(dis, ddpm, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        Enhancer(dis, ddpm, device="cpu", dtype=torch.float16)
