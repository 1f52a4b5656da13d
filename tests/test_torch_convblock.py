"""Port K3 packing and plain stage math against the JAX fused encoder (CPU).

The port packs each encoder stage from its own converted modules
(``ops/cuda/convblock.py``) and runs the plain version of K3
(``enc_stage_plain``); the reference is the JAX ``fused_enc_stage`` on
JAX's own packing, with ``use_pallas=False`` for all five stages and
``interpret=True`` for one stage at T = 4.  Same stage inputs on both
sides.  Bound: 1e-5 * max|ref| (float32 products of length <= 192 summed
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_diffuse_tpu.models.diffunet import Encoder as JEncoder
from prior_diffuse_tpu.ops.pallas import convblock_kernel as jcb
from prior_diffuse_tpu_torch.convert import flax_to_state_dict
from prior_diffuse_tpu_torch.models.diffunet import Encoder
from prior_diffuse_tpu_torch.ops.cuda import convblock as cb


def _close_rel(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, bound = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def _randomize_bn(stats, rng):
    for bn in stats.values():
        bn = bn["BatchNorm_0"]
        bn["mean"] = (rng.standard_normal(bn["mean"].shape) * 0.1).astype(np.float32)
        bn["var"] = (0.5 + rng.random(bn["var"].shape)).astype(np.float32)


def _encoders(time_cond, t_frames, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t_frames, 161, 2)).astype(np.float32)
    temb = rng.standard_normal((2, 512)).astype(np.float32) if time_cond else None
    jenc = JEncoder(time_cond=time_cond)
    variables = jenc.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                          None if temb is None else jnp.asarray(temb), False)
    params = jax.tree.map(np.array, variables["params"])
    stats = jax.tree.map(np.array, variables["batch_stats"])
    _randomize_bn(stats, rng)
    enc = Encoder(time_cond).eval()
    enc.load_state_dict(flax_to_state_dict(
        enc, {"params": params, "batch_stats": stats}))
    return x, temb, params, stats, enc


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "tproj"])
def encoders(request):
    return (request.param, *_encoders(request.param, 9, 5 + request.param))


@pytest.mark.parametrize("stage", range(5))
def test_stage_matches_jax(encoders, stage):
    time_cond, x, temb, params, stats, enc = encoders
    jpacked = jcb.pack_encoder(params, stats)
    ports = cb.pack_encoder(enc)
    # stage input: the JAX chain's output of the stages before
    xin = jnp.asarray(x)
    jtemb = None if temb is None else jnp.asarray(temb)
    for (ops, tp), kf in list(zip(jpacked, jcb._ENC_KERNELS))[:stage]:
        tproj = None if tp is None else jtemb @ tp[0] + tp[1]
        xin = jcb.fused_enc_stage(xin, ops, tproj, kernel_f=kf,
                                  dtype=jnp.float32, use_pallas=False)
    ops, tp = jpacked[stage]
    tproj = None if tp is None else jtemb @ tp[0] + tp[1]
    want = jcb.fused_enc_stage(xin, ops, tproj, kernel_f=jcb._ENC_KERNELS[stage],
                               dtype=jnp.float32, use_pallas=False)
    with torch.no_grad():
        got, _ = cb.encoder_fused(
            torch.from_numpy(np.array(xin)), [ports[stage]],
            None if temb is None else torch.from_numpy(temb))
    _close_rel(got.numpy(), want)


def test_packing_matches_jax(encoders):
    _, _, _, params, stats, enc = encoders
    for (jops, _), (ops, _) in zip(jcb.pack_encoder(params, stats),
                                   cb.pack_encoder(enc)):
        for key in ("wmain", "bmain", "wg", "bg", "w2", "b2"):
            _close_rel(ops[key].detach().numpy(), jops[key], 1e-6)
        np.testing.assert_array_equal(ops["alpha"].numpy().reshape(()),
                                      np.asarray(jops["alpha"]))
        assert (ops["pre"] is None) == (jops["pre"] is None)


def test_fused_encoder_matches_module_form(encoders):
    """The packed path and the conv-by-conv modules give the same skips."""
    _, x, temb, _, _, enc = encoders
    t = None if temb is None else torch.from_numpy(temb)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        _, want = enc(xt, t)
        _, got = enc(xt, t, packed=cb.pack_encoder(enc))
    for a, b in zip(got, want):
        _close_rel(a.numpy(), b.numpy(), 1e-5)


def test_stage_matches_pallas_interpret():
    """Stage 1 of a time-conditioned encoder at T = 4, against the Pallas
    kernel in interpret mode."""
    x, temb, params, stats, enc = _encoders(True, 4, 11)
    ops, tp = jcb.pack_encoder(params, stats)[0]
    tproj = jnp.asarray(temb) @ tp[0] + tp[1]
    want = jcb.fused_enc_stage(jnp.asarray(x), ops, tproj, kernel_f=5,
                               dtype=jnp.float32, tile_r=64, interpret=True)
    with torch.no_grad():
        got, _ = cb.encoder_fused(torch.from_numpy(x), cb.pack_encoder(enc)[:1],
                                  torch.from_numpy(temb))
    _close_rel(got.numpy(), want)


@pytest.mark.parametrize("pad", [0, 1])
def test_kernel_index_math_matches_plain(pad):
    """K3's gather, emulated row by row with the kernel's index arithmetic
    (k -> (kt, kf, c); input frame t + kt - pad, frames before 0 read as
    zeros) and its two diagonal gate blocks, equals ``enc_stage_plain``."""
    g = torch.Generator().manual_seed(pad)
    b, tin, f, c, kf = 2, 3, 9, 4, 3
    x = torch.randn(b, tin, f, c, generator=g)
    ops = {"kernel_f": kf, "wmain": torch.randn(2 * kf * c, 64, generator=g) * 0.2,
           "wg": torch.zeros(64, 64), "bg": torch.randn(64, generator=g),
           "w2": torch.randn(32, 64, generator=g) * 0.2,
           "b2": torch.randn(64, generator=g), "alpha": torch.tensor([0.2])}
    ops["wg"][:32, :32] = torch.randn(32, 32, generator=g) * 0.2
    ops["wg"][32:, 32:] = torch.randn(32, 32, generator=g) * 0.2
    bias_b = torch.randn(b, 64, generator=g)
    want = cb.enc_stage_plain(x, ops, bias_b, pad)
    t_out, fo = tin - 1 + pad, (f - kf) // 2 + 1
    assert want.shape == (b, t_out, fo, 64)
    k_dim = 2 * kf * c
    emu = torch.empty_like(want)
    for bi in range(b):
        for row in range(t_out * fo):
            t, o = divmod(row, fo)
            col = torch.zeros(k_dim)
            for k in range(k_dim):
                kt, kfi, ci = k // (kf * c), (k // c) % kf, k % c
                tsrc = t + kt - pad
                if tsrc >= 0:
                    col[k] = x[bi, tsrc, 2 * o + kfi, ci]
            y = col @ ops["wmain"] + bias_b[bi]
            ml = y[:32] @ ops["wg"][:32, :32] + ops["bg"][:32]
            mr = y[32:] @ ops["wg"][32:, 32:] + ops["bg"][32:]
            comb = y[:32] * torch.sigmoid(mr) + y[32:] * torch.sigmoid(ml)
            out = comb @ ops["w2"] + ops["b2"]
            emu[bi, t, o] = torch.where(out >= 0, out, 0.2 * out)
    _close_rel(emu.numpy(), want.numpy())


def test_wrapper_takes_plain_path_on_cpu(encoders):
    _, x, temb, _, _, enc = encoders
    ops, _ = cb.pack_encoder(enc)[0]
    xt = torch.from_numpy(x)
    bias_b = ops["bmain"].expand(2, 64).contiguous()
    before = cb.enc_stage.launches
    with torch.no_grad():
        got = cb.enc_stage(xt, ops, bias_b, 1)
        want = cb.enc_stage_plain(xt, ops, bias_b, 1)
    assert torch.equal(got, want)
    assert cb.enc_stage.launches == before
