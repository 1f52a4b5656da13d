"""bf16 serving of the GCRN and DB-AIAT priors against the JAX package (CPU).

The JAX package serves any prior in ``serve_dtype`` bfloat16 by casting its
variables (parameters and BatchNorm statistics) to bf16 and feeding a bf16
input; each op then runs in the promotion of its operands' dtypes, so
GCRN's grouped LSTM (fed ``e5.astype(float32)``) and DB-AIAT's GRUs and
the ``linear2`` after them run in float32 on bf16-rounded weights
(``tools/bf16_trace.py``).  The port's ``serving/enhancer.py::
serving_copy`` mirrors that.  On the same perturbed flax variables
(``test_torch_priors.py``) and seeded numpy inputs:

* the serving copy's dtype split: the modules whose products run in
  float32 in JAX's traced forward are exactly those that hold float32
  weights in the copy, each equal to its bf16-rounded original, and every
  other parameter and statistic is bf16; the net itself stays float32;
* ``PriorServer(dtype=bfloat16)``'s prior against JAX's jitted ``apply``
  on the cast variables with a bf16 input (what ``_dis_apply`` runs),
  B = 2, T = 12 frames: relative RMS <= 2e-2 (``test_torch_bf16.py``'s
  bound) for GCRN and ``aia_complex_trans_mag``; 3e-2 for the three
  variants whose RI branch's dense blocks and attention amplify bf16
  rounding flips: there JAX's own jitted and op-by-op runs of that forward
  sit 2.0e-2 .. 2.2e-2 apart, the port 1.9e-2 .. 2.2e-2 from the jitted one
  and 1.4e-2 .. 1.7e-2 from the op-by-op one (``python3
  tools/bf16_trace.py --parity``);
* the bf16 ``Enhancer`` with a GCRN and an ``aia_complex_trans_ri`` prior
  against JAX's ``enhance_batch`` at ``serve_dtype = bfloat16`` (the prior
  on its cast variables, the DDPM's six forwards on the dual route), the
  same ``x_T``, 2 x 2400 samples: relative RMS within the same bounds.
"""

import importlib.util
import os
import re
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
from prior_diffuse_tpu.models import fused_forward as jff
from prior_diffuse_tpu.signal.compress import decompress_spec as j_decompress_spec
from prior_diffuse_tpu.signal.stft import istft as j_istft
from prior_diffuse_tpu.training.base import spec_features as j_spec_features
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.serving.enhance import PriorServer
from prior_diffuse_tpu_torch.serving.enhancer import Enhancer, serving_copy
from test_torch_bf16 import tb
from test_torch_enhance import _speechlike
from test_torch_models import make_pair
from test_torch_priors import ORACLE, make_prior, speclike

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = jnp.bfloat16
T_FRAMES = 12
LENGTH = 2400
# the module docstring says why the RI-branch variants get 3e-2
REL_RMS = {name: 3e-2 for name in ORACLE}
REL_RMS.update({"GCRN": 2e-2, "aia_complex_trans_mag": 2e-2})


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def _trace_tool():
    spec = importlib.util.spec_from_file_location(
        "bf16_trace", os.path.join(ROOT, "tools", "bf16_trace.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module", params=list(ORACLE))
def prior(request):
    return (request.param, *make_prior(request.param, seed=len(request.param)))


def _cast(variables):
    return jax.tree.map(lambda p: jnp.asarray(p).astype(BF16), variables)


def _f32_products(copy):
    """Paths (indices as ``#``) of the serving copy's conv, linear and
    recurrent layers that hold float32 weights."""
    out = set()
    for name, m in copy.named_modules():
        if isinstance(m, torch.nn.RNNBase):
            weight = m.weight_ih_l0
        elif isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                            torch.nn.Linear)):
            weight = m.weight
        else:
            continue
        if weight.dtype == torch.float32:
            out.add(re.sub(r"\d+", "#", name.replace(".product", "").replace(".", "/")))
    return out


def test_serving_copy_dtype_split(prior):
    name, jm, variables, tm = prior
    copy = serving_copy(tm, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())  # the net is untouched
    # the products JAX runs in float32, from its traced forward
    traced = {re.sub(r"^[^/]+/", "", path)
              for path, ops in _trace_tool().trace(name, variables).items()
              if any(op.startswith(("dot_general(f32", "conv_general_dilated(f32"))
                     for op in ops)}
    assert traced == _f32_products(copy), (traced, _f32_products(copy))
    assert traced, name  # every family has float32 parts
    originals = dict(tm.named_parameters())
    f32 = 0
    for key, p in copy.named_parameters():
        orig = originals[key.replace(".product", "")]
        if p.dtype == torch.float32:
            f32 += p.numel()
            assert torch.equal(p, orig.detach().to(torch.bfloat16).float()), key
        else:
            assert p.dtype == torch.bfloat16 and torch.equal(p, orig.detach().bfloat16()), key
    assert all(b.dtype == torch.bfloat16 for k, b in copy.named_buffers()
               if "running" in k)
    assert 0 < f32 < sum(p.numel() for p in tm.parameters())


def test_prior_server_bf16_matches_jax(prior):
    name, jm, variables, tm = prior
    x = speclike((2, T_FRAMES, 161, 2), 1)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        _cast(variables), jnp.asarray(x).astype(BF16))
    server = PriorServer(tm, tcfg.ExperimentConfig(), device="cpu", dtype=torch.bfloat16)
    got = server.prior(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and server.net() is server.net()
    err = rel_rms(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert err <= REL_RMS[name], f"rel RMS {err:.3g}"


def _jax_enhance_prior_bf16(jm, dis_vars, ddpm_vars, wav, rng):
    """``ComplexDDPMTrainer.enhance_batch``'s ``impl`` at ``serve_dtype =
    bfloat16`` with a prior that is not a DiffUNet: the prior's ``apply``
    on its cast variables (``_dis_apply``), the DDPM's forwards on the dual
    route, pirorgrad, no sigma."""
    cfg, diff = JTrainConfig(), JDiffusionConfig()
    dt, c = BF16, diff.scale_c
    feat = j_spec_features(wav, cfg)
    x_init = jm.apply(_cast(dis_vars), feat.astype(dt), train=False)
    x_init = x_init.astype(dt) / jnp.asarray(c, dt)
    packed = jff.pack_unet(ddpm_vars)

    def model_fn(x, t):
        return jff.fused_unet_forward(packed, x.astype(dt), x_init, t.astype(dt),
                                      num_steps=diff.num_steps, dtype=dt, use_pallas=False,
                                      dual_decoder=True, dual_split=False,
                                      interpret=True).astype(dt)

    audio = j_reverse_sample(model_fn, rng, x_init, x_init.shape, j_inference_schedule(diff),
                             "pirorgrad", None, dtype=dt, n_avg=diff.n_avg,
                             zero_init=diff.zero_init, predict=diff.predict)
    spec = j_decompress_spec(audio.astype(jnp.float32) * c, cfg.feat_type)
    return j_istft(spec, length=wav.shape[-1], fft_num=cfg.fft_num, win_size=cfg.win_size,
                   win_shift=cfg.win_shift)


@pytest.mark.parametrize("name", ["GCRN", "aia_complex_trans_ri"])
def test_enhancer_bf16_matches_jax(name):
    jm, dis_vars, dis = make_prior(name, seed=len(name))
    _, ddpm_vars, ddpm = make_pair("DiffUNet1", seed=4)
    wav = _speechlike(2, LENGTH, 0)
    wav /= np.sqrt(np.mean(wav.astype(np.float64) ** 2, axis=1, keepdims=True)
                   ).astype(np.float32)
    rng = jax.random.PRNGKey(21)
    want = np.asarray(jax.jit(partial(_jax_enhance_prior_bf16, jm))(
        dis_vars, ddpm_vars, jnp.asarray(wav), rng))
    x_T = jax.random.normal(jax.random.split(rng)[0], (2, LENGTH // 160 + 1, 161, 2), BF16)
    enh = Enhancer(dis, ddpm, device="cpu", dtype=torch.bfloat16)
    got = enh.enhance_batch(wav, x_T=tb(x_T)[None])
    assert got.dtype == torch.float32 and got.shape == wav.shape
    assert enh.packs()[0] is None  # the prior runs unpacked, as its serving copy
    err = rel_rms(got.numpy(), want)
    assert err <= REL_RMS[name], f"rel RMS {err:.3g}"
