"""The port's static roofline (``utils/roofline.py``) on the CPU.

Three parts.

1. ``tests/test_roofline.py``'s cases, with the H100's tile padding in
   place of the TPU's (8, 128): a product, a convolution, repeated ops,
   elementwise bytes and views, the totals and ``format_report``, and the
   ``chip_spec`` lookup (an unknown name gives ``None``); and what only the
   port counts: a convolution's gradients by ``output_mask``, and the
   recurrences whether they reach the dispatcher whole or as products.
2. Parity with ``prior_diffuse_tpu.utils.roofline.analyze`` on the same
   programs, inputs from one numpy seed and the same converted weights:
   a bf16 and an f32 product, a grouped and a stride-(1, 2) transposed
   convolution, GCRN's LSTM, DB-AIAT's bidirectional GRU; the ``DiffUNet``
   forward, the fused fast-6 enhance chain at full width on a 1 x 0.5 s
   batch in f32 (two ``Decoder`` modules) and in bf16 (the dual decoder),
   and the joint ``--sigma`` train step at batch 2 x 4800.  Model FLOPs and
   product bytes are equal, except where a package formulates an op
   otherwise, each computed here from the port's own shapes:

   * **conv1 of encoder stages 2-5 on the causal pad frame.** JAX's fused
     stage runs conv1 on ``T + 1`` frames, the zero pad frame included;
     the port writes that frame's conv1 (its bias) without a product
     (``ops/cuda/convblock.py::conv1_input``).  JAX counts ``2 B F 64 x
     32`` FLOPs and ``B F (64 + 32)`` elements of bytes more per stage and
     forward (F = 79, 39, 19, 9).  Exact.
   * **Transposed convolutions.** JAX's stride-(1, 2) odd-kernel one is a
     phase decomposition into two VALID convolutions over an input padded
     by ``kh - 1`` frames and the phase's taps - 1 bins
     (``prior_diffuse_tpu/models/layers.py:164-210``), and counts the pads'
     zeros; any other stride is lhs-dilated and counts its output pixels
     (``:211-218``); the port's ``convolution(transposed=True)`` counts each
     input pixel once, and the dual decoder's runs with ``groups=2`` where
     JAX's block-diagonal weight counts its zero blocks.  Recomputed per
     call from the port's shapes: exact.
   * **Convolution pairs.** JAX fuses the two convolutions of a GLU
     (``conv_pair_fused``) into one that reads the shared input once; the
     port reads it twice.  Exact.
   * **Grouped convolutions.** JAX's ``_conv_cost`` counts ``1 / groups``
     of the MACs (``roofline.py:166-176`` divides the output channels by
     the groups and never multiplies back).  Exact: JAX = port / g.
   * **bf16 product bytes.** The plain K3-bf16 stage (the kernel's plain
     version, which the walk counts) widens its three products' operands
     and results to f32 where JAX's einsums read and write bf16; on the
     CPU the dual decoder's ``_mm`` widens its operands (on the card it
     reads bf16 and writes f32, as JAX); its time projection reads f32
     ``temb`` and ``tp2b``.  Each is recomputed from the recorded calls.
     What remains comes from JAX's report: it keys an op by its shapes
     alone, so products of one shape and two result dtypes (the encoder's
     window product and the dual decoder's conv1, both ``[B T 39, 192] @
     [192, 64]``) all take the first one's bytes, and the DDPM's bf16
     ``preprocess`` product writes bf16 in JAX and f32 in the port's
     ``_mm``: held within 2 % of JAX's product bytes (1.5 % at this size).
   * **Recurrences' bytes.** JAX's scan reads the recurrent weight and
     writes the gates each step; the port's op reads its operands once:
     FLOPs are held exactly, bytes not compared.
   * **The train step's gradients.** JAX's input gradient of a stride-(1,
     2) convolution is lhs-dilated and counts the inserted zeros, and its
     phase-decomposed transposed convolutions count their pads in both
     gradients; the port counts each gradient as the forward's MACs.
     Products are equal; the convolutions' model FLOPs are held to
     ``port <= JAX <= 1.15 x port`` (1.102 at this size).
3. A spy on the four kernel entry points: ``analyze`` never calls them, on
   the serving batch in both dtypes and on the train step.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import prior_diffuse_tpu.config as jcfg
from prior_diffuse_tpu.config import DiffusionConfig as JDiffusionConfig
from prior_diffuse_tpu.config import TrainConfig as JTrainConfig
from prior_diffuse_tpu.data import synthetic
from prior_diffuse_tpu.diffusion import inference_schedule as j_inference_schedule
from prior_diffuse_tpu.diffusion import reverse_sample as j_reverse_sample
from prior_diffuse_tpu.models import layers as jl
from prior_diffuse_tpu.models.fused_forward import fused_unet_forward as j_fused
from prior_diffuse_tpu.models.fused_forward import pack_unet as j_pack
from prior_diffuse_tpu.parallel.mesh import make_mesh
from prior_diffuse_tpu.signal.compress import compress_spec as j_compress
from prior_diffuse_tpu.signal.compress import decompress_spec as j_decompress
from prior_diffuse_tpu.signal.stft import istft as j_istft
from prior_diffuse_tpu.signal.stft import stft as j_stft
from prior_diffuse_tpu.utils import roofline as jroof
from prior_diffuse_tpu_torch import config as tcfg
from prior_diffuse_tpu_torch.models import fused_forward as ff
from prior_diffuse_tpu_torch.models import layers
from prior_diffuse_tpu_torch.ops.cuda import convblock as cb
from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
from prior_diffuse_tpu_torch.serving.enhancer import Enhancer
from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer
from prior_diffuse_tpu_torch.utils.roofline import (CHIP_SPECS, analyze, chip_spec,
                                                    format_report, op_peak, plain_kernels)
from test_torch_models import make_pair
from test_torch_priors import _layer_pair
from test_torch_train_step import CHUNK, _batch, _exp, _jax_draws

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from roofline_enhance import CONV1_F, SERVING_FORWARDS, conv_calls, jax_convs  # noqa: E402

torch.set_num_threads(2)

SXM = CHIP_SPECS["H100 80GB HBM3"]
LENGTH = 8000  # 0.5 s
TRAIN_CONV_EXCESS = 1.15
BF16_BYTES_RESIDUAL = 0.02


def _by_kind(rep, what="flops"):
    out = {}
    for o in rep.ops.values():
        out[o.kind] = out.get(o.kind, 0.0) + getattr(o, what)
    return out


# ---- 1. the JAX module's cases, with the H100's padding ------------------------

def test_dot_macs_and_padding():
    a = torch.zeros((64, 100), dtype=torch.bfloat16)
    w = torch.zeros((100, 32), dtype=torch.bfloat16)
    rep = analyze(lambda x: x @ w, a)
    (op,) = rep.ops.values()
    assert op.kind == "dot_general" and op.dtype_class == "bf16" and op.count == 1
    assert op.macs == 64 * 100 * 32
    # wgmma m64 nN k16: M 64 stays, K 100 -> 112, N 32 stays
    assert op.padded_macs == 64 * 112 * 32
    assert op.bytes_moved == 2 * (64 * 100 + 100 * 32 + 64 * 32)


def test_f32_pads_nothing_and_is_charged_at_3xtf32():
    rep = analyze(lambda x, w: torch.addmm(torch.zeros(7), x, w),
                  torch.zeros((5, 3)), torch.zeros((3, 7)))
    (op,) = rep.ops.values()
    assert op.dtype_class == "f32" and op.padded_macs == op.macs == 5 * 3 * 7
    assert op.bytes_moved == 4 * (5 * 3 + 3 * 7 + 5 * 7)  # the fused bias is not an operand
    assert op_peak("f32", SXM) == SXM["peak_tf32"] / 3 == 165e12
    assert op_peak("tf32", SXM) == 495e12 and op_peak("bf16", SXM) == 989e12
    assert op.roofline_s(SXM) == max(2 * op.macs / 165e12, op.bytes_moved / 3.35e12)


def test_conv_macs():
    x = torch.zeros((2, 16, 9, 20))  # NCHW
    k = torch.zeros((32, 16, 3, 3))
    for dtype in (torch.float32, torch.bfloat16):
        rep = analyze(lambda x, k: F.conv2d(x, k, padding=1), x.to(dtype), k.to(dtype))
        (op,) = rep.ops.values()
        m = 2 * 9 * 20
        assert op.kind == "conv" and op.macs == m * (3 * 3 * 16) * 32
        # im2col view: M 360, K 144, N 32; bf16 pads M to 64 (384), K and N fit
        assert op.padded_macs == (m if dtype == torch.float32 else 384) * 144 * 32


def test_repeated_ops_count():
    w = torch.zeros((64, 64))

    def f(x):
        for _ in range(5):
            x = x @ w
        return x

    rep = analyze(f, torch.zeros((8, 64)))
    (op,) = rep.ops.values()
    assert op.count == 5 and op.flops == 2 * 8 * 64 * 64 * 5
    assert rep.has_unbounded_while is False


def test_elementwise_bytes_and_views():
    w = torch.zeros((128, 128))
    rep = analyze(lambda x: torch.relu(x @ w), torch.zeros((8, 128)))
    assert len(rep.ops) == 1 and rep.elementwise_bytes == 2 * 8 * 128 * 4
    views = analyze(lambda x: x.view(16, 64).t().permute(1, 0)[2:].expand(2, 14, 64),
                    torch.zeros((8, 128)))
    assert views.elementwise_bytes == 0
    assert analyze(lambda x: x.t().contiguous(), torch.zeros((8, 128))
                   ).elementwise_bytes == 2 * 8 * 128 * 4


def test_totals_and_format():
    w = torch.zeros((100, 32), dtype=torch.bfloat16)
    rep = analyze(lambda x: x @ w, torch.zeros((64, 100), dtype=torch.bfloat16))
    t = rep.totals(SXM, measured_s=1e-3)
    assert t["model_flops"] == 2 * 64 * 100 * 32
    assert 0 < t["lane_occupancy"] < 1
    assert t["attainable_s_fused"] <= t["attainable_s_unfused"]
    assert t["attained_fraction"] == t["attainable_s_fused"] / 1e-3
    assert t["mfu"] == t["model_flops"] / (1e-3 * 989e12)
    assert t["bound_by"] in ("compute", "memory")
    assert "mfu" not in rep.totals(SXM)
    txt = format_report(rep, SXM, measured_s=1e-3)
    assert "attainable ceiling" in txt and "measured" in txt and "mfu" in txt


def test_chip_spec_lookup():
    assert chip_spec("NVIDIA H100 80GB HBM3")["peak_bf16"] == 989e12
    assert chip_spec("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2.0e12
    assert chip_spec("NVIDIA H100 NVL")["peak_tf32"] == 418e12
    assert chip_spec(None) is None
    assert chip_spec(torch.device("cpu")) is None
    assert chip_spec("NVIDIA A100-SXM4-80GB") is None
    assert chip_spec("TPU v5 lite") is None


def test_conv_backward_counts_the_asked_gradients():
    conv = torch.nn.Conv2d(4, 8, (2, 3), stride=(1, 2))
    fwd = 2 * (2 * 4 * 4) * (8 * 4 * 2 * 3)  # B To Fo x Cout Cin taps
    for needs_input_grad, grads in ((False, 1), (True, 2)):
        x = torch.randn(2, 4, 5, 9, requires_grad=needs_input_grad)
        rep = analyze(lambda x: conv(x).sum().backward(), x)
        bwd = [o for k, o in rep.ops.items() if "grad" in k]
        assert len(bwd) == grads and all(o.flops == fwd for o in bwd)
        assert any("wgrad" in k for k in rep.ops)


@pytest.mark.parametrize("name", ["lstm", "gru"])
def test_recurrences_count_their_products(name):
    """The LSTM reaches the mode whole on the CPU (``mkldnn_rnn_layer``),
    the GRU as products: both give ``T N (G H I + G H H)`` MACs, and the
    LSTM's backward twice that (the hidden state's and the input's
    gradients through time, and the weights')."""
    mod, g = ((layers.LSTM(16, 32), 4) if name == "lstm"
              else (layers.GRU(16, 32, bidirectional=True), 3 * 2))
    x = torch.randn(3, 7, 16)
    with torch.no_grad():
        rep = analyze(mod, x)
    assert sum(o.flops for o in rep.ops.values()) == 2 * 3 * 7 * g * 32 * (16 + 32)
    if name == "lstm":
        assert [o.kind for o in rep.ops.values()] == ["rnn"]
        rep = analyze(lambda x: mod(x).sum().backward(), x)
        assert _by_kind(rep)["rnn"] == 3 * 2 * 3 * 7 * g * 32 * (16 + 32)


# ---- 2. parity with the JAX analyzer -----------------------------------------------

def _single(name):
    """(JAX fn, JAX args, port fn, port args, JAX FLOPs from the port's)."""
    g = np.random.default_rng(0)
    if name in ("dot_bf16", "dot_f32"):
        a, w = g.standard_normal((64, 100)), g.standard_normal((100, 32))
        jd, td = (jnp.bfloat16, torch.bfloat16) if name == "dot_bf16" else (jnp.float32,
                                                                          torch.float32)
        return (lambda x, y: x @ y, (jnp.asarray(a, jd), jnp.asarray(w, jd)),
                lambda x, y: x @ y, (torch.tensor(a).to(td), torch.tensor(w).to(td)), 1.0)
    if name == "grouped_conv":
        x = g.standard_normal((2, 9, 20, 16)).astype(np.float32)
        k = g.standard_normal((2, 3, 4, 32)).astype(np.float32)
        return (lambda x, k: jax.lax.conv_general_dilated(
                    x, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    feature_group_count=4), (jnp.asarray(x), jnp.asarray(k)),
                lambda x, k: F.conv2d(x, k, groups=4),
                (torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(k).permute(3, 2, 0, 1)),
                1 / 4)
    if name == "transposed_conv":
        x = g.standard_normal((2, 6, 9, 8)).astype(np.float32)
        w = g.standard_normal((2, 3, 8, 16)).astype(np.float32)
        b = np.zeros(16, np.float32)
        return (lambda x, w: jl.conv_transpose(x, w, b, (1, 2)),
                (jnp.asarray(x), jnp.asarray(w)),
                lambda x, w: F.conv_transpose2d(x, w, stride=(1, 2)),
                (torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w).permute(2, 3, 0, 1)),
                None)
    make_j, make_t, shape = {  # the models' widths (GCRN's LSTM, DB-AIAT's GRU)
        "gcrn_lstm": (lambda: jl.LSTM(512), lambda: layers.LSTM(512, 512), (2, 51, 512)),
        "dbaiat_gru": (lambda: jl.GRU(64, bidirectional=True),
                       lambda: layers.GRU(32, 64, True), (6, 51, 32)),
    }[name]
    x = g.standard_normal(shape).astype(np.float32)
    variables, tm = _layer_pair(make_j(), make_t(), jnp.asarray(x))
    jm = make_j()
    return (lambda v, x: jm.apply(v, x), (variables, jnp.asarray(x)),
            torch.no_grad()(tm), (torch.from_numpy(x),), 1.0)


@pytest.mark.parametrize("name", ["dot_bf16", "dot_f32", "grouped_conv", "transposed_conv",
                                  "gcrn_lstm", "dbaiat_gru"])
def test_single_op_matches_jax(name):
    jfn, jargs, tfn, targs, ratio = _single(name)
    want, got = jroof.analyze(jfn, *jargs), analyze(tfn, *targs)
    flops = lambda r: sum(o.flops for o in r.ops.values())
    if ratio is None:  # the transposed convolution: JAX's phases from the port's shapes
        tot = jax_convs(conv_calls(tfn, *targs))
        assert flops(got) == tot["port_flops"] and flops(want) == tot["jax_flops"]
        assert _by_kind(want, "total_bytes")["conv"] == tot["jax_bytes"]
        return
    assert flops(want) == ratio * flops(got) > 0
    if name.startswith(("dot", "grouped")):
        assert _by_kind(want, "total_bytes") == {
            "dot_general" if name.startswith("dot") else "conv":
            sum(o.total_bytes for o in got.ops.values())}


def _j_enhance(dt, dual):
    """``scripts/roofline_enhance.py::build``'s program at ``dt``: the
    fused prior, the fast-6 chain, STFT and ISTFT."""
    cfg, diff = JTrainConfig(), JDiffusionConfig()
    sched = j_inference_schedule(diff, fast_sampling=True)

    def enhance(packed, wav, rng):
        feat = j_compress(j_stft(wav), cfg.feat_type)
        x_init = j_fused(packed["dis"], feat.astype(dt), dtype=dt, use_pallas=False,
                         dual_decoder=dual)
        x_init = x_init.astype(dt) / jnp.asarray(diff.scale_c, dt)

        def model_fn(x, t):
            return j_fused(packed["ddpm"], x.astype(dt), x_init, t.astype(dt),
                           num_steps=diff.num_steps, dtype=dt, use_pallas=False,
                           dual_decoder=dual).astype(dt)

        audio = j_reverse_sample(model_fn, rng, x_init, x_init.shape, sched, "pirorgrad",
                                 dtype=dt)
        spec = j_decompress(audio.astype(jnp.float32) * diff.scale_c, cfg.feat_type)
        return j_istft(spec, length=wav.shape[-1])
    return enhance


@pytest.fixture(scope="module")
def nets():
    return make_pair("DiffUNet", seed=3), make_pair("DiffUNet1", seed=4)


def _recorded(module, name, calls):
    """``module.name`` wrapped to record its arguments into ``calls``."""
    fn = getattr(module, name)

    def rec(*args):
        calls.append(args)
        return fn(*args)
    return rec


@pytest.fixture(scope="module", params=["f32", "bf16"])
def chain(request, nets):
    """Both analyzers on the fused fast-6 chain, 1 x 0.5 s, and the calls
    of the port's plain bf16 stages and ``_mm`` during its walk."""
    (_, dis_vars, dis), (_, ddpm_vars, ddpm) = nets
    jd, td = ((jnp.float32, torch.float32) if request.param == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    cast = lambda t: jax.tree.map(lambda p: jnp.asarray(p).astype(jd), t)
    packed = {"dis": j_pack(cast(dis_vars)), "ddpm": j_pack(cast(ddpm_vars))}
    wav = np.random.default_rng(0).standard_normal((1, LENGTH)).astype(np.float32)
    want = jroof.analyze(_j_enhance(jd, request.param == "bf16"), packed, jnp.asarray(wav),
                         jax.random.PRNGKey(1))
    enh = Enhancer(dis, ddpm, device="cpu", dtype=td)
    enh.packs()  # packing is not the batch's work (JAX packs outside its program)
    stages, mms = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cb, "enc_stage_plain", _recorded(cb, "enc_stage_plain", stages))
        mp.setattr(ff, "_mm", _recorded(ff, "_mm", mms))
        got = analyze(enh.enhance_batch, wav, torch.Generator().manual_seed(0))
    calls = conv_calls(enh.enhance_batch, wav, torch.Generator().manual_seed(0))
    return dict(dtype=request.param, want=want, got=got, convs=jax_convs(calls),
                stages=stages, mms=mms, enh=enh, wav=wav)


def test_chain_products_match_jax(chain):
    """Products: JAX's FLOPs exceed the port's by conv1 on the pad frame
    of stages 2-5 in each of the 7 forwards; so do its bytes, and in bf16
    the port's widened operands and results count on top."""
    want, got = _by_kind(chain["want"]), _by_kind(chain["got"])
    forwards, b = SERVING_FORWARDS, 1
    assert want["dot_general"] - got["dot_general"] == forwards * b * sum(CONV1_F) * 2 * 64 * 32
    isz = 4 if chain["dtype"] == "f32" else 2
    pad_bytes = forwards * b * sum(CONV1_F) * isz * (64 + 32)
    widened = 0
    if chain["dtype"] == "bf16":
        for x, ops, _, pad in chain["stages"]:  # three products, f32 against bf16
            m = x.shape[0] * (x.shape[1] - 1 + pad) * ((x.shape[2] - ops["kernel_f"]) // 2 + 1)
            k = ops["wmain"].shape[0]
            widened += 2 * (m * k + k * 64 + m * 64) + 2 * (2 * m * 64 + 64 * 64) \
                + 2 * (m * 32 + 32 * 64 + m * 64)
        for a, w, _ in chain["mms"]:  # f32 operands against bf16, both f32 out
            widened += 2 * (a.numel() + w.numel())
        for st in chain["enh"].packs()[1]["dual"]:  # temb [1, 512] @ tp2b, all f32
            if "tp2b" in st:
                widened += 6 * 2 * (512 + st["tp2b"].numel() + st["tp2b"].shape[1])
    got_b, want_b = _by_kind(chain["got"], "total_bytes"), _by_kind(chain["want"],
                                                                    "total_bytes")
    residual = got_b["dot_general"] + pad_bytes - widened - want_b["dot_general"]
    if chain["dtype"] == "f32":
        assert residual == 0
    else:
        assert abs(residual) <= BF16_BYTES_RESIDUAL * want_b["dot_general"], residual


def test_chain_convolutions_match_jax(chain):
    convs = chain["convs"]
    assert _by_kind(chain["got"])["conv"] == convs["port_flops"]
    assert _by_kind(chain["want"])["conv"] == convs["jax_flops"]
    assert _by_kind(chain["got"], "total_bytes")["conv"] == convs["port_bytes"]
    assert _by_kind(chain["want"], "total_bytes")["conv"] == convs["jax_bytes"]


def test_chain_bf16_model_flops_in_bf16_tiles(chain):
    """The bf16 program's products that run in bf16 are padded to wgmma's
    tiles; the f32 program's are not padded at all."""
    classes = {o.dtype_class for o in chain["got"].ops.values()}
    t = chain["got"].totals(SXM)
    if chain["dtype"] == "f32":
        assert classes == {"f32"} and t["lane_occupancy"] == 1.0
    else:
        assert "bf16" in classes and t["lane_occupancy"] < 1.0
    assert t["attainable_s_fused"] < t["attainable_s_unfused"]


def test_diffunet_forward_matches_jax(nets):
    (jm, variables, tm), _ = nets
    x = np.random.default_rng(1).standard_normal((1, 51, 161, 2)).astype(np.float32)
    want = jroof.analyze(lambda v, x: jm.apply(v, x, train=False), variables, jnp.asarray(x))
    with torch.no_grad():
        got = analyze(tm, torch.from_numpy(x))
        convs = jax_convs(conv_calls(tm, torch.from_numpy(x)))
    assert set(_by_kind(want)) == set(_by_kind(got)) == {"conv"}
    assert _by_kind(got)["conv"] == convs["port_flops"]
    assert _by_kind(want)["conv"] == convs["jax_flops"]
    assert _by_kind(want, "total_bytes")["conv"] == convs["jax_bytes"]


@pytest.fixture(scope="module")
def train_step(tmp_path_factory):
    """Both analyzers on the joint ``--sigma`` step, batch 2 x 4800."""
    from prior_diffuse_tpu.training import ComplexDDPMTrainer as JTrainer

    tmp = tmp_path_factory.mktemp("roofline_step")
    corpus = synthetic.write_corpus(str(tmp / "corpus"), n_train=2, n_test=2,
                                    min_len=6000, max_len=9000, seed=5)
    flags = dict(joint=True, sigma=True)
    jtr = JTrainer(jcfg.RunConfig(assets=str(tmp / "jax"), doc="t", data_root=corpus, **flags),
                   _exp(jcfg, {}), mesh=make_mesh(dp=1))
    tr = ComplexDDPMTrainer(tcfg.RunConfig(assets=str(tmp / "torch"), doc="t",
                                           data_root=corpus, **flags), _exp(tcfg, {}),
                            device="cpu")
    batch = _batch(corpus)
    rng = jax.random.PRNGKey(11)
    want = jroof.analyze(jtr._train_step, jtr.state,
                         *jtr.put_batch(batch.noisy, batch.clean, batch.frame_nums), rng)
    draws = _jax_draws(rng, jtr.exp.diffusion, (2, CHUNK // 160 + 1, 161, 2))
    args = (torch.from_numpy(batch.noisy), torch.from_numpy(batch.clean),
            torch.from_numpy(batch.frame_nums).long())
    got = analyze(tr._train_step, *args, draws=draws)
    return dict(want=want, got=got, tr=tr, args=args, draws=draws)


def test_train_step_matches_jax(train_step):
    want, got = train_step["want"], train_step["got"]
    assert _by_kind(want)["dot_general"] == _by_kind(got)["dot_general"] > 0
    assert (_by_kind(want, "total_bytes")["dot_general"]
            == _by_kind(got, "total_bytes")["dot_general"])
    assert any("dgrad" in k for k in got.ops) and any("wgrad" in k for k in got.ops)
    port, jax_ = _by_kind(got)["conv"], _by_kind(want)["conv"]
    assert port <= jax_ <= TRAIN_CONV_EXCESS * port, jax_ / port


# ---- 3. the kernels are never called ------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    calls = []
    for mod, name in ((kstft, "stft"), (kstft, "istft"), (cb, "enc_stage"),
                      (cb, "enc_stage_bf16")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    return calls


def test_analyze_never_calls_the_kernels(spies, chain, train_step):
    run = lambda: chain["enh"].enhance_batch(chain["wav"], torch.Generator().manual_seed(0))
    run()  # without analyze the wrappers are called (on the CPU they take the plain path)
    wanted = {"stft", "istft", "enc_stage" if chain["dtype"] == "f32" else "enc_stage_bf16"}
    assert set(spies) == wanted
    spies.clear()
    again = analyze(run)
    analyze(train_step["tr"]._train_step, *train_step["args"], draws=train_step["draws"])
    assert spies == []
    assert _by_kind(again) == _by_kind(chain["got"])
    assert kstft.stft.__name__ == "<lambda>"  # the spies are back after the walk


def test_plain_kernels_restores_the_wrappers():
    before = (kstft.stft, kstft.istft, cb.enc_stage, cb.enc_stage_bf16)
    with pytest.raises(RuntimeError), plain_kernels():
        assert kstft.stft is kstft.stft_plain and cb.enc_stage is cb.enc_stage_plain
        raise RuntimeError
    assert (kstft.stft, kstft.istft, cb.enc_stage, cb.enc_stage_bf16) == before
    assert "jax" not in sys.modules["prior_diffuse_tpu_torch.utils.roofline"].__dict__
