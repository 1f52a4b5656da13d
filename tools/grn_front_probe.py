#!/usr/bin/env python3
"""Where the port's bf16 GRN train forward leaves the JAX package's: the
forward of ``tests/test_torch_bf16_train_complex.py``'s ``mag-GRN`` step,
traced layer by layer in both packages (CPU, both packages).

    python3 tools/grn_front_probe.py [forward] [--ops]
    python3 tools/grn_front_probe.py step
    python3 tools/grn_front_probe.py bn
    python3 tools/grn_front_probe.py ops

Setup, as the test's ``step_pair("mag-GRN")``: ``MagTrainer`` at
``train.compute_dtype: bfloat16`` (batch 2 x 1600 samples, 11 frames), the
JAX trainer's initial state carried into the port by ``convert.py``, and
one input, JAX's compressed noisy magnitude, fed to both packages.

``forward``: JAX's ``GRN(dtype=bfloat16)`` in train mode, jitted, with
``capture_intermediates`` and a method interceptor that records each
module's input; the same forward run op by op (``jax.disable_jit``); the
port's ``compute_view(GRN, bf16)`` in train mode with forward hooks.  At
each point (the front end's four convs before and after their ELU, the
c-major flatten, ``conv1d_in``'s product and its bias add, ``bn_in``'s
batch mean, variance and output, each GLU block, the head, the mask) it
prints port vs jitted JAX and op-by-op JAX vs jitted JAX, each as a
relative RMS and as the largest difference in bf16 ulps (of the larger
magnitude of the two values), and marks the first point where the port's
relative RMS exceeds 1.5x JAX's own (``departs``; a point where JAX's two
runs agree bit for bit departs at any difference).

``--ops`` adds each op alone on JAX's jitted input at that point (the same
bits into both packages): the port's op against JAX's jitted and op-by-op
op, which tells an op that computes differently from a difference it
inherits.

``step``: the test's whole step (``step_pair``), port and JAX's own spread
samples against JAX's jitted step, in the test's terms (``step_report``):
JAX op by op, JAX on the input times ``1 + 1e-7 N(0, 1)``, and JAX jitted
from :func:`reordered`'s parameters (the same step with the front end's
sums in another order), its result put back in the original channel
order; then the gradient's relative L2 module by module for each.

``bn``: where JAX's jitted program rounds a conv's bias add before the
BatchNorm after it.  In the jitted train forward and in the jitted
gradient of a loss on it, each of GRN's 76 BatchNorms' output against
flax's BatchNorm computed alone (relative RMS)
on the captured conv output (the bias add rounded to bf16, as the port and
flax's module boundary round it) and on the rounded product plus the bias
in float32 (the add not rounded): on the trainer's state at the step's
input (its conv biases are 0, so the two agree), on that state with the
conv biases of ``tests/test_torch_bf16_train.py``'s variables, and on those
variables at ``tests/test_torch_bf16_grn_front.py``'s B = 8, 48 frames.

``ops``: the numbers of ``tests/test_torch_bf16_grn_front.py``: for each
front-end product it holds, the port's distance from JAX's op, JAX's four
reordered samples, the bound, and each wrong port's distance.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONT = ("dila1", "dila2", "dila3", "dila4")
HEAD = ("conv1d_3", "bn3", "conv1d_4", "bn4", "conv1d_5", "bn5")
SEEDS = (1, 2)


def _setup():
    """(JAX trainer, port trainer, JAX's noisy magnitude, the port's)."""
    import jax
    import jax.numpy as jnp
    import torch

    from prior_diffuse_tpu.training.base import mag_features as jmag
    from prior_diffuse_tpu_torch.training.base import mag_features
    from test_torch_bf16_train_step import batch_of, trainers, write_corpus

    tmp = tempfile.mkdtemp()
    corpus = write_corpus(f"{tmp}/corpus")
    jtr, tr = trainers("mag-GRN", tmp, corpus)
    batch = batch_of(corpus)
    feat = np.asarray(jax.jit(lambda w: jmag(w, jtr.cfg)[0])(jnp.asarray(batch.noisy)))
    with torch.no_grad():
        port_feat = mag_features(torch.from_numpy(batch.noisy), tr.cfg)[0].numpy()
    return jtr, tr, feat, port_feat


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def ulps(got, want) -> float:
    """The largest ``|got - want|`` in bf16 ulps of the larger magnitude."""
    a = np.abs(np.asarray(got, np.float64))
    b = np.abs(np.asarray(want, np.float64))
    big = np.maximum(np.maximum(a, b), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    return float((np.abs(np.asarray(got, np.float64) - want) / ulp).max())


def _f32(a) -> np.ndarray:
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def reordered(params, seed: int):
    """``(params, perms)``: GRN's parameters with the front end's hidden
    channels (``dila1``-``dila4``'s outputs, and ``conv1d_in``'s input
    channels in blocks of 161, as the c-major flatten takes them) permuted
    by permutations drawn from ``seed``.  The network computes the same
    function; each conv after ``dila1`` sums its input channels in another
    order."""
    g = np.random.default_rng(seed)
    p = {k: dict(v) for k, v in params.items()}
    perms, prev = {}, None
    for name in FRONT:
        k = np.asarray(p[name]["kernel"])
        if prev is not None:
            k = k[:, :, prev, :]
        perm = g.permutation(k.shape[-1])
        p[name] = {"kernel": k[..., perm], "bias": np.asarray(p[name]["bias"])[perm]}
        perms[name] = prev = perm
    k = np.asarray(p["conv1d_in"]["kernel"])
    p["conv1d_in"] = {**p["conv1d_in"],
                      "kernel": k.reshape(1, len(prev), -1, k.shape[-1])[:, prev].reshape(k.shape)}
    return p, perms


def restored(tree: dict, perms: dict) -> dict:
    """A tree shaped as GRN's parameters (its gradient, its Adam moments)
    from :func:`reordered`'s network, in the original channel order."""
    t = {k: dict(v) for k, v in tree.items()}
    prev = None
    for name in FRONT:
        inv = np.argsort(perms[name])
        k = np.asarray(t[name]["kernel"])[..., inv]
        if prev is not None:
            k = k[:, :, np.argsort(prev), :]
        t[name] = {"kernel": k, "bias": np.asarray(t[name]["bias"])[inv]}
        prev = perms[name]
    k = np.asarray(t["conv1d_in"]["kernel"])
    t["conv1d_in"] = {**t["conv1d_in"], "kernel": k.reshape(1, len(prev), -1, k.shape[-1])[
        :, np.argsort(prev)].reshape(k.shape)}
    return t


def product(x, k):
    """A kernel-1 ``conv1d``'s product in bf16 (flax's ``Conv`` at
    ``dtype=bfloat16`` without its bias add), channels last."""
    import jax
    import jax.numpy as jnp

    bf16 = jnp.bfloat16
    return jax.lax.conv_general_dilated(x.astype(bf16), k.astype(bf16), (1,), "VALID",
                                        dimension_numbers=("NWC", "WIO", "NWC"))


def jax_points(jtr, feat, eager: bool = False, seed: int = None) -> dict:
    """``{point: array}`` of JAX's bf16 train forward (channels last), op
    by op if ``eager``; on :func:`reordered`'s parameters if ``seed`` is
    given, its points put back in the original channel order."""
    import jax
    import jax.numpy as jnp

    from test_torch_bf16_grn_front import captured

    state = jtr.state["model"]
    params, perms = state["params"], None
    if seed is not None:
        params, perms = reordered(jax.tree.map(np.asarray, params), seed)
    variables = {"params": params, "batch_stats": state["batch_stats"]}
    y, new, mid = captured(jtr.model, variables, feat, eager)
    old = jax.tree.map(np.asarray, state["batch_stats"])
    new = jax.tree.map(np.asarray, new)

    def out(*path):
        node = mid
        for p in path:
            node = node[p]
        return node["__call__"][0]

    def inp(*path):
        node = mid
        for p in path:
            node = node[p]
        return node["input"][0]

    pts = {}
    for i, name in enumerate(FRONT):
        pts[name] = out(name)
        pts[f"{name} elu"] = inp(FRONT[i + 1]) if i + 1 < len(FRONT) else None
    flat = inp("conv1d_in")
    b, t, cf = flat.shape
    pts["dila4 elu"] = flat.reshape(b, t, 32, cf // 32).transpose(0, 1, 3, 2)
    pts["flatten"] = flat

    if eager:
        with jax.disable_jit():
            pts["conv1d_in product"] = product(flat, params["conv1d_in"]["kernel"])
    else:
        pts["conv1d_in product"] = jax.jit(product)(flat, params["conv1d_in"]["kernel"])
    pts["conv1d_in"] = out("conv1d_in")
    for key in ("mean", "var"):  # the batch's, from the running statistics' move
        pts[f"bn_in {key}"] = (new["bn_in"]["BatchNorm_0"][key]
                               - 0.9 * old["bn_in"]["BatchNorm_0"][key]) / 0.1
    pts["bn_in"] = out("bn_in")
    for g in range(3):
        for i in range(6):
            pts[f"glu_{g}_{i}"] = out(f"glu_{g}_{i}")[0]
    pts["sum of blocks"] = inp("conv1d_3")
    for name in HEAD:
        pts[name] = out(name)
    pts["mask"] = jax.nn.sigmoid(pts["bn5"])
    pts["output"] = y
    pts = {k: _f32(v) for k, v in pts.items()}
    if perms is not None:
        for name in FRONT:
            for key in (name, f"{name} elu"):
                pts[key] = pts[key][..., np.argsort(perms[name])]
        b, t, cf = pts["flatten"].shape
        c = len(perms["dila4"])
        pts["flatten"] = pts["flatten"].reshape(b, t, c, cf // c)[:, :, np.argsort(
            perms["dila4"])].reshape(b, t, cf)
    return pts


def port_points(tr, feat) -> dict:
    """:func:`jax_points` of the port's ``compute_view`` (channels last)."""
    import torch

    from prior_diffuse_tpu_torch.models import layers as tl
    from prior_diffuse_tpu_torch.models.precision import compute_view

    old = {k: v.clone() for k, v in tr.model.state_dict().items()}
    view = compute_view(tr.model, torch.bfloat16).train()
    seen = {}
    hooks = [m.register_forward_hook(lambda m, a, o, n=n: seen.__setitem__(n, (a[0], o)))
             for n, m in view.named_children()]
    with torch.no_grad():
        y = view(torch.from_numpy(feat.copy()))
    for h in hooks:
        h.remove()
    last = lambda a: a.detach().double().movedim(1, -1).numpy()  # noqa: E731
    pts = {}
    for name in FRONT:
        pts[name] = last(seen[name][1])
        pts[f"{name} elu"] = last(torch.nn.functional.elu(seen[name][1]))
    pts["flatten"] = last(seen["conv1d_in"][0])
    m = tr.model.conv1d_in
    pts["conv1d_in product"] = last(m._conv_forward(seen["conv1d_in"][0].bfloat16(),
                                                    m.weight.bfloat16(), None))
    pts["conv1d_in"] = last(seen["conv1d_in"][1])
    sd = tr.model.state_dict()
    for key in ("mean", "var"):
        now, before = sd[f"bn_in.running_{key}"], old[f"bn_in.running_{key}"]
        pts[f"bn_in {key}"] = ((now - 0.9 * before) / 0.1).double().numpy()
    pts["bn_in"] = last(seen["bn_in"][1])
    for g in range(3):
        for i in range(6):
            pts[f"glu_{g}_{i}"] = last(seen[f"glu_{g}_{i}"][1][0])
    pts["sum of blocks"] = last(seen["conv1d_3"][0])
    for name in HEAD:
        pts[name] = last(seen[name][1])
    pts["mask"] = last(tl.sigmoid(seen["bn5"][1]))
    pts["output"] = y.float().double().numpy()
    tr.model.load_state_dict(old)
    return pts


ORDER = ("dila1", "dila1 elu", "dila2", "dila2 elu", "dila3", "dila3 elu", "dila4",
         "dila4 elu", "flatten", "conv1d_in product", "conv1d_in", "bn_in mean", "bn_in var",
         "bn_in", *(f"glu_{g}_{i}" for g in range(3) for i in range(6)), "sum of blocks",
         *HEAD, "mask", "output")


def op_rows(jtr, tr, feat, jit_pts) -> list:
    """``--ops``: each op alone on JAX's jitted input at its point."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F

    from prior_diffuse_tpu.models import layers as jl
    from prior_diffuse_tpu_torch.models.precision import compute_view

    bf16 = jnp.bfloat16
    params = jtr.state["model"]["params"]
    stats = jtr.state["model"]["batch_stats"]
    view = compute_view(tr.model, torch.bfloat16).train()
    old = {k: v.clone() for k, v in tr.model.state_dict().items()}
    dil = {"dila1": (1, 1), "dila2": (1, 1), "dila3": (1, 2), "dila4": (1, 4)}
    rows = []

    def jax_pair(fn, *args):
        jitted = _f32(jax.jit(fn)(*args))
        with jax.disable_jit():
            eager = _f32(fn(*args))
        return jitted, eager

    def row(label, port, jitted, eager, reach=None):
        """``reach``: a conv's padding (T, F); the differing elements whose
        window reaches into the zero padding are counted apart."""
        differ = port != jitted
        border = ""
        if reach is not None:
            edge = np.zeros(differ.shape, bool)
            (pt, pf), (t, f) = reach, differ.shape[1:3]
            edge[:, :pt] = edge[:, t - pt:] = edge[:, :, :pf] = edge[:, :, f - pf:] = True
            border = f"{int((differ & edge).sum())} of {int(edge.sum())}"
        rows.append((label, rel_rms(port, jitted), ulps(port, jitted), rel_rms(eager, jitted),
                     ulps(eager, jitted), f"{int(differ.sum())} of {differ.size}", border))

    for i, name in enumerate(FRONT):
        x = (jnp.asarray(feat)[..., None] if i == 0
             else jnp.asarray(jit_pts[f"{FRONT[i - 1]} elu"], bf16))
        pad = tuple((d * 2, d * 2) for d in dil[name])
        conv = jl.conv2d(params[name]["kernel"].shape[-1], (5, 5), dilation=dil[name],
                         padding=pad, dtype=bf16)
        jitted, eager = jax_pair(lambda v, x: conv.apply(v, x), {"params": params[name]}, x)
        with torch.no_grad():
            port = getattr(view, name)(torch.from_numpy(np.array(x, np.float32)).movedim(-1, 1)
                                       .bfloat16())
        row(f"{name} op", port.float().movedim(1, -1).numpy(), jitted, eager,
            reach=tuple(p[0] for p in pad))
        xb = jnp.asarray(jit_pts[name], bf16)
        jitted, eager = jax_pair(jax.nn.elu, xb)
        port = F.elu(torch.from_numpy(jit_pts[name]).float().bfloat16()).float().numpy()
        row(f"{name} elu op", port, jitted, eager)
    x = jnp.asarray(jit_pts["flatten"], bf16)
    conv = jl.conv1d(256, 1, dtype=bf16)
    jitted, eager = jax_pair(lambda v, x: conv.apply(v, x), {"params": params["conv1d_in"]}, x)
    with torch.no_grad():
        port = view.conv1d_in(torch.from_numpy(np.array(x, np.float32)).movedim(-1, 1)
                              .bfloat16())
    row("conv1d_in op", port.float().movedim(1, -1).numpy(), jitted, eager)
    x = jnp.asarray(jit_pts["conv1d_in"], bf16)
    bn = jl.BatchNorm(use_running_average=False, dtype=bf16)
    bnv = {"params": {"BatchNorm_0": params["bn_in"]["BatchNorm_0"]},
           "batch_stats": {"BatchNorm_0": stats["bn_in"]["BatchNorm_0"]}}
    jitted, eager = jax_pair(lambda v, x: bn.apply(v, x, mutable=["batch_stats"])[0], bnv, x)
    with torch.no_grad():
        port = view.bn_in(torch.from_numpy(np.array(x, np.float32)).movedim(-1, 1).bfloat16())
    row("bn_in op", port.float().movedim(1, -1).numpy(), jitted, eager)
    tr.model.load_state_dict(old)
    return rows


def forward(ops: bool) -> None:
    """``forward``'s table."""
    jtr, tr, feat, port_feat = _setup()
    print(f"input: port's magnitude vs JAX's relative RMS {rel_rms(port_feat, feat):.3e}, "
          f"{ulps(port_feat, feat):.1f} ulps (both packages are fed JAX's)", flush=True)
    jit_pts = jax_points(jtr, feat)
    eager_pts = jax_points(jtr, feat, eager=True)
    moved = [jax_points(jtr, feat, seed=s) for s in SEEDS]
    port_pts = port_points(tr, feat)
    print("relative RMS against JAX's jitted forward, and the largest difference in bf16 "
          f"ulps; 'reordered': JAX jitted on reordered() parameters, the larger of seeds {SEEDS}")
    print(f"{'point':<18} {'port':>10} {'ulps':>6} {'op-by-op':>10} {'ulps':>6} "
          f"{'reordered':>10} {'ulps':>6}  port/op-by-op", flush=True)
    departed = False
    for name in ORDER:
        p, e, w = port_pts[name], eager_pts[name], jit_pts[name]
        assert p.shape == w.shape == e.shape, (name, p.shape, w.shape, e.shape)
        pr, er = rel_rms(p, w), rel_rms(e, w)
        rr = max(rel_rms(m[name], w) for m in moved)
        ru = max(ulps(m[name], w) for m in moved)
        ratio = pr / er if er else (np.inf if pr else 1.0)
        mark = ""
        if not departed and ratio > 1.5:
            departed, mark = True, "  <- departs"
        print(f"{name:<18} {pr:10.3e} {ulps(p, w):6.1f} {er:10.3e} {ulps(e, w):6.1f} "
              f"{rr:10.3e} {ru:6.1f}  {ratio:6.2f}{mark}", flush=True)
    if ops:
        print("each op alone on JAX's jitted input (port, op-by-op JAX: vs jitted JAX; the "
              "port's elements that differ, and those of them whose window reaches into the "
              "zero padding):", flush=True)
        for label, pr, pu, er, eu, differ, border in op_rows(jtr, tr, feat, jit_pts):
            print(f"{label:<18} {pr:10.3e} {pu:6.1f} {er:10.3e} {eu:6.1f}  {differ:>16}  "
                  f"{border}", flush=True)


def step() -> None:
    """``step``'s table."""
    import types

    import jax
    import jax.numpy as jnp

    from test_torch_bf16_train_step import jax_run, step_pair, step_report
    from test_torch_train_step import _adam

    pair = step_pair("mag-GRN", tempfile.mkdtemp())
    jtr = pair["jtr"]
    runs = [("port", pair["got"]), ("op-by-op", pair["eager"]())]
    runs += [(f"input x 1+1e-7 N, seed {s}", pair["perturbed"](s)) for s in SEEDS]
    for seed in SEEDS:
        start = jax.tree.map(np.asarray, pair["start"])
        params, perms = reordered(start["model"]["params"], seed)
        state = jax.tree.map(jnp.asarray, {**start, "model": {**start["model"], "params": params}})
        new, loss, gnorms = jtr._train_step(state, *pair["arrays"])
        new = jax.tree.map(np.asarray, new)
        adam = _adam(new["opt"])
        moments = adam._replace(mu=restored(adam.mu, perms), nu=restored(adam.nu, perms))
        back = {"model": {"params": restored(new["model"]["params"], perms),
                          "batch_stats": new["model"]["batch_stats"]},
                "opt": types.SimpleNamespace(inner_state=[moments])}
        runs.append((f"reordered, seed {seed}", jax_run("mag-GRN", back, [loss], gnorms)))
    print("one bf16 MagTrainer step, against JAX's jitted step (step_report's terms):")
    for label, run in runs:
        print(f"{label:<26} " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in step_report(pair, run).items()),
              flush=True)
    # the gradient's relative L2 module by module, in the forward's order
    leaves = jax.tree_util.tree_flatten_with_path(pair["start"]["model"]["params"])[0]
    module = np.concatenate([np.full(np.size(v), jax.tree_util.keystr(p[:1]))
                             for p, v in leaves])
    want = pair["want"]["grads"]["model"]
    print(f"{'module':<12} " + " ".join(f"{label.split(',')[0][:14]:>14}" for label, _ in runs)
          + "  (gradient, relative L2)")
    for name in ("dila1", "dila2", "dila3", "dila4", "conv1d_in", "bn_in",
                 *(f"glu_{g}_{i}" for g in range(3) for i in range(6)), *HEAD):
        sel = module == f"['{name}']"
        dist = [np.linalg.norm(run["grads"]["model"][sel] - want[sel])
                / np.linalg.norm(want[sel]) for _, run in runs]
        print(f"{name:<12} " + " ".join(f"{d:14.3e}" for d in dist), flush=True)


def bn() -> None:
    """``bn``'s table."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from prior_diffuse_tpu.models import layers as jl
    from test_torch_bf16_grn_front import SHAPE, captured, record_inputs
    from test_torch_bf16_train import make_model
    from test_torch_priors import speclike

    def alone(scale, x):
        """flax's train-mode BatchNorm at dtype bf16 on ``x``, jitted alone."""
        bn = jl.BatchNorm(use_running_average=False, dtype=jnp.bfloat16)
        return _f32(jax.jit(lambda v, x: bn.apply(v, x, mutable=["batch_stats"])[0])(
            {"params": {"BatchNorm_0": scale}, "batch_stats": {"BatchNorm_0": {
                "mean": jnp.zeros(x.shape[-1]), "var": jnp.ones(x.shape[-1])}}}, x))

    def pairs(mid, params):
        """Per conv -> BatchNorm pair: (the conv's kind, distance from BN
        alone on the rounded conv output, from BN alone on the rounded
        product plus the bias in float32)."""
        rows = [((), c, b) for c, b in (("conv1d_in", "bn_in"), ("conv1d_3", "bn3"),
                                        ("conv1d_4", "bn4"), ("conv1d_5", "bn5"))]
        rows += [((f"glu_{g}_{i}",), c, b) for g in range(3) for i in range(6)
                 for c, b in (("in_conv", "in_bn"), ("out_conv", "out_bn"))]
        for path, conv, norm in rows:
            node, p = mid, params
            for key in path:
                node, p = node[key], p[key]
            want = _f32(node[norm]["__call__"][0])
            scale = p[norm]["BatchNorm_0"]
            unrounded = (jax.jit(product)(node[conv]["input"][0], p[conv]["kernel"])
                         .astype(jnp.float32)
                         + jnp.asarray(p[conv]["bias"]).astype(jnp.bfloat16).astype(jnp.float32))
            yield ("a Conv module's", rel_rms(want, alone(scale, node[conv]["__call__"][0])),
                   rel_rms(want, alone(scale, unrounded)))
        for g in range(3):  # the fused left / right convs of each block
            for i in range(6):
                node, p, d = mid[f"glu_{g}_{i}"], params[f"glu_{g}_{i}"], 2 ** i
                a = jax.nn.elu(node["in_bn"]["__call__"][0])
                for half, norm in enumerate(("left", "right")):
                    k = p[f"{norm}_conv"]["kernel"]
                    y = jax.jit(lambda a, k: jax.lax.conv_general_dilated(
                        a.astype(jnp.bfloat16), k.astype(jnp.bfloat16), (1,),
                        ((3 * d, 3 * d),), rhs_dilation=(d,),
                        dimension_numbers=("NWC", "WIO", "NWC")))(a, k)
                    b = jnp.asarray(p[f"{norm}_conv"]["bias"]).astype(jnp.bfloat16)
                    scale = p[f"{norm}_bn"]["BatchNorm_0"]
                    want = _f32(node[f"{norm}_bn"]["__call__"][0])
                    yield ("conv_pair_fused's", rel_rms(want, alone(scale, y + b)),
                           rel_rms(want, alone(scale, y.astype(jnp.float32)
                                               + b.astype(jnp.float32))))

    jtr, _, feat, _ = _setup()
    jm, _, variables, _, _ = make_model("GRN")
    state = {"params": jtr.state["model"]["params"],
             "batch_stats": jtr.state["model"]["batch_stats"]}
    biased = jax.tree.map(np.asarray, state)
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith("['bias']") and "conv" in key:
            node = biased["params"]
            for key in path[:-1]:
                node = node[key.key]
            node["bias"] = np.asarray(leaf)
    runs = [("the trainer's state (its conv biases 0)", state, feat),
            ("the trainer's state, conv biases of test_torch_bf16_train.py", biased, feat),
            ("test_torch_bf16_train.py's variables", variables,
             np.abs(speclike((*SHAPE, 161), 1)))]
    for label, v, x in runs:
        def loss(params, x):
            with nn.intercept_methods(record_inputs):
                y, aux = jtr.model.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                         train=True, capture_intermediates=True,
                                         mutable=["batch_stats", "intermediates"])
            return jnp.mean(y.astype(jnp.float32) ** 2), aux["intermediates"]

        (_, grad_mid), _ = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"],
                                                                           jnp.asarray(x))
        for program, mid in (("forward", captured(jtr.model, v, x)[2]),
                             ("gradient", grad_mid)):
            rows = list(pairs(mid, v["params"]))
            for kind in ("a Conv module's", "conv_pair_fused's"):
                sel = [r for r in rows if r[0] == kind]
                print(f"{label}, B, T = {x.shape[:2]}, the jitted {program}: the {len(sel)} "
                      f"BatchNorms after {kind} output vs flax's BatchNorm alone on the bias add "
                      f"rounded {min(r[1] for r in sel):.3e} .. {max(r[1] for r in sel):.3e}, "
                      f"not rounded {min(r[2] for r in sel):.3e} .. "
                      f"{max(r[2] for r in sel):.3e}", flush=True)


def ops() -> None:
    """``ops``' table."""
    import torch

    import test_torch_bf16_grn_front as t
    from test_torch_bf16_train import make_model
    from test_torch_priors import speclike

    jm, _, variables, tm, _ = make_model("GRN")
    _, _, mid = t.captured(jm, variables, np.abs(speclike((*t.SHAPE, 161), 1)))
    view = t.compute_view(tm, torch.bfloat16).train()
    for name in t.OPS:
        x, want = mid[name]["input"][0], t._f32(mid[name]["__call__"][0])
        samples = [rel_rms(t._f32(t.reordered_op(name, variables["params"][name], x, s)), want)
                   for s in t.SEEDS]
        with torch.no_grad():
            port = rel_rms(t._from_port(getattr(view, name)(t._to_port(x))), want)
            wrong = {w: rel_rms(t._from_port(t.wrong_port(getattr(view, name).layer,
                                                          t._to_port(x), w)), want)
                     for w in t.WRONG}
        print(f"{name}: port {port:.3e}; JAX reordered " + ", ".join(f"{v:.3e}" for v in samples)
              + f"; bound {2 * max(samples):.3e}; " + ", ".join(f"{w} {v:.3e}"
                                                                for w, v in wrong.items()),
              flush=True)


def main(argv=None) -> None:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(min(2, torch.get_num_threads()))
    args = list(argv if argv is not None else sys.argv[1:])
    mode = args.pop(0) if args and not args[0].startswith("--") else "forward"
    if mode == "forward":
        forward("--ops" in args)
    elif mode == "step":
        step()
    elif mode == "bn":
        bn()
    elif mode == "ops":
        ops()
    else:
        raise SystemExit(f"unknown mode {mode!r}: forward, step, bn or ops")


if __name__ == "__main__":
    main()
