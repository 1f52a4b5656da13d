#!/usr/bin/env python3
"""Which parts of a prior run in float32 when the JAX package serves it in
bfloat16, and how close the port's bf16 serving copy comes to it.

    python3 tools/bf16_trace.py [GCRN aia_complex_trans_ri ...]
    python3 tools/bf16_trace.py --train [NAME ...]
    python3 tools/bf16_trace.py --parity [NAME ...]
    python3 tools/bf16_trace.py --sensitivity
    python3 tools/bf16_trace.py --bn [NAME ...]

The JAX package serves a prior in ``serve_dtype`` bfloat16 by casting every
parameter and BatchNorm statistic to bf16 and feeding a bf16 input
(``training/ddpm_trainer.py``, ``_dis_apply``; ``serving/enhance.py::
prior_only_server``); each op then runs in the promotion of its operands'
dtypes.  This script traces that forward with ``jax.make_jaxpr`` (CPU, a
4-frame input) and prints, for each module of the prior, the operand and
result dtypes of its products (``dot_general``), convolutions, reductions,
``rsqrt``, ``exp`` and activations, the scan bodies of the recurrences
under the module that runs the scan.  The port's
``serving/enhancer.py::serving_copy`` mirrors the table this gives
(PERF.md, §6).  Needs the JAX package (not the port's card machine).

``--train``: the policy of bf16 *training* (``train.compute_dtype:
bfloat16``), which is another than serving's: the trainers build each
model with ``dtype=bfloat16`` and keep its parameters float32
(``training/ddpm_trainer.py:148-161``, ``complex_trainer.py:36-45``,
``mag_trainer.py:41-50``), so flax casts a weight inside the op of a module
that has a ``dtype`` field and promotes the rest.  For each model
(``DiffUNet``, ``DiffUNet1``, ``Nocon``, ``GCRN``, the four DB-AIAT
variants, ``GRN``) it traces the train-mode forward (``train=True``,
``mutable=["batch_stats"]``) and the eval-mode one on float32 variables,
and for the DiffUNet family also ``models/fused_forward.py::
dual_train_forward``, the bf16 train forward the DDPM trainer takes; rows
whose operands include an f32 product or convolution mark the weights that
enter an op unrounded.  The port's ``models/precision.py::compute_view``
follows this table (PERF.md, §6).

``--parity``: for each prior, on the perturbed variables and the input of
``tests/test_torch_priors.py`` (B = 2, T = 12), the relative RMS of the
port's bf16 serving copy against JAX's jitted bf16 forward and against the
same forward run op by op (``jax.disable_jit``: every op rounded to its
dtype), of those two JAX runs against each other, and of JAX's bf16
against its f32 forward (a few minutes: the op-by-op runs are slow).

``--bn``: which train-mode BatchNorms of JAX's jitted bf16-compute train
forward read their bf16 input as it is.  For each model of ``--train`` (and
``dual_train_forward`` for the DiffUNet family), on the variables and
inputs of ``tests/test_torch_bf16_train.py`` (B = 2, T = 12; non-zero conv
biases), every BatchNorm's output is compared with the same flax BatchNorm
run alone, jitted, on the bf16 input the forward fed it (relative RMS):
0 where the program rounded that input to bf16 first, as the port does;
about 1e-3 or more where XLA kept the producer's last add in float32 (a
flax module's output rounding dropped inside a fusion).

``--sensitivity``: with ``chip_smoke.py``'s seeded weights (the port only),
how far the bf16 prior-only server and the bf16 enhancer (GCRN and
``aia_complex_trans_ri`` priors, 2 x 1 s, one ``x_T``) move when the STFT's
output is multiplied by ``1 + 1e-7 N(0, 1)``: the size of a kernel's
float32 rounding against its plain version.
"""

from __future__ import annotations

import os
import re
import sys
from collections import defaultdict

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("dot_general", "conv_general_dilated", "reduce_sum", "reduce_max", "rsqrt", "exp",
       "logistic", "tanh", "div", "sqrt", "atan2")
SHORT = {"float32": "f32", "bfloat16": "bf16", "int32": "i32"}


def _walk(jaxpr, outer: str, rows) -> None:
    for e in jaxpr.eqns:
        path = str(e.source_info.name_stack) or outer
        for p in e.params.values():
            for q in p if isinstance(p, (list, tuple)) else [p]:
                inner = getattr(q, "jaxpr", q)
                if hasattr(inner, "eqns"):
                    _walk(inner, path, rows)
        if e.primitive.name in OPS:
            ins = ",".join(SHORT.get(str(v.aval.dtype), str(v.aval.dtype)) for v in e.invars)
            out = SHORT.get(str(e.outvars[0].aval.dtype), str(e.outvars[0].aval.dtype))
            # one row per module kind: layer and group indices collapsed
            key = re.sub(r"\d+", "#", re.sub(r"/(BatchNorm|LayerNorm)_0", "", path))
            key = re.sub(r"/[a-z]+,[a-z]+->[a-z]+", "", key)  # einsum names
            rows[key].add(f"{e.primitive.name}({ins})->{out}")


def trace(name: str, variables=None) -> dict:
    """``{module path: {op(operand dtypes)->result dtype}}`` of the bf16
    serving forward of the prior registered as ``name`` (on ``variables``,
    by default its own init)."""
    import jax
    import jax.numpy as jnp

    import prior_diffuse_tpu.models  # noqa: F401  (registers the models)
    from prior_diffuse_tpu.registry import MODELS

    model = MODELS.get(name)()
    x = jnp.zeros((1, 4, 161, 2), jnp.float32)
    if variables is None:
        variables = model.init(jax.random.PRNGKey(0), x)
    cast = jax.tree.map(lambda p: p.astype(jnp.bfloat16), variables)
    closed = jax.make_jaxpr(lambda v, x: model.apply(v, x, train=False))(
        cast, x.astype(jnp.bfloat16))
    rows = defaultdict(set)
    _walk(closed.jaxpr, name, rows)
    return rows


TRAIN_MODELS = ("DiffUNet", "DiffUNet1", "Nocon", "GCRN", "aia_complex_trans_ri",
                "aia_complex_trans_mag", "dual_aia_complex_trans",
                "dual_aia_trans_merge_crm", "GRN")


def train_trace(name: str, train: bool = True, dual: bool = False) -> dict:
    """``{module path: {op(operand dtypes)->result dtype}}`` of the
    bf16-compute forward of ``name`` on float32 variables (its own init):
    train mode with mutable BatchNorm statistics, or eval mode; ``dual``
    traces ``dual_train_forward`` (the DiffUNet family only)."""
    import jax
    import jax.numpy as jnp

    import prior_diffuse_tpu.models  # noqa: F401  (registers the models)
    from prior_diffuse_tpu.models.fused_forward import dual_train_forward
    from prior_diffuse_tpu.registry import MODELS

    bf16 = jnp.bfloat16
    kw = {"num_steps": 50} if name in ("DiffUNet1", "Nocon") else {}
    model = MODELS.get(name)(dtype=bf16, **kw)
    x = jnp.zeros((1, 4, 161) if name == "GRN" else (1, 4, 161, 2), jnp.float32)
    t = jnp.full((1,), 3.5, jnp.float32)
    args = {"DiffUNet1": (x, x, t), "Nocon": (x, t)}.get(name, (x,))
    variables = model.init(jax.random.PRNGKey(0), *args)
    if dual:
        kw = {"DiffUNet1": dict(x_init=x, t=t), "Nocon": dict(t=t)}.get(name, {})
        fn = lambda v, *a: dual_train_forward(v, x, dtype=bf16, **kw)  # noqa: E731
    else:
        fn = lambda v, *a: model.apply(  # noqa: E731
            v, *a, train=train, mutable=["batch_stats"] if train else False)
    closed = jax.make_jaxpr(fn)(variables, *args)
    rows = defaultdict(set)
    _walk(closed.jaxpr, name, rows)
    return rows


def bn_rounding(name: str, dual: bool = False) -> list:
    """``--bn``'s rows for ``name``: ``(BatchNorm path, relative RMS of its
    output from the BatchNorm alone on its bf16 input)``."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from prior_diffuse_tpu.models.fused_forward import dual_train_forward
    from test_torch_bf16_train import make_model

    jm, _, variables, _, args = make_model(name)
    seen = []

    def icpt(next_fun, a, kw, context):
        out = next_fun(*a, **kw)
        m = context.module
        if (context.method_name == "__call__" and isinstance(m, nn.BatchNorm)
                and not m.use_running_average and a[0].dtype == jnp.bfloat16):
            seen.append(("/".join(m.path), m.clone(parent=None), a[0], out,
                         m.variables["params"]))
        return out

    def fwd(v, *a):
        seen.clear()
        with nn.intercept_methods(icpt):
            if dual:
                x, rest = a[0], dict(zip(("x_init", "t") if len(a) == 3 else ("t",), a[1:]))
                dual_train_forward(v, x, dtype=jnp.bfloat16, num_steps=50, **rest)
            else:
                jm.apply(v, *a, train=True, mutable=["batch_stats"])
        return [(x, y, p) for _, _, x, y, p in seen]

    outs = jax.jit(fwd)(variables, *[jnp.asarray(a) for a in args])
    rows = []
    for (path, bn, *_), (x, y, params) in zip(seen, outs):
        stats = {"mean": jnp.zeros(x.shape[-1]), "var": jnp.ones(x.shape[-1])}
        alone = jax.jit(lambda v, x: bn.apply(v, x, mutable=["batch_stats"])[0])(
            {"params": params, "batch_stats": stats}, x)
        f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
        rows.append((path, _rel_rms(f32(y), f32(alone))))
    return rows


def _print_rows(rows) -> None:
    for path, ops in sorted(rows.items()):
        f32 = any("f32" in op.split("->")[0] for op in ops)
        print(f"{'f32 ' if f32 else 'bf16'}  {path}: {'; '.join(sorted(ops))}")


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def parity(name: str) -> dict:
    """The distances of ``--parity`` for the prior ``name``."""
    import jax
    import jax.numpy as jnp
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from prior_diffuse_tpu_torch.serving.enhancer import serving_copy
    from test_torch_priors import make_prior, speclike

    jm, variables, tm = make_prior(name, seed=len(name))
    x = speclike((2, 12, 161, 2), 1)
    cast = jax.tree.map(lambda p: jnp.asarray(p).astype(jnp.bfloat16), variables)
    apply = lambda v, x: jm.apply(v, x, train=False)  # noqa: E731
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    jit = f32(jax.jit(apply)(cast, xb))
    with jax.disable_jit():
        eager = f32(apply(cast, xb))
    exact = f32(jax.jit(apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        port = serving_copy(tm, torch.bfloat16)(torch.from_numpy(x).bfloat16()).float().numpy()
    return {"port_vs_jit": _rel_rms(port, jit), "port_vs_op_by_op": _rel_rms(port, eager),
            "jit_vs_op_by_op": _rel_rms(jit, eager), "jax_bf16_vs_f32": _rel_rms(jit, exact)}


def sensitivity() -> None:
    """``--sensitivity``'s table."""
    import torch

    import chip_smoke as cs
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.serving.enhance import prior_only_server
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    torch.set_grad_enabled(False)
    cpu = torch.device("cpu")
    ddpm = cs.seeded_nets(0, cpu)[1]
    priors = cs.prior_nets(cpu)
    wav = cs.speechlike(2, 16000, 3)
    x_T = torch.randn((1, 2, 101, 161, 2), generator=torch.Generator().manual_seed(7))
    plain = kstft.stft

    def perturbed(w):
        s = plain(w)
        return s * (1 + 1e-7 * torch.randn(s.shape, generator=torch.Generator().manual_seed(5)))

    for name in ("GCRN", "aia_complex_trans_ri"):
        enh = Enhancer(priors[name], ddpm, cs.mode_config("pirorgrad"), device=cpu,
                       dtype=torch.bfloat16)
        server = prior_only_server(enh)
        runs = []
        for stft in (plain, perturbed):
            kstft.stft = stft
            runs.append((server.enhance_batch(wav), enh.enhance_batch(wav, x_T=x_T)))
        kstft.stft = plain
        print(f"{name}: the STFT times 1 + 1e-7 N(0, 1) moves the bf16 prior-only waveform "
              f"{_rel_rms(runs[1][0], runs[0][0]):.3e} and the bf16 enhancer's "
              f"{_rel_rms(runs[1][1], runs[0][1]):.3e} (relative RMS)", flush=True)


def main(argv=None) -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    args = list(argv if argv is not None else sys.argv[1:])
    mode = args.pop(0) if args and args[0].startswith("--") else "--trace"
    if mode == "--sensitivity":
        sensitivity()
        return
    if mode == "--bn":
        for name in args or TRAIN_MODELS:
            for dual in ((False, True) if name in ("DiffUNet", "DiffUNet1", "Nocon")
                         else (False,)):
                rows = bn_rounding(name, dual)
                kept = defaultdict(list)
                for path, dist in rows:
                    kept[dist > 1e-4].append(re.sub(r"\d+", "#", path))
                label = f"{name}{' dual_train_forward' if dual else ''}"
                print(f"{label}: {len(rows)} bf16 BatchNorms; input rounded to bf16 "
                      f"(<= 1e-4 from the BatchNorm alone): {len(kept[False])}; kept above "
                      f"bf16: {len(kept[True])} "
                      f"{sorted(set(kept[True]))}; largest "
                      f"{max((d for _, d in rows), default=0.0):.3e}", flush=True)
        return
    if mode == "--train":
        for name in args or TRAIN_MODELS:
            runs = [("train", True, False), ("eval", False, False)]
            if name in ("DiffUNet", "DiffUNet1", "Nocon"):
                runs.insert(1, ("dual_train_forward", True, True))
            for label, train, dual in runs:
                print(f"== {name}, {label}: float32 variables, dtype=bfloat16", flush=True)
                _print_rows(train_trace(name, train, dual))
        return
    names = args or ["GCRN", "aia_complex_trans_ri", "aia_complex_trans_mag",
                     "dual_aia_complex_trans", "dual_aia_trans_merge_crm"]
    if mode == "--parity":
        for name in names:
            print(f"{name}: " + ", ".join(f"{k} {v:.3e}" for k, v in parity(name).items()),
                  flush=True)
        return
    for name in names:
        print(f"== {name}: variables and input cast to bf16")
        _print_rows(trace(name))


if __name__ == "__main__":
    main()
