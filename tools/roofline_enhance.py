#!/usr/bin/env python3
"""Static roofline of the port's programs at their published shapes.

    python3 tools/roofline_enhance.py [--device cpu|cuda] [--paths NAME,...]
        [--measured-ms NAME=MS ...] [--out FILE.md] [--json FILE.json]

The counterpart of ``scripts/roofline_enhance.py``.  It builds, with seeded
weights (``chip_smoke.py``'s), the programs of ``chip_smoke.py``'s phase 13
(``roofline_paths``): the serving batch ``Enhancer.eager_batch`` (8 x 3 s,
fast-6) in f32 and bf16, ``conf/diff.yml``'s ``--joint --sigma`` train step
(6 x 48000) in f32 and bf16 compute, and the GCRN and
``aia_complex_trans_ri`` priors alone, plus GRN through ``MagServer``; it
counts each with ``utils/roofline.py`` (the kernels through their plain
versions) against the H100 SXM's entry of ``CHIP_SPECS``, and the serving
batch also by segment, as the JAX script splits it: the prior's forward,
one chain step, and within that step the encoder, the three TCMs and the
decoder (two ``Decoder`` modules in f32, the dual decoder in bf16), then
the STFT and ISTFT.  ``--measured-ms`` gives a program's measured time, for
its ``attained_fraction`` and ``mfu``.  It prints the bf16 serving
program's model FLOPs beside JAX's (``docs/PERF_r5_roofline.json``), kind
by kind, with JAX's count recomputed from the port's own shapes where the
packages formulate an op otherwise (:func:`jax_convs`, and conv1 of
encoder stages 2-5 on the causal pad frame).

``--device cpu`` (the default) counts the CPU's program: there the bf16
dual decoder's ``_mm`` widens its operands to f32 (the card reads bf16),
so its bytes and dtype classes differ from the card's, not its FLOPs.  A
count at these shapes runs the program once; a train step at 6 x 48000
keeps every activation for its backward, so count the ``train_step_*``
programs on the card (``--device cuda``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_REFERENCE = os.path.join(ROOT, "docs", "PERF_r5_roofline.json")
CONV1_F = (79, 39, 19, 9)  # the frequency bins of encoder stages 2-5's input
SERVING_FORWARDS = 7       # the prior and 6 chain steps


def conv_calls(fn, *args, **kwargs) -> list:
    """``(args, output shape)`` of each forward convolution of one run of
    ``fn`` (the kernels through their plain versions)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from prior_diffuse_tpu_torch.utils.roofline import plain_kernels

    class Convs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if func.overloadpacket is torch.ops.aten.convolution:
                self.calls.append((a, tuple(out.shape)))
            return out

    rec = Convs()
    with plain_kernels(), rec:
        fn(*args, **kwargs)
    return rec.calls


def jax_conv(args, out) -> tuple:
    """(port FLOPs, JAX FLOPs, port bytes, JAX bytes, JAX's input bytes) of
    one convolution as the port runs it and as the JAX package formulates
    it.  An ordinary one is the same op (JAX's ``_conv_cost`` counts a
    grouped one's MACs divided by the groups).  A transposed one: JAX's
    stride-(1, 2) odd-kernel one is a phase decomposition into two VALID
    convolutions over an input padded by ``kh - 1`` frames and the phase's
    taps - 1 bins, without groups (``prior_diffuse_tpu/models/
    layers.py:164-210``), any other one is lhs-dilated and counts its output
    pixels (``:211-218``); the port's counts each input pixel once."""
    x, w, stride, op, groups = args[0], args[1], tuple(args[3]), tuple(args[7]), args[8]
    isz = w.element_size()
    if not args[6]:
        fl = 2 * out[0] * math.prod(out[2:]) * w.numel()
        nbytes = isz * (x.numel() + w.numel() + math.prod(out))
        return fl, fl // groups, nbytes, nbytes, isz * x.numel()
    (b, cin, t, f), (_, cog, kh, kw) = x.shape, w.shape
    cout = cog * groups
    port = 2 * b * t * f * kh * kw * cin * cog
    pbytes = isz * (x.numel() + w.numel() + math.prod(out))
    if stride == (1, 2) and kw % 2 and op[0] == 0:
        jf = jb = jin = 0
        for taps, pad in (((kw + 1) // 2, (kw - 1) // 2), ((kw - 1) // 2, (kw - 3) // 2)):
            wo = f + 2 * pad - taps + 1
            jf += 2 * b * (t + kh - 1) * wo * kh * taps * cin * cout
            xin = isz * b * (t + 2 * kh - 2) * (f + 2 * pad) * cin
            jin += xin
            jb += xin + isz * (kh * taps * cin * cout + b * (t + kh - 1) * wo * cout)
        return port, jf, pbytes, jb, jin
    ot, of = (t - 1) * stride[0] + kh + op[0], (f - 1) * stride[1] + kw + op[1]
    return (port, 2 * b * ot * of * kh * kw * cin * cout, pbytes,
            isz * (x.numel() + cin * cout * kh * kw + b * cout * ot * of), isz * x.numel())


def jax_convs(calls, transposed=None) -> dict:
    """The port's and JAX's convolution FLOPs and bytes over ``calls`` (all,
    or the transposed ones or not); two calls in a row on one input tensor
    with one geometry are a pair that JAX runs as one (``conv_pair_fused``:
    its input read once)."""
    tot = dict(port_flops=0, jax_flops=0, port_bytes=0, jax_bytes=0)
    prev = None
    for args, out in calls:
        if transposed is not None and bool(args[6]) != transposed:
            continue
        pf, jf, pb, jb, jin = jax_conv(args, out)
        geometry = (tuple(args[1].shape), *[str(a) for a in args[3:]])
        if prev is not None and prev[0] is args[0] and prev[1] == geometry:
            jb -= jin
            prev = None
        else:
            prev = (args[0], geometry)
        for k, v in zip(tot, (pf, jf, pb, jb)):
            tot[k] += v
    return tot


def serving_segments(device, nets, dtype) -> dict:
    """The serving batch's parts, each a call on its own inputs at the
    chain's shapes (8 x 301 frames): the prior's forward, one chain step
    (a ``DiffUNet1`` forward), its encoder, TCMs and decoder, the STFT, the
    ISTFT."""
    import torch

    import chip_smoke as cs
    from prior_diffuse_tpu_torch.models.diffunet import UNetCore
    from prior_diffuse_tpu_torch.models.fused_forward import (dual_decoder_forward,
                                                             fused_unet_forward)
    from prior_diffuse_tpu_torch.ops.cuda import convblock, stft as kstft
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    enh = Enhancer(*nets, device=device, dtype=dtype)
    pack_dis, pack = enh.packs()
    g = torch.Generator(device=device).manual_seed(6)
    rand = lambda *shape: torch.randn(shape, generator=g, device=device).to(dtype)
    x, x_init = rand(cs.BATCH, cs.T_FRAMES, 161, 2), rand(cs.BATCH, cs.T_FRAMES, 161, 2)
    t = torch.full((cs.BATCH,), 3.0, device=device)
    temb = pack["temb"](t).to(dtype)
    xe, skips = convblock.encoder_fused(x.contiguous(), pack["enc"], temb)
    mid = UNetCore.bottleneck(xe.permute(0, 3, 1, 2), pack["tcm"])
    wav = torch.from_numpy(cs.speechlike(cs.BATCH, cs.LENGTH, 3)).to(device)
    spec = torch.randn((cs.BATCH, cs.T_FRAMES, 161, 2), generator=g, device=device)
    if pack["dual"] is not None:
        decoder = lambda: dual_decoder_forward(pack["dual"], mid.permute(0, 2, 3, 1), skips, temb)
    else:
        decoder = lambda: UNetCore.decode(mid, [s.permute(0, 3, 1, 2) for s in skips], temb,
                                          pack["dec"])
    return {"prior forward": lambda: fused_unet_forward(pack_dis, x),
            "chain step": lambda: fused_unet_forward(pack, x, x_init, t),
            "encoder": lambda: convblock.encoder_fused(x.contiguous(), pack["enc"], temb),
            "tcm_x3": lambda: UNetCore.bottleneck(xe.permute(0, 3, 1, 2), pack["tcm"]),
            "decoder": decoder,
            "stft": lambda: kstft.stft(wav),
            "istft": lambda: kstft.istft(spec, cs.LENGTH)}


def jax_comparison(report, calls, batch: int) -> list:
    """Lines setting the bf16 serving program's counts beside JAX's, kind
    by kind: products (JAX's conv1 of stages 2-5 runs on the pad frame
    too), the TCMs' convolutions and the decoders' transposed ones (JAX's
    recomputed from the port's shapes)."""
    with open(JAX_REFERENCE) as f:
        ref = json.load(f)
    jdot = sum(o["flops"] for o in ref["ops"] if o["kind"] == "dot_general")
    j1d = sum(o["flops"] for o in ref["ops"] if o["kind"] == "conv" and "x" not in
              o["shape"].split()[1])
    j2d = sum(o["flops"] for o in ref["ops"] if o["kind"] == "conv" and "x" in
              o["shape"].split()[1])
    by = lambda pick: sum(o.flops for k, o in report.ops.items() if pick(k, o))
    pdot = by(lambda k, o: o.kind == "dot_general")
    p1d = by(lambda k, o: o.kind == "conv" and "transposed" not in k)
    pt = jax_convs(calls, transposed=True)
    pad = SERVING_FORWARDS * batch * sum(CONV1_F) * 2 * 64 * 32
    total = sum(o.flops for o in report.ops.values())
    return [
        f"- model FLOPs {total:,.0f} (port) against JAX's "
        f"{ref['totals']['model_flops']:,.0f} (docs/PERF_r5_roofline.json), by kind:",
        f"  - products: {pdot:,.0f} against {jdot:,.0f}; JAX's conv1 of encoder stages 2-5 "
        f"on the causal pad frame adds {pad:,.0f} ({'equal' if pdot + pad == jdot else 'NOT equal'}"
        " with it)",
        f"  - TCM convolutions: {p1d:,.0f} against {j1d:,.0f}",
        f"  - transposed convolutions: {pt['port_flops']:,.0f} (each input pixel once, the dual "
        f"decoder's groups=2) against {j2d:,.0f}; JAX's phase decomposition of the port's "
        f"calls counts {pt['jax_flops']:,.0f} "
        f"({'equal' if pt['jax_flops'] == j2d else 'NOT equal'})",
    ]


def summary_row(name, t) -> str:
    share = (f" | {t['attained_fraction']:.5f} | {t['mfu']:.5f}" if "mfu" in t else " | - | -")
    return (f"| {name} | {t['model_flops'] / 1e9:.3f} | {t['padded_flops'] / 1e9:.3f} "
            f"| {t['lane_occupancy']:.4f} | {t['mxu_bytes'] / 1e9:.4f} "
            f"| {t['elementwise_bytes'] / 1e9:.4f} | {t['attainable_s_fused'] * 1e3:.4f} "
            f"({t['bound_by']}) | {t['attainable_s_unfused'] * 1e3:.4f}" + share + " |")


HEADER = ["| program | model GFLOP | padded GFLOP | occupancy | product GB | elementwise GB "
          "| fused ceiling ms (set by) | unfused ms | attained_fraction | mfu |",
          "|---|---|---|---|---|---|---|---|---|---|"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", help="cpu (default) or cuda")
    ap.add_argument("--paths", help="comma-separated program names (default: all)")
    ap.add_argument("--measured-ms", action="append", default=[], metavar="NAME=MS",
                    help="a program's measured ms per call (repeatable)")
    ap.add_argument("--out", help="write the markdown report here")
    ap.add_argument("--json", help="write the counts as JSON here")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from prior_diffuse_tpu_torch.models.grn import GRN
    from prior_diffuse_tpu_torch.serving.enhance import MagServer
    from prior_diffuse_tpu_torch.utils.roofline import CHIP_SPECS, analyze, format_report

    device = torch.device(a.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False  # as the port's entry points run
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)  # the train steps enable it themselves
    spec = CHIP_SPECS["H100 80GB HBM3"]
    measured = {k: float(v) / 1e3 for k, v in (m.split("=") for m in a.measured_ms)}
    nets = cs.seeded_nets(0, device)
    with tempfile.TemporaryDirectory(prefix="roofline_") as root:
        corpus = cs.write_train_corpus(root)
        paths = cs.roofline_paths(device, nets, cs.prior_nets(device), root, corpus)
        grn = MagServer(cs.seeded_nets(60, device, (GRN,))[0], cs.prior_exp("GRN"), device=device)
        wav = torch.from_numpy(cs.speechlike(cs.BATCH, cs.LENGTH, 3)).to(device)
        paths["prior_GRN"] = lambda: grn.enhance_batch(wav)
        names = a.paths.split(",") if a.paths else list(paths)
        unknown = sorted(set(names) - set(paths))
        if unknown:
            sys.exit(f"roofline_enhance: unknown programs {unknown}; known: {sorted(paths)}")
        rows, sections, payload = [], [], {"device": str(device), "chip": "H100 80GB HBM3",
                                           "spec": spec, "programs": {}}
        for name in names:
            rep = analyze(paths[name])
            t = rep.totals(spec, measured.get(name))
            rows.append(summary_row(name, t))
            sections += [f"## {name}", "", format_report(rep, spec, measured.get(name)), ""]
            entry = {"totals": t, "ops": [
                {"kind": o.kind, "shape": o.shape_sig, "count": o.count, "flops": o.flops,
                 "padded_flops": o.padded_flops, "bytes": o.total_bytes,
                 "roofline_us": o.roofline_s(spec) * 1e6}
                for o in sorted(rep.ops.values(), key=lambda o: -o.roofline_s(spec))]}
            if name.startswith("serve_"):
                dtype = torch.bfloat16 if name.endswith("bfloat16") else torch.float32
                seg = {k: rep_.totals(spec) for k, rep_ in
                       ((k, analyze(fn)) for k, fn in serving_segments(device, nets,
                                                                       dtype).items())}
                sections += [f"### {name} by segment", "", *HEADER,
                             *(summary_row(k, v) for k, v in seg.items()), ""]
                entry["segments"] = seg
                if dtype == torch.bfloat16:
                    lines = jax_comparison(rep, conv_calls(paths[name]), cs.BATCH)
                    sections += [f"### {name} against JAX's count", "", *lines, ""]
                    entry["jax_comparison"] = lines
                    print("\n".join(lines), flush=True)
            payload["programs"][name] = entry
            print(rows[-1], flush=True)
    doc = "\n".join([
        f"# Static roofline of the port's programs ({device.type} count)", "",
        "Counted by `prior_diffuse_tpu_torch/utils/roofline.py` (the kernels through their "
        "plain versions) against the H100 SXM's published dense peaks (989 TFLOP/s bf16, "
        "495 TF32, f32 products at 3xTF32's 165, 3.35 TB/s). Shares only for the programs "
        "given `--measured-ms`.", "", *HEADER, *rows, "", *sections])
    if a.out:
        with open(a.out, "w") as f:
            f.write(doc + "\n")
    if a.json:
        with open(a.json, "w") as f:
            json.dump(payload, f, indent=1)


if __name__ == "__main__":
    main()
