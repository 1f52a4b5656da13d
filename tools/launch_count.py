#!/usr/bin/env python3
"""Count the kernel launches of one serving batch by kernel, on one GPU.

    python3 tools/launch_count.py [--root DIR] [--json PATH]

Imports the port and ``chip_smoke.py`` of the checkout at ``DIR`` (default:
this one), so two checkouts can be compared in one machine, each in its
own process.  For each mode and dtype that checkout serves (pirorgrad in
f32 and bf16; deltamu and conditional too where it has ``Nocon``) it runs
``Enhancer.enhance_batch`` on ``chip_smoke.py``'s batch (8 x 3 s
speech-like wavs, fast-6, weights from the same seeds as its phases 3 and
7), then profiles two more batches and prints the device kernels by name
with their launches a batch and the total (``chip_smoke.top_kernels``).
Then it times one bf16 DiffUNet1 encoder at that batch (``encoder_fused``
on its packed encoder: the five K3-bf16 stages with whatever glue that
checkout runs around them): device ms (``chip_smoke.device_ms``), graph ms
(``chip_smoke.graph_ms``) and launches.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--json", help="also write the results to this file")
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from prior_diffuse_tpu_torch import models
    from prior_diffuse_tpu_torch.config import DiffusionConfig, ExperimentConfig
    from prior_diffuse_tpu_torch.models import diffunet
    from prior_diffuse_tpu_torch.serving.enhancer import Enhancer

    if not torch.cuda.is_available():
        sys.exit("launch_count: no CUDA card")
    if not os.path.abspath(models.__file__).startswith(root + os.sep):
        sys.exit(f"launch_count: imported {models.__file__}, not {root}'s package")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    device = torch.device("cuda:0")
    nets = cs.seeded_nets(0, device)
    runs = {"pirorgrad": (nets[1], {})}
    if hasattr(diffunet, "Nocon"):
        nocon = cs.seeded_nets(1, device, (diffunet.Nocon,))[0]
        runs["deltamu"] = (nocon, {"pirorgrad": False, "deltamu": True})
        runs["conditional"] = (nets[1], {"pirorgrad": False})
    wav = torch.from_numpy(cs.speechlike(cs.BATCH, cs.LENGTH, 3)).to(device)
    out = {"root": root, "card": cs.card_line(), "batches": {}}
    for mode, (ddpm, flags) in runs.items():
        for dtype in (torch.float32, torch.bfloat16):
            enh = Enhancer(nets[0], ddpm, ExperimentConfig(diffusion=DiffusionConfig(**flags)),
                           device=device, dtype=dtype)
            gen = torch.Generator(device=device).manual_seed(5)
            rows, total = cs.top_kernels(lambda: enh.enhance_batch(wav, gen), n=10 ** 6)
            key = f"{mode} {str(dtype)[6:]}"
            names = collections.Counter()
            for name, _, n in rows:  # names are cut to 60 characters
                names[name] += n
            out["batches"][key] = {"launches": total, "kernels": dict(names)}
            print(f"{key}: {total} kernel launches a batch", flush=True)
    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb

    g = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(cs.BATCH, cs.T_FRAMES, 161, 2, generator=g, device=device).bfloat16()
    temb = nets[1].time_embedding(torch.rand(cs.BATCH, generator=g, device=device) * 40.0)
    packed = cb.pack_encoder(nets[1].core.en, torch.bfloat16)
    enc = lambda: cb.encoder_fused(x, packed, temb.bfloat16())  # noqa: E731
    _, launches = cs.top_kernels(enc)
    out["bf16_encoder"] = {"device_ms": cs.device_ms(enc), "graph_ms": cs.graph_ms(enc),
                           "launches": launches}
    print(f"bf16 encoder, {cs.BATCH} x {cs.T_FRAMES} frames: {out['bf16_encoder']}", flush=True)
    print(json.dumps(out), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
