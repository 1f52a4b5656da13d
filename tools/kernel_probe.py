#!/usr/bin/env python3
"""Three probes of the PyTorch + CUDA port on one GPU (development tools;
the port and ``chip_smoke.py`` do not use them).

    python3 tools/kernel_probe.py k3 [--json PATH]
    python3 tools/kernel_probe.py k3bf16 [--json PATH]
    python3 tools/kernel_probe.py k2 [--json PATH]
    python3 tools/kernel_probe.py step [--json PATH]

``k3`` attributes K3's device time by rebuilding the kernels from patched
copies of ``csrc/enc_chain.cu``.  Each variant takes one part of the
kernel's work away (a patched kernel computes wrong values on purpose;
only its time is read): two of the three TF32 products of every 3xTF32
step, the window product, the gate and W2 chain after it, or the output
stores.  Every variant runs the five encoder stages of one DiffUNet1
forward at batch 8 x 3 s (weights from a seed), each stage timed by
CUDA-graph replay, so the host's pace does not enter.  The kernel as
built is timed first and last; on the first run the card's power draw and
SM clock are read while the five stages run back to back for 2 s.  A
patch whose text no longer occurs once in the source stops the probe.

``k3bf16`` does the same for K3-bf16 (``csrc/enc_chain_bf16.cu``): the
five whole bf16 stages of that forward (stage 2-5's conv1 inside), each
variant taking away one part (or, first, running the gate and W2
products on ``mma.sync`` in place of ``wgmma``, or the sigmoid with an
IEEE ``expf`` and divide): the window product, the gate and W2
products, the sigmoid cross gate (comb from y and m without a sigmoid),
conv1's epilogue (its stores of the 32-channel tile), or the output
stores.

``k2`` times K2 (``csrc/stft.cu``) at each tile it is built for (4, 8
and 16 output rows a block, ``ops/cuda/stft.py::ISTFT_TILES``), twice in
turns, by CUDA-graph replay, at the serving shape (batch 8 x 3 s,
``[8, 301, 161, 2]`` -> ``[8, 48000]``), the eval shape (a cv batch of
6 x 4 s, ``[6, 401, 161, 2]`` -> ``[6, 64000]``) and 8 x 30 s
(``[8, 3001, 161, 2]``, ~10 waves of blocks); each result is held against
the plain version as ``chip_smoke.py`` holds it.  The power draw and SM
clock are read while the path's tile runs at the serving shape.  Then, at
the path's tile (``ISTFT_ROWS``), it attributes the time as ``k3`` does,
from patched builds: the inverse FFT taken away (loads, pre-split,
window, overlap-add left), and the output stores taken away.

``step`` measures how far one train step of ``conf/diff.yml``
(``--joint --sigma``, batch 6 x 48000, weights from a seed) moves when its
STFT changes: the same step is taken from one state with the plain STFT,
then with each variant (the plain STFT again; K1; ``torch.stft``; the
plain STFT times ``1 + r N(0, 1)``; K1 with the symmetric Hann window in
its table; K1 times ``1 + r``), and the losses, each net's gradient and
Adam update are compared with the first run's as ``chip_smoke.py``
compares the step through K1 with the plain step.

All need a CUDA card; ``k3`` and ``k2`` also need ``nvcc``.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from prior_diffuse_tpu_torch.ops import build  # noqa: E402

# variant -> [(text of csrc/enc_chain.cu, replacement)]
K3_PATCHES = {
    "as built": [],
    "1xTF32 (hi x hi products only)": [
        ("for (int j = 0; j < N; ++j) mma(d[i][j], a[i].lo, b[j].x, b[j].y);",
         "for (int j = 0; j < 0; ++j) mma(d[i][j], a[i].lo, b[j].x, b[j].y);"),
        ("for (int j = 0; j < N; ++j) mma(d[i][j], a[i].hi, b[j].z, b[j].w);",
         "for (int j = 0; j < 0; ++j) mma(d[i][j], a[i].hi, b[j].z, b[j].w);")],
    "no window product": [
        ("for (int s = 0; s < KS; ++s) {", "for (int s = 0; s < 0; ++s) {")],
    "no gate and W2 chain (y stored)": [
        ("make_float2(prelu(o[i][j][2 * h]), prelu(o[i][j][2 * h + 1]))",
         "make_float2(y[i][j][2 * h], y[i][j][2 * h + 1])")],
    "no output stores": [
        ("if (r < rows) {", "if (r < rows && o[i][0][2 * h] == 1234.5f) {")],
}
# K3-bf16's gate and W2 products on mma.sync m16n8k16, B fragments by
# ldmatrix from the same swizzled images, in place of wgmma (a variant that
# measured slower; the kernel keeps wgmma)
_MMA_SYNC_HELPERS = r"""// d[16 x 8] += a[16 x 16] b[16 x 8] (mma.sync m16n8k16, bf16, f32 sums) on
// accumulator registers d[o..o+3] (the wgmma per-warp layout of n8 tile o / 4).
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.sync B fragments of n8 tiles j, j + 1 at k16 step s from a one-atom
// K-major SW128 image at `img`: b[0], b[1] of tile j, b[2], b[3] of j + 1.
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], uint32_t img, int j, int s) {
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, img + (8 * (j + (q >> 1)) + r) * 128 + (((2 * s + (q & 1)) ^ r) << 4));
}

"""
_GATE_WGMMA = r"""      fence_regs(m);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < 4; ++st) wgmma_n64_rs(m, ay[st], desc_sw128(w_gate + st * 32));
      wgmma_commit();
      wgmma_wait();
      fence_regs(m);
"""
_GATE_MMA_SYNC = r"""#pragma unroll
      for (int j = 0; j < 8; j += 2)
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          const int st = (j >> 2) * 2 + sl;
          uint32_t bw[4];
          ld_b(bw, w_gate, j, st);
          mma16816(m + 4 * j, ay[st], bw[0], bw[1]);
          mma16816(m + 4 * j + 4, ay[st], bw[2], bw[3]);
        }
"""
_W2_WGMMA = r"""      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < 2; ++st) wgmma_n64_rs(o, ac[st], desc_sw128(w_2 + st * 32));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
"""
_W2_MMA_SYNC = r"""#pragma unroll
      for (int j = 0; j < 8; j += 2)
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          uint32_t bw[4];
          ld_b(bw, w_2, j, st);
          mma16816(o + 4 * j, ac[st], bw[0], bw[1]);
          mma16816(o + 4 * j + 4, ac[st], bw[2], bw[3]);
        }
"""
# variant -> [(text of csrc/enc_chain_bf16.cu, replacement)]
K3_BF16_PATCHES = {
    "as built": [],
    "gate and W2 on mma.sync": [
        ("// ------------------------------------------------------------------ math",
         _MMA_SYNC_HELPERS + "// ------------------------------------------------------------------ math"),
        (_GATE_WGMMA, _GATE_MMA_SYNC), (_W2_WGMMA, _W2_MMA_SYNC)],
    "sigmoid by IEEE expf and divide": [
        ("return __fdividef(1.f, 1.f + __expf(-v));", "return 1.f / (1.f + expf(-v));")],
    "no window product": [
        ("      for (int st = 0; st < KS; ++st)\n        wgmma_n64_rs(y,",
         "      for (int st = 0; st < 0; ++st)\n        wgmma_n64_rs(y,")],
    "no gate and W2 products": [
        ("for (int st = 0; st < 4; ++st) wgmma_n64_rs(m,", "for (int st = 0; st < 0; ++st) wgmma_n64_rs(m,"),
        ("for (int st = 0; st < 2; ++st) wgmma_n64_rs(o,", "for (int st = 0; st < 0; ++st) wgmma_n64_rs(o,")],
    "no sigmoid (comb = y_l + y_r + m)": [
        ("comb[e] = y[e] * sigmoid(m[e + 16]) + y[e + 16] * sigmoid(m[e]);",
         "comb[e] = y[e] + y[e + 16] + m[e];")],
    "no conv1 epilogue stores": [("if (px < pixels) {", "if (px < 0) {")],
    "no output stores": [("if (rr < valid) {", "if (rr < valid - 64) {")],
}
# variant -> [(text of csrc/stft.cu, replacement)]
K2_PATCHES = {
    "as built": [],
    "no inverse FFT (loads, pre-split, window, overlap-add)": [
        ("for (int h = 1; h <= 16; h <<= 1) {", "for (int h = 1; h <= 0; h <<= 1) {"),
        ("for (int k1 = 1; k1 < 5; ++k1) v[k1] = cmul(v[k1], __ldg(tw + lane * k1));", ""),
        ("const float2 p = cmul(v[k1], __ldg(tw + 32 * ((n1 * k1) % 5)));",
         "const float2 p = v[k1];")],
    "no output stores": [
        ("ob[e] = r <= T ?", "const float y = r <= T ?"),
        ("                   : 0.f;\n", "                   : 0.f;\n    if (y == 1234.5f) ob[e] = y;\n")],
}
def patched_library(name: str, source: str, edits, work: Path) -> ctypes.CDLL:
    """The kernels of ``csrc/`` built with ``edits`` applied to ``source``,
    with the flags and entry points of ``ops/build.py``."""
    src = work / "".join(c if c.isalnum() else "_" for c in name)
    shutil.copytree(build.SRC_DIR, src)
    path = src / source
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"probe variant {name!r}: {old!r} does not occur once")
        text = text.replace(old, new)
    path.write_text(text)
    lib = src / "libprobe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                    *map(str, sorted(src.glob("*.cu")))], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    for fn_name, argtypes in build._SIGNATURES.items():
        getattr(so, fn_name).argtypes = argtypes
        getattr(so, fn_name).restype = ctypes.c_int
    so.pdt_error_string.argtypes = [ctypes.c_int]
    so.pdt_error_string.restype = ctypes.c_char_p
    return so


def power_under(fn, seconds: float = 2.0) -> dict:
    """Median power draw (W) and SM clock (MHz) that ``nvidia-smi`` reads
    every 200 ms while ``fn`` runs back to back for ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=power.draw,clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "200"], stdout=subprocess.PIPE, text=True)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        end.record()
        torch.cuda.synchronize()
        while start.elapsed_time(end) < seconds * 1e3:
            for _ in range(20):
                fn()
            end.record()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    rows = sorted((float(w), float(c)) for w, c in rows)
    return {"power_w": rows[len(rows) // 2][0], "sm_mhz": rows[len(rows) // 2][1],
            "samples": len(rows)}


def stage_inputs_of_a_forward(seed: int = 0):
    """The five (xin, ops, bias_b, pad) of one DiffUNet1 forward at batch
    8 x 3 s (T = 301), from the plain stages, with weights drawn from
    ``seed``."""
    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet1
    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb

    torch.manual_seed(seed)
    net = DiffUNet1().cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(8, 301, 161, 2, generator=g, device="cuda")
    temb = net.time_embedding(torch.rand(8, generator=g, device="cuda") * 40.0)
    stages = []
    for ops, tp in cb.pack_encoder(net.core.en):
        xin, bias_b, pad = cb.stage_inputs(x, ops, tp, temb)
        stages.append((xin, ops, bias_b, pad))
        x = cb.enc_stage_plain(xin, ops, bias_b, pad)
    return stages


def k3_probe(card: str) -> list:
    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb

    stages = stage_inputs_of_a_forward()
    results = []
    with tempfile.TemporaryDirectory(prefix="k3_probe_") as work:
        for i, name in enumerate(list(K3_PATCHES) + ["as built"]):
            lib = patched_library(f"{i} {name}", "enc_chain.cu", K3_PATCHES[name], Path(work))
            with mock.patch.object(build, "library", lambda: lib):
                ms = [chip_smoke.graph_ms(lambda s=s: cb.enc_stage(*s)) for s in stages]
                power = power_under(lambda: [cb.enc_stage(*s) for s in stages]) if (
                    not results) else {}
            results.append({"variant": name, "stage_ms": ms, "ms": sum(ms), **power})
            print(f"{name}: {sum(ms):.4f} ms (stages " + ", ".join(f"{v:.4f}" for v in ms)
                  + f"){'; ' + json.dumps(power) if power else ''}; card {card}", flush=True)
    return results


def k3_bf16_probe(card: str) -> list:
    """Each K3_BF16_PATCHES variant on the five bf16 stages of one DiffUNet1
    forward at batch 8 x 3 s, each stage by CUDA-graph replay."""
    from prior_diffuse_tpu_torch.models.diffunet import DiffUNet1
    from prior_diffuse_tpu_torch.ops.cuda import convblock as cb

    torch.manual_seed(0)
    net = DiffUNet1().cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 301, 161, 2, generator=g, device="cuda").bfloat16()
    temb = net.time_embedding(torch.rand(8, generator=g, device="cuda") * 40.0).bfloat16()
    stages = []
    for ops, tp in cb.pack_encoder(net.core.en, torch.bfloat16):
        stages.append((x, ops, *cb.stage_biases(x, ops, tp, temb)))
        x = cb.enc_stage_bf16_plain(*stages[-1])
    results = []
    with tempfile.TemporaryDirectory(prefix="k3_bf16_probe_") as work:
        for i, name in enumerate(list(K3_BF16_PATCHES) + ["as built"]):
            lib = patched_library(f"{i} {name}", "enc_chain_bf16.cu", K3_BF16_PATCHES[name],
                                  Path(work))
            with mock.patch.object(build, "library", lambda: lib):
                ms = [chip_smoke.graph_ms(lambda s=s: cb.enc_stage_bf16(*s)) for s in stages]
            results.append({"variant": name, "stage_ms": ms, "ms": sum(ms)})
            print(f"{name}: {sum(ms):.4f} ms (stages " + ", ".join(f"{v:.4f}" for v in ms)
                  + f"); card {card}", flush=True)
    return results


def k2_probe(card: str) -> list:
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, b, n in (("serving", 8, 48000), ("eval", 6, 64000), ("8 x 30 s", 8, 480000)):
        spec = kstft.stft_plain(torch.randn(b, n, generator=g, device="cuda"))
        cases.append((f"{name} {list(spec.shape)}", spec, n, kstft.istft_plain(spec, length=n)))
    results = []
    for rows in kstft.ISTFT_TILES * 2:
        row = {"variant": "as built", "rows": rows}
        with mock.patch.object(kstft, "ISTFT_ROWS", rows):
            for label, spec, n, ref in cases:
                err = chip_smoke.expect_close(f"K2 ({rows} rows a block) {label}",
                                              kstft.istft(spec, n), ref)
                row[label] = {"graph_ms": chip_smoke.graph_ms(lambda: kstft.istft(spec, n)),
                              "max_abs_err": err}
            if rows == kstft.ISTFT_ROWS and not any(r["rows"] == rows for r in results):
                _, spec, n, _ = cases[0]
                row.update(power_under(lambda: kstft.istft(spec, n)))
        results.append(row)
        print(f"{rows} rows a block: " + ", ".join(
            f"{label} {row[label]['graph_ms']:.5f} ms (max|err| {row[label]['max_abs_err']:.3e})"
            for label, *_ in cases) + " (graph replays)"
            + (f"; {row['power_w']} W, {row['sm_mhz']} MHz" if "power_w" in row else "")
            + f"; card {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="k2_probe_") as work:
        for i, name in enumerate(list(K2_PATCHES) + ["as built"]):
            lib = patched_library(f"{i} {name}", "stft.cu", K2_PATCHES[name], Path(work))
            row = {"variant": name, "rows": kstft.ISTFT_ROWS}
            with mock.patch.object(build, "library", lambda: lib):
                for label, spec, n, ref in cases:
                    # a patched kernel computes wrong values on purpose
                    row[label] = {"graph_ms": chip_smoke.graph_ms(lambda: kstft.istft(spec, n)),
                                  "max_abs_err": float((kstft.istft(spec, n) - ref).abs().max())}
            results.append(row)
            print(f"{name} ({row['rows']} rows a block): " + ", ".join(
                f"{label} {row[label]['graph_ms']:.5f} ms" for label, *_ in cases)
                + f" (graph replays, patched build); card {card}", flush=True)
    return results


def step_probe(card: str) -> list:
    from prior_diffuse_tpu_torch.config import RunConfig, load_experiment
    from prior_diffuse_tpu_torch.data.synthetic import write_corpus_speechlike
    from prior_diffuse_tpu_torch.ops.cuda import stft as kstft
    from prior_diffuse_tpu_torch.training.ddpm_trainer import ComplexDDPMTrainer

    dev = torch.device("cuda:0")
    window = torch.hann_window(320, device=dev)
    g = torch.Generator(device=dev).manual_seed(123)
    tab, itab = kstft._device_operands(dev)
    wrong = tab.clone()
    wrong[:320] = torch.hann_window(320, periodic=False, device=dev)

    def noisy(r):
        return lambda x: (s := kstft.stft_plain(x)) * (
            1 + r * torch.randn(s.shape, generator=g, device=dev))

    k1 = kstft.stft  # the variants run while kstft.stft is patched to them

    def k1_wrong_window(x):
        with mock.patch.object(kstft, "_device_operands", lambda device: (wrong, itab)):
            return k1(x)

    variants = {
        "the plain STFT again": kstft.stft_plain,
        "K1": k1,
        "torch.stft (cuFFT)": lambda x: torch.view_as_real(torch.stft(
            x, 320, 160, window=window, center=True, pad_mode="reflect",
            return_complex=True).transpose(1, 2)),
        **{f"the plain STFT x (1 + {r:g} N(0, 1))": noisy(r) for r in (1e-8, 1e-6)},
        "K1 with the symmetric Hann window": k1_wrong_window,
        **{f"K1 x (1 + {r:g})": (lambda r: lambda x: k1(x) * (1 + r))(r)
           for r in (1e-4, 1e-3)},
    }
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    results = []
    with tempfile.TemporaryDirectory(prefix="probe_step_") as root:
        corpus = write_corpus_speechlike(os.path.join(root, "corpus"), n_train=6, n_test=6,
                                         min_len=48000, max_len=64000, seed=8)
        exp = load_experiment(str(ROOT / "conf" / "diff.yml"))
        run = RunConfig(seed=7, joint=True, sigma=True, data_root=corpus,
                        assets=os.path.join(root, "assets"))
        tr = ComplexDDPMTrainer(run, exp, device=dev)
        b = next(iter(tr.tr_loader))
        batch = tr.put_batch(b.noisy, b.clean, b.frame_nums)
        snap = copy.deepcopy(tr.ckpt_payload())
        spec = kstft.stft_plain(batch[0])

        def step(fn):
            tr.restore_payload(copy.deepcopy(snap))
            # K1 counts its launches on the module's ``stft``, here the variant
            variant = lambda x: fn(x)
            variant.launches = 0
            with mock.patch.object(kstft, "stft", variant):
                return chip_smoke.one_step(tr, batch)

        ref = step(kstft.stft_plain)
        for name, fn in variants.items():
            got = step(fn)
            row = {"variant": name,
                   "stft_max_abs_diff": float((fn(batch[0]) - spec).abs().max()),
                   "loss_rel": [abs(a - r) / abs(r) for a, r in zip(got["loss"], ref["loss"])]}
            for n in tr.nets:
                g_ref, u_ref = ref["grad"][n], ref["update"][n]
                flips = torch.sign(got["grad"][n]) != torch.sign(g_ref)
                steady = ~flips & (g_ref.abs() >= chip_smoke.STEADY_GRAD)
                row[n] = {"grad_rel_l2": rel(got["grad"][n], g_ref),
                          "update_rel_l2_steady": rel(got["update"][n][steady], u_ref[steady]),
                          "sign_flips": int(flips.sum())}
            results.append(row)
            print(f"{name}: STFT max|diff| {row['stft_max_abs_diff']:.3e}; losses rel "
                  + ", ".join(f"{v:.2e}" for v in row["loss_rel"]) + "; " + "; ".join(
                      f"{n}: grad {row[n]['grad_rel_l2']:.3e}, update "
                      f"{row[n]['update_rel_l2_steady']:.3e} over the steady elements, "
                      f"{row[n]['sign_flips']} sign flips" for n in tr.nets)
                  + f"; card {card}", flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("k3", "k3bf16", "k2", "step"))
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA card")
    card = chip_smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    results = {"k3": k3_probe, "k3bf16": k3_bf16_probe, "k2": k2_probe,
               "step": step_probe}[args.probe](card)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "results": results}))


if __name__ == "__main__":
    main()
