"""Inputs made from ``--seed``: weights, speech-like signals, lengths.

Weights follow the rules the port's card checks drew them by (uniform
+-1/sqrt(fan_in) kernels and biases, recurrent and attention weights
+-1/sqrt(width), PReLU slopes in [0.1, 0.4], norm scales near 1 and
shifts near 0, BatchNorm running means ~ N(0, 0.1) and variances in
[0.5, 1.5], so that folded statistics are exercised), drawn on the device
in two large calls from one ``torch.Generator``.  Signals are voiced
speech-like rows: harmonics of a gliding f0 under a syllable-rate
envelope.  The same seed gives the same inputs on the same device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

SR = 16000


def derived_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for a sub-stream ``path`` of ``seed`` (any integer)."""
    words = [seed % 2 ** 32, seed // 2 ** 32 % 2 ** 32, *path]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(seed, *path))


def _rules(net: nn.Module):
    """``(key, shape, kind, lo, hi)`` for every parameter and buffer that
    gets a draw: kind ``u`` uniform in [lo, hi], ``n`` normal of std hi."""
    out = []
    for prefix, m in net.named_modules():
        p = f"{prefix}." if prefix else ""

        def add(name, kind, lo, hi, m=m, p=p):
            out.append((p + name, tuple(getattr(m, name).shape), kind, lo, hi))

        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            add("weight", "u", 0.8, 1.2)
            add("bias", "u", -0.1, 0.1)
        elif isinstance(m, nn.RNNBase):
            b = m.hidden_size ** -0.5
            for name, _ in m.named_parameters(recurse=False):
                add(name, "u", -b, b)
        elif type(m).__name__ == "MultiHeadAttention":
            b = m.in_proj_weight.shape[1] ** -0.5
            for name, _ in m.named_parameters(recurse=False):
                add(name, "u", -b, b)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            add("weight", "u", 0.8, 1.2)
            add("bias", "u", -0.1, 0.1)
            add("running_mean", "n", 0.0, 0.1)
            add("running_var", "u", 0.5, 1.5)
        elif isinstance(m, nn.PReLU):
            add("weight", "u", 0.1, 0.4)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w[:, 0].numel() if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            b = fan_in ** -0.5
            add("weight", "u", -b, b)
            add("bias", "u", -b, b)
    return out


def seeded_state(net: nn.Module, seed: int, device, stream: int) -> dict:
    """A ``state_dict`` for ``net`` (a reference net, whose keys the port's
    nets share) drawn from ``seed`` on ``device``: one uniform and one
    normal draw for all of it; what no rule covers keeps ``net``'s own
    initial value (AIAT's mix weights, BatchNorm's update counts)."""
    rules = _rules(net)
    state = {k: v.detach().to(device).clone() for k, v in net.state_dict().items()}
    g = generator(seed, device, stream)
    for kind in ("u", "n"):
        sel = [r for r in rules if r[2] == kind]
        if not sel:
            continue
        sizes = [int(np.prod(r[1])) for r in sel]
        total = sum(sizes)
        draw = (torch.rand if kind == "u" else torch.randn)(total, generator=g, device=device)
        counts = torch.tensor(sizes, device=device)
        lo = torch.repeat_interleave(torch.tensor([r[3] for r in sel], device=device), counts)
        hi = torch.repeat_interleave(torch.tensor([r[4] for r in sel], device=device), counts)
        vals = lo + (hi - lo) * draw if kind == "u" else lo + hi * draw
        for (key, shape, *_), part in zip(sel, torch.split(vals, sizes)):
            state[key] = part.view(shape).clone()
    return state


def speechlike(rows: int, length: int, g: torch.Generator, device) -> torch.Tensor:
    """``[rows, length]`` float32 voiced rows (unnormalised) with their
    per-row parameters drawn from ``g``."""
    u = torch.rand((rows, 4), generator=g, device=device, dtype=torch.float64)
    t = torch.arange(length, device=device, dtype=torch.float64)[None] / SR
    f0 = (90 + 130 * u[:, :1]) * (1 + 0.1 * torch.sin(2 * np.pi * (0.5 + 1.5 * u[:, 1:2]) * t))
    phase = 2 * np.pi * torch.cumsum(f0, dim=1) / SR
    voiced = sum(torch.sin(h * phase) / h for h in range(1, 12))
    env = 0.5 + 0.5 * torch.sin(2 * np.pi * (2 + 3 * u[:, 2:3]) * t) ** 2
    return (voiced * env).float()


def noisy_speech(rows: int, length: int, g: torch.Generator, device,
                 snr_db=(0.0, 15.0)) -> tuple:
    """``(noisy, clean)`` ``[rows, length]``: unit-RMS speech-like rows and
    white noise at an SNR drawn uniformly from ``snr_db``."""
    clean = speechlike(rows, length, g, device)
    clean = clean / torch.sqrt(torch.mean(clean ** 2, dim=1, keepdim=True))
    snr = snr_db[0] + (snr_db[1] - snr_db[0]) * torch.rand((rows, 1), generator=g,
                                                           device=device)
    noise = torch.randn((rows, length), generator=g, device=device)
    return clean + noise * 10 ** (-snr / 20), clean


def quantile_lengths(count: int, dist: dict) -> np.ndarray:
    """``count`` lengths in samples at the quantiles ``(i + 0.5) / count``
    of ``dist``: ``{"kind": "lognormal", "median_s", "sigma", "min_s",
    "max_s"}`` (clipped) or ``{"kind": "uniform", "min_s", "max_s"}``.
    Every seed gets this same set, in its own order."""
    q = (np.arange(count) + 0.5) / count
    if dist["kind"] == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(v) for v in q])
        sec = np.clip(dist["median_s"] * np.exp(dist["sigma"] * z), dist["min_s"], dist["max_s"])
    elif dist["kind"] == "uniform":
        sec = dist["min_s"] + (dist["max_s"] - dist["min_s"]) * q
    else:
        raise ValueError(f"unknown length distribution {dist['kind']!r}")
    return np.round(sec * SR).astype(np.int64)


def stratified_order(lengths: np.ndarray, strata: int, seed: int, stream: int) -> np.ndarray:
    """An order in which to serve items of ``lengths``: blocks of
    ``strata`` items, each block one item of every length stratum (the
    items ranked by length, cut into ``strata`` runs of equal size), the
    seed choosing which member of each stratum goes to which block and the
    order inside a block.  Every seed then serves the same mix of sizes in
    every block, so a window's work does not hang on the seed."""
    n = len(lengths)
    if n % strata:
        raise ValueError(f"{n} items do not cut into {strata} strata")
    rng = np.random.default_rng(derived_seed(seed, stream))
    groups = np.argsort(lengths, kind="stable").reshape(strata, n // strata)
    blocks = np.stack([rng.permutation(g) for g in groups]).T.copy()
    for b in blocks:
        rng.shuffle(b)
    return blocks.reshape(-1)


def signal_pool(lengths: np.ndarray, seed: int, device, stream: int) -> list:
    """One noisy speech-like wav (numpy float32) for each length, in the
    order of ``lengths``, made on the device in blocks."""
    g = generator(seed, device, stream, 1)
    wavs = []
    block = max(1, int(3e7 // max(int(lengths.max()), 1)))
    for i in range(0, len(lengths), block):
        part = lengths[i: i + block]
        noisy, _ = noisy_speech(len(part), int(part.max()), g, device)
        host = noisy.cpu().numpy()
        wavs.extend(host[j, : n].copy() for j, n in enumerate(part))
    return wavs
