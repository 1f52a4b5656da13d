"""Typed configuration tree.

The counterpart of ``prior_diffuse_tpu/config.py``: the same dataclasses,
fields, defaults and properties (``TrainConfig``, ``ModelConfig``,
``OptimConfig``, ``DiffusionConfig``, ``ExperimentConfig``, ``RunConfig``),
``experiment_from_dict`` and ``load_experiment``.  The defaults are the
system of ``conf/diff.yml``.

``load_experiment`` reads ``conf/*.yml`` with :func:`read_yaml`, a reader
of the subset those files use (the machine with the GPU has no PyYAML):
mappings nested two levels deep, ``#`` comments, quoted and bare strings,
ints, floats with a decimal point, and booleans.  Anything else raises.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class StftConfig:
    """STFT framing parameters (reference ``conf/*.yml`` train block)."""

    fft_num: int = 320
    win_size: int = 320
    win_shift: int = 160

    @property
    def freq_bins(self) -> int:
        return self.fft_num // 2 + 1  # 161


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 6
    n_epochs: int = 50
    loss: str = "com_mse_loss"
    chunk_length: int = 48000  # 3 s @ 16 kHz
    win_size: int = 320
    fft_num: int = 320
    win_shift: int = 160
    feat_type: str = "sqrt"  # normal | sqrt | cubic | log_1x | none
    pesq_loss: bool = False
    lam: float = 1.0  # joint loss weight: lam * L_ddpm + L_dis
    sample_rate: int = 16000
    compute_dtype: str = "float32"  # "bfloat16" / "bf16": bf16 compute (models/precision.py)

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.fft_num, self.win_size, self.win_shift)

    @property
    def freq_bins(self) -> int:
        return self.fft_num // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    name: str = "DiffUNet"


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "Adam"
    lr: float = 5e-4
    l2: float = 1e-7  # torch-Adam L2 (decay added to the gradient)
    half_lr: int = 3  # halve LR after this many non-improving CV epochs
    early_stop: int = 5  # stop after this many non-improving CV epochs


@dataclass(frozen=True)
class DiffusionConfig:
    """Diffusion hyper-parameters; the extensions (``cond_noisy``,
    ``train_t_fast``, ``n_avg``, ``zero_init``, ``predict``,
    ``x0_leak_drop``) are documented in ``prior_diffuse_tpu/config.py``."""

    pirorgrad: bool = True  # [sic] reference flag name
    deltamu: bool = False
    ours: bool = False
    fast_sampling: bool = True
    noise_schedule: List[float] = field(
        default_factory=lambda: np.linspace(1e-4, 0.05, 50).tolist()
    )
    inference_noise_schedule: List[float] = field(
        default_factory=lambda: [1e-4, 1e-3, 1e-2, 0.05, 0.2, 0.5]
    )
    gamma0_override: float = 0.2
    scale_c: float = 11.0
    # condition the residual DDPM on concat([x_init, feat / c])
    cond_noisy: bool = False
    # train on the fast schedule's (T, alpha_bar) pairs only
    train_t_fast: bool = False
    # average this many independent reverse chains
    n_avg: int = 1
    # start the chain from zeros instead of a random draw
    zero_init: bool = False
    # network output parameterization: "eps" or "x0"
    predict: str = "eps"
    # per-sample probability of zeroing x_t's signal term (predict="x0")
    x0_leak_drop: float = 0.0

    @property
    def num_steps(self) -> int:
        return len(self.noise_schedule)


@dataclass(frozen=True)
class ExperimentConfig:
    """One experiment = one of the reference's ``conf/*.yml`` files."""

    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    model_ddpm: Optional[ModelConfig] = None
    optim: OptimConfig = field(default_factory=OptimConfig)
    optim_ddpm: Optional[OptimConfig] = None
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)


@dataclass(frozen=True)
class RunConfig:
    """CLI run flags (reference ``main.py:23-36``)."""

    seed: int = 1234
    trainer: str = "ComplexDDPMTrainer"
    config: str = "diff.yml"
    doc: str = "diff"
    assets: str = "assets_dpm"
    generate: bool = False
    retrain: bool = False
    joint: bool = False
    eval: bool = False
    sigma: bool = False
    noisy: bool = False
    draw: bool = False
    profile_steps: int = 0
    data_root: str = "data"

    @property
    def log_dir(self) -> str:
        return f"{self.assets}/log/{self.doc}"

    @property
    def checkpoint_dir(self) -> str:
        return f"{self.assets}/checkpoint/{self.doc}"

    @property
    def generated_wav_dir(self) -> str:
        return f"{self.assets}/wav/{self.doc}"


_SECTIONS = {
    "train": TrainConfig,
    "model": ModelConfig,
    "model_ddpm": ModelConfig,
    "optim": OptimConfig,
    "optim_ddpm": OptimConfig,
    "diffusion": DiffusionConfig,
}


def _build(cls, data: dict):
    """Recursively build a dataclass from a plain dict, ignoring unknowns."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in names:
            continue
        target = _SECTIONS.get(key)
        if isinstance(value, dict) and target is not None:
            value = _build(target, value)
        kwargs[key] = value
    return cls(**kwargs)


def experiment_from_dict(raw: dict) -> ExperimentConfig:
    return _build(ExperimentConfig, raw)


def load_experiment(path: str) -> ExperimentConfig:
    """Load an experiment YAML (same schema as reference ``conf/*.yml``)."""
    with open(path) as f:
        return experiment_from_dict(read_yaml(f.read()))


# ---- the YAML subset of conf/*.yml -----------------------------------------

# no leading zeros: YAML 1.1 reads 010 as octal
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
# YAML 1.1 (PyYAML) floats need a decimal point: 1e-7 alone is a string there
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")
_BARE = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
# plain words YAML 1.1 reads as something other than a string
_SPECIAL = {"yes", "no", "on", "off", "y", "n", "null", "none", "~"}
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    if quote:
        raise ValueError(f"unterminated quote in {line!r}")
    return line.rstrip()


def _scalar(text: str, where: str):
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] in body or "\\" in body:
            raise ValueError(f"{where}: escapes in quoted strings are not supported")
        return body
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _BARE.fullmatch(text) and text.lower() not in _SPECIAL:
        return text
    raise ValueError(f"{where}: unsupported YAML value {text!r}")


def read_yaml(text: str) -> dict:
    """Parse the YAML subset of ``conf/*.yml`` into nested dicts: top-level
    keys, each a scalar or a mapping of scalars one indentation level down.
    Raises ``ValueError`` on any other construct (lists, flow collections,
    anchors, multi-line values, tabs, a third level)."""
    root: dict = {}
    section: Optional[dict] = None
    indent: Optional[int] = None
    for n, raw in enumerate(text.splitlines(), start=1):
        where = f"line {n}"
        if "\t" in raw:
            raise ValueError(f"{where}: tabs are not supported")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        depth = len(line) - len(line.lstrip(" "))
        m = _KEY.fullmatch(line.strip())
        if m is None:
            raise ValueError(f"{where}: expected 'key: value', got {raw!r}")
        key, value = m.group(1), m.group(2)
        if depth == 0:
            if key in root:
                raise ValueError(f"{where}: duplicate key {key!r}")
            if value is None:
                section, indent = root.setdefault(key, {}), None
            else:
                section = None
                root[key] = _scalar(value, where)
            continue
        if section is None or (indent is not None and depth != indent):
            raise ValueError(f"{where}: unexpected indentation")
        indent = depth
        if value is None:
            raise ValueError(f"{where}: mappings deeper than two levels are not supported")
        if key in section:
            raise ValueError(f"{where}: duplicate key {key!r}")
        section[key] = _scalar(value, where)
    # a key with nothing under it is null, as in YAML
    return {k: (None if v == {} else v) for k, v in root.items()}
