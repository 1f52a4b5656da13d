"""The configuration fields the serving path reads.

Dataclasses with the same names and defaults as ``prior_diffuse_tpu.config``
(``TrainConfig``, ``DiffusionConfig``, ``ExperimentConfig``), cut to the
fields the enhance path uses.  The defaults are the system of
``conf/diff.yml``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 6
    win_size: int = 320
    fft_num: int = 320
    win_shift: int = 160
    feat_type: str = "sqrt"  # normal | sqrt | cubic | log_1x | none


@dataclass(frozen=True)
class DiffusionConfig:
    pirorgrad: bool = True  # [sic] reference flag name
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
    # average this many independent reverse chains
    n_avg: int = 1
    # start the chain from zeros instead of a random draw
    zero_init: bool = False
    # network output parameterization: "eps" or "x0"
    predict: str = "eps"

    @property
    def num_steps(self) -> int:
        return len(self.noise_schedule)


@dataclass(frozen=True)
class ExperimentConfig:
    train: TrainConfig = field(default_factory=TrainConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
