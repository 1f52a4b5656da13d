"""Structured observability.

The counterpart of ``prior_diffuse_tpu/utils/logging.py``: Python logging
configured like the reference's ``main.py:53-67`` (stream + file, one
format), an append-only JSONL metrics sink, and the optional wandb mirror
(``--wandb``), which activates only when wandb is installed *and*
explicitly requested.  In a process group rank 0 alone writes the log file
and the metrics and runs wandb; the other ranks log to their stream.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

from prior_diffuse_tpu_torch.parallel.distributed import is_main


def setup_logging(log_dir: Optional[str] = None, level: str = "info") -> None:
    lvl = getattr(logging, level.upper(), logging.INFO)
    fmt = logging.Formatter("%(levelname)s - %(filename)s - %(asctime)s - %(message)s")
    root = logging.getLogger()
    root.setLevel(lvl)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        root.addHandler(h)
    if log_dir and is_main():
        os.makedirs(log_dir, exist_ok=True)
        h = logging.FileHandler(os.path.join(log_dir, "stdout.txt"))
        h.setFormatter(fmt)
        root.addHandler(h)


class MetricsLogger:
    """Append-only JSONL metrics (one object per log call); a no-op off
    rank 0 of a process group."""

    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 project: str = "prior-diffuse-tpu"):
        self._file = None
        self._wandb = None
        if not is_main():
            return
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project)
                self._wandb = wandb
            except ImportError:
                logging.warning("wandb requested but not installed; skipping")

    def log(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        record = {
            "time": time.time(),
            **{k: (v if isinstance(v, str) else float(v))
               for k, v in metrics.items()},
        }
        if step is not None:
            record["step"] = int(step)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._file:
            self._file.close()
