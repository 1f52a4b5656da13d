"""Checkpoints over ``torch.save`` / ``torch.load``.

The surface of ``prior_diffuse_tpu/training/checkpoint.py``'s store: the
payload (``TrainerBase.ckpt_payload``: both nets' ``state_dict``s, both
optimizer states, step, generator state, plateau state) is saved per
epoch as ``<dir>/epochs/<epoch>.pt``, keeping the newest ``max_to_keep``,
plus a ``<dir>/best.pt`` alias.  Files are written to a temporary name
and renamed, so a crash never leaves a partial checkpoint under the real
name.  Loading is ``weights_only``: tensors and plain containers only.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, List, Optional

import torch

_EPOCH = re.compile(r"(\d+)\.pt")


class CheckpointStore:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._epochs = os.path.join(self.directory, "epochs")
        os.makedirs(self._epochs, exist_ok=True)

    def _save(self, path: str, payload: Any) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def _epoch_list(self) -> List[int]:
        found = (_EPOCH.fullmatch(n) for n in os.listdir(self._epochs))
        return sorted(int(m.group(1)) for m in found if m)

    def save_epoch(self, epoch: int, payload: Any) -> None:
        self._save(os.path.join(self._epochs, f"{epoch}.pt"), payload)
        if self.max_to_keep:
            for old in self._epoch_list()[:-self.max_to_keep]:
                os.remove(os.path.join(self._epochs, f"{old}.pt"))

    def save_best(self, payload: Any) -> None:
        self._save(os.path.join(self.directory, "best.pt"), payload)

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epoch_list()
        return epochs[-1] if epochs else None

    @staticmethod
    def _load(path: str) -> Any:
        # on the CPU: a generator state must be a CPU tensor, and
        # load_state_dict moves every other tensor to its module's device
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore_latest(self) -> Optional[Any]:
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        logging.info("restoring checkpoint epoch %d from %s", epoch, self.directory)
        return self._load(os.path.join(self._epochs, f"{epoch}.pt"))

    def restore_best(self) -> Optional[Any]:
        path = os.path.join(self.directory, "best.pt")
        return self._load(path) if os.path.exists(path) else None
