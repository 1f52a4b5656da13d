"""LR-halving-on-plateau + early stopping.

Extracted from the scaffold duplicated across all three reference
trainers (``trainer/complex_ddpm_trainer.py:583-610``): when CV loss
fails to improve, count; at ``half_lr`` consecutive bad epochs halve the
LR(s); at ``early_stop`` bad epochs stop.  Comparison is against the
*previous* epoch's loss (not the best), matching the reference.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PlateauController:
    half_lr: int = 3
    early_stop: int = 5
    prev_loss: float = float("inf")
    best_loss: float = float("inf")
    bad_epochs: int = 0

    def update(self, cv_loss: float):
        """-> (halve_lr: bool, stop: bool, is_best: bool)."""
        halve = False
        stop = False
        if self.half_lr > 1:
            if cv_loss >= self.prev_loss:
                self.bad_epochs += 1
                if self.bad_epochs == self.half_lr:
                    halve = True
                if self.bad_epochs >= self.early_stop > 0:
                    stop = True
            else:
                self.bad_epochs = 0
        self.prev_loss = cv_loss
        is_best = cv_loss < self.best_loss
        if is_best:
            self.best_loss = cv_loss
        return halve, stop, is_best
