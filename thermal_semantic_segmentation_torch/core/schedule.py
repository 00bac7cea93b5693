"""LR schedules (counterpart of the JAX ``core/schedule.py``, which the port
keeps its own copy of).

``ReduceLROnPlateau`` mirrors torch's defaults (factor 0.1, patience 10,
threshold 1e-4 'rel', cooldown 0) but keeps a scale that the train step
multiplies into each param group's lr. ``torch.optim.lr_scheduler.
ReduceLROnPlateau`` is not used: its ``eps=1e-8`` drops a reduction once
``old_lr - new_lr <= 1e-8``, so from lr 1e-4 the fifth reduction and later
are skipped where this scale keeps falling.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 cooldown: int = 0, min_scale: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {mode!r}")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_scale = min_scale
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.scale = 1.0
        self.num_steps = 0          # values fed so far

    def _is_better(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, value: float) -> float:
        """Feed the monitored metric; returns the current LR scale."""
        self.num_steps += 1
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.scale


def poly_lr(base_lr: float, step: int, num_steps: int,
            power: float = 0.9) -> float:
    """Poly decay: ``base_lr * (1 - step / num_steps) ** power``."""
    return base_lr * (1.0 - step / num_steps) ** power
