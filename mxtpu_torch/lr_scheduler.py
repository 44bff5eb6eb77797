"""Learning-rate schedulers — a copy of ``mxtpu/lr_scheduler.py`` (pure
Python, parity with ``python/mxnet/lr_scheduler.py``)."""

from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmupScheduler"]


class LRScheduler:
    def __init__(self, base_lr: float = 0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^(floor(num_update/step)) with stop_factor_lr
    floor."""

    def __init__(self, step: int, factor: float = 1.0,
                 stop_factor_lr: float = 1e-8, base_lr: float = 0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step, self.factor, self.stop_factor_lr = step, factor, \
            stop_factor_lr

    def __call__(self, num_update: int) -> float:
        lr = self.base_lr * (self.factor ** (num_update // self.step))
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Drop by ``factor`` at each step in a sorted step list."""

    def __init__(self, step, factor: float = 1.0, base_lr: float = 0.01):
        super().__init__(base_lr)
        self.steps = sorted(step)
        self.factor = factor

    def __call__(self, num_update: int) -> float:
        lr = self.base_lr
        for s in self.steps:
            if num_update >= s:
                lr *= self.factor
        return lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to final_lr over max_update steps."""

    def __init__(self, max_update: int, base_lr: float = 0.01, pwr: int = 2,
                 final_lr: float = 0.0):
        super().__init__(base_lr)
        self.max_update, self.pwr, self.final_lr = max_update, pwr, final_lr

    def __call__(self, num_update: int) -> float:
        if num_update >= self.max_update:
            return self.final_lr
        frac = 1.0 - num_update / self.max_update
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (frac ** self.pwr)


class CosineScheduler(LRScheduler):
    def __init__(self, max_update: int, base_lr: float = 0.01,
                 final_lr: float = 0.0):
        super().__init__(base_lr)
        self.max_update, self.final_lr = max_update, final_lr

    def __call__(self, num_update: int) -> float:
        if num_update >= self.max_update:
            return self.final_lr
        cos = (1 + math.cos(math.pi * num_update / self.max_update)) / 2
        return self.final_lr + (self.base_lr - self.final_lr) * cos


class WarmupScheduler(LRScheduler):
    """Linear warmup wrapper around another scheduler."""

    def __init__(self, base_scheduler: LRScheduler, warmup_steps: int,
                 warmup_begin_lr: float = 0.0):
        super().__init__(base_scheduler.base_lr)
        self.sched = base_scheduler
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            frac = num_update / max(1, self.warmup_steps)
            return self.warmup_begin_lr + \
                (self.base_lr - self.warmup_begin_lr) * frac
        return self.sched(num_update - self.warmup_steps)
