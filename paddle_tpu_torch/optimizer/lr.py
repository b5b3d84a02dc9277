"""Learning-rate schedulers (mirrors ``paddle_tpu/optimizer/lr.py``).

Each scheduler is a pure function of the step counter, ``value(step)``,
which the optimizer evaluates at its own step count, as the reference's do
inside its jitted step.  Values are Python floats (the optimizer's
float32 arithmetic rounds them).  The imperative ``step()`` / ``get_lr()``
mirror keeps the reference's API.
"""

from __future__ import annotations

import math

__all__ = ["LRScheduler", "ConstantLR", "LinearWarmup", "CosineAnnealingDecay",
           "StepDecay", "MultiStepDecay", "ExponentialDecay", "NoamDecay",
           "PolynomialDecay"]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.step()  # initialise to epoch 0 like the reference

    def value(self, step) -> float:
        """lr at integer ``step`` — overridden by each scheduler."""
        raise NotImplementedError

    # -- imperative mirror --------------------------------------------------
    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1

    def get_lr(self) -> float:
        return self.value(self.last_epoch)

    def state_dict(self):
        return {"last_epoch": self.last_epoch}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]


class ConstantLR(LRScheduler):
    def value(self, step) -> float:
        return self.base_lr


class LinearWarmup(LRScheduler):
    """Linear warmup into an inner scheduler (or a constant)."""

    def __init__(self, learning_rate, warmup_steps: int, start_lr: float = 0.0,
                 end_lr: float = None, last_epoch: int = -1):
        self.inner = learning_rate if isinstance(learning_rate, LRScheduler) \
            else None
        base = learning_rate.base_lr if self.inner else float(learning_rate)
        self.warmup_steps = int(warmup_steps)
        self.start_lr = float(start_lr)
        self.end_lr = float(end_lr) if end_lr is not None else base
        super().__init__(base, last_epoch)

    def value(self, step) -> float:
        step = float(step)
        if step >= self.warmup_steps:
            if self.inner is not None:
                return self.inner.value(max(step - self.warmup_steps, 0.0))
            return self.end_lr
        frac = _clip(step / max(self.warmup_steps, 1), 0.0, 1.0)
        return self.start_lr + (self.end_lr - self.start_lr) * frac


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, T_max: int, eta_min: float = 0.0,
                 last_epoch: int = -1):
        self.T_max = int(T_max)
        self.eta_min = float(eta_min)
        super().__init__(learning_rate, last_epoch)

    def value(self, step) -> float:
        t = _clip(float(step) / self.T_max, 0.0, 1.0)
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1.0 + math.cos(math.pi * t))


class StepDecay(LRScheduler):
    def __init__(self, learning_rate: float, step_size: int, gamma: float = 0.1,
                 last_epoch: int = -1):
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        super().__init__(learning_rate, last_epoch)

    def value(self, step) -> float:
        return self.base_lr * self.gamma ** math.floor(
            float(step) / self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate: float, milestones, gamma: float = 0.1,
                 last_epoch: int = -1):
        self.milestones = [int(m) for m in milestones]
        self.gamma = float(gamma)
        super().__init__(learning_rate, last_epoch)

    def value(self, step) -> float:
        k = sum(1 for m in self.milestones if float(step) >= m)
        return self.base_lr * self.gamma ** k


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1):
        self.gamma = float(gamma)
        super().__init__(learning_rate, last_epoch)

    def value(self, step) -> float:
        return self.base_lr * self.gamma ** float(step)


class NoamDecay(LRScheduler):
    def __init__(self, d_model: int, warmup_steps: int,
                 learning_rate: float = 1.0, last_epoch: int = -1):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch)

    def value(self, step) -> float:
        s = max(float(step), 1.0)
        return self.base_lr * (self.d_model ** -0.5) * min(
            s ** -0.5, s * (self.warmup_steps ** -1.5))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int,
                 end_lr: float = 0.0001, power: float = 1.0,
                 last_epoch: int = -1):
        self.decay_steps = int(decay_steps)
        self.end_lr = float(end_lr)
        self.power = float(power)
        super().__init__(learning_rate, last_epoch)

    def value(self, step) -> float:
        t = _clip(float(step) / self.decay_steps, 0.0, 1.0)
        return (self.base_lr - self.end_lr) * (1.0 - t) ** self.power \
            + self.end_lr
