"""Learning-rate schedules (port of espnet_tpu/train/schedulers.py).

Each builder returns fn(step) -> lr, a float32 tensor on the step's device;
`step` is the optimizer's count before its increment, clamped at 1 where the
formula divides by it. noam: lr · d_model^-0.5 · min(s^-0.5, s·w^-1.5);
warmuplr: lr · w^0.5 · min(s^-0.5, s·w^-1.5) (peak lr at step w).
"""

from __future__ import annotations

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).clamp(min=1).float()


def noam_schedule(base_lr: float, d_model: int, warmup_steps: int = 25000):
    def fn(step):
        s = _steps(step)
        return (base_lr * d_model ** -0.5
                * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5))

    return fn


def warmup_schedule(base_lr: float, warmup_steps: int = 25000):
    def fn(step):
        s = _steps(step)
        return (base_lr * warmup_steps ** 0.5
                * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5))

    return fn


def constant_schedule(base_lr: float):
    def fn(step):
        return torch.full((), base_lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return fn


def exponential_decay_schedule(base_lr: float, decay_rate: float,
                               decay_steps: int):
    def fn(step):
        s = torch.as_tensor(step).float()
        return base_lr * decay_rate ** (s / decay_steps)

    return fn


def build_schedule(name, base_lr: float, **kw):
    if name == "noam":
        return noam_schedule(base_lr, kw.get("d_model", 256),
                             kw.get("warmup_steps", 25000))
    if name == "warmuplr":
        return warmup_schedule(base_lr, kw.get("warmup_steps", 25000))
    if name == "constant" or name is None:
        return constant_schedule(base_lr)
    if name == "exponential":
        return exponential_decay_schedule(
            base_lr, kw.get("decay_rate", 0.96), kw.get("decay_steps", 10000))
    raise ValueError(f"unknown schedule {name}")
