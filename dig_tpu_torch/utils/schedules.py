"""Step-resolution schedules as numpy arrays, indexed by the step counter.

The port's own copy of `dig_tpu/utils/schedules.py` (reference:
utils/utils.py:522-543, engine_for_pretraining_moco.py:47-73): the same
arrays for the same arguments.
"""

from __future__ import annotations

import numpy as np


def cosine_schedule(base_value: float, final_value: float, epochs: int, steps_per_epoch: int,
                    warmup_epochs: int = 0, start_warmup_value: float = 0.0,
                    warmup_steps: int = -1) -> np.ndarray:
    """Linear warmup followed by cosine decay, one value per optimizer step."""
    warmup_iters = warmup_epochs * steps_per_epoch
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    total = epochs * steps_per_epoch
    warmup_iters = min(warmup_iters, total)
    warmup = (np.linspace(start_warmup_value, base_value, warmup_iters)
              if warmup_iters > 0 else np.array([]))
    n = total - warmup_iters
    body = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * np.arange(n) / max(n, 1)))
    schedule = np.concatenate([warmup, body])
    assert len(schedule) == total
    return schedule.astype(np.float32)


def moco_momentum_schedule(moco_m: float, epochs: int, steps_per_epoch: int,
                           use_cosine: bool = True) -> np.ndarray:
    """Per-step teacher momentum: moco_m -> 1 along a half cosine over the
    fractional epoch, or constant."""
    total = epochs * steps_per_epoch
    if not use_cosine:
        return np.full((total,), moco_m, dtype=np.float32)
    frac_epoch = np.arange(total) / steps_per_epoch
    m = 1.0 - 0.5 * (1.0 + np.cos(np.pi * frac_epoch / epochs)) * (1.0 - moco_m)
    return m.astype(np.float32)


def contrast_weight_schedule(loss_weight: float, epochs: int, steps_per_epoch: int,
                             start_epoch: int = 0, warmup_steps: int = 0) -> np.ndarray:
    """Contrastive-loss weight: zero before `start_epoch`, a linear ramp over
    `warmup_steps`, then flat at `loss_weight`."""
    total = epochs * steps_per_epoch
    w = np.zeros((total,), dtype=np.float32)
    start = start_epoch * steps_per_epoch
    if start >= total:
        return w
    ramp = min(warmup_steps, total - start)
    if ramp > 0:
        w[start:start + ramp] = np.linspace(0.0, loss_weight, ramp)
    w[start + ramp:] = loss_weight
    return w
