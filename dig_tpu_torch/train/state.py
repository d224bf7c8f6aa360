"""Train state and the momentum EMA (counterpart of `dig_tpu/train/state.py`).

JAX's state is an immutable pytree that each step replaces; here the model,
its momentum modules and the optimizer are updated in place, and the
state holds them with the step counter.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # holds the student and its momentum modules
    optimizer: object  # `dig_tpu_torch.optim.create_optimizer`'s
    step: int = 0

    @property
    def ema_modules(self):
        """[(student module, momentum module), ...]"""
        return self.model.ema_submodules()


@torch.no_grad()
def ema_update(pairs, momentum: float) -> None:
    """ema = m * ema + (1 - m) * param for every (student, momentum) module
    pair, in place (reference: modeling_pretrain_moco_mim_ori.py:428-442);
    the two products are rounded apart before the sum, as the JAX package
    computes them.  Elementwise, so under a mesh it runs on each rank's
    pieces: the momentum branch is sharded as the student is."""
    for student, ema in pairs:
        e = list(ema.parameters())
        p = [t.to(et.dtype) for t, et in zip(student.parameters(), e)]
        torch._foreach_mul_(e, momentum)
        torch._foreach_add_(e, torch._foreach_mul(p, 1.0 - momentum))
