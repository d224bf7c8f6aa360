"""The AdamW path of `dig_tpu/optim.py::create_optimizer`.

Semantics of the JAX package's AdamW (optax `scale_by_adam` + decoupled,
masked weight decay + schedule-driven lr and wd), on `torch.optim.AdamW`
with two parameter groups:

* bias-corrected moments, eps outside the sqrt: torch's
  m / bc1 / (sqrt(v) / sqrt(bc2) + eps) is optax's m_hat / (sqrt(v_hat) + eps);
* decoupled decay -lr * wd * p on every parameter except the no-decay set
  (`is_no_decay`: 1-D parameters, biases, norm scales, and by name the
  position / cls / mask tokens -- `encoder.mask_token` is 3-D);
* optional clipping by the global norm with factor
  min(1, clip / (||g|| + 1e-6));
* lr and wd read from the schedule arrays at index min(count, len - 1)
  before every step.

The other optimizers of the JAX factory (layer-wise decay, AdamP, LAMB, ...)
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NO_DECAY_NAMES = ("pos_embed", "cls_token", "mask_token")


def is_no_decay(name: str, param: torch.Tensor) -> bool:
    return param.ndim <= 1 or any(tok in name for tok in NO_DECAY_NAMES)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor (optax's `global_norm`)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class AdamW:
    def __init__(self, named_params, lr_schedule, wd_schedule=None, betas=(0.9, 0.999),
                 eps: float = 1e-8, clip_grad: Optional[float] = None):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.params = [p for _, p in named]
        self.lr = np.asarray(lr_schedule, np.float32)
        self.wd = None if wd_schedule is None else np.asarray(wd_schedule, np.float32)
        self.clip_grad = clip_grad
        self.count = 0
        self.inner = torch.optim.AdamW(
            [{"params": [p for n, p in named if not is_no_decay(n, p)]},
             {"params": [p for n, p in named if is_no_decay(n, p)]}],
            lr=0.0, betas=tuple(betas), eps=eps, weight_decay=0.0)

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self):
        """One update from the parameters' `.grad`s."""
        if self.clip_grad is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            factor = torch.clamp(self.clip_grad / (global_norm(grads) + 1e-6), max=1.0)
            torch._foreach_mul_(grads, factor)
        i = min(self.count, len(self.lr) - 1)
        decay, no_decay = self.inner.param_groups
        decay["lr"] = no_decay["lr"] = float(self.lr[i])
        decay["weight_decay"] = 0.0 if self.wd is None else float(self.wd[i])
        self.inner.step()
        self.count += 1


def create_optimizer(opt_name: str, named_params, lr_schedule, wd_schedule=None,
                     betas=(0.9, 0.999), eps: float = 1e-8,
                     clip_grad: Optional[float] = None) -> AdamW:
    """`create_optimizer` of the JAX package for ``opt_name="adamw"``."""
    if opt_name.lower() != "adamw":
        raise NotImplementedError(f"optimizer {opt_name!r} is not ported yet (adamw only; "
                                  f"see ROADMAP.md)")
    return AdamW(named_params, lr_schedule, wd_schedule, betas, eps, clip_grad)
