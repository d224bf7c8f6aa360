"""The AdamW path of `dig_tpu/optim.py::create_optimizer`.

Semantics of the JAX package's AdamW (optax `scale_by_adam` + decoupled,
masked weight decay + schedule-driven lr and wd + per-parameter lr
scales), on `torch.optim.AdamW` with one parameter group per (decay,
lr scale) pair:

* bias-corrected moments, eps outside the sqrt: torch's
  m / bc1 / (sqrt(v) / sqrt(bc2) + eps) is optax's m_hat / (sqrt(v_hat) + eps);
* decoupled decay -lr * scale * wd * p on every parameter except the
  no-decay set (`is_no_decay`: 1-D parameters, biases, norm scales, and by
  name the position / cls / mask tokens -- `encoder.mask_token` is 3-D);
* layer-wise lr decay (`layer_scales`, reference optim_factory.py:32-54):
  lr * layer_decay ** (num_layers + 1 - layer id), with the ViT layer ids
  of `vit_layer_id`;
* frozen encoder layers (`frozen_encoder_mask`): lr scale 0, so they keep
  their values while their gradients still count in the global norm and
  their moments still update, as in the JAX package;
* optional clipping by the global norm with factor
  min(1, clip / (||g|| + 1e-6));
* lr and wd read from the schedule arrays at index min(count, len - 1)
  before every update;
* every parameter is updated, a parameter without a gradient as with a
  zero one (optax steps every leaf; `torch.optim.AdamW` alone would skip
  it);
* gradient accumulation (`update_freq` k > 1, optax `MultiSteps` in the
  JAX package): each call of `step` folds the gradients into a running
  mean, acc + (g - acc) / (n + 1) for the n-th of k; the k-th call clips
  that mean and applies AdamW, and the mean starts again from 0.  `count`,
  the schedules' index and AdamW's step tensors count applied updates only.

The other optimizers of the JAX factory (AdamP, LAMB, Lookahead, ...) are
not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

NO_DECAY_NAMES = ("pos_embed", "cls_token", "mask_token")
_EMBED_NAMES = ("cls_token", "mask_token", "pos_embed", "patch_embed")


def is_no_decay(name: str, param: torch.Tensor) -> bool:
    return param.ndim <= 1 or any(tok in name for tok in NO_DECAY_NAMES)


def vit_layer_id(name: str, num_layers: int) -> int:
    """ViT depth index of a parameter for layer-wise lr decay
    (`dig_tpu/optim.py:43-55`; reference optim_factory.py:32-43): 0 for the
    embeddings, i + 1 for block i, num_layers - 1 for everything else; the
    `encoder.` prefix is stripped first."""
    if name.startswith("encoder."):
        name = name[len("encoder."):]
    parts = name.split(".")
    if parts[0] in _EMBED_NAMES:
        return 0
    if parts[0] == "blocks":
        return int(parts[1]) + 1
    return num_layers - 1


def layer_scales(names, layer_decay: float, num_layers: int) -> dict:
    """{name: lr multiplier layer_decay ** (num_layers + 1 - id)}
    (`dig_tpu/optim.py:58-66`)."""
    scales = [layer_decay ** (num_layers + 1 - i) for i in range(num_layers + 2)]
    return {n: scales[min(vit_layer_id(n, num_layers + 2), num_layers + 1)] for n in names}


def frozen_encoder_mask(num_frozen_layers: int) -> Callable[[str], bool]:
    """Predicate on parameter names: the encoder's embeddings and its first
    `num_frozen_layers` blocks (`dig_tpu/optim.py:69-86`; reference
    run_class_finetuning.py:500-516)."""

    def is_frozen(name: str) -> bool:
        if num_frozen_layers <= 0 or not name.startswith("encoder."):
            return False
        parts = name.split(".")
        if parts[1] in _EMBED_NAMES:
            return True
        return parts[1] == "blocks" and int(parts[2]) < num_frozen_layers

    return is_frozen


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor (optax's `global_norm`)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class AdamW:
    def __init__(self, named_params, lr_schedule, wd_schedule=None, betas=(0.9, 0.999),
                 eps: float = 1e-8, clip_grad: Optional[float] = None, layer_decay: float = 1.0,
                 num_layers: int = 12, frozen: Optional[Callable[[str], bool]] = None,
                 update_freq: int = 1):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.params = [p for _, p in named]
        self.update_freq = int(update_freq)
        self.mini_step = 0  # gradients folded into `acc` since the last update
        self.acc = None
        self.lr = np.asarray(lr_schedule, np.float32)
        self.wd = None if wd_schedule is None else np.asarray(wd_schedule, np.float32)
        self.clip_grad = clip_grad
        self.count = 0
        scales = (layer_scales([n for n, _ in named], layer_decay, num_layers)
                  if layer_decay < 1.0 else {})
        groups = {}  # (no decay, lr scale) -> params; decaying groups first
        for n, p in named:
            scale = 0.0 if frozen is not None and frozen(n) else scales.get(n, 1.0)
            groups.setdefault((is_no_decay(n, p), -scale), []).append(p)
        self.inner = torch.optim.AdamW(
            [{"params": ps, "no_decay": key[0], "lr_scale": -key[1]}
             for key, ps in sorted(groups.items())],
            lr=0.0, betas=tuple(betas), eps=eps, weight_decay=0.0)

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Take the parameters' `.grad`s: an update, or with `update_freq`
        > 1 one more gradient into the running mean and an update on the
        k-th.  Returns whether the parameters were updated."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.update_freq > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < self.update_freq:
                return False
            self.mini_step = 0
            grads = [a.clone() for a in self.acc]
            torch._foreach_zero_(self.acc)
        for p, g in zip(self.params, grads):
            p.grad = g
        if self.clip_grad is not None:
            factor = torch.clamp(self.clip_grad / (global_norm(grads) + 1e-6), max=1.0)
            torch._foreach_mul_(grads, factor)
        i = min(self.count, len(self.lr) - 1)
        wd = 0.0 if self.wd is None else float(self.wd[i])
        for group in self.inner.param_groups:
            group["lr"] = float(self.lr[i]) * group["lr_scale"]
            group["weight_decay"] = 0.0 if group["no_decay"] else wd
        self.inner.step()
        self.count += 1
        return True


def create_optimizer(opt_name: str, named_params, lr_schedule, wd_schedule=None,
                     betas=(0.9, 0.999), eps: float = 1e-8,
                     clip_grad: Optional[float] = None, layer_decay: float = 1.0,
                     num_layers: int = 12, frozen: Optional[Callable[[str], bool]] = None,
                     update_freq: int = 1) -> AdamW:
    """`create_optimizer` of the JAX package for ``opt_name="adamw"``;
    `frozen` is a predicate on parameter names (`frozen_encoder_mask`);
    `update_freq` > 1 accumulates as optax `MultiSteps` wrapped around it
    does (`dig_tpu/cli/run_finetune.py:330-334`)."""
    if opt_name.lower() != "adamw":
        raise NotImplementedError(f"optimizer {opt_name!r} is not ported yet (adamw only; "
                                  f"see ROADMAP.md)")
    return AdamW(named_params, lr_schedule, wd_schedule, betas, eps, clip_grad, layer_decay,
                 num_layers, frozen, update_freq)
