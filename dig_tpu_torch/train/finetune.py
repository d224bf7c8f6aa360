"""The recognizer's fine-tuning step and its eval step.

Counterpart of `dig_tpu/train/finetune.py` for ``model_kind="rec"``
(reference: engine_for_finetuning.py:26-285):

* `make_finetune_step`: teacher-forced pass with dropout and drop-path
  drawn from the step's `torch.Generator` (the JAX step's `rng`), label-
  smoothing sequence CE (plain CE at smoothing 0), backward, the global
  gradient norm before clipping, then clipping + AdamW
  (`dig_tpu_torch.optim`); returns the greedy ids of the teacher-forced
  logits with the metrics;
* `make_eval_step`: deterministic greedy decode at full length (the JAX
  step's ``eos=-1``) and the per-row sequence CE of log(probs + 1e-9), the
  reference's logging convention (:232-249); or beam search with the real
  EOS and a per-row loss of 0.

The steps run where the model lives and take uint8 image batches, as the
JAX steps do.  Gradient accumulation (`update_freq` > 1) lives in the
optimizer (`dig_tpu_torch.optim.AdamW`), as optax `MultiSteps` does in the
JAX package: the step is the same.  The returned metrics are device
tensors, so a step does not wait for the card.
"""

from __future__ import annotations

import torch

from dig_tpu_torch.losses.seq_ce import (
    seq_cross_entropy,
    seq_cross_entropy_rows,
    seq_label_smoothing_cross_entropy,
)
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.optim import global_norm
from dig_tpu_torch.train.state import TrainState


def init_finetune_state(model, optimizer) -> TrainState:
    """A fresh state at step 0 (the model holds its own parameters)."""
    return TrainState(model=model, optimizer=optimizer, step=0)


def _batch_on(model, batch):
    device = next(model.parameters()).device
    images = to_model_images(torch.as_tensor(batch["images"]).to(device))
    targets = torch.as_tensor(batch["targets"]).to(device).long()
    lengths = torch.as_tensor(batch["lengths"]).to(device).long()
    return images, targets, lengths


def make_finetune_step(model, smoothing: float = 0.1):
    """Returns `train_step(state, batch, generator) -> (state, metrics,
    pred_ids)`.  batch: images [B, H, W, 3] (uint8, or floats already in
    [-1, 1]), targets [B, T] and lengths [B], as numpy arrays or tensors;
    `generator` (on the model's device) draws this step's dropout masks.
    metrics: loss and grad_norm, the global norm of the gradients before
    clipping (`dig_tpu/train/finetune.py:75-79`)."""

    def train_step(state: TrainState, batch, generator: torch.Generator):
        images, targets, lengths = _batch_on(model, batch)
        logits = model(images, targets, lengths, deterministic=False, generator=generator)
        if smoothing > 0:
            loss = seq_label_smoothing_cross_entropy(logits, targets, lengths, smoothing)
        else:
            loss = seq_cross_entropy(logits, targets, lengths)
        opt = state.optimizer
        opt.zero_grad()
        loss.backward()
        grad_norm = global_norm(p.grad for p in opt.params if p.grad is not None)
        opt.step()
        state.step += 1
        pred_ids = torch.argmax(logits.detach(), dim=-1)
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}, pred_ids

    return train_step


def make_eval_step(model, beam_width: int = 0, eos: int = 94):
    """Returns `eval_step(batch) -> (ids [B, T], per-row loss [B])`
    (`dig_tpu/train/finetune.py:265-309`).  Greedy decodes at full length
    (the early exit would leave the probabilities past the stop at 0, which
    the loss would read) and its loss is `seq_cross_entropy_rows` of
    log(probs + 1e-9) against the targets; beam (`beam_width` > 0) decodes
    with `eos` as its end symbol and its loss is 0 by convention."""
    decode_eos = -1 if beam_width == 0 else eos

    def eval_step(batch):
        images, targets, lengths = _batch_on(model, batch)
        probs, ids = model.recognize(images, beam_width, decode_eos)
        if probs is None:
            return ids, torch.zeros((targets.shape[0],), dtype=torch.float32,
                                    device=targets.device)
        return ids, seq_cross_entropy_rows(torch.log(probs + 1e-9), targets, lengths)

    return eval_step
