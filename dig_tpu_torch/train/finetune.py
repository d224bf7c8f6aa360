"""The recognizers' fine-tuning steps and their eval steps.

Counterpart of `dig_tpu/train/finetune.py` (reference:
engine_for_finetuning.py:26-285):

* `make_finetune_step` (rec, attn, seq_cls and the decoupled decoder):
  teacher-forced pass with dropout and drop-path drawn from the step's
  `torch.Generator` (the JAX step's `rng`), label-smoothing sequence CE
  (plain CE at smoothing 0), backward, the global gradient norm before
  clipping, then clipping + the optimizer (`dig_tpu_torch.optim`); returns the
  greedy ids of the teacher-forced logits with the metrics;
* `make_distill_finetune_step`: the same plus a smooth-L1 (beta 2) between
  the student's projected features and a frozen teacher's standardized
  encoder features;
* `make_ctc_step` (`losses/ctc.py`) and `make_mim_finetune_step` (an exact-
  count mask on the first rows and a masked pixel MSE beside the CE);
* `make_eval_step`: deterministic greedy decode at full length (the JAX
  step's ``eos=-1``) and the per-row sequence CE of log(probs + 1e-9), the
  reference's logging convention (:232-249); or beam search with the real
  EOS and a per-row loss of 0; `with_cls` adds the presence logits of the
  multi-label head.  `make_ctc_eval_step`: the per-frame argmax.

The steps run where the model lives and take uint8 image batches, as the
JAX steps do.  Gradient accumulation (`update_freq` > 1) lives in the
optimizer (`dig_tpu_torch.optim`), as optax `MultiSteps` does in the
JAX package: the step is the same.  The returned metrics are device
tensors, so a step does not wait for the card.
"""

from __future__ import annotations

import torch

from dig_tpu_torch.data import masking
from dig_tpu_torch.losses.ctc import ctc_step_loss
from dig_tpu_torch.losses.seq_ce import (
    seq_cross_entropy,
    seq_cross_entropy_rows,
    seq_label_smoothing_cross_entropy,
)
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.ops.patchify import mim_pixel_targets
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


def _seq_ce(logits, targets, lengths, smoothing):
    if smoothing > 0:
        return seq_label_smoothing_cross_entropy(logits, targets, lengths, smoothing)
    return seq_cross_entropy(logits, targets, lengths)


def _backward_and_update(state: TrainState, loss, with_norm: bool = True):
    """backward, the data-parallel reduction, the global gradient norm
    before clipping (when `with_norm`), clipping + the update; returns the norm."""
    opt = state.optimizer
    opt.zero_grad()
    loss.backward()
    opt.reduce_gradients()  # across data-parallel ranks, before the norm
    grad_norm = (global_norm(p.grad for p in opt.params if p.grad is not None)
                 if with_norm else None)
    opt.step()
    state.step += 1
    return grad_norm


def make_finetune_step(model, smoothing: float = 0.1):
    """Returns `train_step(state, batch, generator) -> (state, metrics,
    pred_ids)`.  batch: images [B, H, W, 3] (uint8, or floats already in
    [-1, 1]), targets [B, T] and lengths [B], as numpy arrays or tensors;
    `generator` (on the model's device) draws this step's dropout masks.
    metrics: loss and grad_norm, the global norm of the gradients before
    clipping (`dig_tpu/train/finetune.py:75-79`).  A model that returns a
    tuple (`SeqClsRecModel`) trains on its first element, the logits."""

    def train_step(state: TrainState, batch, generator: torch.Generator):
        images, targets, lengths = _batch_on(model, batch)
        logits = model(images, targets, lengths, deterministic=False, generator=generator)
        if isinstance(logits, tuple):
            logits = logits[0]
        loss = _seq_ce(logits, targets, lengths, smoothing)
        grad_norm = _backward_and_update(state, loss)
        pred_ids = torch.argmax(logits.detach(), dim=-1)
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}, pred_ids

    return train_step


def standardize(x, eps: float = 1e-5):
    """`jax.nn.standardize` over the last axis: (x - mean) * rsqrt(var + eps)
    with var = max(E[x^2] - mean^2, 0)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0)
    return (x - mean) * torch.rsqrt(var + eps)


def make_distill_finetune_step(model, teacher, smoothing: float = 0.1,
                               loss_weight_feat_distill: float = 1.0):
    """Fine-tuning with feature distillation from a frozen teacher
    (reference engine_for_finetuning.py:32-41; `dig_tpu/train/finetune.py:82-123`):
    the teacher's `encode_features` under `no_grad`, standardized in fp32
    (eps 1e-5); the loss is the label-smoothing CE plus
    `loss_weight_feat_distill` times the mean smooth-L1 (beta 2) between
    the student's projected features and the teacher's.  `teacher` is a
    recognizer on the same device that is never updated.  metrics: loss,
    loss_rec, loss_distill, as the JAX step reports them."""

    def train_step(state: TrainState, batch, generator: torch.Generator):
        images, targets, lengths = _batch_on(model, batch)
        with torch.no_grad():
            t_feat = standardize(teacher.encode_features(images).float())
        logits, s_feat = model(images, targets, lengths, deterministic=False,
                               generator=generator)
        loss_rec = seq_label_smoothing_cross_entropy(logits, targets, lengths, smoothing)
        diff = torch.abs(s_feat.float() - t_feat)
        beta = 2.0
        loss_distill = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta).mean()
        loss = loss_rec + loss_weight_feat_distill * loss_distill
        _backward_and_update(state, loss, with_norm=False)
        metrics = {"loss": loss.detach(), "loss_rec": loss_rec.detach(),
                   "loss_distill": loss_distill.detach()}
        return state, metrics, torch.argmax(logits.detach(), dim=-1)

    return train_step


def make_ctc_step(model, blank_id: int):
    """The CTC recognizer's step (`dig_tpu/train/finetune.py:126-168`): the
    CTC loss of the per-frame logits against the targets without their EOS
    (`losses/ctc.py`), mean over the batch.  metrics: loss; pred_ids: the
    per-frame argmax [B, frames]."""

    def train_step(state: TrainState, batch, generator: torch.Generator):
        images, targets, lengths = _batch_on(model, batch)
        logits = model(images, deterministic=False, generator=generator)
        loss = ctc_step_loss(logits, targets, lengths, blank_id)
        _backward_and_update(state, loss, with_norm=False)
        return state, {"loss": loss.detach()}, torch.argmax(logits.detach(), dim=-1)

    return train_step


def make_mim_finetune_step(model, smoothing: float = 0.1, mask_ratio: float = 0.7,
                           mim_sample_ratio: float = 0.5, loss_weight_pixel: float = 1.0,
                           normalize_target: bool = True):
    """Fine-tuning with the auxiliary SimMIM pixel branch (`MimRecModel`;
    `dig_tpu/train/finetune.py:171-238`).  Each step the first
    ``round(mim_sample_ratio * B)`` rows get exact-count masks of
    ``int(mask_ratio * N)`` patches, drawn from the step's generator
    (`data.masking.random_mask_batch`) before the dropout masks; the CE
    covers the whole batch, and the masked-patch pixel MSE
    (`train.pretrain.masked_mse` of `mim_pixel_targets`) is added with
    weight `loss_weight_pixel`.  With no masked row the pixel branch is
    skipped.  metrics: loss, loss_rec, loss_pixel (with masked rows),
    grad_norm."""
    from dig_tpu_torch.train.pretrain import masked_mse

    def train_step(state: TrainState, batch, generator: torch.Generator):
        images, targets, lengths = _batch_on(model, batch)
        b, n = images.shape[0], model.encoder.num_patches
        num_mim = int(round(mim_sample_ratio * b))
        mask = None
        if num_mim > 0:
            m = masking.random_mask_batch(generator, num_mim, n, int(mask_ratio * n), 1)[:, 0]
            mask = torch.zeros((b, n), dtype=torch.bool, device=images.device)
            mask[:num_mim] = m.to(images.device)
        out = model(images, targets, lengths, mask, num_mim, deterministic=False,
                    generator=generator)
        logits = out["rec_pred"]
        loss = rec = _seq_ce(logits, targets, lengths, smoothing)
        metrics = {"loss_rec": rec.detach()}
        if num_mim > 0:
            pix_targets = mim_pixel_targets(images, model.encoder.patch_embed.patch_size,
                                            normalize_target)
            pix = masked_mse(out["pix_pred"], pix_targets, mask)
            loss = loss + pix * loss_weight_pixel
            metrics["loss_pixel"] = pix.detach()
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = _backward_and_update(state, loss)
        return state, metrics, torch.argmax(logits.detach(), dim=-1)

    return train_step


def make_eval_step(model, beam_width: int = 0, eos: int = 94, with_cls: bool = False):
    """Returns `eval_step(batch) -> (ids [B, T], per-row loss [B])`, and the
    presence logits [B, nb_classes] third with `with_cls` (`SeqClsRecModel`;
    `dig_tpu/train/finetune.py:265-309`).  Greedy decodes at full length
    (the early exit would leave the probabilities past the stop at 0, which
    the loss would read) and its loss is `seq_cross_entropy_rows` of
    log(probs + 1e-9) against the targets; beam (`beam_width` > 0) decodes
    with `eos` as its end symbol and its loss is 0 by convention."""
    decode_eos = -1 if beam_width == 0 else eos

    def eval_step(batch):
        images, targets, lengths = _batch_on(model, batch)
        if with_cls:
            probs, ids, cls_logit = model.recognize(images, beam_width, decode_eos, with_cls=True)
        else:
            probs, ids = model.recognize(images, beam_width, decode_eos)
        if probs is None:
            loss = torch.zeros((targets.shape[0],), dtype=torch.float32, device=targets.device)
        else:
            loss = seq_cross_entropy_rows(torch.log(probs + 1e-9), targets, lengths)
        return (ids, loss, cls_logit) if with_cls else (ids, loss)

    return eval_step


def make_ctc_eval_step(model):
    """`eval_step(batch) -> (per-frame argmax [B, frames], zeros [B])`: the
    collapse happens in the metric (`metrics.text.ctc_accuracy`); CTC
    reports no eval loss."""

    @torch.no_grad()
    def eval_step(batch):
        images, targets, _ = _batch_on(model, batch)
        ids = torch.argmax(model(images, deterministic=True), dim=-1)
        return ids, torch.zeros((targets.shape[0],), dtype=torch.float32, device=targets.device)

    return eval_step
