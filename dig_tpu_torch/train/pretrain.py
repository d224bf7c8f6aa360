"""The pre-training step: joint MoCo v3 contrastive + SimMIM pixel loss.

Counterpart of `dig_tpu/train/pretrain.py` (reference:
engine_for_pretraining_moco.py:26-204), with the same order of
operations:

1. the teacher momentum and the contrast weight are looked up from their
   schedules at the step counter;
2. the momentum branch is updated by EMA *before* its forward, from the
   student as it was before this step (reference :526-538);
3. the student runs on concat(ori, aug) with the flattened per-view masks
   (the aug view's mask zeroed under `only_mim_on_ori_img`), and the
   momentum branch on the same images and masks, without gradients;
4. loss = (InfoNCE(q1, k2) + InfoNCE(q2, k1)) * cw + pixel MSE * w_pixel,
   the pixel targets taken from the ori view only;
5. backward, then clipping + AdamW (`dig_tpu_torch.optim`).

The step runs where its model lives.  Masks and augmented views arrive as
batch inputs; the data path (`make_device_view_fn`, the loaders) is not
ported yet.  The returned metrics are device tensors, so a step does not
wait for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from dig_tpu_torch.losses.infonce import info_nce_loss
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.ops.patchify import mim_pixel_targets
from dig_tpu_torch.optim import global_norm
from dig_tpu_torch.train.state import TrainState, ema_update


def init_pretrain_state(model, optimizer) -> TrainState:
    """A fresh state: step 0, the momentum branch an exact copy of the
    student (the reference's init, modeling_pretrain_moco_mim_ori.py:399-409)."""
    model.reset_momentum()
    return TrainState(model=model, optimizer=optimizer, step=0)


def masked_mse(pred, target, mask):
    """Mean squared error over the masked patches only; `mask` [B, N] has an
    exact per-sample count, so this is the reference's gather + MSE."""
    acc = torch.promote_types(pred.dtype, torch.float32)
    err = (pred.to(acc) - target.to(acc)) ** 2
    m = mask.to(acc)[..., None]
    denom = torch.clamp(m.sum() * pred.shape[-1], min=1.0)
    return (err * m).sum() / denom


def make_pretrain_step(model, momentum_schedule, contrast_weight_schedule,
                       loss_weight_pixel: float = 1.0, only_mim_on_ori_img: bool = True,
                       normalize_target: bool = True):
    """Returns `train_step(state, batch) -> (state, metrics)`.  batch:
    images and aug_images [B, H, W, 3] (uint8, or floats already in
    [-1, 1]) and mask [B, 2, N] bool, as numpy arrays or tensors."""
    mom_arr = np.asarray(momentum_schedule, np.float32)
    cw_arr = np.asarray(contrast_weight_schedule, np.float32)

    def train_step(state: TrainState, batch):
        device = next(model.parameters()).device
        images = to_model_images(torch.as_tensor(batch["images"]).to(device))
        aug_images = to_model_images(torch.as_tensor(batch["aug_images"]).to(device))
        mask = torch.as_tensor(batch["mask"]).to(device)
        n_views = mask.shape[1]
        if n_views != 2:
            raise ValueError(f"pretrain step requires num_view == 2 (got mask [B, {n_views}, N]): "
                             f"the MoCo graph is two-view by construction")
        i = min(state.step, len(mom_arr) - 1)
        m, cw = float(mom_arr[i]), float(cw_arr[i])

        ema_update(state.ema_modules, m)

        all_images = torch.cat([images, aug_images], dim=0)
        flat_mask = None
        if model.use_pixel_target:
            if only_mim_on_ori_img:
                mask = mask.clone()
                mask[:, 1] = False  # aug view unmasked (engine :103-104)
            # [B, V, N] -> [V*B, N], row-aligned with concat(ori, aug)
            flat_mask = mask.transpose(0, 1).reshape(-1, mask.shape[-1])

        metrics = {}
        loss = torch.zeros((), dtype=torch.float32, device=device)
        out = model.forward_student(all_images, flat_mask)
        if model.use_moco_target:
            k1, k2 = model.forward_key(all_images, flat_mask)
            t, ls = model.temperature, model.label_smoothing
            l1, (a1, a5) = info_nce_loss(out["q1"], k2, t, ls, return_acc=True)
            l2, (b1, b5) = info_nce_loss(out["q2"], k1, t, ls, return_acc=True)
            contra = l1 + l2
            loss = loss + contra * cw
            metrics.update(loss_contrast=contra, q1_acc1=a1, q1_acc5=a5, q2_acc1=b1, q2_acc5=b5)
        if model.use_pixel_target:
            # targets always come from the ORI view, as in the reference
            targets = mim_pixel_targets(images, model.patch_size, normalize_target)
            pred_views = out["pix_pred"].chunk(2, dim=0)
            n_loss_views = 1 if only_mim_on_ori_img else n_views
            loss_pixel = torch.zeros((), dtype=torch.float32, device=device)
            for v in range(n_loss_views):
                loss_pixel = loss_pixel + (1.0 / n_loss_views) * masked_mse(
                    pred_views[v], targets, mask[:, v])
            loss = loss + loss_pixel * loss_weight_pixel
            metrics["loss_pixel"] = loss_pixel
        metrics["loss"] = loss

        opt = state.optimizer
        opt.zero_grad()
        loss.backward()
        metrics["grad_norm"] = global_norm(p.grad for p in opt.params if p.grad is not None)
        metrics["moco_m"] = torch.tensor(m, dtype=torch.float32)
        opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
