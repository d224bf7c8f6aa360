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
5. backward, then clipping + the optimizer (`dig_tpu_torch.optim`: any
   `--opt` of the JAX package).

The step runs where its model lives.  Masks and augmented views arrive as
batch inputs: from the host loader (`data/pipeline.py`, SeqCLR augmentation
on the workers), or, under `--device_aug`, from `make_device_view_fn` on
the model's device.  The step's `generator` draws the student's drop-path
masks (`--drop_path` > 0); the CLI seeds one per step from (seed, step)
(`utils/rng.py`).  The returned metrics are device tensors, so a step does
not wait for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from dig_tpu_torch.losses.infonce import info_nce_loss
from dig_tpu_torch.ops.images import to_model_images
from dig_tpu_torch.ops.patchify import mim_pixel_targets
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
    """Returns `train_step(state, batch, generator=None) -> (state,
    metrics)`.  batch: images and aug_images [B, H, W, 3] (uint8, or floats
    already in [-1, 1]) and mask [B, 2, N] bool, as numpy arrays or
    tensors.  `generator` (on the model's device) is the JAX step's `rng`:
    the student's drop-path draws from it; without one, or at drop-path
    rate 0, nothing is drawn."""
    mom_arr = np.asarray(momentum_schedule, np.float32)
    cw_arr = np.asarray(contrast_weight_schedule, np.float32)

    def train_step(state: TrainState, batch, generator=None):
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
        out = model.forward_student(all_images, flat_mask, generator)
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
        opt.reduce_gradients()  # across data-parallel ranks, before the norm
        metrics["grad_norm"] = opt.grad_norm()  # over the whole tensors under a mesh
        # filled on the device: torch.tensor(m, device=...) would copy from
        # pageable host memory, which waits for the card once a step
        metrics["moco_m"] = torch.full((), m, dtype=torch.float32, device=device)
        opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_device_view_fn(num_patches: int, mask_ratio: float = 0.7, num_view: int = 2):
    """The on-device view generator of `--device_aug`: returns
    `view_fn(generator, images, params=None)`, which turns a uint8 (or
    already normalized) image batch on the model's device into the whole
    pre-training batch {"images", "aug_images", "mask"}: the original view
    through `to_model_images`, the augmented second view
    (`device_augment`) and exact-count SimMIM masks [B, num_view, N].
    `generator` lives on the images' device; the augmentation's draws come
    first, then the masks'.  `params` hands the augmentation its draws
    (`draw_augment_params`); the masks are still drawn from `generator`."""
    from dig_tpu_torch.data.device_aug import device_augment, random_mask_batch

    num_mask = int(mask_ratio * num_patches)  # 179 for 0.7 x 256, as the JAX package counts

    @torch.no_grad()
    def view_fn(generator, images, params=None):
        images = to_model_images(images)  # uint8 transport (ops/images.py)
        aug = device_augment(generator, images, params)
        mask = random_mask_batch(generator, images.shape[0], num_patches, num_mask, num_view)
        return {"images": images, "aug_images": aug, "mask": mask}

    return view_fn
