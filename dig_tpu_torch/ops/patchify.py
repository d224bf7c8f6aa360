"""Patch <-> pixel reshapes and the SimMIM pixel targets.

Counterpart of `dig_tpu/ops/patchify.py`.  Targets are built for every
patch and the loss is masked (`train.pretrain.masked_mse`), as in the JAX
package, instead of the reference's boolean gather.
"""

from __future__ import annotations

import torch


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p, C] (the reference's
    'b c (h p1) (w p2) -> b (h w) (p1 p2) c' on NHWC input)."""
    b, h, w, c = images.shape
    p = patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p, c)


def unpatchify(patches: torch.Tensor, patch_size: int, height: int, width: int) -> torch.Tensor:
    """Inverse of `patchify`: [B, N, p*p*C] -> [B, H, W, C]."""
    b, n, d = patches.shape
    p = patch_size
    gh, gw = height // p, width // p
    x = patches.reshape(b, gh, gw, p, p, d // (p * p)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, height, width, d // (p * p))


def mim_pixel_targets(images: torch.Tensor, patch_size: int, normalize_target: bool = True,
                      mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """Per-patch regression targets [B, N, p*p*C]: un-normalize to [0, 1],
    optionally standardize each patch over its pixels with the unbiased
    variance and 1e-6 added outside the sqrt
    (engine_for_pretraining_moco.py:89-96; `dig_tpu/ops/patchify.py:52-55`)."""
    patches = patchify(images * std + mean, patch_size)
    if normalize_target:
        mu = patches.mean(dim=-2, keepdim=True)
        n = patches.shape[-2]
        var = ((patches - mu) ** 2).mean(dim=-2, keepdim=True) * (n / max(n - 1, 1))
        patches = (patches - mu) / (torch.sqrt(var) + 1e-6)
    b, num, pp, c = patches.shape
    return patches.reshape(b, num, pp * c)
