"""On-device batched augmentation: the pre-training half.

Counterpart of `dig_tpu/data/device_aug.py`'s `device_augment` and what it
stands on (`batched_affine_warp`, `_rand_affine_mats`, `_gaussian_blur`).
The reference augments per sample on CPU workers (imgaug / cv2 pipelines,
dataset/dataset_lmdb.py:102-153); `--device_aug` makes the second MoCo
view on the model's device instead, for a whole batch at once: the
geometric warp is one batched bilinear gather, the photometric operations
are elementwise, and the SimMIM masks come from `random_mask_batch`.
Distribution-matched to the SeqCLR host pipeline (each family of
operations present, magnitudes comparable), not identical to it.

Inputs and outputs are normalized float images ([-1, 1], mean = std = 0.5)
in NHWC.  No hand-written kernel: the JAX package's version is plain `jnp`
too.

Randomness.  torch's Philox and JAX's threefry cannot give the same
numbers, so every random quantity enters through a seam:
`draw_augment_params` draws them all from a `torch.Generator`, and
`device_augment(..., params=...)` takes them as given.  With the JAX
package's own draws as `params` the two packages give the same view
(tests/test_torch_port_device_aug.py).

The ABI augmentation of fine-tuning (`device_abi_augment`, the projective
warp, motion blur, down-up rescale, hue rotation) is not ported yet; see
ROADMAP.md.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from dig_tpu_torch.data.masking import random_mask_batch  # re-export for callers

__all__ = ["device_augment", "draw_augment_params", "batched_affine_warp", "affine_mats",
           "random_mask_batch"]


def batched_affine_warp(images: torch.Tensor, inv_mats: torch.Tensor) -> torch.Tensor:
    """Bilinear warp: for each output pixel p, sample the input at A_inv @ p.

    images [B, H, W, C]; inv_mats [B, 2, 3] (output -> input mapping about
    the image centre, in pixels).  The *source coordinate* is clamped to
    the image and the interpolation runs between clamped neighbours
    (== cv2 BORDER_REPLICATE), as the JAX package writes it out;
    `F.grid_sample` is another function (normalised coordinates, its own
    border rule) and is not used.
    """
    b, h, w, c = images.shape
    dev = images.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)   # [1, HW]

    # A_inv @ (x, y, 1), summed as an fp32 matrix product sums it: over k in
    # order, each step one fused multiply-add.  The middle step is taken in
    # fp64 and rounded once, which is that FMA on every device; no GEMM
    # (a library's may run in TF32) and no reliance on a compiler's fusing.
    # A coordinate that differs in its last bit (2^-17 pixels below 128)
    # moves a bilinear sample by up to 1.5e-5 on an image of noise.
    m = inv_mats.to(torch.float32)

    def row(i, centre):
        t = (m[:, i, 0:1] * gx).double() + m[:, i, 1:2].double() * gy.double()
        return t.float() + m[:, i, 2:3] + centre

    sx = row(0, (w - 1) / 2.0)  # [B, HW]
    sy = row(1, (h - 1) / 2.0)
    sx = sx.clamp(0.0, w - 1.0)
    sy = sy.clamp(0.0, h - 1.0)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    flat = images.reshape(b, h * w, c)

    def gather(yi, xi):
        idx = (yi * w + xi).to(torch.int64)  # [B, HW]
        return torch.take_along_dim(flat, idx[..., None], dim=1)

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return out.reshape(b, h, w, c)


def affine_mats(angle, scale, shear, tx, ty, h: int = 32, w: int = 128) -> torch.Tensor:
    """Per-sample inverse affine matrices [B, 2, 3] from the drawn
    quantities, each [B]: `angle` and `shear` in degrees, `scale` a factor,
    `tx` / `ty` as fractions of the width / height.  fp32 throughout, as in
    the JAX package.  cos, sin and tan differ by an ulp or two between the
    CPU and the card, which the warp turns into up to 2e-5 pixels at the
    image's ends, and up to 4e-5 in a sample of an image of noise (seen on
    an NVIDIA H100 by chip_smoke.py's `[device view]` check)."""
    angle = angle * (math.pi / 180.0)
    sh = shear * (math.pi / 180.0)
    tx = tx * w
    ty = ty * h
    cos, sin = torch.cos(angle), torch.sin(angle)
    tan = torch.tan(sh)
    # forward matrix F = sc * rot @ shear_x
    #                 = sc * [[cos, -sin + cos*tan], [sin, cos + sin*tan]]
    f00 = scale * cos
    f01 = scale * (-sin + cos * tan)
    f10 = scale * sin
    f11 = scale * (cos + sin * tan)
    det = f00 * f11 - f01 * f10
    i00 = f11 / det
    i01 = -f01 / det
    i10 = -f10 / det
    i11 = f00 / det
    # inverse translation in source space
    itx = -(i00 * tx + i01 * ty)
    ity = -(i10 * tx + i11 * ty)
    return torch.stack(
        [torch.stack([i00, i01, itx], -1), torch.stack([i10, i11, ity], -1)], dim=1)


def _uniform(generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def _draw_affine(generator, b, degrees=10.0, scale=(0.8, 1.25), shear=15.0,
                 translate=0.1) -> dict:
    return {"angle": _uniform(generator, (b,), -degrees, degrees),
            "scale": _uniform(generator, (b,), scale[0], scale[1]),
            "shear": _uniform(generator, (b,), -shear, shear),
            "tx": _uniform(generator, (b,), -translate, translate),
            "ty": _uniform(generator, (b,), -translate, translate)}


def _rand_affine_mats(generator, b, degrees=10.0, scale=(0.8, 1.25), shear=15.0,
                      translate=0.1, h=32, w=128):
    """Per-sample inverse affine matrices [B, 2, 3], drawn from `generator`."""
    return affine_mats(**_draw_affine(generator, b, degrees, scale, shear, translate), h=h, w=w)


_BLUR_TAPS = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _gaussian_blur(images, sigma):
    """Fixed 5-tap separable gaussian over H then W, per-sample strength
    via lerp.  Both passes pad with zeros (not by reflection), as the JAX
    package's convolutions with explicit (2, 2) padding do.  Written as
    five shifted products a pass and no `F.conv2d`: cuDNN would run an fp32
    convolution in TF32."""
    x = images
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 0, 0, 2, 2))  # zeros above and below
    y = sum(t * xp[:, k:k + h] for k, t in enumerate(_BLUR_TAPS))
    yp = F.pad(y, (0, 0, 2, 2))        # zeros left and right
    y = sum(t * yp[:, :, k:k + w] for k, t in enumerate(_BLUR_TAPS))
    s = sigma[:, None, None, None]
    return x * (1 - s) + y * s


def draw_augment_params(generator: torch.Generator, b: int, h: int, w: int, c: int = 3,
                        p_geom: float = 0.5, p_blur: float = 0.3, p_jitter: float = 0.8,
                        p_gray: float = 0.2, p_noise: float = 0.25) -> dict:
    """Every random quantity of one `device_augment` call, drawn from
    `generator` on its device, by name: the affine draws `angle`, `shear`
    (degrees), `scale`, `tx`, `ty` (fractions of width / height); the
    gates `geom_gate`, `blur_gate`, `jitter_gate`, `gray_gate`, `noise_gate`
    (bool [B]); `sigma`, `brightness`, `contrast`, `saturation` ([B]); and
    `noise` (standard normal, [B, H, W, C])."""
    def gate(p):
        return torch.rand((b,), generator=generator, device=generator.device) < p

    return {
        **_draw_affine(generator, b),
        "geom_gate": gate(p_geom),
        "sigma": _uniform(generator, (b,), 0.3, 1.0),
        "blur_gate": gate(p_blur),
        "jitter_gate": gate(p_jitter),
        "brightness": _uniform(generator, (b,), -0.4, 0.4),
        "contrast": _uniform(generator, (b,), 0.6, 1.4),
        "saturation": _uniform(generator, (b,), 0.8, 1.2),
        "gray_gate": gate(p_gray),
        "noise_gate": gate(p_noise),
        "noise": torch.randn((b, h, w, c), generator=generator, device=generator.device),
    }


def device_augment(generator: Optional[torch.Generator], images: torch.Tensor,
                   params: Optional[dict] = None, p_geom: float = 0.5, p_blur: float = 0.3,
                   p_jitter: float = 0.8, p_gray: float = 0.2,
                   p_noise: float = 0.25) -> torch.Tensor:
    """SeqCLR-class augmentation of a whole batch on the images' device.

    images: normalized [-1, 1] float NHWC.  Each operation is applied per
    sample behind its own gate with its own magnitude.  `params` (see
    `draw_augment_params`) gives every draw; when it is None they are
    drawn from `generator`, which must live on the images' device."""
    b, h, w, c = images.shape
    if params is None:
        params = draw_augment_params(generator, b, h, w, c, p_geom, p_blur, p_jitter,
                                     p_gray, p_noise)
    p = {k: v.to(images.device) for k, v in params.items()}

    def per_sample(t):
        return t[:, None, None, None]

    x = images

    # --- geometry: batched affine (rotation/scale/shear/translate) ---------
    mats = affine_mats(p["angle"], p["scale"], p["shear"], p["tx"], p["ty"], h, w)
    x = torch.where(per_sample(p["geom_gate"]), batched_affine_warp(x, mats), x)

    # --- blur ----------------------------------------------------------------
    x = torch.where(per_sample(p["blur_gate"]), _gaussian_blur(x, p["sigma"]), x)

    # --- color jitter: brightness / contrast / saturation --------------------
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    jittered = (x - mean) * per_sample(p["contrast"]) + mean + per_sample(p["brightness"])
    gray = jittered.mean(dim=-1, keepdim=True)
    jittered = gray + (jittered - gray) * per_sample(p["saturation"])
    x = torch.where(per_sample(p["jitter_gate"]), jittered, x)

    # --- grayscale ------------------------------------------------------------
    x = torch.where(per_sample(p["gray_gate"]),
                    x.mean(dim=-1, keepdim=True) * torch.ones_like(x), x)

    # --- gaussian noise ---------------------------------------------------------
    x = torch.where(per_sample(p["noise_gate"]), x + p["noise"] * 0.08, x)

    return x.clamp(-1.0, 1.0).to(images.dtype)
