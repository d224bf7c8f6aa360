"""On-device batched augmentation: the pre-training and fine-tuning views.

Counterpart of `dig_tpu/data/device_aug.py`: `device_augment` (the SeqCLR
view of `--device_aug`) and what it stands on (`batched_affine_warp`,
`_rand_affine_mats`, `_gaussian_blur`); `device_abi_augment` (the ABINet
recipe of the fine-tuning CLI's `--device_abi_aug`) and what it stands on
(`batched_projective_warp`, `_affine_to_h`, `_center_to_corner`,
`abi_affine_mats`, `perspective_h`, `_solve_homography`, `_down_up`,
`_motion_blur`, `_rgb_hue_rotate`).
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
`draw_augment_params` / `draw_abi_augment_params` draw them all from a
`torch.Generator`, and `device_augment(..., params=...)` /
`device_abi_augment(..., params=...)` take them as given.  With the JAX
package's own draws as `params` the two packages give the same view
(tests/test_torch_port_device_aug.py, tests/test_torch_port_abi_aug.py).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from dig_tpu_torch.data.masking import random_mask_batch  # re-export for callers

__all__ = ["device_augment", "draw_augment_params", "batched_affine_warp", "affine_mats",
           "device_abi_augment", "draw_abi_augment_params", "batched_projective_warp",
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

    m = inv_mats.to(torch.float32)
    sx = _matrix_row(m, 0, gx, gy) + (w - 1) / 2.0  # [B, HW]
    sy = _matrix_row(m, 1, gx, gy) + (h - 1) / 2.0
    return _bilinear(images, sx.clamp(0.0, w - 1.0), sy.clamp(0.0, h - 1.0))


def _matrix_row(m, i, gx, gy):
    """m[:, i] @ (x, y, 1) for every pixel, summed as an fp32 matrix
    product sums it: over k in order, each step one fused multiply-add.  The
    middle step is taken in fp64 and rounded once, which is that FMA on
    every device; no GEMM (a library's may run in TF32) and no reliance on a
    compiler's fusing.  A coordinate that differs in its last bit (2^-17
    pixels below 128) moves a bilinear sample by up to 1.5e-5 on an image of
    noise.  m [B, R, 3]; gx, gy [1, HW] -> [B, HW]."""
    t = (m[:, i, 0:1] * gx).double() + m[:, i, 1:2].double() * gy.double()
    return t.float() + m[:, i, 2:3]


def _bilinear(images, sx, sy):
    """Bilinear samples of images [B, H, W, C] at source coordinates sx, sy
    [B, HW], already clamped to the image: the interpolation runs between
    clamped neighbours (== cv2 BORDER_REPLICATE)."""
    b, h, w, c = images.shape
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

    top = gather(y0, x0) * (1 - fx) + gather(y0, x1) * fx
    bot = gather(y1, x0) * (1 - fx) + gather(y1, x1) * fx
    return (top * (1 - fy) + bot * fy).reshape(b, h, w, c)


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


# ---------------------------------------------------------------------------
# The ABINet recipe of fine-tuning (`--device_abi_aug`)
# ---------------------------------------------------------------------------

def batched_projective_warp(images: torch.Tensor, inv_h: torch.Tensor) -> torch.Tensor:
    """Bilinear projective warp: sample the input at (H_inv @ p) / z.

    images [B, H, W, C]; inv_h [B, 3, 3] output -> input homographies in
    pixel coordinates, origin at the top-left pixel.  Edge-clamped like the
    reference's cv2 BORDER_REPLICATE warps (transforms.py:390)."""
    b, h, w, c = images.shape
    dev = images.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
    m = inv_h.to(torch.float32)
    z = _matrix_row(m, 2, gx, gy)
    z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    sx = (_matrix_row(m, 0, gx, gy) / z).clamp(0.0, w - 1.0)
    sy = (_matrix_row(m, 1, gx, gy) / z).clamp(0.0, h - 1.0)
    return _bilinear(images, sx, sy)


def _affine_to_h(mats):
    """[B, 2, 3] affine -> [B, 3, 3] homography (last row 0, 0, 1)."""
    bottom = torch.zeros((mats.shape[0], 1, 3), dtype=mats.dtype, device=mats.device)
    bottom[:, 0, 2] = 1.0
    return torch.cat([mats, bottom], dim=1)


def _center_to_corner(h_mats, height: int, width: int):
    """A homography about the image centre, re-expressed in pixel
    coordinates with the origin at the top-left pixel: T @ H @ T^-1."""
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    # filled on the device: a tensor copied from host memory would wait for the card
    t = torch.eye(3, dtype=h_mats.dtype, device=h_mats.device)
    t_inv = t.clone()
    t[0, 2], t[1, 2], t_inv[0, 2], t_inv[1, 2] = cx, cy, -cx, -cy
    return t @ h_mats @ t_inv


def abi_affine_mats(angle, scale, shear_x, shear_y) -> torch.Tensor:
    """Inverse (output -> input) affine matrices [B, 2, 3] about the image
    centre, from the drawn rotation, scale and shears ([B]; the angles in
    degrees): the forward map is scale * R(angle) @ [[1, tan sx], [tan sy, 1]]
    (ABI's CVRandomRotation / CVRandomAffine, dataset/dataset_lmdb.py:40)."""
    ang = angle * (math.pi / 180)
    cos, sin = torch.cos(ang), torch.sin(ang)
    tx, ty = torch.tan(shear_x * (math.pi / 180)), torch.tan(shear_y * (math.pi / 180))
    f00 = scale * (cos + (-sin) * ty)
    f01 = scale * (cos * tx - sin)
    f10 = scale * (sin + cos * ty)
    f11 = scale * (sin * tx + cos)
    det = f00 * f11 - f01 * f10
    det = torch.where(det.abs() < 1e-6, torch.full_like(det, 1e-6), det)
    zero = torch.zeros_like(det)
    return torch.stack([torch.stack([f11 / det, -f01 / det, zero], -1),
                        torch.stack([-f10 / det, f00 / det, zero], -1)], dim=1)


def _solve_homography(src, dst):
    """Batched 4-point DLT: H with H @ [src, 1] ~ [dst, 1]; src, dst
    [B, 4, 2] -> [B, 3, 3].  An 8 x 8 fp32 solve a sample
    (`torch.linalg.solve_ex`, which, unlike `solve`, does not read its
    status back to the host; the JAX package's LU is another one, so the
    matrices agree to rounding, not to the bit)."""
    b = src.shape[0]
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    a = torch.cat([rows_u, rows_v], dim=1)  # [B, 8, 8]
    rhs = torch.cat([u, v], dim=1)[..., None]  # [B, 8, 1]
    sol = torch.linalg.solve_ex(a, rhs)[0][..., 0]
    return torch.cat([sol, torch.ones((b, 1), dtype=sol.dtype, device=sol.device)],
                     -1).reshape(b, 3, 3)


def perspective_h(noise_h, noise_w, h: int, w: int, distortion: float = 0.5):
    """Inverse homographies of ABI's perspective op (CVRandomPerspective,
    transforms.py:361-392): the four corners pulled inward by |N(0, 1)| *
    distortion * dim / 4, at most distortion * dim / 2.  noise_h, noise_w:
    the standard normal draws [B, 4]."""
    off_h = (noise_h.abs() * (distortion * h / 4)).clamp(0.0, distortion * h / 2)
    off_w = (noise_w.abs() * (distortion * w / 4)).clamp(0.0, distortion * w / 2)
    dst = torch.stack([
        torch.stack([off_w[:, 0], off_h[:, 0]], -1),
        torch.stack([w - 1 - off_w[:, 1], off_h[:, 1]], -1),
        torch.stack([w - 1 - off_w[:, 2], h - 1 - off_h[:, 2]], -1),
        torch.stack([off_w[:, 3], h - 1 - off_h[:, 3]], -1),
    ], dim=1)
    corners = torch.zeros((4, 2), dtype=dst.dtype, device=dst.device)
    corners[1:3, 0] = w - 1.0
    corners[2:, 1] = h - 1.0
    return _solve_homography(dst, corners.expand(dst.shape[0], 4, 2))


_RESIZE_WEIGHTS: dict = {}  # (in, out, device) -> [out, in]


def _linear_resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """The weights of the JAX package's linear image resize along one axis, [out,
    in]: the triangle kernel at half-pixel centres, widened by the factor
    when shrinking (antialiasing), each output's weights normalised to sum
    1 over the taps inside the image.  Built once in numpy float32, the JAX
    package's arithmetic."""
    key = (n_in, n_out, torch.device(device))
    if key not in _RESIZE_WEIGHTS:
        f32 = np.float32
        inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
        kernel_scale = max(inv_scale, f32(1.0))
        sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
        x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
        wts = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
        total = wts.sum(axis=0, keepdims=True, dtype=f32)
        wts = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       wts / np.where(total != 0, total, f32(1.0)), f32(0.0))
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        wts = np.where(inside[None, :], wts, f32(0.0)).astype(f32)
        _RESIZE_WEIGHTS[key] = torch.from_numpy(np.ascontiguousarray(wts.T)).to(device)
    return _RESIZE_WEIGHTS[key]


def _resize_linear(images, h_out: int, w_out: int):
    """Linear resize of [B, H, W, C] with the JAX package's rule."""
    b, h, w, c = images.shape
    wh = _linear_resize_weights(h, h_out, images.device)
    ww = _linear_resize_weights(w, w_out, images.device)
    y = torch.einsum("oh,bhwc->bowc", wh, images)
    return torch.einsum("pw,bowc->bopc", ww, y)


def _down_up(images, factor: int):
    """Pyramid-style rescale: resize down by `factor`, then back (CVRescale,
    transforms.py:394-420)."""
    b, h, w, c = images.shape
    return _resize_linear(_resize_linear(images, h // factor, w // factor), h, w)


def _motion_blur(images, angle, length):
    """Directional average over 7 bilinear taps along `angle` (radians,
    [B]) within the support `length` ([B], >= 1; length 1 keeps the centre
    tap alone) (CVMotionBlur, transforms.py:437-455)."""
    b = images.shape[0]
    dx, dy = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(dx), torch.zeros_like(dx)
    out = torch.zeros_like(images)
    wsum = torch.zeros((b, 1, 1, 1), dtype=images.dtype, device=images.device)
    for t in range(-3, 4):
        wgt = (abs(t) <= length / 2).to(images.dtype)[:, None, None, None]
        mats = torch.stack([torch.stack([one, zero, t * dx], -1),
                            torch.stack([zero, one, t * dy], -1)], dim=1)
        out = out + wgt * batched_affine_warp(images, mats)
        wsum = wsum + wgt
    return out / torch.clamp(wsum, min=1.0)


_TO_YIQ = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]],
                   np.float32)
_TO_RGB = np.linalg.inv(_TO_YIQ.astype(np.float64)).astype(np.float32)


def _apply_3x3(m: np.ndarray, u):
    """m @ u[..., :] for a constant 3 x 3 m, summed over j in order."""
    return torch.stack([sum(float(m[i, j]) * u[..., j] for j in range(3)) for i in range(3)], -1)


def _rgb_hue_rotate(u, angle):
    """Rotate the chroma in YIQ space (close to an HSV hue shift); u in
    [0, 1], angle [B] radians."""
    yiq = _apply_3x3(_TO_YIQ, u)
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    i = yiq[..., 1] * cos - yiq[..., 2] * sin
    q = yiq[..., 1] * sin + yiq[..., 2] * cos
    return _apply_3x3(_TO_RGB, torch.stack([yiq[..., 0], i, q], -1))


DETER_ORDERS = list(itertools.permutations(range(3)))  # of (noise, motion blur, rescale)


def _beta_1_4(generator, shape):
    """Beta(1, 4) by inversion, 1 - (1 - U)^(1/4): `torch.distributions`
    takes no generator."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return 1.0 - (1.0 - u) ** 0.25


def draw_abi_augment_params(generator: torch.Generator, b: int, h: int, w: int, c: int = 3,
                            p_geom: float = 0.5, p_deter: float = 0.25,
                            p_jitter: float = 0.25) -> dict:
    """Every random quantity of one `device_abi_augment` call, drawn from
    `generator` on its device, by name (angles in degrees unless said):

    * geometry: `rot_angle`; `aff_angle`, `aff_scale`, `aff_shear_x`,
      `aff_shear_y`; `persp_noise_h`, `persp_noise_w` (standard normal,
      [B, 4]); `geom_choice` (uniform [0, 1): rotation below 1/3, affine
      below 2/3, else perspective); `geom_gate`;
    * deterioration: `noise_beta` (Beta(1, 4)) and `noise` (standard
      normal, [B, H, W, C]); `blur_angle` (radians) and `blur_beta`
      (Beta(1, 4)); `rescale_f` (uniform [0, 4)); `deter_order`, a Python
      int below 6 indexing `DETER_ORDERS`, drawn per batch on the host from
      a CPU generator seeded with `generator.initial_seed()`, so that
      nothing waits for the card; `deter_gate`;
    * colour: `brightness`, `contrast`, `saturation` ([0.5, 1.5)), `hue`
      (radians, ±0.2 pi), `jitter_gate`.
    Gates are bool [B]; the other draws [B] unless said."""
    dev = generator.device

    def u(lo, hi, shape=(b,)):
        return _uniform(generator, shape, lo, hi)

    def gate(p):
        return torch.rand((b,), generator=generator, device=dev) < p

    host = torch.Generator().manual_seed(generator.initial_seed())
    return {
        "rot_angle": u(-45.0, 45.0),
        "aff_angle": u(-45.0, 45.0), "aff_scale": u(0.5, 2.0),
        "aff_shear_x": u(-45.0, 45.0), "aff_shear_y": u(-15.0, 15.0),
        "persp_noise_h": torch.randn((b, 4), generator=generator, device=dev),
        "persp_noise_w": torch.randn((b, 4), generator=generator, device=dev),
        "geom_choice": u(0.0, 1.0), "geom_gate": gate(p_geom),
        "noise_beta": _beta_1_4(generator, (b,)),
        "noise": torch.randn((b, h, w, c), generator=generator, device=dev),
        "blur_angle": u(-math.pi / 2, math.pi / 2), "blur_beta": _beta_1_4(generator, (b,)),
        "rescale_f": u(0.0, 4.0),
        "deter_order": int(torch.randint(0, len(DETER_ORDERS), (), generator=host)),
        "deter_gate": gate(p_deter),
        "brightness": u(0.5, 1.5), "contrast": u(0.5, 1.5), "saturation": u(0.5, 1.5),
        "hue": u(-0.1, 0.1) * (2 * math.pi), "jitter_gate": gate(p_jitter),
    }


def device_abi_augment(generator: Optional[torch.Generator], images: torch.Tensor,
                       params: Optional[dict] = None, p_geom: float = 0.5,
                       p_deter: float = 0.25, p_jitter: float = 0.25) -> torch.Tensor:
    """ABINet augmentation of a whole batch on the images' device
    (dataset/dataset_lmdb.py:40-42): CVGeometry (degrees 45, scale (0.5, 2),
    shear (45, 15), distortion 0.5, p 0.5: one of rotation, affine and
    perspective a sample); CVDeterioration (var 20, degrees 6, factor 4,
    p 0.25: noise, motion blur and a pyramid rescale, in an order drawn per
    batch, magnitudes per sample); CVColorJitter (0.5 / 0.5 / 0.5 / 0.1,
    p 0.25).  Distribution-matched to the host recipe, as in the JAX
    package.  images: normalized [-1, 1] float NHWC.  `params` (see
    `draw_abi_augment_params`) gives every draw; when it is None they are
    drawn from `generator`, which must live on the images' device."""
    b, h, w, c = images.shape
    if params is None:
        params = draw_abi_augment_params(generator, b, h, w, c, p_geom, p_deter, p_jitter)
    p = {k: v.to(images.device) if torch.is_tensor(v) else v for k, v in params.items()}

    def per_sample(t):
        return t[:, None, None, None]

    x = images

    # --- geometry: one of rotation / affine / perspective a sample ------------
    one, zero = torch.ones_like(p["rot_angle"]), torch.zeros_like(p["rot_angle"])
    rot_h = _center_to_corner(_affine_to_h(abi_affine_mats(p["rot_angle"], one, zero, zero)),
                              h, w)
    aff_h = _center_to_corner(_affine_to_h(abi_affine_mats(
        p["aff_angle"], p["aff_scale"], p["aff_shear_x"], p["aff_shear_y"])), h, w)
    per_h = perspective_h(p["persp_noise_h"], p["persp_noise_w"], h, w)
    t = p["geom_choice"][:, None, None]
    h_mats = torch.where(t < 1 / 3, rot_h, torch.where(t < 2 / 3, aff_h, per_h))
    x = torch.where(per_sample(p["geom_gate"]), batched_projective_warp(x, h_mats), x)

    # --- deterioration: noise, motion blur, rescale in the batch's order -----
    def noise(xx):
        var = torch.clamp(torch.floor(p["noise_beta"] * 20.0), min=1.0)
        return xx + p["noise"] * per_sample(torch.sqrt(var) / 127.5)  # pixel var -> [-1, 1] std

    def blur(xx):
        length = torch.clamp(torch.floor(p["blur_beta"] * 6.0), min=1.0)
        return _motion_blur(xx, p["blur_angle"], length)

    def rescale(xx):
        # f = round(uniform(0, 4)) (CVRescale, transforms.py:404)
        f = per_sample(p["rescale_f"])
        return torch.where(f < 2.5, xx, torch.where(f < 3.5, _down_up(xx, 2), _down_up(xx, 4)))

    deteriorated = x
    for i in DETER_ORDERS[p["deter_order"]]:
        deteriorated = (noise, blur, rescale)[i](deteriorated)
    x = torch.where(per_sample(p["deter_gate"]), deteriorated, x)

    # --- colour jitter, hue included -------------------------------------------
    v = (x + 1.0) * 0.5 * per_sample(p["brightness"])
    mean = v.mean(dim=(1, 2, 3), keepdim=True)
    v = (v - mean) * per_sample(p["contrast"]) + mean
    gray = v.mean(dim=-1, keepdim=True)
    v = gray + (v - gray) * per_sample(p["saturation"])
    v = _rgb_hue_rotate(v.clamp(0.0, 1.0), p["hue"])
    x = torch.where(per_sample(p["jitter_gate"]), v * 2.0 - 1.0, x)

    return x.clamp(-1.0, 1.0).to(images.dtype)
