"""Host-side image augmentations (numpy + OpenCV).

The port's own copy of `dig_tpu/data/transforms.py`: the same functions,
the same draws from the same `numpy.random.Generator`, so one seed gives
the same pixels in both packages on one machine (the pixels are OpenCV's:
another OpenCV version may round a warp differently).  They replace the
reference's two augmentation stacks with re-implementations matched *in
distribution* (the reference depends on `imgaug`):

* ABINet CV set (reference: transforms.py:188-505): CVGeometry — one of
  {rotation, affine, perspective} applied with probability p;
  CVDeterioration — shuffled {gaussian noise, motion blur, pyramid
  rescale}; CVColorJitter — brightness/contrast/saturation/hue.
  Magnitudes use the reference's asymmetric beta(1,4) and symmetric
  beta(4,4) samplers (transforms.py:188-195).
* SeqCLR-style pipeline (reference: dataset/dataset_lmdb.py:102-153):
  `SomeOf(2..5)` over {linear contrast, gaussian blur, crop, sharpen,
  rotate, piecewise affine, perspective, solarize, grayscale}.

Deviation (documented): randomness flows through an explicit
`numpy.random.Generator` instead of global `random` state — per-worker
seeding is reproducible by construction (the reference needed a custom
`seed_worker`, run_mae_pretraining_moco.py:297-300).

All transforms map uint8 HWC RGB -> uint8 HWC RGB.  `resize_normalize`
produces the final float32 (x - 0.5) / 0.5 tensor the models consume
(reference: dataset/datasets.py:31-37).  `resize_uint8` is the one of
`dig_tpu_torch.data.images`.

cv2 is imported where a function first needs it (`_cv2`), so this module
imports on a machine without OpenCV, and an augmentation that needs it
raises an ImportError that names cv2.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from dig_tpu_torch.data.images import resize_uint8

_CV2 = None
_INTERPS = None


def _cv2():
    """The cv2 module, imported on first use with its own thread pool
    turned off (the loader's workers are the parallelism)."""
    global _CV2
    if _CV2 is None:
        try:
            import cv2
        except ImportError as e:
            raise ImportError("this augmentation needs OpenCV (cv2), which cannot be "
                              "imported here") from e
        cv2.setNumThreads(0)  # avoid thread contention with loader workers
        _CV2 = cv2
    return _CV2


def _rand_interp(rng):
    cv2 = _cv2()
    global _INTERPS
    if _INTERPS is None:
        _INTERPS = [cv2.INTER_NEAREST, cv2.INTER_LINEAR, cv2.INTER_CUBIC, cv2.INTER_AREA]
    return _INTERPS[int(rng.integers(0, len(_INTERPS)))]


def sample_asym(rng, magnitude, size=None):
    return rng.beta(1, 4, size) * magnitude


def sample_sym(rng, magnitude, size=None):
    return (rng.beta(4, 4, size=size) - 0.5) * 2 * magnitude


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------


def random_rotate(img, rng, degrees: float = 15):
    cv2 = _cv2()
    angle = float(sample_sym(rng, degrees))
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    cos_a, sin_a = abs(m[0, 0]), abs(m[0, 1])
    dw = int(h * sin_a + w * cos_a)
    dh = int(h * cos_a + w * sin_a)
    m[0, 2] += (dw - w) / 2
    m[1, 2] += (dh - h) / 2
    return cv2.warpAffine(img, m, (dw, dh), flags=_rand_interp(rng),
                          borderMode=cv2.BORDER_REPLICATE)


def _inverse_affine(center, angle, scale, shear):
    """Torchvision-convention inverse affine (rotation+shear+scale about
    center), expressed directly rather than via the inverse-compose dance."""
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    cx, cy = center
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    m = np.array([[d, -b, 0.0], [-c, a, 0.0]]) / scale
    m[0, 2] += m[0, 0] * (-cx) + m[0, 1] * (-cy) + cx
    m[1, 2] += m[1, 0] * (-cx) + m[1, 1] * (-cy) + cy
    return m


def random_affine(img, rng, degrees: float = 45, translate=(0.0, 0.0),
                  scale=(0.5, 2.0), shear=(45, 15)):
    cv2 = _cv2()
    h, w = img.shape[:2]
    angle = float(sample_sym(rng, degrees))
    sc = float(rng.uniform(scale[0], scale[1]))
    sh = [float(sample_sym(rng, shear[0])), float(sample_sym(rng, shear[1]))]
    tx = float(np.round(sample_sym(rng, translate[0] * h)))
    ty = float(np.round(sample_sym(rng, translate[1] * h)))

    m = _inverse_affine((w / 2, h / 2), angle, sc, sh)
    corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float64)
    proj = corners @ m[:, :2].T + m[:, 2]
    dw = int(proj[:, 0].max() - proj[:, 0].min())
    dh = int(proj[:, 1].max() - proj[:, 1].min())
    dw, dh = max(dw, 8), max(dh, 8)
    m[0, 2] += (dw - w) / 2
    m[1, 2] += (dh - h) / 2
    dw += int(abs(tx))
    dh += int(abs(ty))
    if tx < 0:
        m[0, 2] += abs(tx)
    if ty < 0:
        m[1, 2] += abs(ty)
    return cv2.warpAffine(img, m, (dw, dh), flags=_rand_interp(rng),
                          borderMode=cv2.BORDER_REPLICATE)


def random_perspective(img, rng, distortion: float = 0.5):
    cv2 = _cv2()
    h, w = img.shape[:2]
    oh = sample_asym(rng, distortion * h / 2, size=4).astype(np.int32)
    ow = sample_asym(rng, distortion * w / 2, size=4).astype(np.int32)
    src = np.array([(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)], np.float32)
    dst = np.array(
        [
            (ow[0], oh[0]),
            (w - 1 - ow[1], oh[1]),
            (w - 1 - ow[2], h - 1 - oh[2]),
            (ow[3], h - 1 - oh[3]),
        ],
        np.float32,
    )
    m = cv2.getPerspectiveTransform(src, dst)
    max_x = int(dst[:, 0].max())
    max_y = int(dst[:, 1].max())
    min_x = max(int(dst[:, 0].min()), 0)
    min_y = max(int(dst[:, 1].min()), 0)
    out = cv2.warpPerspective(img, m, (max(max_x, 8), max(max_y, 8)),
                              flags=_rand_interp(rng), borderMode=cv2.BORDER_REPLICATE)
    return out[min_y:, min_x:]


# --------------------------------------------------------------------------
# deterioration
# --------------------------------------------------------------------------


def gaussian_noise(img, rng, var: float = 20):
    v = max(int(sample_asym(rng, var)), 1)
    noise = rng.normal(0, v**0.5, img.shape)
    return np.clip(img.astype(np.float64) + noise, 0, 255).astype(np.uint8)


def motion_blur(img, rng, degrees: float = 6, angle: float = 90):
    cv2 = _cv2()
    degree = max(int(sample_asym(rng, degrees)), 1)
    theta = float(rng.uniform(-angle, angle))
    if degree <= 1:
        return img
    kernel = np.zeros((degree, degree))
    kernel[degree // 2, :] = 1
    m = cv2.getRotationMatrix2D((degree // 2, degree // 2), theta, 1)
    kernel = cv2.warpAffine(kernel, m, (degree, degree)) / degree
    out = cv2.filter2D(img, -1, kernel)
    return np.clip(out, 0, 255).astype(np.uint8)


def pyramid_rescale(img, rng, factor: float = 4, base_size=(128, 512)):
    cv2 = _cv2()
    f = round(float(rng.uniform(0, factor)))
    if f == 0:
        return img
    h, w = img.shape[:2]
    out = cv2.resize(img, (base_size[1], base_size[0]), interpolation=_rand_interp(rng))
    for _ in range(f):
        out = cv2.pyrDown(out)
    return cv2.resize(out, (w, h), interpolation=_rand_interp(rng))


# --------------------------------------------------------------------------
# color
# --------------------------------------------------------------------------


def color_jitter(img, rng, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1):
    """Torchvision-style jitter: factors ~ U[max(0, 1-x), 1+x], random order."""
    cv2 = _cv2()
    img = img.astype(np.float32)
    ops = []
    if brightness > 0:
        b = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * b)
    if contrast > 0:
        c = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: (x - x.mean()) * c + x.mean())
    if saturation > 0:
        s = rng.uniform(max(0, 1 - saturation), 1 + saturation)

        def sat(x):
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            return gray[..., None] * (1 - s) + x * s

        ops.append(sat)
    if hue > 0:
        dh = rng.uniform(-hue, hue)

        def hue_shift(x):
            hsv = cv2.cvtColor(np.clip(x, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
            hsv = hsv.astype(np.int32)
            hsv[..., 0] = (hsv[..., 0] + int(dh * 180)) % 180
            return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)

        ops.append(hue_shift)
    order = rng.permutation(len(ops))
    for i in order:
        img = ops[i](img)
    return np.clip(img, 0, 255).astype(np.uint8)


def grayscale(img, rng, alpha=None):
    a = float(rng.uniform(0, 1)) if alpha is None else alpha
    gray = (img.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
    return np.clip(img * (1 - a) + gray * a, 0, 255).astype(np.uint8)


def solarize(img, rng, threshold=(32, 128)):
    t = int(rng.uniform(threshold[0], threshold[1]))
    out = img.copy()
    out[img >= t] = 255 - out[img >= t]
    return out


def linear_contrast(img, rng, alpha=(0.5, 1.0)):
    a = float(rng.uniform(*alpha))
    return np.clip((img.astype(np.float32) - 127) * a + 127, 0, 255).astype(np.uint8)


def gaussian_blur(img, rng, sigma=(0.5, 1.5)):
    cv2 = _cv2()
    s = float(rng.uniform(*sigma))
    k = max(3, int(2 * round(2 * s) + 1))
    return cv2.GaussianBlur(img, (k, k), s)


def sharpen(img, rng, alpha=(0.0, 0.5), lightness=(0.0, 0.5)):
    cv2 = _cv2()
    a = float(rng.uniform(*alpha))
    l = 1.0 + float(rng.uniform(*lightness))
    blur = cv2.GaussianBlur(img, (3, 3), 1.0)
    sharp = np.clip(img.astype(np.float32) * (1 + l) - blur.astype(np.float32) * l, 0, 255)
    return np.clip(img * (1 - a) + sharp * a, 0, 255).astype(np.uint8)


def random_crop(img, rng, top=(0, 0.3), bottom=(0, 0.3), left=(0, 0.0), right=(0, 0.0)):
    cv2 = _cv2()
    h, w = img.shape[:2]
    t = int(rng.uniform(*top) * h)
    b = int(rng.uniform(*bottom) * h)
    l = int(rng.uniform(*left) * w)
    r = int(rng.uniform(*right) * w)
    out = img[t : h - b if b else h, l : w - r if r else w]
    if out.size == 0:
        return img
    return cv2.resize(out, (w, h), interpolation=cv2.INTER_LINEAR)


def piecewise_affine(img, rng, scale=(0.03, 0.04), grid=4):
    """Coarse-grid random warp approximating iaa.PiecewiseAffine."""
    cv2 = _cv2()
    h, w = img.shape[:2]
    s = float(rng.uniform(*scale))
    gx = np.linspace(0, w - 1, grid)
    gy = np.linspace(0, h - 1, grid)
    jitter_x = rng.normal(0, s * w, (grid, grid)).astype(np.float32)
    jitter_y = rng.normal(0, s * h, (grid, grid)).astype(np.float32)
    map_x = cv2.resize(jitter_x, (w, h)) + np.arange(w, dtype=np.float32)[None, :]
    map_y = cv2.resize(jitter_y, (w, h)) + np.arange(h, dtype=np.float32)[:, None]
    return cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)


# --------------------------------------------------------------------------
# composed pipelines
# --------------------------------------------------------------------------


class ABIAugment:
    """CVGeometry + CVDeterioration + CVColorJitter with the reference's
    probabilities (dataset/dataset_lmdb.py:39-48): geometry p=0.5,
    deterioration p=0.25, jitter p=0.25."""

    def __init__(self, rng: Optional[np.random.Generator] = None,
                 p_geometry=0.5, p_deterioration=0.25, p_jitter=0.25):
        self.rng = rng if rng is not None else np.random.default_rng()
        self.p = (p_geometry, p_deterioration, p_jitter)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        if rng.random() < self.p[0]:
            t = rng.random()
            if t < 1 / 3:
                img = random_rotate(img, rng, degrees=45)
            elif t < 2 / 3:
                img = random_affine(img, rng)
            else:
                img = random_perspective(img, rng)
        if rng.random() < self.p[1]:
            ops = [
                lambda x: gaussian_noise(x, rng, var=20),
                lambda x: motion_blur(x, rng, degrees=6),
                lambda x: pyramid_rescale(x, rng, factor=4),
            ]
            for i in rng.permutation(3):
                img = ops[i](img)
        if rng.random() < self.p[2]:
            img = color_jitter(img, rng)
        return img


class SeqCLRAugment:
    """SomeOf(2..5) over the SeqCLR op pool
    (reference: dataset/dataset_lmdb.py:102-134), followed by the
    MoCo-style jitter/grayscale (p=0.8 / p=0.2; :56-66)."""

    def __init__(self, rng: Optional[np.random.Generator] = None, color_only=False):
        self.rng = rng if rng is not None else np.random.default_rng()
        self.color_only = color_only

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        pool = [
            lambda x: linear_contrast(x, rng),
            lambda x: gaussian_blur(x, rng),
            lambda x: sharpen(x, rng),
            lambda x: solarize(x, rng),
            lambda x: grayscale(x, rng),
        ]
        if not self.color_only:
            pool += [
                lambda x: random_crop(x, rng, top=(0, 0.3), bottom=(0, 0.3)),
                lambda x: random_crop(x, rng, top=(0, 0.0), bottom=(0, 0.0),
                                      left=(0, 0.1), right=(0, 0.1)),
                lambda x: random_rotate(x, rng, degrees=10),
                lambda x: piecewise_affine(x, rng),
                lambda x: random_perspective(x, rng, distortion=0.1),
            ]
        n = int(rng.integers(2, 6))
        idx = rng.permutation(len(pool))[:n]
        for i in idx:
            img = pool[i](img)
        # post transforms (ColorJitter p=0.8, grayscale p=0.2)
        if rng.random() < 0.8:
            img = color_jitter(img, rng, 0.4, 0.4, 0.2, 0.1)
        if rng.random() < 0.2:
            img = grayscale(img, rng, alpha=1.0)
        return img


def resize_normalize(img: np.ndarray, height: int = 32, width: int = 128) -> np.ndarray:
    """Resize to model input and normalize with mean=std=0.5 -> float32
    HWC in [-1, 1] (host-side; kept for float consumers/tests — the
    training path ships uint8, see `resize_uint8`)."""
    return (resize_uint8(img, height, width).astype(np.float32) / 255.0 - 0.5) / 0.5
