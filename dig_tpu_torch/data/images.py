"""Image decode and resize on the host: bytes -> uint8 RGB [H, W, 3].

Counterpart of `decode_image` (`dig_tpu/data/dataset.py`) and
`resize_uint8` (`dig_tpu/data/transforms.py`).  The JAX package resizes
with OpenCV's bicubic (`cv2.resize(..., INTER_CUBIC)`), and the weights
were trained on its pixels, so a machine without cv2 must produce the same
ones: `cubic_resize_uint8` is that function written out in numpy.  PIL's
`BICUBIC` is another function (a = -0.5, taps widened when shrinking) and
is not used.  cv2 and PIL are imported inside the functions: only numpy is
needed to import this module.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

_CUBIC_A = np.float32(-0.75)  # OpenCV's Keys kernel; PIL's is -0.5


def decode_image(buf: bytes) -> Optional[np.ndarray]:
    """JPEG / PNG / ... bytes -> uint8 RGB HWC, or None if the bytes are no
    image.  cv2 decodes where it imports, PIL where cv2 is missing or gives
    up; with neither installed there is nothing to decode with, and that
    raises instead of reporting every image as unreadable."""
    cv2 = Image = None
    try:
        import cv2
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        pass
    if cv2 is None and Image is None:
        raise RuntimeError("decode_image needs OpenCV (cv2) or Pillow (PIL); "
                           "neither can be imported")
    if cv2 is not None:
        try:
            img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        except cv2.error:  # an empty buffer is an error to OpenCV, not a None
            img = None
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if Image is not None:
        try:
            return np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))
        except Exception:  # PIL raises many types on corrupt input; all mean "no image"
            return None
    return None


def _cubic_taps(dst: int, src: int):
    """For each of `dst` output positions along an axis of `src` pixels:
    the 4 source indices (clamped at the border) and the 4 float32
    coefficients, as OpenCV's resize computes them: the pixel-centred source
    coordinate (dst + 0.5) * scale - 0.5 rounded to float32, the Keys cubic
    with a = -0.75 evaluated in float32 in OpenCV's order, the fourth
    coefficient as 1 minus the others, no widening when shrinking."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    start = np.floor(f)
    f = f - start
    a, one = _CUBIC_A, np.float32(1)
    c0 = ((a * (f + one) - np.float32(5) * a) * (f + one) + np.float32(8) * a) * (f + one) \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    g = one - f
    c2 = ((a + np.float32(2)) * g - (a + np.float32(3))) * g * g + one
    c3 = one - c0 - c1 - c2
    idx = start.astype(np.int64)[:, None] + np.arange(-1, 3)
    return np.clip(idx, 0, src - 1), (c0, c1, c2, c3)


def cubic_resize_uint8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=cv2.INTER_CUBIC)` for
    a uint8 [H, W, C] image, in numpy: separable, the horizontal pass over
    the source's rows first, then the vertical pass, both in float32 with
    the four products summed left to right, then rounded to nearest (ties
    to even) and saturated to uint8.  That is what OpenCV 4.13 and 5.0 compute: on
    random and smooth images it gives the same pixels but for a few in a
    million, one grey level apart, where a float32 sum rounds across a tie
    (tests/test_torch_port_images.py states the shares).  A fixed-point
    form of the same filter (coefficients quantised to 2^-11, one rounding
    shift at the end) differs from OpenCV 5.0's pixels in 3-5 % of them, by
    one level, and is not what is used."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"cubic_resize_uint8 takes a uint8 [H, W, C] image, got "
                         f"{img.dtype} {img.shape}")
    xi, xc = _cubic_taps(width, img.shape[1])
    yi, yc = _cubic_taps(height, img.shape[0])
    src = img.astype(np.float32)
    p = [src[:, xi[:, k], :] * xc[k][None, :, None] for k in range(4)]   # [H, width, C] each
    rows = ((p[0] + p[1]) + p[2]) + p[3]
    p = [rows[yi[:, k]] * yc[k][:, None, None] for k in range(4)]        # [height, width, C]
    out = ((p[0] + p[1]) + p[2]) + p[3]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_uint8(img: np.ndarray, height: int = 32, width: int = 128) -> np.ndarray:
    """Resize to the model's input, staying uint8 HWC: OpenCV's bicubic
    where cv2 imports, the port's own version of it otherwise.  An image
    that already has the size is returned as it is."""
    if img.shape[:2] == (height, width):
        return img
    try:
        import cv2
    except ImportError:
        return cubic_resize_uint8(img, height, width)
    return cv2.resize(img, (width, height), interpolation=cv2.INTER_CUBIC)
