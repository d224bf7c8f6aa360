"""uint8 image batches to model input.

Hosts ship raw uint8 NHWC batches (4x fewer bytes to the card than
float32); the conversion is the first op on the device.  The expression
is the one in `dig_tpu/ops/images.py:21-22`, so both packages see the
same float32 values.
"""

from __future__ import annotations

import torch


def to_model_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] -> float32 in [-1, 1]; float input passes through."""
    if x.dtype == torch.uint8:
        return (x.to(torch.float32) / 255.0 - 0.5) / 0.5
    return x
