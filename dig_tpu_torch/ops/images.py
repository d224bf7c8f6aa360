"""uint8 image batches to model input.

Hosts ship raw uint8 NHWC batches (4x fewer bytes to the card than
float32); the conversion is the first op on the device.  The expression
is the one in `dig_tpu/ops/images.py:21-22`, so on the CPU both packages
see the same float32 values.  On the card PyTorch divides by a scalar as a
product with its reciprocal, so a value may differ from the CPU's by one
ulp (seen on an NVIDIA H100 by chip_smoke.py's `[device view]` check).
"""

from __future__ import annotations

import torch


def to_model_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] -> float32 in [-1, 1]; float input passes through."""
    if x.dtype == torch.uint8:
        return (x.to(torch.float32) / 255.0 - 0.5) / 0.5
    return x
