"""uint8 image batches to model input.

Hosts ship raw uint8 NHWC batches (4x fewer bytes to the card than
float32); the conversion is the first op on the device.  A uint8 value
maps through a 256-entry float32 table built once on the host with the
JAX package's arithmetic, ``(i / 255 - 0.5) / 0.5``
(`dig_tpu/ops/images.py:21-22`), and copied to each device that asks for
it.  So every device gives the JAX package's values bit for bit: computed
on the card, the division by the scalar 255 would be a product with its
reciprocal, one ulp off for some values.
"""

from __future__ import annotations

import numpy as np
import torch

_TABLE = ((np.arange(256, dtype=np.float32) / np.float32(255.0) - np.float32(0.5))
          / np.float32(0.5))
_TABLES: dict = {}  # device -> the table on it


def uint8_table(device) -> torch.Tensor:
    """The float32 value of each uint8 value, [256], on `device`."""
    device = torch.device(device)
    table = _TABLES.get(device)
    if table is None:
        table = _TABLES[device] = torch.from_numpy(_TABLE.copy()).to(device)
    return table


def to_model_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] -> float32 in [-1, 1]; float input passes through."""
    if x.dtype == torch.uint8:
        return uint8_table(x.device)[x.long()]
    return x
