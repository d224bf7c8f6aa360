"""GELU with the JAX package's default form.

`dig_tpu` uses the tanh GELU by default and the erf form (torch's
`F.gelu` default) when evaluating weights trained under erf, i.e. any
reference `.pth` (`dig_tpu/ops/activations.py:30-60`).  This module keeps
the same switch: `DIG_TPU_EXACT_GELU` (nonempty = erf), `set_exact`, and
the CLI's `resolve_exact_gelu`.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

EXACT = bool(os.environ.get("DIG_TPU_EXACT_GELU"))


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none" if EXACT else "tanh")


def set_exact(value: bool) -> None:
    """Switch between erf (torch-exact) and tanh GELU for later calls."""
    global EXACT
    EXACT = bool(value)


def resolve_exact_gelu(explicit, checkpoint_paths) -> bool:
    """An explicit ``--exact_gelu`` wins; then the ``DIG_TPU_EXACT_GELU``
    env var; otherwise erf when any checkpoint path is a torch
    ``.pth``/``.pt`` (weights trained under erf are evaluated under erf)."""
    if explicit is not None:
        return bool(explicit)
    if os.environ.get("DIG_TPU_EXACT_GELU"):
        return True
    return any(p.endswith((".pth", ".pt")) for p in checkpoint_paths if p)
