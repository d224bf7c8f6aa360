"""Random patch masking for masked-image-modeling pre-training.

Counterpart of `dig_tpu/data/masking.py` (reference:
masking_generator.py:12-46): an exact-count boolean mask over the
(grid_h x grid_w) patch grid, one independent mask per view.

* `RandomMaskingGenerator`: the host-side numpy generator of the data
  pipeline, batched (one vectorized argsort).
* `random_mask_batch`: the on-device version of the view generator: rank
  each patch by a uniform draw and mask the `num_mask` lowest ranks.  The
  ranking is `random_mask_from_uniforms`, which takes the drawn uniforms,
  so the same draws give the JAX package's masks exactly.
"""

from __future__ import annotations

import numpy as np
import torch


class RandomMaskingGenerator:
    """Exact-count random masking over a patch grid.

    Returns float masks of shape ``[num_patches]`` (single view) or
    ``[num_view, num_patches]`` matching the reference's stacking behavior.
    """

    def __init__(self, input_size, mask_ratio, num_view: int = 1, rng=None):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_mask = int(mask_ratio * self.num_patches)
        self.num_view = num_view
        self.rng = rng if rng is not None else np.random.default_rng()

    def __repr__(self):
        return "Mask: total patches {}, mask patches {}".format(
            self.num_patches, self.num_mask
        )

    def __call__(self):
        masks = self.batch(1)[0]
        if self.num_view == 1:
            return masks[0]
        return masks

    def batch(self, n: int) -> np.ndarray:
        """Vectorized: ``[n, num_view, num_patches]`` float32 masks."""
        scores = self.rng.random((n, self.num_view, self.num_patches))
        # The `num_mask` smallest scores per row are masked: exact count.
        kth = np.argsort(scores, axis=-1)
        masks = np.zeros((n, self.num_view, self.num_patches), dtype=np.float32)
        np.put_along_axis(masks, kth[..., : self.num_mask], 1.0, axis=-1)
        return masks


def random_mask_from_uniforms(u: torch.Tensor, num_mask: int) -> torch.Tensor:
    """u [B, V, N] -> bool mask of the same shape with exactly `num_mask`
    True per row: the patches whose uniform ranks among the `num_mask`
    lowest (ties broken by position, as a stable sort breaks them)."""
    ranks = torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1, stable=True)
    return ranks < num_mask


def random_mask_batch(generator: torch.Generator, batch: int, num_patches: int, num_mask: int,
                      num_view: int = 1) -> torch.Tensor:
    """Exact-count random mask ``[batch, num_view, num_patches]`` bool, drawn
    from `generator` on the generator's device."""
    u = torch.rand((batch, num_view, num_patches), generator=generator,
                   device=generator.device)
    return random_mask_from_uniforms(u, num_mask)
