"""Windowed SimCLR NT-Xent loss over horizontally pooled sequence features.

Counterpart of `dig_tpu/losses/simclr.py` (reference:
loss/seqSimCLRLoss.py:5-79): features [B, N, C] are average-pooled along
the tokens into `num_windows` windows; each window is a contrastive
sample whose positive is the same window of the other view, the other
2 (B * W - 1) windows of the batch its negatives; cosine similarity over
the temperature, CE over [positive, negatives].  A library function: no
CLI of either package calls it.
"""

from __future__ import annotations

import torch

from dig_tpu_torch.models.moco import adaptive_window_pool


def _pool_windows(z, num_windows: int):
    """[B, N, C] -> [B * num_windows, C] (the token sequence pooled as a 1 x N map)."""
    b, _, c = z.shape
    return adaptive_window_pool(z[:, None], num_windows).reshape(b * num_windows, c)


def seq_simclr_loss(z_i, z_j, temperature: float, num_windows: int = 5):
    zi, zj = _pool_windows(z_i, num_windows), _pool_windows(z_j, num_windows)
    m = zi.shape[0]
    z = torch.cat([zi, zj], dim=0)
    z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
    sim = torch.einsum("ic,jc->ij", z, z) / temperature
    n = 2 * m
    rows = torch.arange(n, device=z.device)
    pos_idx = torch.cat([torch.arange(m, device=z.device) + m, torch.arange(m, device=z.device)])
    positives = sim[rows, pos_idx][:, None]
    mask = ~torch.eye(n, dtype=torch.bool, device=z.device)
    mask[rows, pos_idx] = False
    negatives = sim.masked_fill(~mask, -1e30)
    logits = torch.cat([positives, negatives], dim=1)
    return -torch.log_softmax(logits.float(), dim=-1)[:, 0].mean()
