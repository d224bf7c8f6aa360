"""MoCo v3-style InfoNCE with label smoothing and top-k accuracy.

Counterpart of `dig_tpu/losses/infonce.py` (reference:
modeling_pretrain_moco_mim_ori.py:444-461, :593-625): the loss is scaled
by 2T, row i's positive is key i.  One process holds the whole batch in
this slice, so no keys are gathered across ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def label_smooth_softmax_ce(logits, labels, smoothing: float = 0.0):
    """Mean CE with the reference's smoothing: positive mass (1 - s) + s/C,
    every other class s/C; log-softmax in at least fp32."""
    c = logits.shape[-1]
    acc = torch.promote_types(logits.dtype, torch.float32)
    logprobs = torch.log_softmax(logits.to(acc), dim=-1)
    true_dist = F.one_hot(labels, c).to(acc) * (1.0 - smoothing) + smoothing / c
    return (-true_dist * logprobs).sum(-1).mean()


def topk_accuracy(logits, labels, ks=(1, 5)):
    """Percent top-k accuracy for each k, as fp32 scalars."""
    pred = logits.topk(max(ks), dim=-1).indices
    correct = pred == labels[:, None]
    return [100.0 * correct[:, :k].any(-1).to(torch.float32).mean() for k in ks]


def info_nce_loss(q, k, temperature: float, smoothing: float = 0.0, return_acc: bool = False):
    """q, k: [N, D]; the caller has detached k (the momentum branch)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
    logits = torch.einsum("nc,mc->nm", q, k) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = label_smooth_softmax_ce(logits, labels, smoothing) * (2.0 * temperature)
    if return_acc:
        return loss, tuple(topk_accuracy(logits, labels, ks=(1, 5)))
    return loss
