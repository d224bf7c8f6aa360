"""The DINO and MSN losses, counterparts of `dig_tpu/losses/extra.py`.

The reference ships both unused and broken (loss/emaLoss.py:5-57,
loss/msnLoss.py:31-140: `np` / `dist` used without imports); these are the
JAX package's working versions of the same math.  Library functions: no
CLI of either package calls them.  Each works on the tensors it is given
(this process's rows): under data parallelism the caller gathers first.
"""

from __future__ import annotations

import torch


def dino_loss(student_logits, teacher_logits, center, student_temp: float = 0.1,
              teacher_temp: float = 0.04, center_momentum: float = 0.9):
    """DINO cross-entropy with teacher centering -> (loss, new center).
    The teacher's probabilities are the softmax of (logits - center) /
    teacher_temp, without gradient; the center follows the batch mean of
    the teacher logits by EMA."""
    t = torch.softmax((teacher_logits - center) / teacher_temp, dim=-1).detach()
    log_s = torch.log_softmax(student_logits / student_temp, dim=-1)
    loss = (-t * log_s).sum(dim=-1).mean()
    batch_center = teacher_logits.mean(dim=0, keepdim=True)
    new_center = center * center_momentum + batch_center * (1.0 - center_momentum)
    return loss, new_center.detach()


def sinkhorn(scores, n_iter: int = 3, eps: float = 1e-8):
    """Sinkhorn-Knopp normalization of [N, K] scores: rows sum to 1,
    columns balanced."""
    q = torch.exp(scores).T  # [K, N]
    q = q / (q.sum() + eps)
    k, n = q.shape
    for _ in range(n_iter):
        q = q / (q.sum(dim=1, keepdim=True) + eps) / k
        q = q / (q.sum(dim=0, keepdim=True) + eps) / n
    return (q * n).T


def msn_loss(anchors, targets, prototypes, temperature: float = 0.1,
             me_max_weight: float = 1.0, use_sinkhorn: bool = True, use_entropy: bool = False):
    """MSN: the CE of soft prototype assignments plus the me-max regularizer.
    anchors / targets [N, D], prototypes [K, D] -> (loss, {"msn_ce",
    "msn_rloss"})."""

    def snn(z, temp):
        z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
        p = prototypes / (torch.linalg.vector_norm(prototypes, dim=-1, keepdim=True) + 1e-12)
        return torch.softmax(z @ p.T / temp, dim=-1)

    probs = snn(anchors, temperature)
    tprobs = snn(targets, temperature)
    if use_sinkhorn:
        tprobs = sinkhorn(torch.log(tprobs + 1e-12))
    tprobs = tprobs.detach()
    ce = (-tprobs * torch.log(probs + 1e-12)).sum(dim=-1).mean()
    avg_probs = probs.mean(dim=0)
    rloss = -torch.log(avg_probs ** (-avg_probs) + 1e-12).sum()
    loss = ce + me_max_weight * rloss
    if use_entropy:
        loss = loss - (probs * torch.log(probs + 1e-12)).sum(dim=-1).mean()
    return loss, {"msn_ce": ce, "msn_rloss": rloss}
