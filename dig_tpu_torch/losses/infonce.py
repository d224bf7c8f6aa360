"""MoCo v3-style InfoNCE with label smoothing and top-k accuracy.

Counterpart of `dig_tpu/losses/infonce.py` (reference:
modeling_pretrain_moco_mim_ori.py:444-461, :593-625): the loss is scaled
by 2T.  Across data-parallel ranks the keys are gathered from every rank
in rank order (`parallel.dist.concat_all_gather`, the reference's
`concat_all_gather`) and this rank's row i takes key rank * N + i as its
positive (:453), so the mean over the ranks of their losses is the JAX
package's loss on the global batch; top-1/5 accuracy is over this rank's
queries against the global keys.  Alone, the keys are this process's and
row i's positive is key i.  Under a mesh the keys come from the
data-parallel ranks only, and the offset is this rank's data-parallel
index: tensor peers hold the same rows (`parallel/mesh.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dig_tpu_torch.parallel.dist import concat_all_gather, get_rank
from dig_tpu_torch.parallel.mesh import current_mesh


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
    """q, k: [N, D], this rank's rows; the caller has detached k (the
    momentum branch)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
    mesh = current_mesh()
    k = concat_all_gather(k, None if mesh is None else mesh.dp_group)
    logits = torch.einsum("nc,mc->nm", q, k) / temperature
    n = logits.shape[0]
    labels = torch.arange(n, device=logits.device) + n * (get_rank() if mesh is None
                                                          else mesh.dp_index)
    loss = label_smooth_softmax_ce(logits, labels, smoothing) * (2.0 * temperature)
    if return_acc:
        return loss, tuple(topk_accuracy(logits, labels, ks=(1, 5)))
    return loss
