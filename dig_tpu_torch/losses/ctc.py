"""The CTC loss of the CTC recognizer's fine-tuning step.

`dig_tpu/train/finetune.py:134-168` calls `optax.ctc_loss`; this is its
log-space forward (alpha) recursion written out in plain PyTorch, with
its semantics:

* the negative log-likelihood of each sequence (no division by the label
  length), which the step averages over the batch;
* alpha kept as two arrays, the blank states (N + 1) and the label states
  (N), and impossible transitions given `log_epsilon` = -1e5 instead of
  -inf, so an alignment that cannot exist (a label longer than the frames
  allow) costs a large finite loss, never inf or nan;
* labels right-padded, `label_paddings` 1.0 past each label's end.

The batch mean keeps what data parallelism needs: over ranks with equal
local batches, the mean of the ranks' means is the global batch's mean.

`F.ctc_loss` is not used: its ``mean`` reduction divides by the label
length, it returns inf for an impossible alignment (or 0 under
``zero_infinity``), and its CUDA backward is documented as not
deterministic, which a resumed run that must repeat an uninterrupted one
bit for bit cannot take.  The backward here is autograd's.  For the same
reason the emit log-probabilities are a one-hot product, as optax builds
them, and not a `torch.gather`: the gather's CUDA backward is an atomic
scatter-add, whose fp32 sums over a label that holds one id three times or
more come out in another order from run to run; the product's backward is
a matrix product, the same bits every run (`models/layers.py::embedding`
does the same for the embedding's backward).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(logits, labels, label_paddings, blank_id: int, log_epsilon: float = -1e5):
    """logits [B, T, K] (every frame valid), labels [B, N] ids,
    label_paddings [B, N] (1.0 = padding) -> per-sequence loss [B], in at
    least fp32 (fp64 logits stay fp64)."""
    b, n = labels.shape
    k = logits.shape[-1]
    acc = torch.promote_types(logits.dtype, torch.float32)
    logprobs = torch.log_softmax(logits.to(acc), dim=-1)
    label_lens = n - label_paddings.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(acc), (0, 1))  # [B, N]
    logprobs_phi = logprobs[:, :, blank_id].transpose(0, 1)[..., None]  # [T, B, 1]
    # an id outside [0, K) has a zero one-hot row: it emits with log-probability 0
    onehot = F.one_hot(labels.long().clamp(0, k - 1), k).to(acc)
    onehot = onehot * ((labels >= 0) & (labels < k))[..., None].to(acc)
    logprobs_emit = torch.bmm(logprobs, onehot.transpose(1, 2)).transpose(0, 1)  # [T, B, N]

    def add_to_phi(phi, score):  # phi[:, 1:] logaddexp score
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], dim=-1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=acc, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=-1)
    emit = torch.full((b, n), log_epsilon, dtype=acc, device=logits.device)
    for t in range(logprobs.shape[1]):
        # emit-to-blank epsilon transition, except before a repeated label
        prev_phi = add_to_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi = logprobs_emit[t], logprobs_phi[t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        # blank self-loop; emit-to-blank through a blank only before a repeat
        next_phi = add_to_phi(prev_phi + lp_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    phi_last = add_to_phi(phi, emit)  # the last epsilon transition
    return -torch.gather(phi_last, 1, label_lens[:, None])[:, 0]


def ctc_step_loss(logits, targets, lengths, blank_id: int):
    """The fine-tuning step's loss: labels run to ``lengths - 1`` (EOS
    dropped), mean over the batch of the per-sequence losses."""
    pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
    label_paddings = (pos >= (lengths - 1)[:, None]).float()
    return ctc_loss(logits, targets, label_paddings, blank_id).mean()
