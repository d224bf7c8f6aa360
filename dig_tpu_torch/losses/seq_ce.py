"""Sequence cross-entropy losses for autoregressive recognition.

The port's own copy of `dig_tpu/losses/seq_ce.py` (reference:
loss/seqCrossEntropyLoss.py:19-63, loss/seqLabelSmoothingCrossEntropyLoss.py:19-70):
length-masked NLL over [B, T, C] logits in fp32, summed and normalized by
the batch size (``sample_normalize``) or by the number of valid tokens
(``sequence_normalize``).  The label-smoothing form is the JAX package's
intended math, confidence * NLL + smoothing * (-mean_c log p_c), not the
reference's broadcasting bug (PARITY.md §2.6).
"""

from __future__ import annotations

import torch


def _length_mask(targets, lengths):
    t = targets.shape[1]
    return (torch.arange(t, device=targets.device)[None, :] < lengths[:, None]).float()


def _nll(logprobs, targets):
    return -torch.gather(logprobs, -1, targets[..., None].long())[..., 0]


def seq_cross_entropy(logits, targets, lengths, sequence_normalize: bool = False,
                      sample_normalize: bool = True):
    assert not (sequence_normalize and sample_normalize)
    mask = _length_mask(targets, lengths)
    out = (_nll(torch.log_softmax(logits.float(), dim=-1), targets) * mask).sum()
    if sequence_normalize:
        out = out / mask.sum()
    if sample_normalize:
        out = out / targets.shape[0]
    return out


def seq_cross_entropy_rows(logits, targets, lengths):
    """Per-sample masked NLL sums [B]: the unreduced form of
    `seq_cross_entropy(sample_normalize=True)`, as the eval step reports it."""
    mask = _length_mask(targets, lengths)
    return (_nll(torch.log_softmax(logits.float(), dim=-1), targets) * mask).sum(-1)


def seq_label_smoothing_cross_entropy(logits, targets, lengths, smoothing: float = 0.1,
                                      sequence_normalize: bool = False,
                                      sample_normalize: bool = True):
    """confidence * NLL + smoothing * (-mean_c log p_c), length-masked."""
    assert not (sequence_normalize and sample_normalize)
    mask = _length_mask(targets, lengths)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    loss = (1.0 - smoothing) * _nll(logprobs, targets) + smoothing * -logprobs.mean(-1)
    out = (loss * mask).sum()
    if sequence_normalize:
        out = out / mask.sum()
    if sample_normalize:
        out = out / targets.shape[0]
    return out
