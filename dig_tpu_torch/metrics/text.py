"""Word-level recognition metrics for the eval step's ids.

The port's own copy of the parts of `dig_tpu/metrics/text.py` that score
greedy predictions (reference: evaluation_metric/metrics.py:14-81):
decode to text stopping at EOS, case-insensitive alphanumeric
normalization, word accuracy and the summed edit distance.
"""

from __future__ import annotations

import numpy as np

from dig_tpu_torch.utils.charset import Charset, normalize_text


def decode_batch(ids, charset: Charset):
    """Decode an [N, T] id array into a list of normalized strings."""
    return [normalize_text(charset.decode(row)) for row in np.asarray(ids)]


def accuracy(pred_ids, target_ids, charset: Charset) -> float:
    preds = decode_batch(pred_ids, charset)
    targs = decode_batch(target_ids, charset)
    return float(sum(p == t for p, t in zip(preds, targs))) / max(len(preds), 1)


def levenshtein(a: str, b: str) -> int:
    """Levenshtein distance (the reference's C++ `editdistance`, eval-time only)."""
    if a == b:
        return 0
    if not a or not b:
        return len(a) + len(b)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(cur[j - 1] + 1, prev[j] + 1, prev[j - 1] + (cb != ca)))
        prev = cur
    return prev[-1]


def edit_distance(pred_ids, target_ids, charset: Charset) -> int:
    preds = decode_batch(pred_ids, charset)
    targs = decode_batch(target_ids, charset)
    return sum(levenshtein(p, t) for p, t in zip(preds, targs))
