"""Word-level recognition metrics for the eval step's ids.

The port's own copy of the parts of `dig_tpu/metrics/text.py` that score
a recognizer's predictions (reference: evaluation_metric/metrics.py:14-202):
decode to text stopping at EOS, case-insensitive alphanumeric
normalization, word accuracy, the character-set F-measure, the summed
edit distance, lexicon-constrained accuracy and the per-word confidence of
`rec_post_process`; the CTC collapse decode and accuracy (:205-251) and
the multi-label F-measure (evaluation_metric/multi_label_metrics.py:24-65).
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


def recognition_f_measure(pred_ids, target_ids, charset: Charset) -> float:
    """Character-set F1 averaged over samples."""
    fs = []
    for pred, targ in zip(decode_batch(pred_ids, charset), decode_batch(target_ids, charset)):
        pred_chars, targ_chars = set(pred), set(targ)
        num_right = float(len(pred_chars & targ_chars))
        p = num_right / (len(pred_chars) + 1e-5)
        r = num_right / (len(targ_chars) + 1e-5)
        fs.append(2 * p * r / (p + r + 1e-5))
    return float(sum(fs)) / max(len(fs), 1)


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


def lexicon_search(lexicon, word: str) -> str:
    """The nearest lexicon entry by edit distance over normalized strings,
    the first on a tie."""
    dists = [levenshtein(normalize_text(w), normalize_text(word)) for w in lexicon]
    return lexicon[int(np.argmin(np.asarray(dists)))]


def accuracy_with_lexicon(pred_ids, target_ids, charset: Charset, lexicons) -> list:
    """[accuracy without a lexicon, then with each lexicon list]: each
    prediction replaced by its sample's nearest lexicon entry (an empty
    lexicon keeps it)."""
    preds = decode_batch(pred_ids, charset)
    targs = decode_batch(target_ids, charset)
    n = max(len(preds), 1)
    accs = [float(sum(p == t for p, t in zip(preds, targs))) / n]
    for lex_per_sample in lexicons:
        refined = [normalize_text(lexicon_search(lex, p)) if lex else p
                   for lex, p in zip(lex_per_sample, preds)]
        accs.append(float(sum(p == t for p, t in zip(refined, targs))) / n)
    return accs


def rec_post_process(pred_ids, target_ids, scores, charset: Charset):
    """(predictions, targets, confidences): each word's confidence is the
    product of its per-step chosen-symbol probabilities `scores` [N, T] up
    to and including EOS, counting ``len(normalized prediction) + 1``
    steps, as the reference does (so a prediction with symbols counts fewer
    factors than decode steps)."""
    preds = decode_batch(pred_ids, charset)
    targs = decode_batch(target_ids, charset)
    scores = np.asarray(scores)
    max_len = scores.shape[1]
    conf = [float(np.prod(scores[i, :min(len(p) + 1, max_len)])) for i, p in enumerate(preds)]
    return preds, targs, conf


def ctc_decode_batch(ids, charset: Charset):
    """Per-frame ids [N, T] -> normalized strings: repeats collapsed, then
    blanks (id ``num_classes``, one past the vocabulary) dropped; EOS,
    UNKNOWN and PADDING emit nothing but still break a repeat."""
    blank = charset.num_classes
    skip = (charset.eos_id, charset.unknown_id, charset.padding_id)
    out = []
    for row in np.asarray(ids):
        chars, prev = [], -1
        for i in (int(v) for v in row):
            if i != blank and i != prev and i not in skip and i < charset.num_classes:
                chars.append(charset.classes[i])
            prev = i
        out.append(normalize_text("".join(chars)))
    return out


def ctc_accuracy(pred_ids, target_ids, charset: Charset) -> float:
    preds = ctc_decode_batch(pred_ids, charset)
    targs = decode_batch(target_ids, charset)
    return float(sum(p == t for p, t in zip(preds, targs))) / max(len(preds), 1)


def multi_label_f_measure(logits, targets, threshold: float = 0.5) -> float:
    """Character-presence F1 over the whole batch from sigmoid logits
    [N, C] (fp64) against 0/1 presence targets [N, C]."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    pred = probs > threshold
    targ = np.asarray(targets) > 0.5
    tp = float((pred & targ).sum())
    p = tp / (pred.sum() + 1e-5)
    r = tp / (targ.sum() + 1e-5)
    return 2 * p * r / (p + r + 1e-5)
