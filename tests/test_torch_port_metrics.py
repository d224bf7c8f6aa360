"""The port's recognition metrics against the JAX package's, on seeded
predictions: F-measure, lexicon search, lexicon-constrained accuracy and
`rec_post_process`'s per-word confidence."""

import numpy as np
import pytest

from dig_tpu.metrics import text as jax_text
from dig_tpu.utils.charset import build_charset as jax_charset
from dig_tpu_torch.metrics import text as port_text
from dig_tpu_torch.utils.charset import build_charset as port_charset

MAX_LEN = 12
WORDS = ["Hello", "world", "tpu", "Scene", "text", "recog", "dig", "a1b2", "HELLO!", "wor1d"]


def _ids(charset, words):
    return np.stack([charset.encode(w)[0] for w in words])


def _batch(seed, n=8):
    """(preds, targets) ids of seeded words, the predictions a mix of exact,
    case-changed and corrupted copies of the targets."""
    rng = np.random.default_rng(seed)
    targ = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    pred = []
    for w in targ:
        r = rng.random()
        if r < 0.3:
            pred.append(w)
        elif r < 0.6:
            pred.append(w.swapcase())
        else:
            chars = list(w)
            chars[rng.integers(0, len(chars))] = "xyz!"[rng.integers(0, 4)]
            pred.append("".join(chars))
    return pred, targ


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f_measure_and_lexicon_accuracy_match_jax(seed):
    pc, jc = port_charset("ALLCASES_SYMBOLS", MAX_LEN), jax_charset("ALLCASES_SYMBOLS", MAX_LEN)
    pred, targ = _batch(seed)
    p_ids, t_ids = _ids(pc, pred), _ids(pc, targ)
    assert np.array_equal(p_ids, _ids(jc, pred)) and np.array_equal(t_ids, _ids(jc, targ))
    assert port_text.recognition_f_measure(p_ids, t_ids, pc) == \
        jax_text.recognition_f_measure(p_ids, t_ids, jc)
    rng = np.random.default_rng(seed + 10)
    # two lexicon lists: per-sample subsets of the vocabulary, one with empty entries
    lexicons = [[[WORDS[i] for i in rng.choice(len(WORDS), 4, replace=False)] for _ in pred],
                [[] if rng.random() < 0.5 else list(WORDS) for _ in pred]]
    got = port_text.accuracy_with_lexicon(p_ids, t_ids, pc, lexicons)
    assert got == jax_text.accuracy_with_lexicon(p_ids, t_ids, jc, lexicons)
    assert len(got) == 3
    for word in pred:
        assert port_text.lexicon_search(WORDS, word) == jax_text.lexicon_search(WORDS, word)


def test_rec_post_process_matches_jax():
    pc, jc = port_charset("ALLCASES_SYMBOLS", MAX_LEN), jax_charset("ALLCASES_SYMBOLS", MAX_LEN)
    pred, targ = _batch(3)
    pred[0] = "HELLO!"
    p_ids, t_ids = _ids(pc, pred), _ids(pc, targ)
    scores = np.random.default_rng(3).uniform(0.5, 1.0, p_ids.shape).astype(np.float32)
    got = port_text.rec_post_process(p_ids, t_ids, scores, pc)
    ref = jax_text.rec_post_process(p_ids, t_ids, scores, jc)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert got[2] == ref[2]
    # "HELLO!" normalizes to 5 characters: 6 factors, not the 7 decode steps
    assert got[2][0] == float(np.prod(scores[0, :6]))
