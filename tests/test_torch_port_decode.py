"""The port's greedy and beam decoders against the JAX package's, on the CPU.

The decoder is `small_tf_decoder` (2 layers, width 384, 97 classes, 25
steps) with the JAX package's initial weights perturbed by numpy noise and
carried across with `decoder_from_jax`; both decoders read the same encoder
map (numpy noise, [B, 256, 384]), so what is compared is the decoding alone.
The classifier's EOS bias is raised, so that beams emit EOS and are killed
(asserted).  Everything is fp32.  Ids must be equal; probabilities within
1e-5 (softmax values of sums of a few hundred products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_threads import one_thread
from dig_tpu.models.decoder import create_decoder as j_create_decoder
from dig_tpu_torch.models import decoder as tdec
from dig_tpu_torch.utils.convert import decoder_from_jax

B, N, WIDTH = 6, 256, 384
EOS = 94
PROB_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def decoders():
    jdec = j_create_decoder("small_tf_decoder", 97, 25)
    rng = np.random.default_rng(60)
    enc = rng.normal(size=(B, N, WIDTH)).astype(np.float32)
    variables = jdec.init(jax.random.PRNGKey(0), jnp.asarray(enc), jnp.zeros((B, 25), jnp.int32),
                          jnp.full((B,), 25), deterministic=True)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p)).astype(np.float32),
        variables["params"])
    # EOS among the leading candidates from the first steps on: beams get killed
    params["classifier"]["bias"][EOS] += 3.0
    tdecoder = tdec.create_decoder("small_tf_decoder", 97, 25)
    tdecoder.load_state_dict(decoder_from_jax(params), strict=False)
    tdecoder.eval()
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    return jdec, jparams, tdecoder, enc


def _jax(jdec, jparams, method, *args):
    return jax.tree_util.tree_map(
        np.asarray, jdec.apply(jparams, *args, method=getattr(jdec, method)))


def _port(tdecoder, method, enc, *args):
    with torch.no_grad():
        out = getattr(tdecoder, method)(torch.from_numpy(enc), *args)
    return jax.tree_util.tree_map(lambda t: t.numpy(), out)


def _kills(monkeypatch):
    """Counts, for every beam_select call of the port, the beams killed."""
    killed = []
    real = tdec.beam_select

    def spy(scores, logp, b, num_classes, eos):
        out = real(scores, logp, b, num_classes, eos)
        killed.append(int((out[2] == eos).sum()))
        return out

    monkeypatch.setattr(tdec, "beam_select", spy)
    return killed


@pytest.mark.parametrize("k", [1, 2, 3])
def test_beam_search_ids_equal_jax(decoders, k, monkeypatch):
    jdec, jparams, tdecoder, enc = decoders
    killed = _kills(monkeypatch)
    got = _port(tdecoder, "beam_search", enc, k, EOS)
    want = _jax(jdec, jparams, "beam_search", jnp.asarray(enc), k, EOS)
    assert got.shape == want.shape == (B, 25)
    np.testing.assert_array_equal(got, want)
    assert sum(killed) > 0, "no beam emitted EOS: the kill path was not exercised"
    assert (got == EOS).any()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_beam_search_dense_ids_equal_jax(decoders, k, monkeypatch):
    jdec, jparams, tdecoder, enc = decoders
    killed = _kills(monkeypatch)
    got = _port(tdecoder, "beam_search_dense", enc, k, EOS)
    np.testing.assert_array_equal(got, _jax(jdec, jparams, "beam_search_dense",
                                            jnp.asarray(enc), k, EOS))
    np.testing.assert_array_equal(got, _port(tdecoder, "beam_search", enc, k, EOS))
    assert sum(killed) > 0


def test_beam_width_one_is_the_greedy_decode_up_to_eos(decoders):
    """k = 1 keeps one beam: the greedy path until its first EOS, after
    which the killed beam's history is the backtracked hypothesis."""
    _, _, tdecoder, enc = decoders
    beam = _port(tdecoder, "beam_search", enc, 1, EOS)
    _, greedy = _port(tdecoder, "greedy_decode", enc)
    for r in range(B):
        stop = list(greedy[r]).index(EOS) if EOS in greedy[r] else 24
        np.testing.assert_array_equal(beam[r, :stop + 1], greedy[r, :stop + 1])


def test_beam_select_breaks_ties_to_the_lowest_index():
    """Equal candidates (killed beams tie at -inf) keep their index order,
    as `jax.lax.top_k` keeps it."""
    scores = torch.tensor([0.0, -torch.inf, -torch.inf])
    logp = torch.zeros((3, 4))  # every candidate of beam 0 ties at 0
    top, pred, sym, new = tdec.beam_select(scores, logp, 1, 4, eos=2)
    assert top.tolist() == [[0.0, 0.0, 0.0]]
    assert pred.tolist() == [0, 0, 0] and sym.tolist() == [0, 1, 2]
    assert new.tolist() == [0.0, 0.0, -np.inf]  # symbol 2 is EOS: killed


def test_greedy_dense_equals_the_cached_greedy_at_full_length(decoders):
    jdec, jparams, tdecoder, enc = decoders
    p_dense, ids_dense = _port(tdecoder, "greedy_decode_dense", enc)
    p_cached, ids_cached = _port(tdecoder, "greedy_decode", enc)
    np.testing.assert_array_equal(ids_dense, ids_cached)
    np.testing.assert_allclose(p_dense, p_cached, rtol=0, atol=PROB_ATOL)
    p_jax, ids_jax = _jax(jdec, jparams, "greedy_decode_dense", jnp.asarray(enc))
    np.testing.assert_array_equal(ids_dense, ids_jax)
    np.testing.assert_allclose(p_dense, p_jax, rtol=0, atol=PROB_ATOL)


def test_greedy_dense_early_exit_equals_up_to_each_rows_eos(decoders):
    jdec, jparams, tdecoder, enc = decoders
    p_full, ids_full = _port(tdecoder, "greedy_decode_dense", enc)
    p_eos, ids_eos = _port(tdecoder, "greedy_decode_dense", enc, EOS)
    p_jax, ids_jax = _jax(jdec, jparams, "greedy_decode_dense", jnp.asarray(enc), EOS)
    firsts = [list(row).index(EOS) for row in ids_full]  # every row ends (the raised bias)
    stop = max(firsts)
    assert stop < 24, "the early exit never fired"
    for r, first in enumerate(firsts):
        np.testing.assert_array_equal(ids_eos[r, :first + 1], ids_full[r, :first + 1])
        np.testing.assert_allclose(p_eos[r, :first + 1], p_full[r, :first + 1], atol=PROB_ATOL)
    # past the global stop nothing was decoded, on either side
    assert (ids_eos[:, stop + 1:] == 0).all() and (p_eos[:, stop + 1:] == 0).all()
    np.testing.assert_array_equal(ids_eos, ids_jax)
    np.testing.assert_allclose(p_eos, p_jax, rtol=0, atol=PROB_ATOL)
