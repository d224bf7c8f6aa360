"""The CTC loss's emit log-probabilities as a one-hot product (the
reproducible form the card needs) against the `torch.gather` form it
replaced and against `optax.ctc_loss` through `dig_tpu`, on the CPU.

Labels hold one id three times or more ("banana"), the case where the
gather's CUDA backward (an atomic scatter-add) sums in a varying order.
Tolerances: in fp64 and in fp32 the loss equals the gather form's bit for
bit (a sum of one term and zeros is exact) and each gradient lies within 4
ulp of the row's largest |gradient| (the matrix product adds a repeated id's terms in
another order than the scatter-add); in fp32 against optax, the loss within
1e-5 and the gradients within 1e-4 of each row's max, as
`tests/test_torch_port_kinds.py` holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from _torch_port_threads import one_thread
from dig_tpu_torch.losses import ctc as tctc


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


B, FRAMES, K, BLANK = 4, 32, 98, 97


def gather_ctc_loss(logits, labels, label_paddings, blank_id, log_epsilon=-1e5):
    """The loss as the port computed it before the repair: the emit
    log-probabilities by `torch.gather` along the class axis."""
    b, n = labels.shape
    k = logits.shape[-1]
    logprobs = torch.log_softmax(logits, dim=-1)
    label_lens = n - label_paddings.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype), (0, 1))
    logprobs_phi = logprobs[:, :, blank_id].transpose(0, 1)[..., None]
    valid = ((labels >= 0) & (labels < k))[:, None, :]
    idx = labels.long().clamp(0, k - 1)[:, None, :].expand(-1, logprobs.shape[1], -1)
    logprobs_emit = torch.where(valid, torch.gather(logprobs, 2, idx), 0.0).transpose(0, 1)

    def add_to_phi(phi, score):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], dim=-1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=logprobs.dtype)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=-1)
    emit = torch.full((b, n), log_epsilon, dtype=logprobs.dtype)
    for t in range(logprobs.shape[1]):
        prev_phi = add_to_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi = logprobs_emit[t], logprobs_phi[t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = add_to_phi(prev_phi + lp_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    return -torch.gather(add_to_phi(phi, emit), 1, label_lens[:, None])[:, 0]


def _inputs(seed):
    """Logits, labels with tripled ids ("banana" patterns, an id outside
    [0, K) in one padded tail) and their paddings."""
    rng = np.random.default_rng(seed)
    logits = 2 * rng.normal(size=(B, FRAMES, K))
    labels = rng.integers(0, 94, (B, 12))
    labels[0, :6] = [1, 0, 13, 0, 13, 0]  # b a n a n a
    labels[1, 2:8:2] = 5
    labels[2, :4] = 9
    lens = np.array([6, 9, 12, 4])
    pad = (np.arange(12)[None] >= lens[:, None]).astype(np.float64)
    labels[3, 10] = K + 3  # past the label's end: padding, any id
    return logits, labels, pad


def _triples(labels, pad):
    return sum(int(np.bincount(row[p == 0]).max() >= 3) for row, p in zip(labels, pad))


def _both_forms(logits, labels, pad):
    res = []
    for fn in (tctc.ctc_loss, gather_ctc_loss):
        x = torch.from_numpy(logits).requires_grad_(True)
        loss = fn(x, torch.from_numpy(labels), torch.from_numpy(pad), BLANK)
        loss.sum().backward()
        res.append((loss.detach().numpy(), x.grad.numpy()))
    return res


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_onehot_emit_matches_the_gather_form(seed, dtype):
    """Loss bit for bit; each gradient within 4 ulp of its row's largest
    |gradient|, in fp64 and in fp32."""
    logits, labels, pad = _inputs(seed)
    assert _triples(labels, pad) >= 2
    (a_loss, a_grad), (b_loss, b_grad) = _both_forms(logits.astype(dtype), labels, pad)
    assert a_loss.dtype == dtype
    np.testing.assert_array_equal(a_loss, b_loss)
    for row in range(B):
        ulp = np.finfo(dtype).eps * np.abs(b_grad[row]).max()
        assert np.abs(a_grad[row] - b_grad[row]).max() <= 4 * ulp, row


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_onehot_ctc_matches_optax_through_dig_tpu(seed):
    """The fine-tuning step's loss (`ctc_step_loss`) against the JAX step's
    `optax.ctc_loss` call (`dig_tpu/train/finetune.py:134-168` builds the
    same paddings from the lengths), loss and gradient, fp32."""
    logits, labels, _ = _inputs(seed)
    logits = logits.astype(np.float32)
    targets = np.concatenate([labels, np.zeros((B, 2), np.int64)], 1) % 94
    targets[0, :6] = [1, 0, 13, 0, 13, 0]
    lens = np.array([7, 10, 13, 5])  # EOS included, as the step counts
    pad = (np.arange(targets.shape[1])[None] >= (lens - 1)[:, None]).astype(np.float32)

    def jloss(lg):
        return optax.ctc_loss(lg, jnp.zeros((B, FRAMES)), jnp.asarray(targets, jnp.int32),
                              jnp.asarray(pad), blank_id=BLANK).mean()

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tctc.ctc_step_loss(x, torch.from_numpy(targets), torch.from_numpy(lens), BLANK)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    want_grad = np.asarray(want_grad)
    for row in range(B):
        scale = np.abs(want_grad[row]).max()
        assert np.abs(x.grad.numpy()[row] - want_grad[row]).max() <= 1e-4 * scale, row
