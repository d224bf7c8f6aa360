"""Autoregressive transformer text decoder (PyTorch), counterpart of
`dig_tpu/models/decoder.py` (reference: models/decoder.py:107-252,
models/transformer_layer.py:47-118, :204-281, :386-403).

`TFDecoder` embeds ``num_classes + 1`` symbols (BOS is the last id), adds
the sinusoid table, and runs pre-LN layers of self-attention,
cross-attention and FFN.  Inference paths, as in the JAX package:

* `greedy_decode`: token-at-a-time with per-layer KV caches, always
  `max_seq_len` steps (what the JAX package runs off the TPU);
* `greedy_decode_dense`: the whole prefix again at every step with the
  cross K/V computed once, fixed-length or with the EOS early exit (the
  loop stops once every row has emitted EOS; probabilities past the stop
  stay 0).  The same ids as `greedy_decode`: causal masking makes position
  t independent of later tokens;
* `beam_search` (KV-cached) and `beam_search_dense`: the reference's beam
  (models/decoder.py:254-370): length-unnormalized log-prob scores, a
  per-sample top-k over all beams' expansions, a beam that emits EOS is
  killed (score -inf) and its hypothesis recovered by backtracking through
  the stored predecessors, symbols and scores.  The per-row token history
  is *not* reordered by predecessor in the forward loop (the reference
  writes only ``init_target_seq[:, step + 1]``, :309): row r conditions on
  its own emissions while its score is inherited from its predecessor.
  That is observable in the ids, so it is reproduced; it also keeps the KV
  caches row-aligned.  Ties in the top-k go to the lowest index, as
  `jax.lax.top_k` breaks them (a stable descending sort: `torch.topk` on
  CUDA leaves the order of ties open, and killed beams tie at -inf).  The
  backtracking runs on the host in numpy, exactly as the JAX scan orders
  its writes, after one copy of the stored steps per batch (the only wait
  for the card in a beam batch).

Two variants (`dig_tpu/models/decoder.py:573-783`):

* ``text_cond_vis``: every layer's cross-attention is `TextConditionalMHA`,
  whose keys and values are FiLM-modulated by each query
  ([B, Lq, Lk, C] per layer).  Nothing of the cross K/V can be cached, so
  greedy and beam decoding run the full layers over the whole prefix at
  every step (the dense loops), as the JAX package does.
* `DecoupledTFDecoder`: a learned order embedding queries the encoder
  through each layer's cross-attention; its attention map is mixed with
  the multi-label head's class-query maps and applied to a re-projected
  value stream.  That vision branch does not depend on the tokens, so it
  is computed once per image (`_vision_branch`) and the decode loops run
  the token branch alone.

Under a mesh with tensor peers (`parallel/sharding.py`) `DecoderMHA`,
`TextConditionalMHA` and `PositionwiseFeedForward` run split when they
hold a `TensorParallel` (``self.tp``): linear_q/k/v and w_1 column-parallel
on this rank's heads and columns, fc and w_2 row-parallel; their dropout
masks are drawn whole and sliced.  The decode loops run in the eval pass,
where every layer runs whole.

None of this reaches a kernel: the self-attention is masked and the
cross-attention has Lq <= 25 < 128, so both take `_ref_attention`, as on
the TPU, or under dropout the unfused `attention_with_dropout`.  Dropout
(default 0.1, `dig_tpu/models/decoder.py:270`) acts in the teacher-forced
pass of training: after embedding + position, on the attention weights
and after each attention's output projection, and twice in the FFN.  Its
masks come from the `torch.Generator` that pass is given.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dig_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    attention_with_dropout,
    dropout,
    embedding,
    column_bias,
    make_causal_mask,
    make_pad_mask,
    row_parallel,
    sinusoid_position_table,
    split_active,
    training_generator,
)
from dig_tpu_torch.ops.activations import gelu
from dig_tpu_torch.ops.attention import multi_head_attention
from dig_tpu_torch.parallel.tensor import copy_to_region



class DecoderMHA(nn.Module):
    """Separate-q/k/v multi-head attention, no biases."""

    def __init__(self, n_head: int = 8, d_k: int = 64, d_v: int = 64,
                 d_model: int = 512, dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        self.linear_q = Dense(d_model, n_head * d_k, bias=False, dtype=dtype)
        self.linear_k = Dense(d_model, n_head * d_k, bias=False, dtype=dtype)
        self.linear_v = Dense(d_model, n_head * d_v, bias=False, dtype=dtype)
        self.fc = Dense(n_head * d_v, d_model, bias=False, dtype=dtype)
        self.tp = None  # a TensorParallel when split (parallel/sharding.py)

    def _heads(self):
        """(heads this rank computes, the TensorParallel when split)."""
        tp = self.tp if split_active(self.tp) else None
        return (self.n_head if tp is None else self.n_head // tp.size), tp

    def project_q(self, q_inp):
        b, lq, _ = q_inp.shape
        h, tp = self._heads()
        if tp is not None:
            q_inp = copy_to_region(q_inp, tp)
        return self.linear_q(q_inp).reshape(b, lq, h, self.d_k)

    def project_kv(self, k_inp, v_inp):
        b, lk, _ = k_inp.shape
        h, tp = self._heads()
        if tp is not None:
            same = v_inp is k_inp
            k_inp = copy_to_region(k_inp, tp)
            v_inp = k_inp if same else copy_to_region(v_inp, tp)
        k = self.linear_k(k_inp).reshape(b, lk, h, self.d_k)
        v = self.linear_v(v_inp).reshape(b, lk, h, self.d_v)
        return k, v

    def attend(self, q, k, v, mask=None, generator=None):
        """q [B, Lq, H, Dk]; k/v [B, Lk, H, D*]; mask broadcastable to
        [B, H, Lq, Lk] (True = attend).  Split, H is this rank's heads."""
        b, lq, h = q.shape[:3]
        _, tp = self._heads()
        scale = self.d_k**-0.5
        if self.dropout > 0.0 and generator is not None:
            out = attention_with_dropout(q, k, v, mask, scale, self.dropout, generator, tp)
        else:
            out = multi_head_attention(q, k, v, mask=mask, scale=scale)
        out = out.reshape(b, lq, h * self.d_v)
        out = self.fc(out) if tp is None else row_parallel(self.fc, out, tp)
        return dropout(out, self.dropout, generator)

    def forward(self, q, k, v, mask=None, generator=None):
        kp, vp = self.project_kv(k, v)
        return self.attend(self.project_q(q), kp, vp, mask, generator)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in: int, d_inner: int, dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.w_1 = Dense(d_in, d_inner, dtype=dtype)
        self.w_2 = Dense(d_inner, d_in, dtype=dtype)
        self.dropout = dropout
        self.tp = None  # a TensorParallel when split (parallel/sharding.py)

    def forward(self, x, generator=None):
        tp = self.tp
        if not split_active(tp):
            x = dropout(gelu(self.w_1(x)), self.dropout, generator)
            return dropout(self.w_2(x), self.dropout, generator)
        w_1, dt = self.w_1, self.w_1.compute_dtype
        h = F.linear(copy_to_region(x, tp).to(dt), w_1.weight.to(dt),
                     column_bias(w_1.bias, tp).to(dt))
        h = dropout(gelu(h), self.dropout, generator, (h.dim() - 1, tp.rank, tp.size))
        return dropout(row_parallel(self.w_2, h, tp), self.dropout, generator)


class TextConditionalMHA(nn.Module):
    """FiLM-modulated cross-attention (reference `TextConditionalMultiHeadAttention`,
    models/transformer_layer.py:284-383; `dig_tpu/models/decoder.py:573-620`):
    each query makes a tanh gamma and beta that modulate the normalized
    projection of the visual keys, so every query attends over keys and
    values of its own, [B, Lq, Lk, C].  The keys' width must equal
    n_head * d_k (the residual adds them)."""

    def __init__(self, n_head: int = 8, d_k: int = 64, d_v: int = 64, d_model: int = 512,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        dim_k, dim_v = n_head * d_k, n_head * d_v
        self.gamma_decode = Dense(d_model, 2 * dim_k, dtype=dtype)
        self.vis_proj = Dense(d_model, dim_k, dtype=dtype)
        self.vis_norm = LayerNorm(dim_k, 1e-6, dtype)
        self.vis_cond_norm = LayerNorm(dim_k, 1e-6, dtype)
        self.linear_q = Dense(d_model, dim_k, bias=False, dtype=dtype)
        self.linear_k = Dense(dim_k, dim_k, bias=False, dtype=dtype)
        self.linear_v = Dense(dim_k, dim_v, bias=False, dtype=dtype)
        self.fc = Dense(dim_v, d_model, bias=False, dtype=dtype)
        self.tp = None  # a TensorParallel when split (parallel/sharding.py)

    def forward(self, q, k, v, mask=None, generator=None):
        b, lq, _ = q.shape
        lk = k.shape[1]
        tp = self.tp if split_active(self.tp) else None
        h = self.n_head if tp is None else self.n_head // tp.size
        gammas, betas = torch.tanh(self.gamma_decode(q)[:, :, None, :]).chunk(2, dim=-1)
        cond = gammas * self.vis_norm(self.vis_proj(k))[:, None] + betas  # [B, Lq, Lk, dk]
        cond = k[:, None] + self.vis_cond_norm(cond)
        if tp is not None:
            q, cond = copy_to_region(q, tp), copy_to_region(cond, tp)
        qh = self.linear_q(q).reshape(b, lq, h, self.d_k)
        kh = self.linear_k(cond).reshape(b, lq, lk, h, self.d_k)
        vh = self.linear_v(cond).reshape(b, lq, lk, h, self.d_v)
        logits = torch.einsum("bqhd,bqkhd->bhqk", qh * self.d_k**-0.5, kh).float()
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e30)
        weights = dropout(torch.softmax(logits, dim=-1).to(vh.dtype), self.dropout, generator,
                          None if tp is None else (1, tp.rank, tp.size))
        out = torch.einsum("bhqk,bqkhd->bqhd", weights, vh).reshape(b, lq, h * self.d_v)
        out = self.fc(out) if tp is None else row_parallel(self.fc, out, tp)
        return dropout(out, self.dropout, generator)


class TransformerDecoderLayer(nn.Module):
    """Pre-LN: self-attn -> cross-attn -> FFN, each with a residual; under
    `text_cond_vis` the cross-attention is `TextConditionalMHA`."""

    def __init__(self, d_model: int = 512, d_inner: int = 256, n_head: int = 8,
                 d_k: int = 64, d_v: int = 64, dropout: float = 0.1,
                 text_cond_vis: bool = False, dtype=torch.float32):
        super().__init__()
        # flax nn.LayerNorm defaults: eps 1e-6
        self.norm1 = LayerNorm(d_model, 1e-6, dtype)
        self.norm2 = LayerNorm(d_model, 1e-6, dtype)
        self.norm3 = LayerNorm(d_model, 1e-6, dtype)
        self.self_attn = DecoderMHA(n_head, d_k, d_v, d_model, dropout, dtype)
        cross = TextConditionalMHA if text_cond_vis else DecoderMHA
        self.enc_attn = cross(n_head, d_k, d_v, d_model, dropout, dtype)
        self.mlp = PositionwiseFeedForward(d_model, d_inner, dropout, dtype)

    def forward(self, x, enc_output, self_attn_mask=None, generator=None):
        sa_in = self.norm1(x)
        x = x + self.self_attn(sa_in, sa_in, sa_in, self_attn_mask, generator)
        x = x + self.enc_attn(self.norm2(x), enc_output, enc_output, None, generator)
        return x + self.mlp(self.norm3(x), generator)

    def prepare_cross_kv(self, enc_output):
        return self.enc_attn.project_kv(enc_output, enc_output)

    def decode_step(self, x_t, t: int, self_k, self_v, cross_k, cross_v):
        """One token step.  x_t [B, 1, C]; self_k/v [B, T, H, D] caches,
        written in place at step t (saves a copy of every cache per step);
        keys past t are masked out (`arange(T) <= t`)."""
        sa_in = self.norm1(x_t)
        q = self.self_attn.project_q(sa_in)
        k_new, v_new = self.self_attn.project_kv(sa_in, sa_in)
        self_k[:, t] = k_new[:, 0]
        self_v[:, t] = v_new[:, 0]
        mask = (torch.arange(self_k.shape[1], device=x_t.device) <= t)[None, None, None, :]
        x = x_t + self.self_attn.attend(q, self_k, self_v, mask)
        x = x + self.enc_attn.attend(self.enc_attn.project_q(self.norm2(x)), cross_k, cross_v)
        return x + self.mlp(self.norm3(x))


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, descending,
    ties to the lowest index (`jax.lax.top_k`'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def beam_select(scores, logp, b: int, num_classes: int, eos: int):
    """One reference beam step (models/decoder.py:288-307): expand every
    beam over every class, take each sample's top k, kill the beams that
    emitted EOS.  scores [b*k], logp [b*k, C] fp32.  Returns (the stored
    top scores [b, k], flat predecessors [b*k], symbols [b*k], new scores
    [b*k])."""
    k = scores.shape[0] // b
    cand = (scores[:, None] + logp).reshape(b, k * num_classes)
    top_scores, top_idx = _top_k(cand, k)
    sym = (top_idx % num_classes).reshape(-1)
    rows = torch.arange(b, device=scores.device)[:, None] * k
    pred = (top_idx // num_classes + rows).reshape(-1)
    new_scores = torch.where(sym == eos, torch.full_like(top_scores.reshape(-1), -torch.inf),
                             top_scores.reshape(-1))
    return top_scores, pred, sym, new_scores


def beam_backtrack(st_scores, st_preds, st_syms, b: int, k: int, eos: int) -> np.ndarray:
    """The reference's backtracking (models/decoder.py:313-370), in numpy:
    walking time backwards, each step's EOS emissions replace the
    lowest-ranked final beams of their sample in a ring, in decreasing beam
    order; returns the best hypothesis's ids [b, T].  The writes run in the
    order of the JAX package's scan (`dig_tpu/models/decoder.py:211-254`),
    which decides the ring.

    st_scores [T, b, k]: the post-top-k, pre-kill scores; st_preds /
    st_syms [T, b*k]: flat predecessors and symbols (numpy arrays)."""
    t_max = st_scores.shape[0]
    pos = np.arange(b) * k
    rows = np.arange(b)
    last = st_scores[-1]
    sorted_idx = np.argsort(-last, axis=1, kind="stable")[:, :k]
    s = np.take_along_axis(last, sorted_idx, axis=1).copy()
    t_pred = (sorted_idx + pos[:, None]).reshape(-1)
    count = np.zeros((b,), np.int64)
    syms_back = []
    for t in range(t_max - 1, -1, -1):
        scores_t, preds_t, syms_t = st_scores[t], st_preds[t], st_syms[t]
        cur = syms_t[t_pred].copy()
        new_pred = preds_t[t_pred].copy()
        for j in range(k - 1, -1, -1):
            flat = pos + j
            is_eos = syms_t[flat] == eos
            res_k = k - 1 - (count % k)
            res_flat = pos + res_k
            new_pred[res_flat] = np.where(is_eos, preds_t[flat], new_pred[res_flat])
            cur[res_flat] = np.where(is_eos, eos, cur[res_flat])
            s[rows, res_k] = np.where(is_eos, scores_t[rows, j], s[rows, res_k])
            count += is_eos
        t_pred = new_pred
        syms_back.append(cur)
    syms = np.stack(syms_back[::-1])  # [T, b*k]
    best_flat = pos + np.argmax(s, axis=1)  # ties -> the lowest index, like top_k
    return syms[:, best_flat].T


def beam_start(n: int, k: int, device):
    """The scores of n = b * k rows at step 0: only beam 0 of each sample is live."""
    live = torch.arange(n, device=device) % k == 0
    return torch.where(live, 0.0, -torch.inf).to(torch.float32)


def beam_finish(stored, b: int, k: int, eos: int, device):
    """`beam_backtrack` on the host after one copy of the stored steps
    [(top scores, predecessors, symbols)] (in one float64 tensor: exact for
    all three); returns ids [b, T] on `device`."""
    t, n = len(stored), b * k
    scores, preds, syms = (torch.stack(x) for x in zip(*stored))
    host = torch.cat([scores.reshape(t, n).double(), preds.double(), syms.double()],
                     dim=1).cpu().numpy()
    ids = beam_backtrack(host[:, :n].astype(np.float32).reshape(t, b, k),
                         host[:, n:2 * n].astype(np.int64), host[:, 2 * n:].astype(np.int64),
                         b, k, eos)
    ids = torch.from_numpy(ids)
    if torch.device(device).type == "cuda":
        ids = ids.pin_memory()
    return ids.to(device, non_blocking=True)


class TFDecoder(nn.Module):
    def __init__(self, num_classes: int = 97, n_layers: int = 6, d_embedding: int = 512,
                 n_head: int = 8, d_k: int = 64, d_v: int = 64, d_model: int = 512,
                 d_inner: int = 256, n_position: int = 200, max_seq_len: int = 25,
                 dropout: float = 0.1, text_cond_vis: bool = False, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = dropout
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.d_embedding = d_embedding
        self.max_seq_len = max_seq_len
        self.text_cond_vis = text_cond_vis
        self.compute_dtype = dtype
        self.trg_word_emb = nn.Embedding(num_classes + 1, d_embedding)
        self.register_buffer("position_table",
                             torch.from_numpy(sinusoid_position_table(n_position, d_embedding)),
                             persistent=False)
        self.layer_stack = nn.ModuleList(
            self._make_layer(d_model, d_inner, n_head, d_k, d_v, dropout, text_cond_vis, dtype)
            for _ in range(n_layers))
        self.layer_norm = LayerNorm(d_model, 1e-6, dtype)
        self.classifier = Dense(d_model, num_classes, dtype=dtype)

    _make_layer = TransformerDecoderLayer

    @property
    def start_idx(self) -> int:
        return self.num_classes  # BOS id, one past the vocabulary

    def _embed(self, trg_seq):
        emb = embedding(self.trg_word_emb.weight, trg_seq).to(self.compute_dtype)
        return emb + self.position_table[:, : trg_seq.shape[1]].to(emb.dtype)

    def _teacher_query(self, targets, tgt_lens, generator):
        """[BOS] + targets shifted right, embedded (with dropout), and the
        pad-and-causal mask [B, 1, T, T]."""
        b, t = targets.shape
        bos = torch.full((b, 1), self.start_idx, dtype=targets.dtype, device=targets.device)
        query = torch.cat([bos, targets], dim=-1)[:, :-1]
        mask = (make_pad_mask(tgt_lens, t) & make_causal_mask(t, targets.device))[:, None]
        return dropout(self._embed(query), self.dropout, generator), mask

    def _run_layers(self, x, enc_output, self_attn_mask, generator=None):
        for layer in self.layer_stack:
            x = layer(x, enc_output, self_attn_mask, generator)
        return self.layer_norm(x)

    def forward(self, enc_output, targets, tgt_lens, deterministic: bool = False,
                generator=None):
        """Teacher-forced pass: queries are [BOS] + targets shifted right;
        returns [B, T, num_classes] logits.  A training pass
        (`deterministic=False`) draws its dropout masks from `generator`."""
        generator = training_generator(deterministic, generator)
        x, mask = self._teacher_query(targets, tgt_lens, generator)
        return self.classifier(self._run_layers(x, enc_output, mask, generator))

    def prepare_cross(self, enc_output):
        return [layer.prepare_cross_kv(enc_output) for layer in self.layer_stack]

    def decode_step(self, tokens_t, t: int, self_caches, cross_kvs):
        """One greedy step.  tokens_t [B] ids -> logits [B, num_classes];
        the caches are updated in place."""
        x = embedding(self.trg_word_emb.weight, tokens_t[:, None]).to(self.compute_dtype)
        x = x + self.position_table[:, t:t + 1].to(x.dtype)
        for layer, (sk, sv), (ck, cv) in zip(self.layer_stack, self_caches, cross_kvs):
            x = layer.decode_step(x, t, sk, sv, ck, cv)
        return self.classifier(self.layer_norm(x)[:, 0])

    def greedy_decode(self, enc_output):
        """[B, N, C] encoder map -> per-step softmax [B, T, num_classes]
        (fp32) and greedy ids [B, T], taken as the argmax of the fp32
        probabilities.  Under `text_cond_vis` nothing can be cached: the
        dense loop at full length."""
        if self.text_cond_vis:
            return self.greedy_decode_dense(enc_output)
        b = enc_output.shape[0]
        t_max = self.max_seq_len
        cross_kvs = self.prepare_cross(enc_output)
        caches = [
            (enc_output.new_zeros((b, t_max, self.n_head, self.d_k)),
             enc_output.new_zeros((b, t_max, self.n_head, self.d_v)))
            for _ in self.layer_stack
        ]
        tokens = torch.full((b,), self.start_idx, dtype=torch.long, device=enc_output.device)
        probs, ids = [], []
        for t in range(t_max):
            logits = self.decode_step(tokens, t, caches, cross_kvs)
            p = torch.softmax(logits.float(), dim=-1)
            tokens = torch.argmax(p, dim=-1)
            probs.append(p)
            ids.append(tokens)
        return torch.stack(probs, dim=1), torch.stack(ids, dim=1)

    def _run_layers_cached_cross(self, tgt, cross_kvs, self_attn_mask):
        """The deterministic full-width decoder pass with precomputed cross K/V."""
        x = tgt
        for layer, (ck, cv) in zip(self.layer_stack, cross_kvs):
            sa_in = layer.norm1(x)
            x = x + layer.self_attn(sa_in, sa_in, sa_in, self_attn_mask)
            x = x + layer.enc_attn.attend(layer.enc_attn.project_q(layer.norm2(x)), ck, cv)
            x = x + layer.mlp(layer.norm3(x))
        return self.layer_norm(x)

    def _prefix_runner(self, enc_output, causal):
        """embedded prefix [N, T, C] -> the deterministic decoder output: the
        full layers under `text_cond_vis`, else with the cross K/V computed
        once here."""
        if self.text_cond_vis:
            return lambda tgt: self._run_layers(tgt, enc_output, causal)
        cross_kvs = self.prepare_cross(enc_output)
        return lambda tgt: self._run_layers_cached_cross(tgt, cross_kvs, causal)

    def _dense_greedy_loop(self, run, b: int, device, eos: Optional[int]):
        """The dense greedy loop: at step t, `run` over the embedded prefix
        tokens[:, :-1], the classifier at position t, the argmax of the fp32
        softmax written to position t + 1.  With `eos` the loop ends once
        every row has emitted EOS (a read of one flag a step from the
        device); probabilities and ids past that step stay 0."""
        t_max = self.max_seq_len
        tokens = torch.zeros((b, t_max + 1), dtype=torch.long, device=device)
        tokens[:, 0] = self.start_idx
        probs = torch.zeros((b, t_max, self.num_classes), dtype=torch.float32, device=device)
        has_eos = torch.zeros((b,), dtype=torch.bool, device=device)
        for t in range(t_max):
            logits = self.classifier(run(self._embed(tokens[:, :-1]))[:, t])
            p = torch.softmax(logits.float(), dim=-1)
            nxt = torch.argmax(p, dim=-1)
            tokens[:, t + 1] = nxt
            probs[:, t] = p
            if eos is not None:
                has_eos |= nxt == eos
                if bool(has_eos.all()):
                    break
        return probs, tokens[:, 1:]

    def greedy_decode_dense(self, enc_output, eos: Optional[int] = None):
        """Greedy decode that runs the decoder over the whole prefix at
        every step (the reference's inference structure), with the cross
        K/V computed once.  Returns (per-step softmax [B, T, num_classes]
        fp32, ids [B, T]), the ids those of `greedy_decode`.

        With `eos`, the loop ends once every row has emitted EOS, so only
        positions up to each row's first EOS may be read (word accuracy,
        confidence).  Without it, `max_seq_len` steps (what a loss over the
        whole target needs)."""
        dev = enc_output.device
        run = self._prefix_runner(enc_output, make_causal_mask(self.max_seq_len, dev)[:, None])
        return self._dense_greedy_loop(run, enc_output.shape[0], dev, eos)

    def beam_search(self, enc_output, beam_width: int, eos: int = 94):
        """KV-cached beam search with the reference's semantics (module
        docstring).  enc_output [B, N, C] -> ids [B, T].  Under
        `text_cond_vis`, `beam_search_dense`."""
        if self.text_cond_vis:
            return self.beam_search_dense(enc_output, beam_width, eos)
        b = enc_output.shape[0]
        k = beam_width
        t_max = self.max_seq_len
        enc = enc_output.repeat_interleave(k, dim=0)  # beams contiguous per sample
        cross_kvs = self.prepare_cross(enc)
        caches = [(enc.new_zeros((b * k, t_max, self.n_head, self.d_k)),
                   enc.new_zeros((b * k, t_max, self.n_head, self.d_v)))
                  for _ in self.layer_stack]
        scores = beam_start(b * k, k, enc.device)
        tokens = torch.full((b * k,), self.start_idx, dtype=torch.long, device=enc.device)
        stored = []
        for t in range(t_max):
            logits = self.decode_step(tokens, t, caches, cross_kvs)
            logp = torch.log_softmax(logits.float(), dim=-1)
            top_scores, pred, tokens, scores = beam_select(scores, logp, b, self.num_classes, eos)
            stored.append((top_scores, pred, tokens))
        return beam_finish(stored, b, k, eos, enc.device)

    def _dense_beam_loop(self, run, b: int, k: int, device, eos: int):
        """The full-prefix beam loop: the reference's selection (kill on
        EOS, no reorder of the token rows) and backtracking; `run` maps the
        embedded prefixes [b * k, T, C] to the decoder output."""
        t_max = self.max_seq_len
        scores = beam_start(b * k, k, device)
        tokens = torch.zeros((b * k, t_max + 1), dtype=torch.long, device=device)
        tokens[:, 0] = self.start_idx
        stored = []
        for t in range(t_max):
            logits = self.classifier(run(self._embed(tokens[:, :-1]))[:, t])
            logp = torch.log_softmax(logits.float(), dim=-1)
            top_scores, pred, sym, scores = beam_select(scores, logp, b, self.num_classes, eos)
            tokens[:, t + 1] = sym
            stored.append((top_scores, pred, sym))
        return beam_finish(stored, b, k, eos, device)

    def beam_search_dense(self, enc_output, beam_width: int, eos: int = 94):
        """Beam search over the whole prefix at every step; the ids of
        `beam_search`."""
        enc = enc_output.repeat_interleave(beam_width, dim=0)
        dev = enc.device
        run = self._prefix_runner(enc, make_causal_mask(self.max_seq_len, dev)[:, None])
        return self._dense_beam_loop(run, enc_output.shape[0], beam_width, dev, eos)


class Order2Cls(nn.Sequential):
    """The decoupled layer's `mlp_order2cls_attn` (reference
    models/transformer_layer.py:157-163): Dense, GELU, dropout, Dense to
    `num_classes`, dropout; the Dense layers at the reference's Sequential
    indices 0 and 3."""

    def __init__(self, d_model: int, d_inner: int, num_classes: int, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__(Dense(d_model, d_inner, dtype=dtype), nn.Identity(), nn.Identity(),
                         Dense(d_inner, num_classes, dtype=dtype), nn.Identity())
        self.dropout = dropout

    def forward(self, x, generator=None):
        x = dropout(gelu(self[0](x)), self.dropout, generator)
        return dropout(self[3](x), self.dropout, generator)


class DecoupledDecoderLayer(TransformerDecoderLayer):
    """A decoder layer with the decoupled extras the reference keeps on
    the layer (models/transformer_layer.py:121-201): `mlp_order2cls_attn`
    and `new_linear_v`."""

    def __init__(self, d_model: int = 512, d_inner: int = 256, n_head: int = 8,
                 d_k: int = 64, d_v: int = 64, dropout: float = 0.1,
                 text_cond_vis: bool = False, dtype=torch.float32, num_classes: int = 97):
        super().__init__(d_model, d_inner, n_head, d_k, d_v, dropout, False, dtype)
        self.mlp_order2cls_attn = Order2Cls(d_model, d_inner, num_classes, dropout, dtype)
        self.new_linear_v = Dense(d_model, n_head * d_v, bias=False, dtype=dtype)


class DecoupledTFDecoder(TFDecoder):
    """The position-query decoder (reference models/decoder.py:373-436 +
    models/transformer_layer.py:121-201; `dig_tpu/models/decoder.py:648-783`).
    The vision branch reads only the order embedding, the encoder map and
    the class-query maps, never the tokens, so it is computed once per
    image and every decode step reuses it."""

    def __init__(self, num_classes: int = 97, max_seq_len: int = 25, dropout: float = 0.1,
                 dtype=torch.float32, **kw):
        self._num_classes = num_classes
        super().__init__(num_classes=num_classes, max_seq_len=max_seq_len, dropout=dropout,
                         dtype=dtype, **kw)
        self.order_enc = nn.Embedding(max_seq_len + 1, self.d_embedding)

    def _make_layer(self, *args):
        return DecoupledDecoderLayer(*args, num_classes=self._num_classes)

    def _vision_branch(self, enc_output, cls_query_attn_maps, t_len: int, generator=None):
        """Each layer's token-independent output [B, T, C]; every layer reads
        the same order embedding."""
        b = enc_output.shape[0]
        orders = torch.arange(t_len, device=enc_output.device)[None].expand(b, -1)
        order_embed = embedding(self.order_enc.weight, orders).to(self.compute_dtype)
        order_embed = dropout(order_embed, self.dropout, generator)
        cls_maps = cls_query_attn_maps.reshape(b, cls_query_attn_maps.shape[1], -1)
        outs = []
        for layer in self.layer_stack:
            attn = layer.enc_attn
            qp = attn.project_q(layer.norm2(order_embed))
            kp, vp = attn.project_kv(enc_output, enc_output)
            order_attn_out = attn.attend(qp, kp, vp, None, generator) + order_embed
            order2cls = torch.softmax(
                layer.mlp_order2cls_attn(order_attn_out, generator).float(), dim=-1
            ).to(enc_output.dtype)
            # the order query's attention map, mean over the heads
            logits = torch.einsum("bqhd,bkhd->bhqk", qp * attn.d_k**-0.5, kp).float()
            attn_maps = torch.softmax(logits, dim=-1).mean(dim=1).to(enc_output.dtype)
            order_attn = torch.einsum("btc,bck->btk", order2cls, cls_maps) + attn_maps
            outs.append(torch.einsum("btk,bkc->btc", order_attn,
                                     layer.new_linear_v(enc_output)))
        return outs

    def _decoupled_run(self, x, vision_outs, self_attn_mask, generator=None):
        """The token branch (self-attention) plus the precomputed vision outputs."""
        for layer, v_out in zip(self.layer_stack, vision_outs):
            sa_in = layer.norm1(x)
            x = x + layer.self_attn(sa_in, sa_in, sa_in, self_attn_mask, generator)
            x = x + v_out
            x = x + layer.mlp(layer.norm3(x), generator)
        return self.layer_norm(x)

    def decoupled_forward(self, enc_output, targets, tgt_lens, cls_query_attn_maps,
                          deterministic: bool = False, generator=None):
        """Teacher-forced pass -> [B, T, num_classes] logits."""
        generator = training_generator(deterministic, generator)
        x, mask = self._teacher_query(targets, tgt_lens, generator)
        vision_outs = self._vision_branch(enc_output, cls_query_attn_maps, targets.shape[1],
                                          generator)
        return self.classifier(self._decoupled_run(x, vision_outs, mask, generator))

    def _vision_runner(self, enc_output, cls_query_attn_maps):
        dev = enc_output.device
        causal = make_causal_mask(self.max_seq_len, dev)[:, None]
        vision_outs = self._vision_branch(enc_output, cls_query_attn_maps, self.max_seq_len)
        return lambda tgt: self._decoupled_run(tgt, vision_outs, causal)

    def decoupled_greedy_decode(self, enc_output, cls_query_attn_maps,
                                eos: Optional[int] = None):
        """Dense greedy decode through the decoupled graph; (per-step
        softmax [B, T, num_classes], ids [B, T]); `eos` as in
        `greedy_decode_dense`."""
        run = self._vision_runner(enc_output, cls_query_attn_maps)
        return self._dense_greedy_loop(run, enc_output.shape[0], enc_output.device, eos)

    def decoupled_beam_search(self, enc_output, cls_query_attn_maps, beam_width: int,
                              eos: int = 94):
        """Beam search through the decoupled graph, with the transformer
        decoder's selection and backtracking.  Returns ids [B, T]."""
        k = beam_width
        run = self._vision_runner(enc_output.repeat_interleave(k, dim=0),
                                  cls_query_attn_maps.repeat_interleave(k, dim=0))
        return self._dense_beam_loop(run, enc_output.shape[0], k, enc_output.device, eos)


def create_decoder(decoder_name: str, num_classes: int, max_len: int, dtype=torch.float32,
                   text_cond_vis: bool = False) -> TFDecoder:
    """Decoder factory by name (reference: models/decoder.py:13-73), at
    the decoders' dropout of 0.1, as the JAX package builds them.
    `text_cond_vis` swaps every layer's cross-attention for the
    FiLM-conditioned one; the decoupled decoder ignores it, as the
    reference's decoupled layer stack does (models/decoder.py:409-412)."""
    common = dict(num_classes=num_classes, max_seq_len=max_len, dtype=dtype)
    if decoder_name == "decoupled_tf_decoder":
        return DecoupledTFDecoder(**common)
    common["text_cond_vis"] = text_cond_vis
    if decoder_name == "tf_decoder":
        return TFDecoder(**common)
    if decoder_name == "small_tf_decoder":
        return TFDecoder(n_layers=2, d_embedding=384, n_head=6, d_k=64, d_v=64,
                         d_model=384, d_inner=192, **common)
    if decoder_name in ("corres_tiny_tf_decoder", "corres_small_tf_decoder",
                        "corres_base_tf_decoder"):
        dim = {"corres_tiny_tf_decoder": 192, "corres_small_tf_decoder": 384,
               "corres_base_tf_decoder": 512}[decoder_name]
        return TFDecoder(n_layers=6, d_embedding=dim, n_head=8, d_model=dim,
                         d_inner=dim * 4, d_k=dim // 8, d_v=dim // 8, **common)
    raise KeyError(f"unknown decoder '{decoder_name}'")
