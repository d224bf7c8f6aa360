"""Autoregressive transformer text decoder (PyTorch), counterpart of
`dig_tpu/models/decoder.py` (reference: models/decoder.py:107-252,
models/transformer_layer.py:47-118, :204-281, :386-403).

`TFDecoder` embeds ``num_classes + 1`` symbols (BOS is the last id), adds
the sinusoid table, and runs pre-LN layers of self-attention,
cross-attention and FFN.  Inference is the KV-cached greedy loop that the
JAX package runs off the TPU (`greedy_decode`): always `max_seq_len`
steps.  Dense greedy decoding, the EOS early exit, beam search, the
decoupled and the text-conditional decoders wait for a later slice.

None of this reaches a kernel: the self-attention is masked and the
cross-attention has Lq <= 25 < 128, so both take `_ref_attention`, as on
the TPU, or under dropout the unfused `attention_with_dropout`.  Dropout
(default 0.1, `dig_tpu/models/decoder.py:270`) acts in the teacher-forced
pass of training: after embedding + position, on the attention weights
and after each attention's output projection, and twice in the FFN.  Its
masks come from the `torch.Generator` that pass is given.
"""

from __future__ import annotations

import torch
from torch import nn

from dig_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    attention_with_dropout,
    dropout,
    make_causal_mask,
    make_pad_mask,
    sinusoid_position_table,
    training_generator,
)
from dig_tpu_torch.ops.activations import gelu
from dig_tpu_torch.ops.attention import multi_head_attention


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

    def project_q(self, q_inp):
        b, lq, _ = q_inp.shape
        return self.linear_q(q_inp).reshape(b, lq, self.n_head, self.d_k)

    def project_kv(self, k_inp, v_inp):
        b, lk, _ = k_inp.shape
        k = self.linear_k(k_inp).reshape(b, lk, self.n_head, self.d_k)
        v = self.linear_v(v_inp).reshape(b, lk, self.n_head, self.d_v)
        return k, v

    def attend(self, q, k, v, mask=None, generator=None):
        """q [B, Lq, H, Dk]; k/v [B, Lk, H, D*]; mask broadcastable to
        [B, H, Lq, Lk] (True = attend)."""
        b, lq = q.shape[:2]
        scale = self.d_k**-0.5
        if self.dropout > 0.0 and generator is not None:
            out = attention_with_dropout(q, k, v, mask, scale, self.dropout, generator)
        else:
            out = multi_head_attention(q, k, v, mask=mask, scale=scale)
        out = self.fc(out.reshape(b, lq, self.n_head * self.d_v))
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

    def forward(self, x, generator=None):
        x = dropout(gelu(self.w_1(x)), self.dropout, generator)
        return dropout(self.w_2(x), self.dropout, generator)


class TransformerDecoderLayer(nn.Module):
    """Pre-LN: self-attn -> cross-attn -> FFN, each with a residual."""

    def __init__(self, d_model: int = 512, d_inner: int = 256, n_head: int = 8,
                 d_k: int = 64, d_v: int = 64, dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        # flax nn.LayerNorm defaults: eps 1e-6
        self.norm1 = LayerNorm(d_model, 1e-6, dtype)
        self.norm2 = LayerNorm(d_model, 1e-6, dtype)
        self.norm3 = LayerNorm(d_model, 1e-6, dtype)
        self.self_attn = DecoderMHA(n_head, d_k, d_v, d_model, dropout, dtype)
        self.enc_attn = DecoderMHA(n_head, d_k, d_v, d_model, dropout, dtype)
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


class TFDecoder(nn.Module):
    def __init__(self, num_classes: int = 97, n_layers: int = 6, d_embedding: int = 512,
                 n_head: int = 8, d_k: int = 64, d_v: int = 64, d_model: int = 512,
                 d_inner: int = 256, n_position: int = 200, max_seq_len: int = 25,
                 dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = dropout
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.d_embedding = d_embedding
        self.max_seq_len = max_seq_len
        self.compute_dtype = dtype
        self.trg_word_emb = nn.Embedding(num_classes + 1, d_embedding)
        self.register_buffer("position_table",
                             torch.from_numpy(sinusoid_position_table(n_position, d_embedding)),
                             persistent=False)
        self.layer_stack = nn.ModuleList(
            TransformerDecoderLayer(d_model, d_inner, n_head, d_k, d_v, dropout, dtype)
            for _ in range(n_layers))
        self.layer_norm = LayerNorm(d_model, 1e-6, dtype)
        self.classifier = Dense(d_model, num_classes, dtype=dtype)

    @property
    def start_idx(self) -> int:
        return self.num_classes  # BOS id, one past the vocabulary

    def _embed(self, trg_seq):
        emb = self.trg_word_emb(trg_seq).to(self.compute_dtype)
        return emb + self.position_table[:, : trg_seq.shape[1]].to(emb.dtype)

    def forward(self, enc_output, targets, tgt_lens, deterministic: bool = False,
                generator=None):
        """Teacher-forced pass: queries are [BOS] + targets shifted right;
        returns [B, T, num_classes] logits.  A training pass
        (`deterministic=False`) draws its dropout masks from `generator`."""
        generator = training_generator(deterministic, generator)
        b, t = targets.shape
        bos = torch.full((b, 1), self.start_idx, dtype=targets.dtype, device=targets.device)
        query = torch.cat([bos, targets], dim=-1)[:, :-1]
        mask = (make_pad_mask(tgt_lens, t) & make_causal_mask(t, targets.device))[:, None]
        x = dropout(self._embed(query), self.dropout, generator)
        for layer in self.layer_stack:
            x = layer(x, enc_output, mask, generator)
        return self.classifier(self.layer_norm(x))

    def prepare_cross(self, enc_output):
        return [layer.prepare_cross_kv(enc_output) for layer in self.layer_stack]

    def decode_step(self, tokens_t, t: int, self_caches, cross_kvs):
        """One greedy step.  tokens_t [B] ids -> logits [B, num_classes];
        the caches are updated in place."""
        x = self.trg_word_emb(tokens_t[:, None]).to(self.compute_dtype)
        x = x + self.position_table[:, t:t + 1].to(x.dtype)
        for layer, (sk, sv), (ck, cv) in zip(self.layer_stack, self_caches, cross_kvs):
            x = layer.decode_step(x, t, sk, sv, ck, cv)
        return self.classifier(self.layer_norm(x)[:, 0])

    def greedy_decode(self, enc_output):
        """[B, N, C] encoder map -> per-step softmax [B, T, num_classes]
        (fp32) and greedy ids [B, T], taken as the argmax of the fp32
        probabilities."""
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


def create_decoder(decoder_name: str, num_classes: int, max_len: int,
                   dtype=torch.float32) -> TFDecoder:
    """Decoder factory by name (reference: models/decoder.py:13-73), at
    the decoders' dropout of 0.1, as the JAX package builds them."""
    common = dict(num_classes=num_classes, max_seq_len=max_len, dtype=dtype)
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
    if decoder_name == "decoupled_tf_decoder":
        raise NotImplementedError("decoupled_tf_decoder is not ported yet")
    raise KeyError(f"unknown decoder '{decoder_name}'")
