"""The GRU additive-attention recognition head (ASTER-style), counterpart
of `dig_tpu/models/attn_decoder.py` (reference: models/attn_decoder.py:11-279).

At each step the GRU state attends over the encoder tokens (additive
attention: w . tanh(s_embed(state) + x_embed(x))), the context is
concatenated with the previous symbol's embedding and fed to a one-layer
GRU, and a linear head emits the class logits.  BOS is ``num_classes``,
one past the vocabulary.  `x_embed(x)` does not depend on the step and is
computed once, outside the step loop, as the JAX package hoists it.

The module tree is the reference's (`decoder.attention_unit.{sEmbed,
xEmbed,wEmbed}`, `decoder.tgt_embedding`, `decoder.gru.{weight,bias}_
{ih,hh}_l0` in the gates' order r, z, n, `decoder.fc`), so a reference
`.pth` loads as it is.  The GRU is written out (`GRU`): torch's `nn.GRU`
would run cuDNN's cell in its own precision.  Flax's `GRUCell` keeps one
bias for each of the r and z gates where torch keeps two; they enter as a
sum, so the two forms are the same function (`utils/convert.py` splits
them).  So that training moves that sum as the JAX package moves its one
bias, the r and z parts of ``bias_hh_l0`` take no gradient: they stay
where they were loaded (0 from a JAX tree) and ``bias_ih_l0`` learns.

Nothing here reaches a kernel: the attention is a softmax over 256
scores a row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dig_tpu_torch.models.decoder import beam_select, beam_start, beam_finish
from dig_tpu_torch.models.layers import Dense, embedding


class GRU(nn.Module):
    """One GRU layer's parameters in torch's layout and the cell: r and z
    the sigmoids of (x W_i + b_i + h W_h + b_h), n = tanh(x W_in + b_in +
    r * (h W_hn + b_hn)), h' = (1 - z) n + z h, in the compute dtype."""

    def __init__(self, input_size: int, hidden_size: int, dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.zeros(3 * hidden_size, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.zeros(3 * hidden_size, hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(3 * hidden_size))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(3 * hidden_size))
        self.bias_hh_l0.register_hook(self._n_gate_only)
        self.compute_dtype = dtype

    def _n_gate_only(self, grad):
        """The hidden bias's gradient with its r and z parts zeroed."""
        return torch.cat([torch.zeros_like(grad[: 2 * self.hidden_size]),
                          grad[2 * self.hidden_size:]])

    def forward(self, h, x):
        dt = self.compute_dtype
        gi = F.linear(x.to(dt), self.weight_ih_l0.to(dt), self.bias_ih_l0.to(dt))
        gh = F.linear(h.to(dt), self.weight_hh_l0.to(dt), self.bias_hh_l0.to(dt))
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h.to(dt)


class AttentionUnit(nn.Module):
    def __init__(self, s_dim: int, x_dim: int, att_dim: int, dtype=torch.float32):
        super().__init__()
        self.sEmbed = Dense(s_dim, att_dim, dtype=dtype)
        self.xEmbed = Dense(x_dim, att_dim, dtype=dtype)
        self.wEmbed = Dense(att_dim, 1, dtype=dtype)

    def forward(self, x, x_proj, state):
        """x [B, N, C], x_proj = xEmbed(x), state [B, s_dim] -> context [B, C]."""
        score = self.wEmbed(torch.tanh(self.sEmbed(state)[:, None, :] + x_proj))[..., 0]
        alpha = torch.softmax(score.float(), dim=-1).to(x.dtype)
        return torch.einsum("bt,btc->bc", alpha, x)


class DecoderUnit(nn.Module):
    def __init__(self, num_classes: int, x_dim: int, s_dim: int, att_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.attention_unit = AttentionUnit(s_dim, x_dim, att_dim, dtype)
        self.tgt_embedding = nn.Embedding(num_classes + 1, att_dim)
        self.gru = GRU(att_dim + x_dim, s_dim, dtype)
        self.fc = Dense(s_dim, num_classes, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x, x_proj, state, y_prev):
        """One step: (new state [B, s_dim], logits [B, num_classes])."""
        context = self.attention_unit(x, x_proj, state)
        y_emb = embedding(self.tgt_embedding.weight, y_prev).to(self.compute_dtype)
        state = self.gru(state, torch.cat([y_emb, context.to(y_emb.dtype)], dim=-1))
        return state, self.fc(state)


class AttentionRecognitionHead(nn.Module):
    def __init__(self, num_classes: int, in_planes: int, s_dim: int = 512, att_dim: int = 512,
                 max_len_labels: int = 25, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.s_dim = s_dim
        self.max_len_labels = max_len_labels
        self.decoder = DecoderUnit(num_classes, in_planes, s_dim, att_dim, dtype)
        self.compute_dtype = dtype

    def _start(self, x):
        b = x.shape[0]
        state = torch.zeros((b, self.s_dim), dtype=self.compute_dtype, device=x.device)
        bos = torch.full((b,), self.num_classes, dtype=torch.long, device=x.device)
        return self.decoder.attention_unit.xEmbed(x), state, bos

    def forward(self, x, targets):
        """Teacher-forced: x [B, N, C], targets [B, T] -> [B, max_len, num_classes]
        logits; step t > 0 is fed targets[:, t - 1]."""
        x_proj, state, y_prev = self._start(x)
        logits = []
        for t in range(self.max_len_labels):
            if t > 0:
                y_prev = targets[:, t - 1]
            state, step_logits = self.decoder(x, x_proj, state, y_prev)
            logits.append(step_logits)
        return torch.stack(logits, dim=1)

    def sample(self, x):
        """Greedy: (per-step softmax [B, T, C] fp32, ids [B, T])."""
        x_proj, state, y_prev = self._start(x)
        probs, ids = [], []
        for _ in range(self.max_len_labels):
            state, logits = self.decoder(x, x_proj, state, y_prev)
            p = torch.softmax(logits.float(), dim=-1)
            y_prev = torch.argmax(p, dim=-1)
            probs.append(p)
            ids.append(y_prev)
        return torch.stack(probs, dim=1), torch.stack(ids, dim=1)

    def beam_search(self, x, beam_width: int, eos: int):
        """The reference TopKDecoder's beam (models/attn_decoder.py:84-200):
        the beams fold into the batch, a beam that emits EOS is killed and
        recovered by backtracking (`decoder.beam_select` / `beam_backtrack`,
        shared with the transformer decoder).  Unlike that decoder's beam,
        the GRU state follows the winning predecessor at every step
        (``state.index_select(1, predecessors)``, :129).  Returns ids [B, T]."""
        b, k = x.shape[0], beam_width
        xk = x.repeat_interleave(k, dim=0)
        x_proj, state, tokens = self._start(xk)
        scores = beam_start(b * k, k, x.device)
        stored = []
        for _ in range(self.max_len_labels):
            state, logits = self.decoder(xk, x_proj, state, tokens)
            logp = torch.log_softmax(logits.float(), dim=-1)
            top_scores, pred, tokens, scores = beam_select(scores, logp, b, self.num_classes, eos)
            state = state[pred]
            stored.append((top_scores, pred, tokens))
        return beam_finish(stored, b, k, eos, x.device)
