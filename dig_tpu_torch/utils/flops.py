"""The matrix-product FLOPs of one training step, written out from the
model's configuration.

`bench.py` asks XLA for the FLOPs of its compiled step (`program_flops`),
a count that includes elementwise work and that only XLA can give.  On the
card, `torch.utils.flop_counter.FlopCounterMode` does not see the port's
hand-written kernels either: they are ctypes calls inside autograd
Functions, not aten ops.  So the count is written out here, and it is the
same whatever runs a product: one of the port's kernels, cuBLAS or SDPA.

The convention:

* 2·m·k·n for every matrix product the step performs: each `Dense`
  (`F.linear`), the patch embedding (a GEMM of the flattened patches), the
  attention products q·kᵀ and w·v (the encoder's self-attention, the
  window extractor's `CrossBlock`, the decoder's self- and cross-attention),
  the window pooling's product, the MoCo heads' MLPs, InfoNCE's q·kᵀ and
  the decoder's one-hot embedding gradient (`models/layers.py::embedding`);
* the forward counts once; the backward once for each operand that
  autograd differentiates: the input gradient and the weight gradient.
  The patch embedding's input (the images) and the momentum branch's
  keys take none, and the momentum branch runs forward only;
* an attention's backward is 4 products (the gradients of q, k, the
  weights and v), whichever path runs it.  The fused pair
  (`ops/attention.py`, no attention weights kept) computes the logits a
  second time in its backward, as SDPA's does; that product is the
  implementation's, not the model's, and is not counted: the count is of
  model FLOPs, and stays the same if a later path fuses what is unfused
  today;
* frozen encoder layers (`--fixed_encoder_layers`, lr scale 0) still have
  their gradients computed (they count in the global norm, as in
  `dig_tpu`), so they do not change the count;
* not counted: elementwise work, softmax, LayerNorm, BatchNorm, GELU,
  dropout, the losses' reductions and the optimizer.

`tests/test_torch_port_flops.py` holds both counts equal to
`FlopCounterMode` over the port's plain step on the CPU, where every
product is an aten op and every attention takes the weight-keeping path
(`_ref_attention`), and holds the fused pair's excess to its recomputed
logits alone.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PretrainShape:
    """What sets the pre-training step's count; the defaults are
    `bench.py`'s model, pretrain_simmim_moco_ori_vit_small_patch4_32x128
    with 4 windows (MoCo MLP 4096, dim 256)."""

    depth: int = 12
    width: int = 384
    heads: int = 6
    mlp_ratio: float = 4.0
    moco_mlp_dim: int = 4096
    moco_dim: int = 256
    num_windows: int = 4
    patchnet_depth: int = 2
    pix_projector_dim: int = 512
    pix_decoder_dim: int = 192
    patch: int = 4
    grid: Tuple[int, int] = (8, 32)


@dataclasses.dataclass(frozen=True)
class FinetuneShape:
    """What sets the fine-tuning step's count (a `RecModel` with a
    `TFDecoder`); the defaults are `bench.py`'s recognizer,
    vit_small_patch4_32x128 + tf_decoder."""

    depth: int = 12
    width: int = 384
    heads: int = 6
    mlp_ratio: float = 4.0
    dec_layers: int = 6
    d_embedding: int = 512
    d_model: int = 512
    dec_heads: int = 8
    d_k: int = 64
    d_v: int = 64
    d_inner: int = 256
    num_classes: int = 97
    max_len: int = 25
    patch: int = 4
    grid: Tuple[int, int] = (8, 32)


def pretrain_shape(model) -> PretrainShape:
    """The shape of a built `DiGPretrainModel` (the regular window
    extractor, both targets)."""
    blk = model.encoder.blocks[0]
    proj = model.encoder_projection_layer
    return PretrainShape(
        depth=len(model.encoder.blocks), width=model.encoder.embed_dim,
        heads=blk.attn.num_heads, mlp_ratio=blk.mlp.fc1.out_features / model.encoder.embed_dim,
        moco_mlp_dim=proj[0].out_features, moco_dim=proj[-2].out_features,
        num_windows=model.patch_extractor.num_windows,
        patchnet_depth=len(model.patch_extractor.blocks),
        pix_projector_dim=model.pix_projector[0].out_features,
        pix_decoder_dim=model.pix_decoder[0].out_features, patch=model.patch_size,
        grid=model.patch_shape)


def finetune_shape(model) -> FinetuneShape:
    """The shape of a built `RecModel` with a `TFDecoder`."""
    enc, dec = model.encoder, model.decoder
    blk, layer = enc.blocks[0], dec.layer_stack[0]
    return FinetuneShape(
        depth=len(enc.blocks), width=enc.embed_dim, heads=blk.attn.num_heads,
        mlp_ratio=blk.mlp.fc1.out_features / enc.embed_dim,
        dec_layers=len(dec.layer_stack), d_embedding=dec.d_embedding,
        d_model=dec.layer_norm.weight.shape[0], dec_heads=dec.n_head, d_k=dec.d_k, d_v=dec.d_v,
        d_inner=layer.mlp.w_1.out_features, num_classes=dec.num_classes,
        max_len=dec.max_seq_len, patch=enc.patch_embed.patch_size, grid=enc.patch_shape)


def _mm(m: int, k: int, n: int) -> int:
    """An [m, k] x [k, n] product."""
    return 2 * m * k * n


def _dense(rows: int, d_in: int, d_out: int, train: bool, input_grad: bool = True) -> int:
    """A `Dense` on `rows` rows: the forward, and in training the weight
    gradient and, where the input takes one, the input gradient."""
    return _mm(rows, d_in, d_out) * (1 + (1 + input_grad) * train)


def _attention(seqs: int, heads: int, lq: int, lk: int, d_k: int, d_v: int,
               train: bool) -> int:
    """q·kᵀ and w·v, and in training their backward: the gradients of q, k,
    w and v."""
    return (_mm(seqs * heads * lq, d_k, lk) + _mm(seqs * heads * lq, lk, d_v)) * (1 + 2 * train)


def _encoder(seqs: int, n: int, depth: int, width: int, heads: int, mlp_ratio: float,
             patch: int, train: bool) -> int:
    """The patch embedding (no input gradient) and `depth` pre-LN blocks."""
    rows, hidden = seqs * n, int(width * mlp_ratio)
    block = (_dense(rows, width, 3 * width, train) + _dense(rows, width, width, train)
             + _dense(rows, width, hidden, train) + _dense(rows, hidden, width, train)
             + _attention(seqs, heads, n, n, width // heads, width // heads, train))
    return _dense(rows, patch * patch * 3, width, train, input_grad=False) + depth * block


def _mlp_head(rows: int, dims, train: bool) -> int:
    """An `MLPHead` through `dims` (input, hidden..., output)."""
    return sum(_dense(rows, a, b, train) for a, b in zip(dims, dims[1:]))


def _patch_net(s: PretrainShape, seqs: int, train: bool) -> int:
    """`PatchNet`: the window pooling over the grid's width (the pooled
    map alone takes a gradient), then `CrossBlock`s of `num_windows`
    queries over the whole token map (Mlp ratio 4)."""
    n, w, c = s.grid[0] * s.grid[1], s.num_windows, s.width
    pool = _mm(w, s.grid[1], seqs * c) * (1 + train)
    block = (_dense(seqs * w, c, c, train) + 2 * _dense(seqs * n, c, c, train)
             + _attention(seqs, s.heads, w, n, c // s.heads, c // s.heads, train)
             + _dense(seqs * w, c, c, train)
             + _dense(seqs * w, c, 4 * c, train) + _dense(seqs * w, 4 * c, c, train))
    return pool + s.patchnet_depth * block


def pretrain_step_flops(s: PretrainShape, batch: int) -> int:
    """One MoCo + SimMIM step (`train/pretrain.py::make_pretrain_step`) on
    `batch` images, both views: the student forward and backward, the
    momentum branch's forward, the two InfoNCE logits (their keys take no
    gradient).  Under data parallel, `batch` is the global batch: the sum
    of every rank's count."""
    seqs, n, c = 2 * batch, s.grid[0] * s.grid[1], s.width
    pix = s.patch * s.patch * 3
    rows_w = seqs * s.num_windows

    def branch(train: bool) -> int:
        enc = _encoder(seqs, n, s.depth, c, s.heads, s.mlp_ratio, s.patch, train)
        projector = _mlp_head(batch * n, (c, s.pix_projector_dim, s.pix_projector_dim, c), train)
        projection = _mlp_head(rows_w, (c, s.moco_mlp_dim, s.moco_mlp_dim, s.moco_dim), train)
        return enc + projector + _patch_net(s, seqs, train) + projection

    predictor = _mlp_head(rows_w, (s.moco_dim, s.moco_mlp_dim, s.moco_dim), True)
    pix_decoder = _mlp_head(seqs * n, (c, s.pix_decoder_dim, s.pix_decoder_dim, pix), True)
    info_nce = 2 * _mm(rows_w // 2, s.moco_dim, rows_w // 2) * 2
    return branch(True) + branch(False) + predictor + pix_decoder + info_nce


def finetune_step_flops(s: FinetuneShape, batch: int) -> int:
    """One teacher-forced fine-tuning step (`train/finetune.py::make_finetune_step`)
    of a `RecModel` with a `TFDecoder` on `batch` images: the encoder,
    `linear_norm`, the decoder's layers over `max_len` positions and its
    classifier, forward and backward, and the embedding's one-hot gradient."""
    n, t = s.grid[0] * s.grid[1], s.max_len
    rows_t, dk, dv = batch * t, s.dec_heads * s.d_k, s.dec_heads * s.d_v
    enc = _encoder(batch, n, s.depth, s.width, s.heads, s.mlp_ratio, s.patch, True)
    linear_norm = _dense(batch * n, s.width, s.d_embedding, True)
    layer = (3 * _dense(rows_t, s.d_model, dk, True)
             + _attention(batch, s.dec_heads, t, t, s.d_k, s.d_v, True)
             + _dense(rows_t, dv, s.d_model, True)
             + _dense(rows_t, s.d_model, dk, True) + 2 * _dense(batch * n, s.d_model, dk, True)
             + _attention(batch, s.dec_heads, t, n, s.d_k, s.d_v, True)
             + _dense(rows_t, dv, s.d_model, True)
             + _dense(rows_t, s.d_model, s.d_inner, True)
             + _dense(rows_t, s.d_inner, s.d_model, True))
    classifier = _dense(rows_t, s.d_model, s.num_classes, True)
    embedding_grad = _mm(s.num_classes + 1, rows_t, s.d_embedding)
    return enc + linear_norm + s.dec_layers * layer + classifier + embedding_grad
