"""The written-out FLOP counts of `dig_tpu_torch/utils/flops.py` against
`torch.utils.flop_counter.FlopCounterMode` over the port's plain steps on
the CPU, where every matrix product (the kernel pairs' plain versions
included) is an aten op: equal, as integers.  The count is of model FLOPs, 4
backward products an attention, so the steps run with every attention on
its weight-keeping plain path (`_ref_attention`); the fused pair's plain
version, which computes the logits again in its backward, is held to that
recompute alone.  Two configurations each: the micro width (2 layers x 64,
2 heads) and 3 layers x 96 (3 heads of 32); the fine-tuning step also with
a frozen encoder layer and under attention dropout.  Then the ratio of
XLA's count of `dig_tpu`'s compiled step (`bench.py::program_flops`'s cost
analysis) to the written-out one at the micro width on the CPU (printed;
run with ``-s`` to read it)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dig_tpu.models.rec_model import build_rec_model as j_build_rec_model
from dig_tpu.models.registry import create_model as j_create_model
from dig_tpu.optim import make_optimizer as j_make_optimizer
from dig_tpu.train.finetune import init_finetune_state as j_init_finetune_state
from dig_tpu.train.finetune import make_finetune_step as j_make_finetune_step
from dig_tpu.train.pretrain import init_pretrain_state as j_init_pretrain_state
from dig_tpu.train.pretrain import make_pretrain_step as j_make_pretrain_step
from dig_tpu_torch.models.decoder import TFDecoder
from dig_tpu_torch.models.moco import DiGPretrainModel, build_pretrain_model
from dig_tpu_torch.models.rec_model import RecModel, build_rec_model
from dig_tpu_torch.models.vit import VisionTransformer
from dig_tpu_torch.ops import attention
from dig_tpu_torch.optim import create_optimizer, frozen_encoder_mask
from dig_tpu_torch.train.finetune import init_finetune_state, make_finetune_step
from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
from dig_tpu_torch.utils.flops import (
    FinetuneShape,
    PretrainShape,
    finetune_shape,
    finetune_step_flops,
    pretrain_shape,
    pretrain_step_flops,
)

B = 2
MICRO_PRE = PretrainShape(depth=2, width=64, heads=2)
MICRO_FT = FinetuneShape(depth=2, width=64, heads=2, dec_layers=2, d_embedding=384, d_model=384,
                         dec_heads=6, d_inner=192)


def _pre_batch(b=B):
    rng = np.random.default_rng(0)
    return {"images": rng.integers(0, 256, (b, 32, 128, 3), dtype=np.uint8),
            "aug_images": rng.integers(0, 256, (b, 32, 128, 3), dtype=np.uint8),
            "mask": rng.random((b, 2, 256)) < 0.7}


def _ft_batch(b=B):
    rng = np.random.default_rng(1)
    return {"images": rng.integers(0, 256, (b, 32, 128, 3), dtype=np.uint8),
            "targets": rng.integers(0, 94, (b, 25)), "lengths": np.array([5, 25])[:b]}


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture
def weight_keeping_attention(monkeypatch):
    """Every attention on `_ref_attention`, whose backward is the model's 4
    products: the fused pair's gate shut."""
    monkeypatch.setattr(attention, "_use_kernel", lambda q, k, mask: False)


def _pretrain_model(case):
    if case == "micro":
        return build_pretrain_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
                                    num_windows=4, temperature=0.2, device="cpu")
    return DiGPretrainModel(encoder_embed_dim=96, encoder_depth=3, encoder_num_heads=3,
                            mlp_dim=128, dim=32, num_windows=4)


def _pretrain_counted(case):
    model = _pretrain_model(case)
    state = init_pretrain_state(model, create_optimizer("adamw", model.named_parameters(),
                                                        [1e-4], [0.05]))
    step = make_pretrain_step(model, [0.99], [0.1])
    return pretrain_shape(model), _counted(lambda: step(state, _pre_batch()))


@pytest.mark.parametrize("case", ["micro", "w96_d3"])
def test_pretrain_step_flops_equal_flop_counter(case, weight_keeping_attention):
    shape, counted = _pretrain_counted(case)
    want = MICRO_PRE if case == "micro" else PretrainShape(
        depth=3, width=96, heads=3, moco_mlp_dim=128, moco_dim=32)
    assert shape == want
    assert pretrain_step_flops(shape, B) == counted


def _finetune_model(case):
    if case.startswith("micro"):
        rate = 0.1 if case == "micro_attn_drop" else 0.0
        return build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", drop_rate=rate,
                               attn_drop_rate=rate, drop_path_rate=0.1, device="cpu")
    enc = VisionTransformer(embed_dim=96, depth=3, num_heads=3, drop_path_rate=0.1)
    dec = TFDecoder(n_layers=2, d_embedding=96, n_head=3, d_k=32, d_v=32, d_model=96,
                    d_inner=192)
    return RecModel(enc, dec)


def _finetune_counted(case):
    model = _finetune_model(case)
    frozen = frozen_encoder_mask(1) if case == "w96_d3_frozen" else None
    opt = create_optimizer("adamw", model.named_parameters(), [1e-4], [0.05], layer_decay=0.75,
                           num_layers=len(model.encoder.blocks), frozen=frozen)
    state = init_finetune_state(model, opt)
    step = make_finetune_step(model, smoothing=0.1)
    counted = _counted(lambda: step(state, _ft_batch(), torch.Generator().manual_seed(0)))
    return finetune_shape(model), counted


@pytest.mark.parametrize("case", ["micro", "micro_attn_drop", "w96_d3_frozen"])
def test_finetune_step_flops_equal_flop_counter(case, weight_keeping_attention):
    """Attention dropout (the dropout path of `models/layers.py`) counts as
    the plain attention does; a frozen layer (lr scale 0) keeps its
    gradients, so the count does not move."""
    shape, counted = _finetune_counted(case)
    if case == "w96_d3_frozen":
        want = FinetuneShape(depth=3, width=96, heads=3, dec_layers=2, d_embedding=96,
                             d_model=96, dec_heads=3, d_k=32, d_v=32, d_inner=192)
    else:
        want = MICRO_FT
    assert shape == want
    assert finetune_step_flops(shape, B) == counted


@pytest.mark.parametrize("case", ["pretrain micro", "finetune micro", "finetune micro_attn_drop",
                                  "finetune w96_d3_frozen"])
def test_kernel_pair_adds_only_its_logits_recompute(case):
    """The step as the port runs it: the encoder's self-attention (L = 256,
    no dropout on its weights) takes the fused pair, whose backward
    computes q·kᵀ again; the count leaves that product out, and nothing
    else differs.  Under attention dropout no attention takes the pair."""
    trainer, case = case.split()
    if trainer == "pretrain":
        shape, counted = _pretrain_counted(case)
        written, seqs = pretrain_step_flops(shape, B), 2 * B  # the student's two views
    else:
        shape, counted = _finetune_counted(case)
        written, seqs = finetune_step_flops(shape, B), B
        seqs *= case != "micro_attn_drop"
    n, d = shape.grid[0] * shape.grid[1], shape.width // shape.heads
    assert counted - written == shape.depth * 2 * seqs * shape.heads * n * d * n


def test_default_shapes_are_the_bench_models():
    """The dataclasses' defaults describe bench.py's (and bench_torch.py's)
    full-width models, as read off the port's built models."""
    pre = build_pretrain_model(num_windows=4, temperature=0.2, device="cpu")
    assert pretrain_shape(pre) == PretrainShape()
    rec = build_rec_model("vit_small_patch4_32x128", "tf_decoder", drop_path_rate=0.1,
                          device="cpu")
    assert finetune_shape(rec) == FinetuneShape()
    # the counts at bench.py's batches (PERF.md)
    assert pretrain_step_flops(PretrainShape(), 128) == 13_104_691_806_208
    assert finetune_step_flops(FinetuneShape(), 256) == 11_087_852_601_344


def _xla_flops(fn, *args) -> float:
    analysis = fn.lower(*args).compile().cost_analysis()
    if isinstance(analysis, list):
        analysis = analysis[0]
    return float(analysis["flops"])


@pytest.mark.parametrize("trainer", ["pretrain", "finetune"])
def test_xla_count_against_written_out(trainer):
    """XLA's count of dig_tpu's step (what bench.py's mfu divides) against
    the written-out count of the same step at the micro width, on the
    CPU: XLA adds the elementwise work and counts the embedding gradient
    as a scatter, so the two differ by a few percent; the ratio is printed
    for PERF.md.  It does not carry over to bench.py on a TPU, where the
    Pallas calls' FLOPs may not be in XLA's count."""
    tx = j_make_optimizer(np.full(4, 1e-3, np.float32), np.full(4, 0.05, np.float32))
    if trainer == "pretrain":
        model = j_create_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128",
                               num_windows=4, temperature=0.2)
        state = j_init_pretrain_state(model, tx, jax.random.PRNGKey(0))
        step = j_make_pretrain_step(model, np.full(4, 0.99, np.float32),
                                    np.full(4, 0.1, np.float32))
        batch = {k: jnp.asarray(v) for k, v in _pre_batch().items()}
        written = pretrain_step_flops(MICRO_PRE, B)
    else:
        model = j_build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder",
                                  drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.1)
        state = j_init_finetune_state(model, tx, jax.random.PRNGKey(0))
        step = j_make_finetune_step(model, smoothing=0.1)
        batch = {k: jnp.asarray(v) for k, v in _ft_batch().items()}
        written = finetune_step_flops(MICRO_FT, B)
    xla = _xla_flops(step, state, batch, jax.random.PRNGKey(1))
    ratio = xla / written
    print(f"\n{trainer} micro batch {B}: XLA {xla:.0f}, written out {written}, ratio {ratio:.4f}")
    assert 1.0 <= ratio <= 1.2
