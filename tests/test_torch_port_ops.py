"""Ops of the PyTorch port (`dig_tpu_torch.ops`) against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU.  The
two kernel modules are held against the JAX Pallas kernels run in the
Pallas interpreter (as tests/test_pallas_kernels.py runs them), in fp32
and in fp64.  The CUDA kernels themselves run only on the card
(tests/test_torch_port_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dig_tpu.ops.attention as jattn
import dig_tpu.ops.layernorm as jln
from dig_tpu.ops import activations as jact
from dig_tpu.ops.images import to_model_images as j_to_model_images
from dig_tpu_torch.ops import activations as tact
from dig_tpu_torch.ops import attention as tattn
from dig_tpu_torch.ops import layernorm as tln
from dig_tpu_torch.ops.images import to_model_images as t_to_model_images


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret():
    jattn.INTERPRET = True
    jln.INTERPRET = True
    yield
    jattn.INTERPRET = False
    jln.INTERPRET = False


def _np(t):
    return t.detach().numpy()


def test_to_model_images_bit_identical():
    x = np.random.default_rng(0).integers(0, 256, (2, 32, 128, 3), dtype=np.uint8)
    # same float32 expression on both sides: exact
    np.testing.assert_array_equal(np.asarray(j_to_model_images(jnp.asarray(x))),
                                  _np(t_to_model_images(torch.from_numpy(x))))
    f = torch.ones(2, 3)
    assert t_to_model_images(f) is f


@pytest.mark.parametrize("exact", [False, True])
def test_gelu_forms(exact):
    x = np.random.default_rng(1).normal(size=(64, 33)).astype(np.float32) * 3
    old = tact.EXACT
    try:
        tact.set_exact(exact)
        got = _np(tact.gelu(torch.from_numpy(x)))
    finally:
        tact.set_exact(old)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=not exact))
    # fp32 elementwise, libm vs XLA transcendental: a few ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gelu_default_is_tanh_like_jax():
    # the JAX package's default form; torch's own F.gelu default is erf
    assert tact.EXACT == jact.EXACT


@pytest.mark.parametrize("explicit,paths,want", [
    (None, ("",), False), (None, ("w.pth",), True), (False, ("w.pth",), False),
    (True, ("",), True), (None, ("ckpt_dir",), False)])
def test_resolve_exact_gelu(explicit, paths, want, monkeypatch):
    monkeypatch.delenv("DIG_TPU_EXACT_GELU", raising=False)
    assert tact.resolve_exact_gelu(explicit, paths) == want
    assert jact.resolve_exact_gelu(explicit, paths) == want


def test_sinusoid_table_equal():
    from dig_tpu.models.layers import sinusoid_position_table as jtab
    from dig_tpu_torch.models.layers import sinusoid_position_table as ttab

    np.testing.assert_array_equal(jtab(200, 512), ttab(200, 512))
    np.testing.assert_array_equal(jtab(256, 64), ttab(256, 64))


def _qkv(rng, b, lq, lk, h, d, dtype):
    q = rng.normal(size=(b, lq, h, d)).astype(dtype)
    k = rng.normal(size=(b, lk, h, d)).astype(dtype)
    v = rng.normal(size=(b, lk, h, d)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("masked", [False, True])
def test_ref_attention_matches_jax(masked):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 7, 11, 2, 16, np.float32)
    mask = None
    if masked:
        mask = rng.random((2, 1, 7, 11)) > 0.3
        mask[..., 0] = True  # every row attends somewhere
    want = jattn._ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                None if mask is None else jnp.asarray(mask), 0.25)
    got = tattn._ref_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               None if mask is None else torch.from_numpy(mask), 0.25)
    # fp32 softmax + two small products, summed in another order: ~1e-7
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_attention_lse_fwd_ref_matches_pallas_kernel(interpret, dtype):
    """o, m, s of the port's plain version against `_attn_kernel_lse` in
    the Pallas interpreter at B=2, L=128, H=2, D=64."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 128, 128, 2, 64, dtype)
    scale = 64**-0.5
    with jax.enable_x64(dtype == "float64"):
        jo, jm, js = jattn._pallas_attention_lse_fwd_impl(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
        jo, jm, js = np.asarray(jo), np.asarray(jm), np.asarray(js)
    to, tm, ts = tattn.attention_lse_fwd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), scale)
    assert to.dtype == getattr(torch, dtype) and tm.dtype == ts.dtype == torch.float32
    assert jo.dtype == np.dtype(dtype) and jm.dtype == np.float32
    # fp32: the same products summed in another order (64 and 128 terms),
    # a few fp32 ulp.  fp64: the kernel's m and s are fp32 outputs, and
    # its dots are fp32-accumulated (preferred_element_type), so fp64
    # agrees to fp32 rounding, not to fp64's.
    tol = dict(rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(_np(to), jo, **tol)
    np.testing.assert_allclose(_np(tm), jm, **tol)
    np.testing.assert_allclose(_np(ts), js, rtol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ln_ref_matches_pallas_kernel(interpret, dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(1024, 128)) * 2 + 0.5).astype(dtype)
    g = (1 + 0.1 * rng.normal(size=(128,))).astype(dtype)
    b = (0.1 * rng.normal(size=(128,))).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jln._pallas_ln_fwd_impl(jnp.asarray(x), jnp.asarray(g),
                                                  jnp.asarray(b), 1e-6))
    got = _np(tln._ln_ref(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-6))
    assert got.dtype == want.dtype == np.dtype(dtype)
    # the Pallas kernel takes var = E[x^2] - mu^2 in fp32 (the port the
    # two-pass form): at |x| ~ 2 that differs by fp32 cancellation, ~1e-6;
    # fp64 inputs keep fp32 kernel statistics
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ln_ref_matches_jax_ref_fp64():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 384))
    g, b = 1 + 0.1 * rng.normal(size=(384,)), 0.1 * rng.normal(size=(384,))
    with jax.enable_x64(True):
        want = np.asarray(jln._ln_ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-6))
    got = _np(tln._ln_ref(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-6))
    # both promote to fp64 (never downcast): equal to fp64 rounding
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,dtype,want", [
    ((2, 256, 384), torch.float32, True),    # ViT-S norm1/norm2 rows: 512
    ((4, 256, 384), torch.bfloat16, True),
    ((3, 256, 384), torch.float32, False),   # 768 rows: not a multiple of 512
    ((512, 1, 512), torch.float32, True),    # c = 512, 512 rows
    ((2, 256, 64), torch.float32, False),    # micro width: c % 128 != 0
    ((2, 256, 1280), torch.float32, False),  # c beyond what the kernel holds
    ((2, 256, 384), torch.float64, False),   # no fp64 kernel
    ((1, 256, 384), torch.float32, False),   # 256 rows < 512
    ((256, 256, 384), torch.bfloat16, True),  # pretrain step: 2 views x 128 images
    ((8, 4, 384), torch.float32, False),     # CrossBlock window queries: 32 rows
])
def test_layer_norm_gate(shape, dtype, want):
    assert tln._use_kernel_ln(torch.zeros(shape, dtype=dtype)) == want


@pytest.mark.parametrize("lq,lk,d,masked,dtype,want", [
    (256, 256, 64, False, torch.bfloat16, True),  # ViT self-attention
    (128, 128, 32, False, torch.float32, True),
    (256, 256, 128, False, torch.float32, True),
    (25, 256, 64, False, torch.float32, False),   # decoder cross-attention
    (25, 25, 64, True, torch.float32, False),     # decoder self-attention
    (256, 256, 64, True, torch.float32, False),   # any mask
    (256, 256, 48, False, torch.float32, False),  # head_dim outside the gate
    (256, 256, 256, False, torch.float32, False),  # JAX gate passes, kernel takes <= 128
    (128, 2048, 64, False, torch.float32, False),  # score tile beyond shared memory
    (256, 256, 64, False, torch.float64, False),
    (4, 256, 64, False, torch.bfloat16, False),    # pretrain CrossBlock: 4 window queries
    (128, 400, 64, False, torch.float32, False),   # the backward's two score tiles exceed shared memory
])
def test_attention_gate(lq, lk, d, masked, dtype, want):
    q = torch.zeros(1, lq, 2, d, dtype=dtype)
    k = torch.zeros(1, lk, 2, d, dtype=dtype)
    mask = torch.ones(1, 1, lq, lk, dtype=torch.bool) if masked else None
    assert tattn._use_kernel(q, k, mask) == want


def test_wrappers_take_plain_version_on_cpu():
    """On a CPU tensor each wrapper returns its plain version's result and
    launches nothing (the count stays)."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.normal(size=(2, 128, 3 * 128)).astype(np.float32))
    q, k, v = (qkv[..., i * 128:(i + 1) * 128].view(2, 128, 2, 64) for i in range(3))
    n_attn, n_ln = tattn.attention_lse_fwd.launches, tln.layer_norm_fwd.launches
    got = tattn.attention_lse_fwd(q, k, v, 0.125)
    want = tattn.attention_lse_fwd_ref(q, k, v, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    x = torch.from_numpy(rng.normal(size=(512, 128)).astype(np.float32))
    g, b = torch.ones(128), torch.zeros(128)
    assert torch.equal(tln.layer_norm_fwd(x, g, b, 1e-6), tln._ln_ref(x, g, b, 1e-6))
    assert (tattn.attention_lse_fwd.launches, tln.layer_norm_fwd.launches) == (n_attn, n_ln)


def test_packed_attention_through_gate_matches_jax():
    """The packed entry point on a fused qkv (the ViT's call: column slices
    reach the kernel pair) through the gate and the wrapper, against the
    JAX package's packed entry on the same columns (its CPU path,
    `_ref_attention`)."""
    rng = np.random.default_rng(7)
    qkv = rng.normal(size=(2, 128, 3 * 128)).astype(np.float32)
    cols = [slice(i * 128, (i + 1) * 128) for i in range(3)]
    want = jattn.multi_head_attention_packed(*(jnp.asarray(qkv[..., c]) for c in cols), 2)
    got = tattn.multi_head_attention_qkv(torch.from_numpy(qkv), 2)
    # exp2 with the folded scale vs softmax of the scaled logits: fp32 rounding
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=2e-6)
