"""Ops of the port's pre-training step against the JAX package, on the CPU.

The two backward kernels' plain versions, reached through the port's
autograd Functions, are held against `jax.vjp` of the JAX package's
custom-VJP Pallas pairs run in the Pallas interpreter (as
tests/test_pallas_kernels.py runs them), in fp32 and fp64; then the
pixel targets, the InfoNCE loss, the AdamW path of the optimizer and the
schedules.  Inputs come from numpy seeds.  Each tolerance is stated where
it is used."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_threads import one_thread
import dig_tpu.ops.attention as jattn
import dig_tpu.ops.layernorm as jln
import dig_tpu.ops.patchify
from dig_tpu.losses import infonce as jnce
from dig_tpu.optim import create_optimizer as j_create_optimizer
from dig_tpu.utils import schedules as jsched
from dig_tpu_torch import optim as toptim
from dig_tpu_torch.losses import infonce as tnce
from dig_tpu_torch.ops import attention as tattn
from dig_tpu_torch.ops import layernorm as tln
from dig_tpu_torch.ops import patchify as tpatch
from dig_tpu_torch.utils import schedules as tsched

# the module itself: the package re-exports a function of the same name
jpatch = sys.modules["dig_tpu.ops.patchify"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture
def interpret():
    jattn.INTERPRET = True
    jln.INTERPRET = True
    yield
    jattn.INTERPRET = False
    jln.INTERPRET = False


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("b,l,d", [pytest.param(2, 128, 64, id="2-64"),
                                   pytest.param(1, 128, 32, id="1-32"),
                                   pytest.param(1, 137, 64, id="1-137-64")])
def test_attention_backward_matches_pallas_vjp(interpret, dtype, b, l, d):
    """dq, dk, dv of the port's kernel-pair Function (plain forward and
    plain backward on the CPU) against `jax.vjp` of `_pallas_attention_lse`,
    whose backward is `_attn_bwd_kernel_lse`, at H=2 and L=128 or a ragged
    L=137 (no multiple of the CUDA bodies' 64-row tiles)."""
    rng = np.random.default_rng(10 + d)
    q, k, v, g = (rng.normal(size=(b, l, 2, d)).astype(dtype) for _ in range(4))
    scale = d**-0.5
    with jax.enable_x64(dtype == "float64"):
        _, vjp = jax.vjp(lambda q, k, v: jattn._pallas_attention_lse(q, k, v, scale),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    n = tattn.attention_lse_bwd.launches
    tattn.multi_head_attention(tq, tk, tv).backward(torch.from_numpy(g))
    assert tattn.attention_lse_bwd.launches == n  # the CPU takes the plain version
    # fp32: the same products summed in another order, ~1e-7 at |g| ~ 1.
    # fp64: the kernel's m, s and its dots are fp32 (preferred_element_type),
    # so fp64 agrees to fp32 rounding, not fp64's
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == getattr(torch, dtype) and ref.dtype == np.dtype(dtype)
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=2e-6)


def test_packed_qkv_backward_matches_slices():
    """The packed entry writes dq | dk | dv into one [B, L, 3C] gradient: it
    equals the gradient through three separate head-split column slices."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 128, 3 * 128)).astype(np.float32)
    g = rng.normal(size=(2, 128, 128)).astype(np.float32)
    a = torch.from_numpy(x).requires_grad_()
    tattn.multi_head_attention_qkv(a, 2).backward(torch.from_numpy(g))
    b = torch.from_numpy(x).requires_grad_()
    q, k, v = (b[..., i * 128:(i + 1) * 128].view(2, 128, 2, 64) for i in range(3))
    tattn.multi_head_attention(q, k, v).backward(torch.from_numpy(g).view(2, 128, 2, 64))
    # the same plain backward on the same numbers: equal
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rows,c", [(512, 128), (1024, 384)])
def test_layernorm_backward_matches_pallas_vjp(interpret, dtype, rows, c):
    """dx, dgamma, dbeta of the port's kernel-pair Function against
    `jax.vjp` of `_pallas_ln`, whose backward is `_ln_bwd_kernel`."""
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(rows, c)) * 2 + 0.5).astype(dtype)
    gamma = (1 + 0.1 * rng.normal(size=(c,))).astype(dtype)
    beta = (0.1 * rng.normal(size=(c,))).astype(dtype)
    dy = rng.normal(size=(rows, c)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        _, vjp = jax.vjp(lambda x, g, b: jln._pallas_ln(x, g, b, 1e-6),
                         jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        want = [np.asarray(t) for t in vjp(jnp.asarray(dy))]
    tx, tg, tb = (torch.from_numpy(t).requires_grad_() for t in (x, gamma, beta))
    n = tln.layer_norm_bwd.launches
    tln.layer_norm(tx, tg, tb, 1e-6).backward(torch.from_numpy(dy))
    assert tln.layer_norm_bwd.launches == n
    # dx: the Pallas kernel's one-pass fp32 variance vs the port's two-pass
    # form, ~1e-7 relative at |x| ~ 2 (fp64 inputs keep fp32 kernel
    # statistics).  dgamma, dbeta: sums over 512-1024 rows of |dy| ~ 1 in
    # another order, ~1e-6 relative to their size (~100)
    np.testing.assert_allclose(_np(tx.grad), want[0], rtol=1e-5, atol=2e-6)
    for got, ref in zip((tg.grad, tb.grad), want[1:]):
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-4)


def test_patchify_roundtrip_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 32, 128, 3)).astype(np.float32)
    want = np.asarray(jpatch.patchify(jnp.asarray(x), 4))
    got = tpatch.patchify(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(_np(got), want)  # a pure permutation
    flat = got.reshape(2, 256, 48)
    np.testing.assert_array_equal(_np(tpatch.unpatchify(flat, 4, 32, 128)), x)
    np.testing.assert_array_equal(
        _np(tpatch.unpatchify(flat, 4, 32, 128)),
        np.asarray(jpatch.unpatchify(jnp.asarray(_np(flat)), 4, 32, 128)))


@pytest.mark.parametrize("normalize", [True, False])
def test_mim_pixel_targets_match_jax(normalize):
    rng = np.random.default_rng(14)
    x = rng.uniform(-1, 1, size=(2, 32, 128, 3)).astype(np.float32)
    want = np.asarray(jpatch.mim_pixel_targets(jnp.asarray(x), 4, normalize))
    got = _np(tpatch.mim_pixel_targets(torch.from_numpy(x), 4, normalize))
    # fp32 mean and unbiased variance over 16 pixels, divided: a few ulp of
    # values up to ~4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _grey_images(case):
    """uint8 images of 4 x 4 patches: "flat" every patch one grey level a
    channel (all 256 levels, each a whole image), "mixed" flat patches
    among patches of noise."""
    rng = np.random.default_rng(16)
    if case == "flat":
        return np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None, None],
                               (256, 32, 128, 3)).copy()
    levels = rng.integers(0, 256, size=(4, 8, 1, 32, 1, 3))
    img = np.broadcast_to(levels, (4, 8, 4, 32, 4, 3)).copy()
    noisy = rng.random((4, 8, 1, 32, 1, 1)) < 0.5
    img = np.where(noisy, rng.integers(0, 256, size=img.shape), img)
    return img.reshape(4, 32, 128, 3).astype(np.uint8)


@pytest.mark.parametrize("case", ["flat", "mixed"])
def test_mim_pixel_targets_on_flat_patches(case):
    """The study's images have flat backgrounds.  A patch-channel of 16
    equal pixels has mean and variance 0, so its standardized target is 0:
    the port's is exactly 0.  `dig_tpu`'s mean on XLA's CPU backend may be
    an ulp off, which the standardization (eps 1e-6) scales to at most
    2 ulp / 1e-6 (~0.25) there; everywhere else the two agree as in
    `test_mim_pixel_targets_match_jax`."""
    from dig_tpu_torch.ops.images import to_model_images

    u8 = _grey_images(case)
    x = _np(to_model_images(torch.from_numpy(u8)))
    got = _np(tpatch.mim_pixel_targets(torch.from_numpy(x), 4, True)).reshape(-1, 256, 16, 3)
    want = np.asarray(jpatch.mim_pixel_targets(jnp.asarray(x), 4, True)).reshape(-1, 256, 16, 3)
    pix = tpatch.patchify(torch.from_numpy(u8.astype(np.int32)), 4).numpy()
    flat = (pix == pix[:, :, :1]).all(axis=2)  # [B, N, C]: 16 equal pixels
    assert flat.any()
    flat_t = np.moveaxis(got, 2, 3)[flat]
    assert np.array_equal(flat_t, np.zeros_like(flat_t))
    assert float(np.abs(np.moveaxis(want, 2, 3)[flat]).max()) <= 2 * 2.0**-23 / 1e-6
    rest = ~flat
    if rest.any():
        np.testing.assert_allclose(np.moveaxis(got, 2, 3)[rest], np.moveaxis(want, 2, 3)[rest],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_info_nce_matches_jax(smoothing):
    rng = np.random.default_rng(15)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    k = (q + 0.7 * rng.normal(size=(8, 16))).astype(np.float32)  # positives score high
    jl, (ja1, ja5) = jnce.info_nce_loss(jnp.asarray(q), jnp.asarray(k), 0.2, smoothing,
                                        return_acc=True)
    tl, (ta1, ta5) = tnce.info_nce_loss(torch.from_numpy(q), torch.from_numpy(k), 0.2,
                                        smoothing, return_acc=True)
    # an 8 x 8 fp32 cosine-similarity softmax: a few ulp
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(ta1) == float(ja1) and float(ta5) == float(ja5)
    assert 0 < float(ta1) <= float(ta5) <= 100


def test_adamw_matches_jax_optimizer():
    """Three AdamW steps from identical grads: decay mask (2-D kernels
    decay; 1-D params and the 3-D mask token do not), global-norm clipping
    that fires, lr and wd from schedule arrays, default eps."""
    rng = np.random.default_rng(16)
    shapes = {"encoder.mask_token": (1, 1, 8), "encoder.w": (8, 4), "head.bias": (4,)}
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    lr = np.array([1e-2, 2e-2], np.float32)  # the last value is reused past the end
    wd = np.array([0.1, 0.05], np.float32)
    jtree = lambda flat: {"encoder": {"mask_token": flat["encoder.mask_token"],
                                      "w": flat["encoder.w"]},
                          "head": {"bias": flat["head.bias"]}}
    tx = j_create_optimizer("adamw", lr, wd, clip_grad=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, jtree(params))
    state = tx.init(jp)
    tp = {n: torch.from_numpy(p.copy()).requires_grad_() for n, p in params.items()}
    opt = toptim.create_optimizer("adamw", tp.items(), lr, wd, clip_grad=0.5)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, jtree(g)), state, jp)
        jp = optax.apply_updates(jp, updates)
        for n, t in tp.items():
            t.grad = torch.from_numpy(g[n].copy())
        opt.step()
    want = {"encoder.mask_token": jp["encoder"]["mask_token"], "encoder.w": jp["encoder"]["w"],
            "head.bias": jp["head"]["bias"]}
    assert opt.count == 3
    for n, t in tp.items():
        # updates of size lr * O(1); the two formulas round apart: ~1e-7
        np.testing.assert_allclose(_np(t), np.asarray(want[n]), rtol=1e-6, atol=1e-6)
    # the other names build optax's rules (tests/test_torch_port_optimizers.py);
    # a name dig_tpu does not know is refused as dig_tpu refuses it
    assert isinstance(toptim.create_optimizer("lamb", tp.items(), lr), toptim.OptaxOptimizer)
    with pytest.raises(ValueError, match="Invalid optimizer 'lamb_x'"):
        toptim.create_optimizer("lamb_x", tp.items(), lr)


def test_adamw_decay_mask():
    model = torch.nn.ModuleDict({"encoder": torch.nn.Linear(4, 4)})
    model.encoder.mask_token = torch.nn.Parameter(torch.zeros(1, 1, 4))
    opt = toptim.AdamW(model.named_parameters(), [1e-3])
    decay, no_decay = opt.inner.param_groups
    assert [p.shape for p in decay["params"]] == [(4, 4)]
    assert sorted(p.dim() for p in no_decay["params"]) == [1, 3]


@pytest.mark.parametrize("fn,args", [
    ("cosine_schedule", (2.4e-3, 1e-5, 3, 7, 1, 1e-6, -1)),
    ("cosine_schedule", (0.1, 0.1, 1, 50, 0, 0.0, 10)),
    ("moco_momentum_schedule", (0.99, 3, 7, True)),
    ("moco_momentum_schedule", (0.99, 3, 7, False)),
    ("contrast_weight_schedule", (0.1, 3, 7, 1, 5)),
])
def test_schedules_equal_jax(fn, args):
    np.testing.assert_array_equal(getattr(tsched, fn)(*args), getattr(jsched, fn)(*args))
