"""The port's opt-in kernels against the JAX package, on the CPU: the
recompute attention pair (`DIG_TPU_ATTN_STORE_LSE=0`, with the
`BF16_EXP` branch of its forward) and the column-sum bias gradient
(`DIG_TPU_FUSED_BIAS_GRAD=1`).

The JAX side runs its Pallas kernels in the interpreter, as
tests/test_pallas_kernels.py runs them; the port's kernel wrappers take
their plain versions on CPU tensors.  Inputs come from numpy seeds; each
tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dig_tpu.ops.attention as jattn
import dig_tpu.ops.fused_dense as jfd
from dig_tpu.models.layers import Mlp as JMlp
from dig_tpu_torch.models.layers import Mlp as TMlp
from dig_tpu_torch.ops import attention as tattn
from dig_tpu_torch.ops import fused_dense as tfd


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jattn, "INTERPRET", True)
    monkeypatch.setattr(jfd, "INTERPRET", True)


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed, shape, n, dtype):
    """n arrays of `shape` from a numpy seed, as (jax, torch) pairs in
    `dtype` (bf16 rounded from fp32 identically on both sides)."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape).astype(np.float32 if dtype == "bfloat16" else dtype)
          for _ in range(n)]
    return ([jnp.asarray(x, getattr(jnp, dtype)) for x in xs],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs])


@pytest.mark.parametrize("dtype,bf16_exp", [("float32", False), ("float64", False),
                                            ("bfloat16", False), ("bfloat16", True)])
def test_attention_fwd_matches_pallas_kernel(interpret, monkeypatch, dtype, bf16_exp):
    """`attention_fwd` (plain version on the CPU) against
    `_pallas_attention_fwd_impl`, whose body is `_attn_kernel`, at B=2,
    L=128, H=2, D=64, with `BF16_EXP` set alike on both sides."""
    monkeypatch.setattr(jattn, "BF16_EXP", bf16_exp)
    monkeypatch.setattr(tattn, "BF16_EXP", bf16_exp)
    scale = 64**-0.5
    with jax.enable_x64(dtype == "float64"):
        (jq, jk, jv), (q, k, v) = _inputs(30, (2, 128, 2, 64), 3, dtype)
        want = np.asarray(jattn._pallas_attention_fwd_impl(jq, jk, jv, scale).astype(jnp.float32))
    n = tattn.attention_fwd.launches
    got = tattn.attention_fwd(q, k, v, scale)
    assert tattn.attention_fwd.launches == n  # the CPU takes the plain version
    assert got.dtype == q.dtype
    if dtype == "bfloat16":
        # bf16 outputs: the fp32 logits sum in another order, so a bf16
        # rounding (of e, of the exponent input under BF16_EXP, or of o)
        # may go the other way; o differs by at most one bf16 ulp (2^-8 of
        # |o| <= ~1.5) plus the shift one flipped e gives a row's sum
        np.testing.assert_allclose(_np(got), want, rtol=2**-7, atol=2**-7)
    else:
        # fp32: the same products in another order, ~1e-7 at |o| ~ 1; fp64:
        # the kernel's products are fp32 (preferred_element_type)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=2e-6)


def test_bf16_exp_branch_differs_from_the_fp32_tile_by_bf16_rounding(monkeypatch):
    """Both forward branches on the same bf16 inputs: within the 2e-2 the
    JAX package allows them (tests/test_pallas_kernels.py), yet not equal;
    fp32 inputs never take the bf16 branch."""
    _, (q, k, v) = _inputs(31, (2, 128, 2, 64), 3, "bfloat16")
    monkeypatch.setattr(tattn, "BF16_EXP", False)
    plain = tattn.attention_fwd(q, k, v, 0.125)
    monkeypatch.setattr(tattn, "BF16_EXP", True)
    fast = tattn.attention_fwd(q, k, v, 0.125)
    delta = float((fast.float() - plain.float()).abs().max())
    assert 0 < delta <= 2e-2
    qf, kf, vf = (t.float() for t in (q, k, v))
    torch.testing.assert_close(tattn.attention_fwd(qf, kf, vf, 0.125),
                               tattn.attention_lse_fwd(qf, kf, vf, 0.125)[0], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("packed,b,l", [pytest.param(False, 2, 128, id="False"),
                                        pytest.param(True, 2, 128, id="True"),
                                        pytest.param(False, 1, 137, id="False-137")])
def test_attention_bwd_matches_pallas_vjp(interpret, monkeypatch, dtype, packed, b, l):
    """dq, dk, dv through the port's recompute autograd Functions (plain
    forward and backward on the CPU) against `jax.vjp` of
    `_pallas_attention`, whose backward is `_attn_bwd_kernel`, at H=2,
    D=64 and L=128 or a ragged L=137 (no multiple of the CUDA bodies'
    64-row tiles); packed: the ViT's [B, L, 3C] entry."""
    monkeypatch.setenv("DIG_TPU_ATTN_STORE_LSE", "0")
    h, d = 2, 64
    scale = d**-0.5
    with jax.enable_x64(dtype == "float64"):
        (jq, jk, jv, jg), (q, k, v, g) = _inputs(32, (b, l, h, d), 4, dtype)
        _, vjp = jax.vjp(lambda q, k, v: jattn._pallas_attention(q, k, v, scale), jq, jk, jv)
        want = [np.asarray(x) for x in vjp(jg)]
    fn = tattn._kernel_fn(packed)
    assert fn is (tattn._AttentionQKV if packed else tattn._Attention)
    n = tattn.attention_bwd.launches
    if packed:
        qkv = torch.cat([t.reshape(b, l, h * d) for t in (q, k, v)], -1).requires_grad_()
        out = fn.apply(qkv, h, scale)
        assert len(out.grad_fn.saved_tensors) == 1  # qkv, no statistics
        out.backward(g)
        got = [t.reshape(b, l, h, d) for t in qkv.grad.split(h * d, dim=-1)]
    else:
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = fn.apply(q, k, v, scale)
        assert len(out.grad_fn.saved_tensors) == 3  # q, k, v, no statistics
        out.backward(g)
        got = [q.grad, k.grad, v.grad]
    assert tattn.attention_bwd.launches == n  # the CPU takes the plain version
    # as for the stored-statistics pair: fp32 products in another order,
    # ~1e-7 at |g| ~ 1; fp64 agrees to fp32 rounding (the kernel's m, s and
    # dots are fp32)
    for t, ref in zip(got, want):
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(t.double()), ref, rtol=1e-5, atol=2e-6)


def test_recompute_pair_equals_stored_statistics_pair(monkeypatch):
    """`multi_head_attention` takes the pair that `DIG_TPU_ATTN_STORE_LSE`
    names at each call.  The two compute the same function; on the CPU
    both take the same plain steps, so their gradients are equal bit for
    bit (the CUDA kernels are held to the same on the card)."""
    _, (q, k, v, g) = _inputs(33, (2, 128, 2, 32), 4, "float32")
    grads = {}
    for store, fn in (("1", "_LSEAttentionBackward"), ("0", "_AttentionBackward")):
        monkeypatch.setenv("DIG_TPU_ATTN_STORE_LSE", store)
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tattn.multi_head_attention(*ts)
        assert type(out.grad_fn).__name__ == fn
        out.backward(g)
        grads[store] = [t.grad for t in ts]
    for a, c in zip(grads["1"], grads["0"]):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1100, 2048, 1000])
def test_column_sum_matches_pallas_kernel(interpret, dtype, n):
    """`column_sum` (plain version on the CPU) against the JAX
    `column_sum`: its Pallas kernel at 1,100 rows (a masked last block) and
    2,048, its plain fp32 sum below 2 x 512 rows (the gate)."""
    (jx,), (x,) = _inputs(34 + n, (n, 384), 1, dtype)
    want = np.asarray(jfd.column_sum(jx))
    got = tfd.column_sum(x)
    assert got.dtype == torch.float32 and got.shape == (384,)
    # fp32 sums of ~1e3 values of |x| ~ 1 in another order: ~1e-5
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rows,launched", [(1023, False), (1024, True), (1100, True)])
def test_bias_grad_takes_the_kernel_from_1024_rows(monkeypatch, rows, launched):
    """The JAX package's gate (`fused_dense.py:59`): fewer than 2 x 512
    rows take the plain sum, never the kernel wrapper; db comes back in
    dy's dtype."""
    calls = []
    monkeypatch.setattr(tfd, "column_sum", lambda x: calls.append(x.shape) or tfd.column_sum_ref(x))
    dy = torch.ones(rows, 16, dtype=torch.bfloat16)
    db = tfd._bias_grad(dy)
    assert torch.equal(db, torch.full((16,), float(rows)).to(torch.bfloat16))
    assert calls == ([(rows, 16)] if launched else [])


@pytest.mark.parametrize("switch", ["1", "0"])
def test_mlp_with_fused_bias_grad_matches_jax(interpret, monkeypatch, switch):
    """`Mlp` with `DIG_TPU_FUSED_BIAS_GRAD` on against the JAX `Mlp` with it
    on (its fc1 a `FusedBiasGradDense` whose bias gradient runs the Pallas
    column sum in the interpreter: 4 x 300 = 1,200 rows), and off against
    off: the same parameters, output and gradients (the pattern of
    tests/test_pallas_kernels.py:120-153)."""
    monkeypatch.setenv("DIG_TPU_FUSED_BIAS_GRAD", switch)
    rng = np.random.default_rng(35)
    x = rng.normal(size=(4, 300, 32)).astype(np.float32)
    jmlp = JMlp(hidden_dim=64)
    params = jmlp.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p)).astype(np.float32), params)
    (jy, (jgp, jgx)) = jax.value_and_grad(
        lambda p, x: jnp.sum(jmlp.apply({"params": p}, x) ** 2), argnums=(0, 1))(
            params, jnp.asarray(x))
    tmlp = TMlp(32, 64)
    tmlp.load_state_dict({f"{dst}.{w}": torch.from_numpy(np.asarray(params[src][key]).T.copy())
                          for src, dst in (("Dense_0", "fc1"), ("Dense_1", "fc2"))
                          for w, key in (("weight", "kernel"), ("bias", "bias"))})
    calls = []
    monkeypatch.setattr(tfd, "column_sum", lambda t: calls.append(t.shape) or tfd.column_sum_ref(t))
    tx = torch.from_numpy(x).requires_grad_()
    y = tmlp(tx).square().sum()
    y.backward()
    assert calls == ([(1200, 64)] if switch == "1" else [])
    # fp32 products of depth 32 and 64 and sums over 1,200 rows: ~1e-6 relative
    np.testing.assert_allclose(y.item(), float(jy), rtol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    for src, dst in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
        layer = getattr(tmlp, dst)
        np.testing.assert_allclose(_np(layer.weight.grad), np.asarray(jgp[src]["kernel"]).T,
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np(layer.bias.grad), np.asarray(jgp[src]["bias"]),
                                   rtol=1e-5, atol=1e-4)


def test_fused_bias_grad_dense_keeps_the_dtypes_of_dense():
    """bf16 compute over fp32 parameters, as `Dense`: db reaches the fp32
    bias through a bf16 cast (`fused_dense.py:90`), and every gradient
    equals plain autograd's within bf16 rounding."""
    rng = np.random.default_rng(36)
    x = torch.from_numpy(rng.normal(size=(1100, 16)).astype(np.float32)).to(torch.bfloat16)
    w, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
            for s in ((8, 16), (8,)))
    dy = torch.from_numpy(rng.normal(size=(1100, 8)).astype(np.float32)).to(torch.bfloat16)
    xf = x.clone().requires_grad_()
    out = tfd.fused_dense(xf, w, b, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out.backward(dy)
    got = (xf.grad, w.grad, b.grad)
    xr, wr, br = x.clone().requires_grad_(), w.detach().clone().requires_grad_(), \
        b.detach().clone().requires_grad_()
    torch.nn.functional.linear(xr, wr.to(torch.bfloat16), br.to(torch.bfloat16)).backward(dy)
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, c in zip(got, (xr.grad, wr.grad, br.grad)):
        # one bf16 rounding of each product sum: 2^-8 relative
        _scale = float(c.float().abs().max())
        assert float((a.float() - c.float()).abs().max()) <= 2**-7 * _scale
