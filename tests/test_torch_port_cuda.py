"""The port's CUDA kernels against their plain versions, on the card: the
stored-statistics and the recompute attention pairs, the LayerNorm pair
and the column sum.

Marked `cuda`: they skip without a card.  This file imports neither JAX
nor `dig_tpu`, so it runs on the card's machine, which has no JAX:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q -m cuda

Tolerances as in chip_smoke.py: fp32 results agree to a few ulp (the same
products summed in another order); a bf16 output may round to the
neighbouring bf16 value (at most 2^-7 of the value).  The bf16 attention
forward sums its logits on the tensor cores, in another order than the
plain version, so the bf16 rounding of the odd exponential goes the other
way: its o is held at `TOL` but for at most `FLIP_SHARE` of its elements,
which stay within `BF16_EXP_TOL`, as for the bf16-exponential branch.  The backward
kernels are held relative to each gradient's max |value| (`BWD_RTOL`):
in bf16 an intermediate rounded to bf16 (e, ds0, the scaled q and do) may
round the other way when its fp32 input differs by an ulp (the bf16 body's
logits and dw are tensor-core sums), and that moves a sum of many terms by
a fraction of one term."""

import math

import pytest
import torch

from dig_tpu_torch.models.layers import Block
from dig_tpu_torch.ops import attention as tattn
from dig_tpu_torch.ops import layernorm as tln


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")


TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2**-7, atol=1e-4)}
BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2**-6}
# the bf16-exponential branch's o: the plain version's logits sum in
# another order, so the bf16 rounding of an exponent input may go the other
# way: one bf16 ulp of o (rtol 2^-7) plus 2^-8 absolute for the shift one
# flipped exponential gives its row
BF16_EXP_TOL = dict(rtol=2**-7, atol=2**-8)
# the share of a bf16 tensor-core forward's o that may lie outside TOL (each
# element within BF16_EXP_TOL): the flipped roundings of e, as above
FLIP_SHARE = 1e-4


def _close_to_max(got, ref, rtol):
    err = float((got.float() - ref.float()).abs().max())
    assert err <= rtol * float(ref.float().abs().max()), f"max abs err {err}"


def _assert_fwd_close(got, ref, dtype, bf16_exp=False):
    """An attention forward's o against its plain version: fp32 within TOL,
    the bf16-exponential branch within BF16_EXP_TOL, the bf16 tensor-core
    body within TOL but for at most FLIP_SHARE of its elements (at least
    one), each within BF16_EXP_TOL."""
    got, ref = got.float(), ref.float()
    if dtype == torch.float32 or bf16_exp:
        torch.testing.assert_close(got, ref, **(BF16_EXP_TOL if bf16_exp else TOL[dtype]))
        return
    torch.testing.assert_close(got, ref, **BF16_EXP_TOL)
    tol = TOL[dtype]
    n = int(((got - ref).abs() > tol["atol"] + tol["rtol"] * ref.abs()).sum())
    allowed = math.ceil(FLIP_SHARE * got.numel())
    assert n <= allowed, f"{n} of {got.numel()} elements outside {tol}, more than {allowed}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,d", [
    (4, 256, 256, 6, 64),   # the ViT-S predict shape
    (3, 200, 130, 2, 32),   # ragged query block and key chunk
    (2, 128, 320, 4, 128),  # widest head the kernel takes
])
def test_attention_kernel_matches_plain_version(cuda, dtype, b, lq, lk, h, d):
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = h * d
    q = torch.randn(b, lq, 3 * c, generator=gen, device="cuda").to(dtype)[..., :c]
    kv = torch.randn(b, lk, 3 * c, generator=gen, device="cuda").to(dtype)
    q = q.view(b, lq, h, d)  # strided column slices, as the ViT passes them
    k, v = (kv[..., i * c:(i + 1) * c].view(b, lk, h, d) for i in (1, 2))
    n = tattn.attention_lse_fwd.launches
    o, m, s = tattn.attention_lse_fwd(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert tattn.attention_lse_fwd.launches == n + 1
    ro, rm, rs = tattn.attention_lse_fwd_ref(q, k, v, d**-0.5)
    _assert_fwd_close(o, ro, dtype)
    torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(1024, 384), (13, 128), (512, 1024), (7, 512)])
def test_layernorm_kernel_matches_plain_version(cuda, dtype, rows, c):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (2 * torch.randn(rows, c, generator=gen, device="cuda") + 0.5).to(dtype)
    g = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    n = tln.layer_norm_fwd.launches
    y = tln.layer_norm_fwd(x, g, b, 1e-6)
    torch.cuda.synchronize()
    assert tln.layer_norm_fwd.launches == n + 1 and y.dtype == dtype
    torch.testing.assert_close(y.float(), tln._ln_ref(x, g, b, 1e-6).float(), **TOL[dtype])


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_take(cuda):
    q = torch.zeros(1, 128, 2, 48, device="cuda")  # head_dim 48
    with pytest.raises(ValueError):
        tattn.attention_lse_fwd(q, q, q, 0.1)
    with pytest.raises(TypeError):
        tattn.attention_lse_fwd(*(torch.zeros(1, 128, 2, 64, device="cuda",
                                              dtype=torch.float64),) * 3, 0.1)
    with pytest.raises(ValueError):
        tln.layer_norm_fwd(torch.zeros(8, 96, device="cuda"), torch.ones(96), torch.zeros(96), 1e-6)
    with pytest.raises(ValueError):  # not contiguous
        x = torch.zeros(8, 256, device="cuda")[:, :128]
        tln.layer_norm_fwd(x, torch.ones(128), torch.zeros(128), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,d", [
    (256, 256, 256, 6, 64),  # the pretrain step: 2 views x 128 images, ViT-S heads
    (3, 200, 130, 2, 32),   # ragged query and key blocks
    (2, 128, 320, 4, 128),  # widest head and longest Lk the dq pass fits
])
def test_attention_backward_kernel_matches_plain_version(cuda, dtype, b, lq, lk, h, d):
    """The backward on strided q, k, v column slices of packed projections,
    writing into the column slices of one packed gradient."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    c = h * d
    qkv = torch.randn(b, lq, 3 * c, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(b, lk, 3 * c, generator=gen, device="cuda").to(dtype)
    q = qkv[..., :c].view(b, lq, h, d)
    k, v = (kv[..., i * c:(i + 1) * c].view(b, lk, h, d) for i in (1, 2))
    do = torch.randn(b, lq, h, d, generator=gen, device="cuda").to(dtype)
    _, m, s = tattn.attention_lse_fwd(q, k, v, d**-0.5)
    dqkv = torch.zeros(b, max(lq, lk), 3 * c, device="cuda", dtype=dtype)
    out = (dqkv[:, :lq, :c].view(b, lq, h, d),
           dqkv[:, :lk, c:2 * c].view(b, lk, h, d), dqkv[:, :lk, 2 * c:].view(b, lk, h, d))
    n = tattn.attention_lse_bwd.launches
    got = tattn.attention_lse_bwd(q, k, v, do, m, s, d**-0.5, out=out)
    torch.cuda.synchronize()
    assert tattn.attention_lse_bwd.launches == n + 1
    assert all(g.data_ptr() == o.data_ptr() for g, o in zip(got, out))
    ref = tattn.attention_lse_bwd_ref(q, k, v, do, m, s, d**-0.5)
    for g, r in zip(got, ref):
        assert torch.isfinite(g.float()).all()
        _close_to_max(g, r, BWD_RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(65536, 384), (13, 128), (300, 1024), (129, 512)])
def test_layernorm_backward_kernel_matches_plain_version(cuda, dtype, rows, c):
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (2 * torch.randn(rows, c, generator=gen, device="cuda") + 0.5).to(dtype)
    dy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
    g = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    n = tln.layer_norm_bwd.launches
    dx, dg, db = tln.layer_norm_bwd(x, g, dy, 1e-6)
    torch.cuda.synchronize()
    assert tln.layer_norm_bwd.launches == n + 1 and dx.dtype == dtype
    rdx, rdg, rdb = tln._ln_bwd_ref(x, g, dy, 1e-6)
    torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dtype])
    # fp32 column sums over the rows in another order
    _close_to_max(dg, rdg, 1e-5)
    _close_to_max(db, rdb, 1e-5)


@pytest.mark.cuda
def test_backward_wrappers_refuse_what_they_cannot_take(cuda):
    q = torch.zeros(1, 128, 2, 48, device="cuda")  # head_dim 48
    ms = torch.ones(1, 128, 2, device="cuda")
    with pytest.raises(ValueError):
        tattn.attention_lse_bwd(q, q, q, q, ms, ms, 0.1)
    q = torch.zeros(1, 128, 2, 64, device="cuda")
    with pytest.raises(ValueError):  # m, s must be fp32
        tattn.attention_lse_bwd(q, q, q, q, ms.half(), ms.half(), 0.1)
    with pytest.raises(TypeError):
        tattn.attention_lse_bwd(*(q.double(),) * 4, ms, ms, 0.1)
    x = torch.zeros(8, 256, device="cuda")
    with pytest.raises(ValueError):  # dy not contiguous
        tln.layer_norm_bwd(x[:, :128], torch.ones(128), x[:, 128:], 1e-6)
    with pytest.raises(TypeError):
        tln.layer_norm_bwd(x, torch.ones(256), x.bfloat16(), 1e-6)
    with pytest.raises(ValueError):
        tln.layer_norm_bwd(torch.zeros(8, 96, device="cuda"), torch.ones(96),
                           torch.zeros(8, 96, device="cuda"), 1e-6)


@pytest.mark.cuda
def test_block_backward_reaches_every_parameter_through_the_kernels(cuda):
    """A ViT block's backward on the card goes through both kernel pairs
    and gives every parameter a finite gradient."""
    torch.manual_seed(0)
    blk = Block(384, 6, qkv_bias=True, dtype=torch.bfloat16).cuda()
    x = torch.randn(2, 256, 384, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    counts = (tattn.attention_lse_bwd.launches, tln.layer_norm_bwd.launches)
    blk(x).float().square().mean().backward()
    torch.cuda.synchronize()
    assert (tattn.attention_lse_bwd.launches, tln.layer_norm_bwd.launches) == (
        counts[0] + 1, counts[1] + 2)
    for name, p in list(blk.named_parameters()) + [("x", x)]:
        assert p.grad is not None and torch.isfinite(p.grad.float()).all(), name


# the opt-in kernels: the recompute attention pair and the column sum


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bf16_exp", [(torch.float32, False), (torch.bfloat16, False),
                                            (torch.bfloat16, True)])
@pytest.mark.parametrize("b,lq,lk,h,d", [
    (256, 256, 256, 6, 64),  # the pretrain step's sequences, ViT-S heads
    (3, 200, 130, 2, 32),    # ragged query block and key chunk
    (2, 128, 320, 4, 128),   # widest head the kernel takes
])
def test_recompute_attention_fwd_matches_plain_version(cuda, monkeypatch, dtype, bf16_exp,
                                                        b, lq, lk, h, d):
    """`attention_fwd` on strided column slices (`_assert_fwd_close`).  Without
    BF16_EXP its output is the stored-statistics kernel's bit for bit (one
    body, the same sums)."""
    monkeypatch.setattr(tattn, "BF16_EXP", bf16_exp)
    gen = torch.Generator(device="cuda").manual_seed(4)
    c = h * d
    q = torch.randn(b, lq, 3 * c, generator=gen, device="cuda").to(dtype)[..., :c].view(b, lq, h, d)
    kv = torch.randn(b, lk, 3 * c, generator=gen, device="cuda").to(dtype)
    k, v = (kv[..., i * c:(i + 1) * c].view(b, lk, h, d) for i in (1, 2))
    n = tattn.attention_fwd.launches
    o = tattn.attention_fwd(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert tattn.attention_fwd.launches == n + 1 and o.dtype == dtype
    ref = tattn.attention_fwd_ref(q, k, v, d**-0.5)
    _assert_fwd_close(o, ref, dtype, bf16_exp)
    if not bf16_exp:
        assert torch.equal(o, tattn.attention_lse_fwd(q, k, v, d**-0.5)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,h,d", [
    (256, 256, 256, 6, 64),
    (3, 200, 130, 2, 32),
    (2, 128, 320, 4, 128),
])
def test_recompute_attention_bwd_matches_plain_version(cuda, dtype, b, lq, lk, h, d):
    """`attention_bwd` writing into the column slices of one packed
    gradient, against its plain version (`BWD_RTOL`), and against the
    stored-statistics backward on the same inputs.  The two are equal bit
    for bit in both dtypes: the dq pass takes m and s from the forward's
    logits (one device function in bf16, the same FMA order in fp32), in
    the forward's order."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    c = h * d
    qkv = torch.randn(b, lq, 3 * c, generator=gen, device="cuda").to(dtype)
    kv = torch.randn(b, lk, 3 * c, generator=gen, device="cuda").to(dtype)
    q = qkv[..., :c].view(b, lq, h, d)
    k, v = (kv[..., i * c:(i + 1) * c].view(b, lk, h, d) for i in (1, 2))
    do = torch.randn(b, lq, h, d, generator=gen, device="cuda").to(dtype)
    dqkv = torch.zeros(b, max(lq, lk), 3 * c, device="cuda", dtype=dtype)
    out = (dqkv[:, :lq, :c].view(b, lq, h, d),
           dqkv[:, :lk, c:2 * c].view(b, lk, h, d), dqkv[:, :lk, 2 * c:].view(b, lk, h, d))
    n = tattn.attention_bwd.launches
    got = tattn.attention_bwd(q, k, v, do, d**-0.5, out=out)
    torch.cuda.synchronize()
    assert tattn.attention_bwd.launches == n + 1
    assert all(g.data_ptr() == o.data_ptr() for g, o in zip(got, out))
    for g, r in zip(got, tattn.attention_bwd_ref(q, k, v, do, d**-0.5)):
        assert torch.isfinite(g.float()).all()
        _close_to_max(g, r, BWD_RTOL[dtype])
    _, m, s = tattn.attention_lse_fwd(q, k, v, d**-0.5)
    for g, r in zip(got, tattn.attention_lse_bwd(q, k, v, do, m, s, d**-0.5)):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(65536, 1536), (65836, 1536), (1024, 256), (1100, 392),
                                 (513, 8)])
def test_column_sum_kernel_matches_plain_version(cuda, dtype, n, c):
    """fp32 column sums over 512-row chunks (the last one ragged) against
    the plain fp32 sum: the same values summed in another order, ~1e-6 of
    the largest sum."""
    from dig_tpu_torch.ops import fused_dense as tfd

    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(n, c, generator=gen, device="cuda").to(dtype)
    k = tfd.column_sum.launches
    got = tfd.column_sum(x)
    torch.cuda.synchronize()
    assert tfd.column_sum.launches == k + 1 and got.dtype == torch.float32
    _close_to_max(got, tfd.column_sum_ref(x), 1e-5)
    assert torch.equal(got, tfd.column_sum(x))  # no atomics: the same every run


@pytest.mark.cuda
def test_opt_in_wrappers_refuse_what_they_cannot_take(cuda):
    from dig_tpu_torch.ops import fused_dense as tfd

    with pytest.raises(ValueError):
        tfd.column_sum(torch.zeros(2048, 12, device="cuda", dtype=torch.bfloat16))  # 12 % 8
    with pytest.raises(ValueError):
        tfd.column_sum(torch.zeros(2048, 512, device="cuda")[:, :256])  # not contiguous
    with pytest.raises(TypeError):
        tfd.column_sum(torch.zeros(2048, 256, device="cuda", dtype=torch.float16))
    q = torch.zeros(1, 128, 2, 48, device="cuda")  # head_dim 48
    with pytest.raises(ValueError):
        tattn.attention_fwd(q, q, q, 0.1)
    with pytest.raises(ValueError):
        tattn.attention_bwd(q, q, q, q, 0.1)


@pytest.mark.cuda
def test_block_backward_under_the_switches_goes_through_the_opt_in_kernels(cuda, monkeypatch):
    """A ViT block at 4 x 256 = 1,024 rows under DIG_TPU_ATTN_STORE_LSE=0
    and DIG_TPU_FUSED_BIAS_GRAD=1: the recompute pair and the column sum,
    not the stored-statistics pair, and a finite gradient everywhere."""
    from dig_tpu_torch.ops import fused_dense as tfd

    monkeypatch.setenv("DIG_TPU_ATTN_STORE_LSE", "0")
    monkeypatch.setenv("DIG_TPU_FUSED_BIAS_GRAD", "1")
    torch.manual_seed(0)
    blk = Block(384, 6, qkv_bias=True, dtype=torch.bfloat16).cuda()
    x = torch.randn(4, 256, 384, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    fns = (tattn.attention_fwd, tattn.attention_bwd, tfd.column_sum, tattn.attention_lse_fwd,
           tattn.attention_lse_bwd)
    before = [f.launches for f in fns]
    blk(x).float().square().mean().backward()
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 1, 0, 0]
    for name, p in list(blk.named_parameters()) + [("x", x)]:
        assert p.grad is not None and torch.isfinite(p.grad.float()).all(), name


# the forward bodies at the edges of what the wrapper takes

def _longest_lk(d):
    """The longest Lk the forward wrapper accepts at head_dim d."""
    lk = 1
    while tattn._smem_bytes(d, lk + 1) <= tattn._SMEM_LIMIT:
        lk += 1
    return lk


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lse-float32", "lse-bfloat16", "fwd-float32", "fwd-bfloat16",
                                     "fwd-bfloat16-exp"])
@pytest.mark.parametrize("case", ["longest-d32", "longest-d64", "longest-d128", "lk130", "skewed"])
def test_attention_fwd_bodies_at_their_edges(cuda, monkeypatch, variant, case):
    """#3 and #1 (both modes) against their plain versions
    (`_assert_fwd_close`; m and s within 1e-4): at the longest Lk the wrapper takes at each head_dim
    (b=1, lq=128, h=2), at an Lk that is no multiple of 16 with a ragged
    query block, and with q scaled x16, so that most exponentials of a row
    underflow and one or two keys carry it."""
    kind, dn, *exp = variant.split("-")
    dtype, bf16_exp = getattr(torch, dn), bool(exp)
    if case.startswith("longest"):
        d = int(case.split("-d")[1])
        b, lq, lk, h = 1, 128, _longest_lk(d), 2
    elif case == "lk130":
        b, lq, lk, h, d = 2, 77, 130, 3, 64
    else:
        b, lq, lk, h, d = 2, 256, 256, 2, 64
    monkeypatch.setattr(tattn, "BF16_EXP", bf16_exp)
    gen = torch.Generator(device="cuda").manual_seed(7)
    c = h * d
    q = torch.randn(b, lq, 3 * c, generator=gen, device="cuda") * (16 if case == "skewed" else 1)
    q = q.to(dtype)[..., :c].view(b, lq, h, d)
    kv = torch.randn(b, lk, 3 * c, generator=gen, device="cuda").to(dtype)
    k, v = (kv[..., i * c:(i + 1) * c].view(b, lk, h, d) for i in (1, 2))
    scale = d**-0.5
    if kind == "lse":
        o, m, s = tattn.attention_lse_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        ro, rm, rs = tattn.attention_lse_fwd_ref(q, k, v, scale)
        torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-4)
    else:
        o = tattn.attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        ro = tattn.attention_fwd_ref(q, k, v, scale)
        if not bf16_exp:
            assert torch.equal(o, tattn.attention_lse_fwd(q, k, v, scale)[0])
    assert o.shape == (b, lq, h, d) and o.dtype == dtype and torch.isfinite(o.float()).all()
    _assert_fwd_close(o, ro, dtype, bf16_exp)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lse", "fwd", "fwd-exp"])
@pytest.mark.parametrize("fault", ["row stride", "base address"])
def test_bf16_forward_refuses_misaligned_rows(cuda, monkeypatch, variant, fault):
    """The bf16 body copies whole rows in 16-byte pieces: a row stride that
    is no multiple of 8 elements, or a base that is not 16-byte aligned, is
    refused with a ValueError before any launch."""
    c = 2 * 64
    if fault == "row stride":
        x = torch.zeros(2, 128, 3 * c + 4, device="cuda", dtype=torch.bfloat16)
    else:
        x = torch.zeros(2 * 128 * 3 * c + 4, device="cuda", dtype=torch.bfloat16)[4:]
        x = x.view(2, 128, 3 * c)
    q, k, v = (x[..., i * c:(i + 1) * c].view(2, 128, 2, 64) for i in range(3))
    monkeypatch.setattr(tattn, "BF16_EXP", variant == "fwd-exp")
    fn = tattn.attention_lse_fwd if variant == "lse" else tattn.attention_fwd
    n = fn.launches
    with pytest.raises(ValueError, match="16-byte"):
        fn(q, k, v, 0.125)
    assert fn.launches == n


# the backward bodies at the edges of what the wrapper takes

def _longest_bwd_lk(d):
    """The longest Lk the backward wrappers accept at head_dim d."""
    lk = 1
    while tattn._fits(d, lk + 1):
        lk += 1
    return lk


def _bwd_inputs(b, lq, lk, h, d, dtype, seed, q_gain=1.0):
    """q, k, v as strided column slices of packed projections, a contiguous
    do, and the column slices of one packed gradient to write into."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = h * d
    q = (torch.randn(b, lq, 3 * c, generator=gen, device="cuda") * q_gain).to(dtype)[..., :c]
    q = q.view(b, lq, h, d)
    kv = torch.randn(b, lk, 3 * c, generator=gen, device="cuda").to(dtype)
    k, v = (kv[..., i * c:(i + 1) * c].view(b, lk, h, d) for i in (1, 2))
    do = torch.randn(b, lq, h, d, generator=gen, device="cuda").to(dtype)
    dqkv = torch.zeros(b, max(lq, lk), 3 * c, device="cuda", dtype=dtype)
    out = (dqkv[:, :lq, :c].view(b, lq, h, d),
           dqkv[:, :lk, c:2 * c].view(b, lk, h, d), dqkv[:, :lk, 2 * c:].view(b, lk, h, d))
    return q, k, v, do, out


BWD_EDGES = {
    "longest-d32": lambda: (1, 128, _longest_bwd_lk(32), 2, 32),
    "longest-d64": lambda: (1, 128, _longest_bwd_lk(64), 2, 64),
    "longest-d128": lambda: (1, 128, _longest_bwd_lk(128), 2, 128),
    "lk130": lambda: (2, 77, 130, 3, 64),        # ragged query block, Lk no multiple of 16
    "lq-longer": lambda: (2, 320, 192, 2, 64),   # Lq != Lk, whole blocks
    "lk-longer-d32": lambda: (2, 130, 300, 3, 32),
    "lq-longer-d128": lambda: (1, 200, 129, 2, 128),
    "one-block": lambda: (3, 50, 40, 2, 64),     # one query block and one key block
    "skewed": lambda: (2, 256, 256, 2, 64),      # q x 16: one or two keys carry a row
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BWD_EDGES))
def test_attention_bwd_bodies_at_their_edges(cuda, dtype, case):
    """#4 and #2 against their plain versions (`BWD_RTOL`), every gradient
    finite; #2 equal to #4 bit for bit; a second launch of each on the same
    inputs gives the same bits (no atomics)."""
    b, lq, lk, h, d = BWD_EDGES[case]()
    scale = d**-0.5
    q, k, v, do, out = _bwd_inputs(b, lq, lk, h, d, dtype, 8, 16.0 if case == "skewed" else 1.0)
    _, m, s = tattn.attention_lse_fwd(q, k, v, scale)
    lse = [g.clone() for g in tattn.attention_lse_bwd(q, k, v, do, m, s, scale, out=out)]
    torch.cuda.synchronize()
    for g, r in zip(lse, tattn.attention_lse_bwd_ref(q, k, v, do, m, s, scale)):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        _close_to_max(g, r, BWD_RTOL[dtype])
    rec = tattn.attention_bwd(q, k, v, do, scale)
    for g, r in zip(rec, tattn.attention_bwd_ref(q, k, v, do, scale)):
        assert torch.isfinite(g.float()).all()
        _close_to_max(g, r, BWD_RTOL[dtype])
    again = tattn.attention_lse_bwd(q, k, v, do, m, s, scale)
    for a, g, r in zip(lse, rec, again):
        assert torch.equal(a, g), "attention_bwd differs from attention_lse_bwd"
        assert torch.equal(a, r), "attention_lse_bwd changed between launches"
    for g, r in zip(rec, tattn.attention_bwd(q, k, v, do, scale)):
        assert torch.equal(g, r), "attention_bwd changed between launches"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lse", "bwd"])
@pytest.mark.parametrize("tensor", ["q", "k", "v", "do", "dq", "dk", "dv"])
@pytest.mark.parametrize("fault", ["row stride", "base address"])
def test_bf16_backward_refuses_misaligned_rows(cuda, variant, tensor, fault):
    """The bf16 body copies and stores whole rows in 16-byte pieces: an
    operand or a gradient whose row stride is no multiple of 8 elements, or
    whose base is not 16-byte aligned, is refused with a ValueError before
    any launch."""
    b, l, h, d = 2, 128, 2, 64
    c = h * d
    ts = {n: torch.zeros(b, l, c, device="cuda", dtype=torch.bfloat16).view(b, l, h, d)
          for n in ("q", "k", "v", "do", "dq", "dk", "dv")}
    if fault == "row stride":
        bad = torch.zeros(b, l, c + 4, device="cuda", dtype=torch.bfloat16)[..., :c]
    else:
        bad = torch.zeros(b * l * c + 4, device="cuda", dtype=torch.bfloat16)[4:].view(b, l, c)
    ts[tensor] = bad.view(b, l, h, d)
    out = (ts["dq"], ts["dk"], ts["dv"])
    ms = torch.ones(b, l, h, device="cuda")
    fn = tattn.attention_lse_bwd if variant == "lse" else tattn.attention_bwd
    n = fn.launches
    with pytest.raises(ValueError, match="16-byte"):
        if variant == "lse":
            fn(ts["q"], ts["k"], ts["v"], ts["do"], ms, ms, 0.125, out=out)
        else:
            fn(ts["q"], ts["k"], ts["v"], ts["do"], 0.125, out=out)
    assert fn.launches == n
