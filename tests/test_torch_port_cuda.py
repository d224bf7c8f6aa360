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
    (2, 128, 320, 4, 128),  # widest head and longest Lk the fp32 dq pass fits
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
@pytest.mark.parametrize("rows,c", [
    (13, 128), (300, 1024), (129, 512),  # fewer rows than the grid has warps, ragged
    *[(rows, c) for rows in (512, 1000, 65536) for c in (128, 384, 1024)],
])
def test_layernorm_backward_kernel_matches_plain_version(cuda, dtype, rows, c):
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (2 * torch.randn(rows, c, generator=gen, device="cuda") + 0.5).to(dtype)
    dy = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
    g = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    n = tln.layer_norm_bwd.launches
    dx, dg, db = tln.layer_norm_bwd(x, g, dy, 1e-6)
    torch.cuda.synchronize()
    assert tln.layer_norm_bwd.launches == n + 1 and dx.dtype == dtype
    assert dg.shape == db.shape == (c,) and dg.dtype == db.dtype == g.dtype
    rdx, rdg, rdb = tln._ln_bwd_ref(x, g, dy, 1e-6)
    torch.testing.assert_close(dx.float(), rdx.float(), **TOL[dtype])
    # fp32 column sums over the rows in another order
    _close_to_max(dg, rdg, 1e-5)
    _close_to_max(db, rdb, 1e-5)
    # no atomics, fixed orders: a second call gives the same bits
    for a, b in zip((dx, dg, db), tln.layer_norm_bwd(x, g, dy, 1e-6)):
        assert torch.equal(a, b)


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
    for bit in both dtypes: the first pass takes m and s from the forward's
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


# the bf16 forward body's tile walk and tensor maps

def _packed_qkv(b, l, h, d, gen, row_pad=0, extra_rows=0):
    """q, k, v at column offsets 0, C and 2C of one packed bf16 projection;
    its rows row_pad elements longer than 3C and its batch extra_rows rows
    longer than L, so that the row and batch strides are not the natural
    ones."""
    c = h * d
    x = torch.randn(b, l + extra_rows, 3 * c + row_pad, generator=gen, device="cuda")
    x = x.bfloat16()[:, :l]
    return [x[..., i * c:(i + 1) * c].view(b, l, h, d) for i in range(3)]


FWD_WALK = {
    # each key tile raises every row's max: logits grow with the key's index
    "rising-keys": (2, 256, 2, 64, "rising"),
    "rising-keys-l281": (2, 281, 2, 64, "rising"),  # a fifth, ragged tile beyond the four kept
    "seq-cls": (256, 281, 12, 64, "packed"),  # the sequence-class encoder's attention
    "packed-offsets": (3, 256, 4, 64, "packed"),  # q, k, v at columns 0, C, 2C of one tensor
    "padded-strides": (3, 200, 2, 64, "padded"),  # row stride 3C + 8, batch stride 205 rows
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FWD_WALK))
def test_bf16_forward_tile_walk_and_tensor_maps(cuda, monkeypatch, case):
    """#3 and #1 (both modes) against their plain versions
    (`_assert_fwd_close`; m and s within 1e-4), #1's o equal to #3's and #2
    equal to #4 bit for bit: with keys whose logits rise tile by tile (the
    row max moves with every tile the body takes), at the sequence-class
    shape (B=256, L=281, H=12: four key tiles held, a fifth swept twice),
    and with q, k, v read by the tensor maps from one packed tensor at
    column offsets 0, C and 2C, with natural and with padded strides."""
    b, l, h, d, kind = FWD_WALK[case]
    gen = torch.Generator(device="cuda").manual_seed(9)
    if kind == "rising":
        # logits rise by ~2 from one 64-key tile to the next (a steeper ramp
        # makes one or two keys carry each row, where the flipped roundings
        # of the plain version's other sum order exceed FLIP_SHARE in the
        # earlier mma.sync body as in this one)
        u = torch.randn(d, generator=gen, device="cuda")
        q = u + 0.3 * torch.randn(b, l, h, d, generator=gen, device="cuda")
        ramp = torch.linspace(-0.5, 0.5, l, device="cuda").view(1, l, 1, 1)
        k = ramp * u + 0.3 * torch.randn(b, l, h, d, generator=gen, device="cuda")
        v = torch.randn(b, l, h, d, generator=gen, device="cuda")
        q, k, v = (t.bfloat16() for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())[..., :l // 64 * 64]
        tile_max = logits.unflatten(-1, (l // 64, 64)).amax(-1)
        rising = (tile_max[..., 1:] > tile_max[..., :-1]).all(-1)
        assert float(rising.float().mean()) > 0.99  # every whole tile raises the row's max
    elif kind == "packed":
        q, k, v = _packed_qkv(b, l, h, d, gen)
    else:
        q, k, v = _packed_qkv(b, l, h, d, gen, row_pad=8, extra_rows=5)
        assert q.stride()[:2] == (205 * (3 * h * d + 8), 3 * h * d + 8)
    scale = scale_of(d)
    o, m, s = tattn.attention_lse_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    ro, rm, rs = tattn.attention_lse_fwd_ref(q, k, v, scale)
    _assert_fwd_close(o, ro, torch.bfloat16)
    torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-4)
    monkeypatch.setattr(tattn, "BF16_EXP", False)
    assert torch.equal(tattn.attention_fwd(q, k, v, scale), o)
    monkeypatch.setattr(tattn, "BF16_EXP", True)
    _assert_fwd_close(tattn.attention_fwd(q, k, v, scale), tattn.attention_fwd_ref(q, k, v, scale),
                      torch.bfloat16, bf16_exp=True)
    do = torch.randn(b, l, h, d, generator=gen, device="cuda").bfloat16()
    lse = tattn.attention_lse_bwd(q, k, v, do, m, s, scale)
    for g, r in zip(tattn.attention_bwd(q, k, v, do, scale), lse):
        assert torch.equal(g, r), "attention_bwd differs from attention_lse_bwd"


def scale_of(d):
    return d**-0.5


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
    # the Hopper bodies' paths: a ragged fifth key tile past the four
    # resident ones at the seq-cls width, one tensor rank's 3 heads, a
    # ragged L, the resident row pass at D = 32 and the two-sweep one at
    # D = 128 past 4 tiles, a single query row, and more work items than
    # the persistent grid has blocks, with spare warpgroups among them
    "seq-cls": lambda: (4, 281, 281, 12, 64),
    "tensor-split": lambda: (8, 256, 256, 3, 64),
    "ragged-137": lambda: (1, 137, 137, 2, 64),
    "resident-d32": lambda: (2, 256, 256, 2, 32),
    "l281-d128": lambda: (2, 281, 281, 2, 128),
    "one-row": lambda: (2, 1, 129, 1, 64),
    "many-items": lambda: (64, 281, 281, 3, 64),
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


@pytest.mark.cuda
def test_device_view_fn_on_the_card_matches_the_cpu(cuda):
    """The view generator of `--device_aug` on the card against the CPU
    under the same `params` (drawn on the CPU), fp32, on images of noise.
    With the matrices given, the warp's source coordinates are equal to the
    bit on both devices and the warped images agree within 1e-5.  From the
    draws, the devices' cos, sin and tan differ by an ulp or two: up to 2e-5
    pixels at the image's ends, up to 4e-5 in a bilinear sample of noise;
    held at 1e-4.  Masks drawn on the card have exact counts."""
    from dig_tpu_torch.data.device_aug import affine_mats, batched_affine_warp
    from dig_tpu_torch.data.device_aug import draw_augment_params
    from dig_tpu_torch.train.pretrain import make_device_view_fn

    g = torch.Generator().manual_seed(0)
    u8 = torch.randint(0, 256, (64, 32, 128, 3), generator=g, dtype=torch.uint8)
    params = draw_augment_params(g, 64, 32, 128)
    view_fn = make_device_view_fn(256, 0.7, 2)
    cpu = view_fn(torch.Generator().manual_seed(1), u8, params)
    card = view_fn(torch.Generator(device="cuda").manual_seed(1), u8.cuda(), params)
    assert card["aug_images"].is_cuda and card["mask"].is_cuda
    # the card divides by the scalar 255 as a product with its reciprocal: one fp32 ulp
    assert float((card["images"].cpu() - cpu["images"]).abs().max()) <= 2**-23
    err = float((card["aug_images"].cpu() - cpu["aug_images"]).abs().max())
    assert err <= 1e-4, err
    mats = affine_mats(*(params[k] for k in ("angle", "scale", "shear", "tx", "ty")), 32, 128)
    warped = batched_affine_warp(cpu["images"], mats)
    werr = float((batched_affine_warp(cpu["images"].cuda(), mats.cuda()).cpu() - warped).abs().max())
    assert werr <= 1e-5 and not torch.equal(warped, cpu["images"]), werr
    assert not torch.equal(card["aug_images"], card["images"])
    assert card["mask"].shape == (64, 2, 256) and bool((card["mask"].sum(-1) == 179).all())
    again = view_fn(torch.Generator(device="cuda").manual_seed(1), u8.cuda(), params)
    assert torch.equal(again["mask"], card["mask"])


@pytest.mark.cuda
def test_drop_path_with_a_cuda_generator_reaches_every_gradient(cuda):
    """One pre-training step at drop-path 0.5 with the step's generator on
    the card: every student parameter gets a finite gradient, the draw is a
    function of the generator's seed, and the global stream is untouched."""
    import numpy as np

    from dig_tpu_torch.models.moco import build_pretrain_model
    from dig_tpu_torch.optim import create_optimizer
    from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step
    from dig_tpu_torch.utils.rng import step_generator

    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "aug_images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "mask": rng.random((4, 2, 256)) < 0.7}

    def loss(step_index):
        model = build_pretrain_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128", seed=1,
                                     device="cuda", mlp_dim=32, dim=16, num_windows=4,
                                     drop_path_rate=0.5)
        state = init_pretrain_state(model, create_optimizer("adamw", model.named_parameters(),
                                                            [1e-3], [0.05]))
        before = torch.cuda.get_rng_state()
        _, metrics = make_pretrain_step(model, [0.99], [0.1])(
            state, batch, step_generator(1, 0, step_index, "cuda"))
        assert torch.equal(torch.cuda.get_rng_state(), before)
        for name, p in model.named_parameters():
            if p.requires_grad:
                assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert metrics["moco_m"].is_cuda
        return float(metrics["loss"])

    assert loss(0) == loss(0)
    assert loss(0) != loss(1)


@pytest.mark.cuda
def test_decoder_embedding_backward_is_reproducible(cuda):
    """The decoder's char embedding at a fine-tuning batch's 256 x 25 ids:
    the same gradient bits on every call (torch's own CUDA embedding
    backward, sorted above 3,072 ids, is not), close to torch's."""
    from dig_tpu_torch.models.layers import embedding

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(98, 512, device="cuda", generator=gen, requires_grad=True)
    ids = torch.randint(0, 98, (256, 25), device="cuda", generator=gen)
    go = torch.randn(256, 25, 512, device="cuda", generator=gen)
    grads = []
    for _ in range(3):
        w.grad = None
        embedding(w, ids).backward(go)
        grads.append(w.grad.clone())
    assert all(torch.equal(grads[0], g) for g in grads)
    w.grad = None
    torch.nn.functional.embedding(ids, w).backward(go)
    torch.testing.assert_close(grads[0], w.grad, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_masked_attention_and_beam_search_do_not_wait_for_the_card(cuda):
    """A masked reference attention waits for nothing; a beam batch waits
    once, for its stored steps (set_sync_debug_mode counts the waits)."""
    import warnings

    from dig_tpu_torch.models.decoder import create_decoder

    dec = create_decoder("small_tf_decoder", 97, 25).cuda().eval()
    enc = torch.randn(4, 16, 384, device="cuda")
    q = torch.randn(2, 5, 6, 64, device="cuda")
    mask = torch.ones(1, 1, 5, 5, dtype=torch.bool, device="cuda").tril()
    with torch.no_grad():
        dec.beam_search(enc, 2)  # warm-up: caches, the allocator
    torch.cuda.synchronize()
    counts = []
    for call in (lambda: tattn.multi_head_attention(q, q, q, mask=mask),
                 lambda: dec.beam_search(enc, 2)):
        with warnings.catch_warnings(record=True) as caught, torch.no_grad():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counts.append(sum("called a synchronizing" in str(w.message) for w in caught))
    assert counts == [0, 1]


def _micro_steps_fp32(seed=0):
    """One fp32 pre-training step and one fine-tuning step of the micro
    models on the card: (metrics, gradients, parameters after) of each."""
    import numpy as np

    from dig_tpu_torch.models.moco import build_pretrain_model
    from dig_tpu_torch.models.rec_model import build_rec_model
    from dig_tpu_torch.optim import create_optimizer
    from dig_tpu_torch.train.finetune import init_finetune_state, make_finetune_step
    from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step

    rng = np.random.default_rng(seed)
    out = {}
    model = build_pretrain_model("pretrain_simmim_moco_ori_vit_micro_patch4_32x128", mlp_dim=32,
                                 dim=16, num_windows=4, device="cuda", seed=seed)
    state = init_pretrain_state(model, create_optimizer(
        "adamw", model.named_parameters(), [1e-3], [0.05], clip_grad=0.5))
    batch = {"images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "aug_images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "mask": np.stack([np.stack([rng.permutation(256) < 179 for _ in range(2)])
                               for _ in range(4)])}
    state, metrics = make_pretrain_step(model, [0.99], [0.1])(state, batch)
    out["pretrain"] = (metrics, {n: p.grad.clone() for n, p in model.named_parameters()
                                 if p.grad is not None}, model.state_dict())
    model = build_rec_model("vit_micro_patch4_32x128", "small_tf_decoder", device="cuda",
                            seed=seed)
    state = init_finetune_state(model, create_optimizer(
        "adamw", model.named_parameters(), [1e-3], [0.05], clip_grad=0.5, layer_decay=0.75,
        num_layers=2))
    batch = {"images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "targets": rng.integers(0, 94, (4, 25)), "lengths": np.array([5, 25, 1, 9])}
    state, metrics, _ = make_finetune_step(model)(state, batch,
                                                  torch.Generator(device="cuda").manual_seed(0))
    out["finetune"] = (metrics, {n: p.grad.clone() for n, p in model.named_parameters()},
                       model.state_dict())
    return out


@pytest.mark.cuda
def test_nccl_world_1_steps_equal_the_one_process_steps_bit_for_bit(cuda):
    """Both training steps in fp32 with an NCCL group of one rank (the
    gradient reducer, the keys' gather, the statistics' all-reduces and
    AdamW on the reduced gradients all run) against the same steps with no
    group: every metric, gradient and parameter equal (torch.equal)."""
    import socket

    from dig_tpu_torch.parallel import dist as pdist

    alone = _micro_steps_fp32()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = pdist.init_distributed_mode("cuda", rank=0, world_size=1, local_rank=0,
                                       init_method=f"tcp://127.0.0.1:{port}")
    try:
        assert info["backend"] == "nccl" and pdist.get_world_size() == 1
        grouped = _micro_steps_fp32()
    finally:
        pdist.destroy()
    for step in ("pretrain", "finetune"):
        for want, got in zip(alone[step], grouped[step]):
            assert sorted(want) == sorted(got), step
            differ = [k for k in want if not torch.equal(want[k], got[k])]
            assert not differ, f"{step}: {differ[:5]} differ"


def _wide_pretrain_model(remat, drop_path_rate, dtype):
    """A pre-training model of width 128 (2 heads x 64, depth 2): its rows
    reach the LayerNorm kernels, which the micro model's 64 do not."""
    from dig_tpu_torch.models.moco import DiGPretrainModel
    from dig_tpu_torch.models.rec_model import init_weights

    model = DiGPretrainModel(encoder_embed_dim=128, encoder_depth=2, encoder_num_heads=2,
                             mlp_dim=32, dim=16, num_windows=4, remat=remat,
                             drop_path_rate=drop_path_rate, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(3))
    model.reset_momentum()
    return model.cuda().train()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_step_launches_its_counts_and_equals_the_plain_step(cuda, dtype):
    """One pre-training step with `remat` at drop-path 0.1 from one card
    generator: the student's forward kernels launch again for the
    recompute (#3 3 x depth, #5 6 x depth; #4 and #6 as without remat), and
    loss, gradients and parameters equal the plain step's bit for bit (the
    recompute draws the forward's masks and the kernels repeat their bits)."""
    import numpy as np

    from dig_tpu_torch.optim import create_optimizer
    from dig_tpu_torch.train.pretrain import init_pretrain_state, make_pretrain_step

    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "aug_images": rng.integers(0, 256, (4, 32, 128, 3), dtype=np.uint8),
             "mask": rng.random((4, 2, 256)) < 0.7}
    wrappers = (tattn.attention_lse_fwd, tattn.attention_lse_bwd, tln.layer_norm_fwd,
                tln.layer_norm_bwd)
    runs = {}
    for remat in (False, True):
        model = _wide_pretrain_model(remat, 0.1, dtype)
        state = init_pretrain_state(model, create_optimizer("adamw", model.named_parameters(),
                                                            [1e-3], [0.05]))
        before = [w.launches for w in wrappers]
        _, metrics = make_pretrain_step(model, [0.99], [0.1])(
            state, batch, torch.Generator(device="cuda").manual_seed(5))
        torch.cuda.synchronize()
        runs[remat] = dict(launches=[w.launches - b for w, b in zip(wrappers, before)],
                           loss=metrics["loss"].item(),
                           grads=[p.grad.clone() for p in model.parameters() if p.requires_grad],
                           params=[t.clone() for t in model.state_dict().values()])
    assert runs[False]["launches"] == [4, 2, 8, 4]
    assert runs[True]["launches"] == [6, 2, 12, 4]
    assert runs[False]["loss"] == runs[True]["loss"]
    assert all(torch.equal(a, b) for a, b in zip(runs[False]["grads"], runs[True]["grads"]))
    assert all(torch.equal(a, b) for a, b in zip(runs[False]["params"], runs[True]["params"]))


@pytest.mark.cuda
def test_ctc_loss_backward_is_reproducible(cuda):
    """The CTC loss at a fine-tuning batch's shapes (256 sequences, 32
    frames, 98 classes) with labels that hold one id three times or more:
    the same gradient bits on every call (the emit log-probabilities are a
    one-hot product, whose backward is a matrix product)."""
    from dig_tpu_torch.losses.ctc import ctc_step_loss

    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(256, 32, 98, device="cuda", generator=gen)
    targets = torch.randint(0, 8, (256, 26), device="cuda", generator=gen)  # many repeats
    lengths = torch.randint(2, 27, (256,), device="cuda", generator=gen)
    grads = []
    for _ in range(3):
        x = logits.clone().requires_grad_()
        ctc_step_loss(x, targets, lengths, 97).backward()
        grads.append(x.grad)
    assert all(torch.equal(grads[0], g) for g in grads[1:])


@pytest.mark.cuda
def test_conv_patchnet_matches_the_cpu_and_repeats_its_bits(cuda):
    """`ConvPatchNet` in fp32 on the card (`models/layers.py::_exact_conv`:
    no cuDNN, no TF32, forward and backward) against the CPU, within 1e-4 of
    each output's and gradient's max plus 1e-6 of the largest gradient (the
    floor of chip_smoke's card-vs-CPU checks: the biases of the convolutions
    and of the head's first Dense, each followed by a batch norm, have a
    gradient that is zero but for rounding), and bit-equal between calls.
    The loss is a fixed random projection of the output (the sum of its
    squares would be constant: the last norm has no affine)."""
    from dig_tpu_torch.models.moco import ConvPatchNet
    from dig_tpu_torch.models.rec_model import init_weights

    net = ConvPatchNet(128, 4, (8, 32))
    init_weights(net, torch.Generator().manual_seed(0))
    x = torch.randn(16, 256, 128, generator=torch.Generator().manual_seed(1))
    r = torch.randn(16, 1, 128, generator=torch.Generator().manual_seed(2))
    res = {}
    for device in ("cpu", "cuda", "cuda"):
        m = net.to(device)
        m.zero_grad()
        xi = x.detach().clone().to(device).requires_grad_()
        y = m(xi)
        (y * r.to(device)).sum().backward()
        res.setdefault(device, []).append([t.detach().cpu() for t in
                                           [y, xi.grad] + [p.grad for p in m.parameters()]])
    a, b = res["cuda"]
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    cpu = res["cpu"][0]
    floor = 1e-6 * max(float(v.abs().max()) for v in cpu[1:])
    for u, v in zip(a, cpu):
        err = float((u - v).abs().max())
        assert err <= 1e-4 * float(v.abs().max()) + floor, err
