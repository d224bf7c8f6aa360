"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without a card.  This file imports neither JAX
nor `dig_tpu`, so it runs on the card's machine, which has no JAX:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q -m cuda

Tolerances as in chip_smoke.py: fp32 results agree to a few ulp (the same
products summed in another order); a bf16 output may round to the
neighbouring bf16 value (at most 2^-7 of the value)."""

import pytest
import torch

from dig_tpu_torch.ops import attention as tattn
from dig_tpu_torch.ops import layernorm as tln


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")


TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2**-7, atol=1e-4)}


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
    torch.testing.assert_close(o.float(), ro.float(), **TOL[dtype])
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
