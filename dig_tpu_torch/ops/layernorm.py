"""LayerNorm forward: a Hopper CUDA kernel and its plain PyTorch version.

Counterpart of `dig_tpu/ops/layernorm.py`.  `layer_norm` takes the kernel
under the JAX package's gate (`_use_pallas_ln`: c % 128 == 0, at least 512
rows and a multiple of 512), so the same LayerNorms take it as on the
TPU: `norm1`/`norm2` of every ViT `Block`.  What the CUDA kernel accepts
narrows the gate further: c <= 1024 and a float32 or bfloat16 input.
Semantics match `flax.linen.LayerNorm` up to the variance form (see
`csrc/layernorm_fwd.cu`): fp32 statistics, biased variance, eps inside
the rsqrt.
"""

from __future__ import annotations

import ctypes

import torch

from dig_tpu_torch.ops import _build

_ROW_BLOCK = 512
_MAX_C = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ln_ref(x, gamma, beta, eps):
    """Plain version (`dig_tpu/ops/layernorm.py:35-41`): statistics in at
    least fp32 (float64 stays float64), eps inside the rsqrt."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.to(acc) + beta.to(acc)).to(x.dtype)


def _lib():
    lib = _build.load("layernorm_fwd")
    fn = lib.dig_ln_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def layer_norm_fwd(x, gamma, beta, eps: float):
    """Kernel wrapper: LayerNorm over the last axis of `x` (any leading
    shape), output in x's dtype.  A CPU tensor takes `_ln_ref`; a CUDA
    tensor launches `csrc/layernorm_fwd.cu` or raises."""
    if x.device.type == "cpu":
        return _ln_ref(x, gamma, beta, eps)
    c = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm_fwd: unsupported dtype {x.dtype}")
    if c % 128 or c > _MAX_C:
        raise ValueError(f"layer_norm_fwd: needs c % 128 == 0 and c <= {_MAX_C}, got {c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer_norm_fwd: x must be contiguous and 16-byte aligned")
    g = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    b = beta.to(device=x.device, dtype=torch.float32).contiguous()
    if g.shape != (c,) or b.shape != (c,):
        raise ValueError(f"layer_norm_fwd: gamma/beta must be [{c}]")
    y = torch.empty_like(x)
    lib = _lib()
    code = lib.dig_ln_fwd(_DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), b.data_ptr(),
                          y.data_ptr(), x.numel() // c, c, float(eps),
                          _build.stream_ptr(x))
    _build.check(lib, code, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0


def _use_kernel_ln(x) -> bool:
    c = x.shape[-1]
    rows = x.numel() // c
    return (c % 128 == 0 and c <= _MAX_C and x.dtype in _DTYPES
            and rows >= _ROW_BLOCK and rows % _ROW_BLOCK == 0)


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis: the kernel wrapper where the shape
    passes the gate, the plain version otherwise."""
    if _use_kernel_ln(x):
        return layer_norm_fwd(x, gamma, beta, eps)
    return _ln_ref(x, gamma, beta, eps)
