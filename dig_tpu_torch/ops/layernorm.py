"""LayerNorm: Hopper CUDA kernels (forward and backward) and their plain
PyTorch versions.

Counterpart of `dig_tpu/ops/layernorm.py`.  `layer_norm` takes the kernel
pair under the JAX package's gate (`_use_pallas_ln`: c % 128 == 0, at
least 512 rows and a multiple of 512), so the same LayerNorms take it as
on the TPU: `norm1`/`norm2` of every ViT `Block`, on the predict path and
in both branches of the pre-training step.  It goes through an autograd
Function whose forward is `layer_norm_fwd` and whose backward is
`layer_norm_bwd` (the `jax.custom_vjp` of `_pallas_ln`).  What the CUDA
kernels accept narrows the gate further: c <= 1024 and a float32 or
bfloat16 input.  Semantics match `flax.linen.LayerNorm` up to the
variance form (see `csrc/layernorm_fwd.cu`): fp32 statistics, biased
variance, eps inside the rsqrt.
"""

from __future__ import annotations

import ctypes
import functools

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


def _ln_bwd_ref(x, gamma, dy, eps):
    """Plain version of the backward kernel (`_ln_bwd_kernel`,
    `dig_tpu/ops/layernorm.py:54-71`) with the two-pass variance of the
    forward: dx = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)) in x's
    dtype, dgamma = sum(dy * xhat) and dbeta = sum(dy) over all rows in
    gamma's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dyf = x.to(acc), dy.to(acc)
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (xf - mu) * rstd
    dyg = dyf * gamma.to(acc)
    dx = rstd * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    c = x.shape[-1]
    dgamma = (dyf * xhat).reshape(-1, c).sum(0)
    dbeta = dyf.reshape(-1, c).sum(0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


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


def _bwd_lib():
    lib = _build.load("layernorm_bwd")
    fn = lib.dig_ln_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dig_ln_bwd_blocks.argtypes = [ctypes.c_int] * 3
        lib.dig_ln_bwd_blocks.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_blocks(device_index: int, dtype_code: int, rows: int, c: int) -> int:
    """Blocks of the backward kernel's persistent grid on this device (SM
    count x the occupancy the runtime reports, at most one warp per row):
    the number of partial rows its scratch holds.  Asked of the library,
    once per device, dtype and shape; it takes the place of `_BWD_ROWS`, the
    fixed 128 rows per block this module once mirrored from the kernel."""
    lib = _bwd_lib()
    blocks = lib.dig_ln_bwd_blocks(dtype_code, rows, c)
    _build.check(lib, max(-blocks, 0), "layer_norm_bwd (grid size)")
    return blocks


def layer_norm_bwd(x, gamma, dy, eps: float):
    """Kernel wrapper: the LayerNorm backward over the last axis of `x` ->
    (dx in x's dtype, dgamma, dbeta in gamma's dtype).  A CPU tensor takes
    `_ln_bwd_ref`; a CUDA tensor launches `csrc/layernorm_bwd.cu`, whose C
    entry writes dx and one fp32 partial dgamma, dbeta row per block of its
    persistent grid into a scratch tensor and then sums the partial rows
    itself (the JAX package sums its kernel's per-block partials outside
    the kernel, `dig_tpu/ops/layernorm.py:135-137`)."""
    if x.device.type == "cpu":
        return _ln_bwd_ref(x, gamma, dy, eps)
    c = x.shape[-1]
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"layer_norm_bwd: unsupported dtypes {x.dtype}, {dy.dtype}")
    if c % 128 or c > _MAX_C or dy.shape != x.shape:
        raise ValueError(f"layer_norm_bwd: needs c % 128 == 0, c <= {_MAX_C} and dy shaped "
                         f"like x, got {x.shape}, {dy.shape}")
    for name, t in (("x", x), ("dy", dy)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"layer_norm_bwd: {name} must be contiguous and 16-byte aligned")
    g = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    if g.shape != (c,):
        raise ValueError(f"layer_norm_bwd: gamma must be [{c}]")
    rows = x.numel() // c
    if rows == 0:
        zeros = torch.zeros(c, dtype=gamma.dtype, device=x.device)
        return torch.empty_like(x), zeros, zeros.clone()
    blocks = _bwd_blocks(x.device.index, _DTYPES[x.dtype], rows, c)
    dx = torch.empty_like(x)
    part = torch.empty((blocks, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = _bwd_lib()
    code = lib.dig_ln_bwd(_DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), dy.data_ptr(),
                          dx.data_ptr(), out.data_ptr(), part.data_ptr(), blocks, rows, c,
                          float(eps), _build.stream_ptr(x))
    _build.check(lib, code, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    dgamma, dbeta = out.unbind(0)
    return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


layer_norm_bwd.launches = 0


class _LayerNormFn(torch.autograd.Function):
    """LayerNorm with the kernel pair's backward (the `jax.custom_vjp` at
    `dig_tpu/ops/layernorm.py:99-140`): saves x and gamma, recomputes the
    statistics in the backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        return (*layer_norm_bwd(x, gamma, dy.contiguous(), ctx.eps), None)


def _use_kernel_ln(x) -> bool:
    c = x.shape[-1]
    rows = x.numel() // c
    return (c % 128 == 0 and c <= _MAX_C and x.dtype in _DTYPES
            and rows >= _ROW_BLOCK and rows % _ROW_BLOCK == 0)


def layer_norm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis: the kernel pair where the shape
    passes the gate, the plain version (plain autograd) otherwise."""
    if _use_kernel_ln(x):
        return _LayerNormFn.apply(x, gamma, beta, eps)
    return _ln_ref(x, gamma, beta, eps)
