"""Dense layer whose backward takes the bias gradient from a column-sum
kernel: the CUDA kernel and its plain PyTorch version.

Counterpart of `dig_tpu/ops/fused_dense.py`.  `FusedBiasGradDense` is the
autograd Function of that module's `_dense_fused`: y = x . W^T + b
forward; backward dx and dW as plain matrix products (the JAX package
leaves them to XLA) and db = `column_sum(dy)` cast to dy's dtype.  `Mlp`
applies it to its `fc1` parameters when `fused_bias_grad_enabled()`, so
the module tree and `state_dict` are the same with the switch on or off.

`column_sum` launches `csrc/colsum.cu` on a CUDA tensor; the JAX
package's own gate (`fused_dense.py:59`) sends fewer than 1,024 rows to
the plain fp32 sum instead (`_bias_grad`).
"""

from __future__ import annotations

import ctypes
import os

import torch

from dig_tpu_torch.ops import _build

_BLOCK_ROWS = 512  # rows per chunk of the kernel (mirrored in csrc/colsum.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_bias_grad_enabled() -> bool:
    """`DIG_TPU_FUSED_BIAS_GRAD`, read at every call (default off)."""
    return os.environ.get("DIG_TPU_FUSED_BIAS_GRAD", "0") == "1"


def column_sum_ref(x):
    """Plain version: the at-least-fp32 sum of a 2-D array over its rows."""
    return x.to(torch.promote_types(x.dtype, torch.float32)).sum(0)


def column_sum(x):
    """Kernel wrapper: fp32 [C] column sums of a 2-D [N, C] array (the
    contract of `column_sum`, `dig_tpu/ops/fused_dense.py:55-71`).  A CPU
    tensor takes `column_sum_ref`; a CUDA tensor launches `csrc/colsum.cu`
    (partial rows over 512-row chunks, then their sum) or raises."""
    if x.device.type == "cpu":
        return column_sum_ref(x)
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise TypeError(f"column_sum: needs a 2-D float32 or bfloat16 array, got "
                        f"{tuple(x.shape)} {x.dtype}")
    n, c = x.shape
    if n == 0 or c % (16 // x.element_size()) or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"column_sum: needs a contiguous, 16-byte aligned [N > 0, C] array "
                         f"with C a multiple of {16 // x.element_size()}, got {tuple(x.shape)}")
    part = torch.empty((-(-n // _BLOCK_ROWS), c), dtype=torch.float32, device=x.device)
    out = torch.empty((c,), dtype=torch.float32, device=x.device)
    lib = _build.load("colsum")
    fn = lib.dig_colsum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(_DTYPES[x.dtype], x.data_ptr(), part.data_ptr(), out.data_ptr(), n, c,
              _build.stream_ptr(x))
    _build.check(lib, code, "column_sum")
    column_sum.launches += 1
    return out


column_sum.launches = 0


def _bias_grad(dy2):
    """db of `_dense_fused_bwd` (`dig_tpu/ops/fused_dense.py:90`): the
    kernel from 2 * 512 rows up, the plain fp32 sum below, cast to dy's
    dtype."""
    if dy2.shape[0] < 2 * _BLOCK_ROWS:
        return column_sum_ref(dy2).to(dy2.dtype)
    return column_sum(dy2).to(dy2.dtype)


class FusedBiasGradDense(torch.autograd.Function):
    """x [..., D_in], weight [D_out, D_in], bias [D_out] (all in the compute
    dtype) -> x . weight^T + bias, with the column-sum bias gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return torch.nn.functional.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1]).contiguous()
        dx = (dy @ weight).to(x.dtype)
        dw = (dy2.t() @ x.reshape(-1, x.shape[-1])).to(weight.dtype)
        return dx, dw, _bias_grad(dy2)


def fused_dense(x, weight, bias, dtype):
    """`FusedBiasGradDense` on fp32 parameters cast to the compute dtype,
    as flax's `nn.Dense(dtype=...)` and the port's `Dense` cast them."""
    return FusedBiasGradDense.apply(x.to(dtype), weight.to(dtype), bias.to(dtype))
