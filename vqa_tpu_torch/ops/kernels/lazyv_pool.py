"""Lazy-v pooling over the int8 feature payload.

Counterpart of ``vqa_tpu/ops/pallas/lazyv_pool.py`` ``pool_int8``; the CUDA
kernel is ``vqa_tpu_torch/csrc/lazyv_pool.cu``:

    v_sum[b, d] = sum_n w[b, n] * x_q[b, n, d]      (w = att * img_scale)

The kernel reads the int8 payload once and never forms the [B, N, D]
product. Product and sum are f32, the output is ``w``'s dtype.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops.kernels import _build

# int8 values each thread loads per box: one 16-byte vector
_VEC = 16


def pool_int8_reference(w: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``einsum('bn,bnd->bd', w, x_q.to(w.dtype))``."""
    return torch.einsum("bn,bnd->bd", w, x_q.to(w.dtype))


def _rules(b: int, n: int, d: int, w_dtype: torch.dtype) -> None:
    if d % _VEC:
        raise ValueError(f"pool_int8: D={d} is not a multiple of {_VEC}")
    _build.check_dtype("pool_int8", "w", w_dtype, torch.bfloat16)


def supports(b: int, n: int, d: int, w_dtype: torch.dtype) -> bool:
    """Whether the kernel takes weights [b, n] of ``w_dtype`` over an int8
    payload [b, n, d]."""
    return _build.holds(_rules, b, n, d, w_dtype)


def pool_int8(w: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """w [B, N] float, x_q [B, N, D] int8 -> [B, D] w.dtype.

    CPU tensors run :func:`pool_int8_reference`. CUDA tensors launch the
    kernel, which takes a bf16 ``w`` and D a multiple of 16
    (:func:`supports`); anything else raises.
    """
    if w.device.type == "cpu":
        return pool_int8_reference(w, x_q)
    b, n, d = x_q.shape
    if w.shape != (b, n):
        raise ValueError(f"pool_int8: shapes w {tuple(w.shape)}, "
                         f"x_q {tuple(x_q.shape)}")
    _rules(b, n, d, w.dtype)
    for name, t, dt in (("w", w, torch.bfloat16), ("x_q", x_q, torch.int8)):
        _build.check_operand("pool_int8", name, t, dt, w.device)
    out = torch.empty((b, d), dtype=w.dtype, device=w.device)
    _build.launch("pool_int8", "pool_int8_forward", w.device, w, x_q, out,
                  b, n, d)
    return out
