"""Lazy-v pooling over the int8 feature payload, and the attended
features of the same operands.

``pool_int8`` is the counterpart of ``vqa_tpu/ops/pallas/lazyv_pool.py``
``pool_int8``; both CUDA kernels are in ``vqa_tpu_torch/csrc/lazyv_pool.cu``:

    v_sum[b, d] = sum_n w[b, n] * x_q[b, n, d]      (w = att * img_scale)
    v[b, n, d] = att[b, n] * (x_q[b, n, d] * img_scale[b, n])

``pool_int8`` reads the int8 payload once and never forms the [B, N, D]
product; its product and sum are f32, the output is ``w``'s dtype.
``attended_int8`` forms that product in bf16 in one pass over the payload,
rounded where eager PyTorch rounds it (the dequantized features, then the
product), so its bits are PyTorch's; it has no Pallas counterpart, since
XLA fuses the same chain by itself.
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


# the attended features' kernel indexes 16-byte vectors with 32 bits
_MAX_VECTORS = 2 ** 31


def attended_int8_reference(att: torch.Tensor, scale: torch.Tensor,
                            x_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``att[..., None] * (x_q.to(scale.dtype) *
    scale[..., None])``, the dequantized features in the scale's dtype,
    then the product."""
    return att[..., None] * (x_q.to(scale.dtype) * scale[..., None])


def _attended_rules(b: int, n: int, d: int, att_dtype: torch.dtype,
                    scale_dtype: torch.dtype) -> None:
    if d % _VEC:
        raise ValueError(f"attended_int8: D={d} is not a multiple of {_VEC}")
    if b * n * d // _VEC >= _MAX_VECTORS:
        raise ValueError(f"attended_int8: [{b}, {n}, {d}] holds 2**31 or "
                         f"more vectors of {_VEC}")
    _build.check_dtype("attended_int8", "att", att_dtype, torch.bfloat16)
    _build.check_dtype("attended_int8", "scale", scale_dtype, torch.bfloat16)


def supports_attended(b: int, n: int, d: int, att_dtype: torch.dtype,
                      scale_dtype: torch.dtype) -> bool:
    """Whether the kernel takes weights [b, n] of ``att_dtype`` and scales
    [b, n] of ``scale_dtype`` over an int8 payload [b, n, d]."""
    return _build.holds(_attended_rules, b, n, d, att_dtype, scale_dtype)


def attended_int8(att: torch.Tensor, scale: torch.Tensor,
                  x_q: torch.Tensor) -> torch.Tensor:
    """att [B, N], scale [B, N] float, x_q [B, N, D] int8 -> [B, N, D].

    CPU tensors run :func:`attended_int8_reference`. CUDA tensors launch
    the kernel, which takes bf16 ``att`` and ``scale`` and D a multiple of
    16 (:func:`supports_attended`) and writes bf16; anything else raises.
    """
    if att.device.type == "cpu":
        return attended_int8_reference(att, scale, x_q)
    b, n, d = x_q.shape
    if att.shape != (b, n) or scale.shape != (b, n):
        raise ValueError(f"attended_int8: shapes att {tuple(att.shape)}, "
                         f"scale {tuple(scale.shape)}, x_q {tuple(x_q.shape)}")
    _attended_rules(b, n, d, att.dtype, scale.dtype)
    for name, t, dt in (("att", att, torch.bfloat16),
                        ("scale", scale, torch.bfloat16),
                        ("x_q", x_q, torch.int8)):
        _build.check_operand("attended_int8", name, t, dt, att.device)
    if x_q.data_ptr() % 16:
        raise ValueError("attended_int8: x_q must be 16-byte aligned")
    out = torch.empty((b, n, d), dtype=torch.bfloat16, device=att.device)
    _build.launch("attended_int8", "attended_int8_forward", att.device, att,
                  scale, x_q, out, b, n, d)
    return out
