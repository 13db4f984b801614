"""int8 GEMMs over quantized activations (counterpart of
``vqa_tpu/ops/quant.py``).

``int8_dot`` computes ``dequant(x_q) @ kernel`` as one int8 GEMM with exact
int32 sums: the kernel is quantized per output column on the fly, and both
scales, the bias and the ReLU go into the GEMM's epilogue,

    y[r, j] = relu((sum_k x_q[r, k] w_q[k, j]) * (x_scale[r] * w_scale[j])
                   -> out_dtype, + bias[j])

in JAX's order. Both of JAX's routes (the fused Pallas kernel and XLA's
int8 dot, bit-identical by construction) run the same hand-written kernel
here: the 3-D entry for a ``use_pallas`` call on [B, G, K] rows, the 2-D
entry on the flattened rows otherwise, as XLA's route flattens them, and
the kernel's plain version where the kernel does not take the shape
(``int8_matmul.supports_3d`` / ``supports``: K a multiple of 32, N of 8),
as JAX falls back to XLA's dot. On CPU tensors the plain version runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from vqa_tpu_torch.ops.kernels import int8_matmul


def quantize_rows(x: torch.Tensor):
    """Dynamic symmetric per-row int8 quantization of [..., in] activations
    -> (x_q int8, x_scale [...] float32). The abs-max is taken in the input
    dtype; the values are multiplied by the reciprocal of the scale (not
    divided by it) and rounded half to even, as in JAX."""
    absmax = torch.amax(torch.abs(x), dim=-1)
    x_scale = torch.clamp(absmax.to(torch.float32) / 127.0, min=1e-8)
    inv = (1.0 / x_scale)[..., None]
    x_q = torch.clamp(torch.round(x.to(torch.float32) * inv), -127, 127)
    return x_q.to(torch.int8), x_scale


def quantize_weight_per_col(kernel: torch.Tensor):
    """Symmetric per-output-column int8 quantization of an [in, out] kernel
    -> (w_q int8 [in, out], w_scale float32 [out]), ``kernel ~= w_q *
    w_scale``. The values are divided by the scale, floored at the f32
    ``tiny``. ``w_q`` is the transpose of a contiguous [out, in] tensor, the
    layout the kernel reads, so its wrapper makes no copy."""
    w = kernel.t().to(torch.float32).contiguous()            # [out, in]
    w_scale = torch.clamp(torch.amax(torch.abs(w), dim=1) / 127.0,
                          min=torch.finfo(torch.float32).tiny)
    w_q = torch.clamp(torch.round(w / w_scale[:, None]), -127, 127)
    return w_q.to(torch.int8).t(), w_scale


def int8_dot(x_q: torch.Tensor, x_scale: torch.Tensor, kernel: torch.Tensor,
             *, out_dtype: Optional[torch.dtype] = None,
             use_pallas: bool = False, bias: Optional[torch.Tensor] = None,
             relu: bool = False) -> torch.Tensor:
    """``dequant(x_q) @ kernel`` as one int8 GEMM.

    x_q [..., in] int8, x_scale [...] float (per-row scales), kernel
    [in, out] float (quantized per output column here). Returns [..., out]
    in ``out_dtype`` (default float32), with ``bias`` (cast to that dtype)
    and the ReLU applied in the epilogue.
    """
    if x_q.dtype != torch.int8:
        raise TypeError(f"int8_dot: x_q must be int8, got {x_q.dtype}")
    w_q, w_scale = quantize_weight_per_col(kernel)
    out_dtype = out_dtype or torch.float32
    if bias is not None:
        bias = bias.to(out_dtype)
    kw = dict(bias=bias, relu=relu, out_dtype=out_dtype)
    n, dts = w_q.shape[1], (x_scale.dtype, out_dtype)
    if use_pallas and x_q.dim() == 3 \
            and int8_matmul.supports_3d(*x_q.shape, n, *dts):
        return int8_matmul.int8_matmul_dequant_3d(x_q, x_scale, w_q,
                                                  w_scale, **kw)
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    x2 = x_q.reshape(-1, k)
    gemm = (int8_matmul.int8_matmul_dequant
            if int8_matmul.supports(*x2.shape, n, *dts)
            else int8_matmul.int8_matmul_dequant_reference)
    y = gemm(x2, x_scale.reshape(-1), w_q, w_scale, **kw)
    return y.reshape(*lead, y.shape[-1])
