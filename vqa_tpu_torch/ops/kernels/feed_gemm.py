"""Int8-feed dequant fused into a bf16 GEMM: the int8 feed's v-projection.

Counterpart of ``vqa_tpu/ops/pallas/feed_gemm.py`` ``dequant_matmul``; the
CUDA kernel is ``vqa_tpu_torch/csrc/feed_gemm.cu`` (wgmma m64n256k16 on
bf16 operands in an mbarrier ring: TMA loads w and the int8 x_q, and each
consumer warpgroup dequantizes its rows of an int8 stage into the swizzled
bf16 A that its wgmma read, a persistent grid over 128 x 256 output
tiles). The
dequantized activation ``x_q * scale`` exists only as the GEMM operand, so
the kernel forms it stage by stage in shared memory and never writes it to
device memory.
Rounding follows the TPU kernel: the product ``x_q.to(bf16) * scale.to(bf16)``
is rounded to bf16 before the GEMM, which accumulates in f32; the output is
``w``'s dtype.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops.kernels import _build

# the kernel reads K in 64-deep stages, but x_q's rows need only be whole
# 16-byte TMA rows (TMA zero-fills the last stage past K); it writes column
# pairs of 8-column blocks of the wgmma accumulator; M is any
_K_STEP, _N_STEP = 16, 8


def dequant_matmul_reference(x_q: torch.Tensor, x_scale: torch.Tensor,
                             w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: dequantize, then matmul. x_q [M, K] int8,
    x_scale [M], w [K, N] -> [M, N] w.dtype."""
    x = x_q.to(w.dtype) * x_scale.to(w.dtype)[:, None]
    return torch.matmul(x, w)


def _rules(m: int, k: int, n: int, w_dtype: torch.dtype) -> None:
    if k % _K_STEP or n % _N_STEP:
        raise ValueError(f"dequant_matmul: K={k} must be a multiple of "
                         f"{_K_STEP} and N={n} of {_N_STEP}")
    _build.check_dtype("dequant_matmul", "w", w_dtype, torch.bfloat16)


def supports(m: int, k: int, n: int, w_dtype: torch.dtype) -> bool:
    """Whether the kernel takes x_q [m, k] times a ``w_dtype`` w [k, n]."""
    return _build.holds(_rules, m, k, n, w_dtype)


def dequant_matmul(x_q: torch.Tensor, x_scale: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """``(x_q.to(w.dtype) * x_scale[:, None]) @ w`` without the dequantized
    [M, K] activation in device memory.

    CPU tensors run :func:`dequant_matmul_reference`. CUDA tensors launch the
    kernel, which takes a bf16 ``w``, K a multiple of 16 and N a multiple of
    8 (:func:`supports`), and masks ragged M, N and K; anything else raises.
    The kernel reads the weight as [N, K] (torch's Linear layout): pass
    ``weight.t()`` and no copy is made.
    """
    if x_q.device.type == "cpu":
        return dequant_matmul_reference(x_q, x_scale, w)
    m, k = x_q.shape
    n = w.shape[1]
    if w.shape != (k, n) or x_scale.shape != (m,):
        raise ValueError(f"dequant_matmul: shapes x_q {tuple(x_q.shape)}, "
                         f"x_scale {tuple(x_scale.shape)}, w {tuple(w.shape)}")
    _rules(m, k, n, w.dtype)
    w_nk = w.t().contiguous()
    scale = x_scale.to(w.dtype)
    for name, t, dt in (("x_q", x_q, torch.int8), ("x_scale", scale, w.dtype),
                        ("w", w_nk, torch.bfloat16)):
        _build.check_operand("dequant_matmul", name, t, dt, x_q.device)
    if x_q.data_ptr() % 16:
        raise ValueError("dequant_matmul: x_q must be 16-byte aligned (TMA)")
    out = torch.empty((m, n), dtype=w.dtype, device=x_q.device)
    _build.launch("dequant_matmul", "dequant_matmul_forward", x_q.device,
                  x_q, scale, w_nk, out, m, k, n)
    return out
