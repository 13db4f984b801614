"""int8 x int8 GEMM with exact int32 sums and a fused dequant epilogue.

Counterpart of ``vqa_tpu/ops/pallas/int8_matmul.py`` ``int8_matmul_dequant``
and ``int8_matmul_dequant_3d``; the CUDA kernel is
``vqa_tpu_torch/csrc/int8_matmul.cu`` (wgmma m64n256k32 on s8 operands that
TMA loads into an mbarrier ring, a persistent grid over 128 x 256 output
tiles). Both entries run the one kernel: the 3-D entry is a [B * G, K] view
of its input (a reshape, no copy), as the TPU kernel's ``flatten=True`` is.

    y = (x_q @ w_q) -> f32 * (x_scale.f32 * w_scale) -> out_dtype
        (+ bias in out_dtype) (max 0)

The int32 sums are exact and the epilogue is elementwise in this fixed
order, so the kernel equals its plain version bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from vqa_tpu_torch.ops.kernels import _build

# the kernel reads K in 32-byte steps (one wgmma k32; TMA zero-fills the
# rest of its 128-byte stage) and writes column pairs of 8-column blocks of
# the wgmma accumulator; M is any
_K_STEP, _N_STEP = 32, 8
_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_dequant_reference(x_q: torch.Tensor, x_scale: torch.Tensor,
                                  w_q: torch.Tensor, w_scale: torch.Tensor, *,
                                  bias: Optional[torch.Tensor] = None,
                                  relu: bool = False,
                                  out_dtype: torch.dtype = torch.bfloat16
                                  ) -> torch.Tensor:
    """Plain PyTorch version. x_q [M, K] int8, x_scale [M], w_q [K, N] int8,
    w_scale [N] -> [M, N] ``out_dtype``. The int32 product is formed
    exactly: an int32 matmul on the CPU, an f64 one on the card (no int32
    matmul there; |sum| <= 127**2 * K < 2**53 for any K below 5e11)."""
    if x_q.device.type == "cpu":
        acc = torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32))
    else:
        acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64))
    scale = x_scale.to(torch.float32)[:, None] * w_scale.to(torch.float32)[None, :]
    y = (acc.to(torch.float32) * scale).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    if relu:
        y = torch.relu(y)
    return y


def int8_matmul_dequant_3d_reference(x_q: torch.Tensor, x_scale: torch.Tensor,
                                     w_q: torch.Tensor, w_scale: torch.Tensor,
                                     **kw) -> torch.Tensor:
    """Plain version of the 3-D entry: [B, G, K] -> [B, G, N] by rows."""
    b, g, k = x_q.shape
    y = int8_matmul_dequant_reference(x_q.reshape(b * g, k),
                                      x_scale.reshape(b * g), w_q, w_scale, **kw)
    return y.reshape(b, g, -1)


def _rules(kernel: str, k: int, n: int, xs_dtype: torch.dtype,
           out_dtype: torch.dtype) -> None:
    if k % _K_STEP or n % _N_STEP:
        raise ValueError(f"{kernel}: K={k} must be a multiple of {_K_STEP} "
                         f"and N={n} of {_N_STEP}")
    if out_dtype not in _KINDS or xs_dtype not in _KINDS:
        raise TypeError(f"{kernel}: out_dtype and x_scale must be float32 or "
                        f"bfloat16, got {out_dtype} and {xs_dtype}")


def supports(m: int, k: int, n: int, xs_dtype: torch.dtype,
             out_dtype: torch.dtype) -> bool:
    """Whether the 2-D entry takes x_q [m, k] times w_q [k, n] with
    ``xs_dtype`` row scales and a ``out_dtype`` output."""
    return _build.holds(_rules, "int8_matmul_dequant", k, n, xs_dtype,
                        out_dtype)


def supports_3d(b: int, g: int, k: int, n: int, xs_dtype: torch.dtype,
                out_dtype: torch.dtype) -> bool:
    """Whether the 3-D entry takes x_q [b, g, k]: the 2-D entry's rules on
    its [b * g, k] view."""
    return _build.holds(_rules, "int8_matmul_dequant_3d", k, n, xs_dtype,
                        out_dtype)


def _launch(kernel: str, x_q, x_scale, w_q, w_scale, bias, relu, out_dtype):
    m, k = x_q.shape
    n = w_q.shape[1]
    if w_q.shape != (k, n) or x_scale.shape != (m,) or w_scale.shape != (n,) \
            or (bias is not None and bias.shape != (n,)):
        raise ValueError(
            f"{kernel}: shapes x_q {tuple(x_q.shape)}, x_scale "
            f"{tuple(x_scale.shape)}, w_q {tuple(w_q.shape)}, w_scale "
            f"{tuple(w_scale.shape)}"
            + (f", bias {tuple(bias.shape)}" if bias is not None else ""))
    _rules(kernel, k, n, x_scale.dtype, out_dtype)
    # the kernel reads the weight K-major as [N, K] (8-bit wgmma takes only
    # K-major operands); a w_q from quantize_weight_per_col is already the
    # transpose of one
    w_nk = w_q.t().contiguous()
    dev = x_q.device
    checks = [("x_q", x_q, torch.int8), ("x_scale", x_scale, x_scale.dtype),
              ("w_q", w_nk, torch.int8), ("w_scale", w_scale, torch.float32)]
    if bias is not None:
        checks.append(("bias", bias, out_dtype))
    for name, t, dt in checks:
        _build.check_operand(kernel, name, t, dt, dev)
    for name, t in (("x_q", x_q), ("w_q", w_nk)):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned (TMA)")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    _build.launch(kernel, "int8_matmul_forward", dev, x_q, x_scale, w_nk,
                  w_scale, bias if bias is not None else 0, out, m, k, n,
                  _KINDS[x_scale.dtype], _KINDS[out_dtype], int(relu))
    return out


def int8_matmul_dequant(x_q: torch.Tensor, x_scale: torch.Tensor,
                        w_q: torch.Tensor, w_scale: torch.Tensor, *,
                        bias: Optional[torch.Tensor] = None,
                        relu: bool = False,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(x_q @ w_q) * x_scale[:, None] * w_scale[None, :]`` (+ bias, ReLU)
    fused. x_q [M, K] int8, x_scale [M] f32 or bf16, w_q [K, N] int8,
    w_scale [N] f32, bias [N] in ``out_dtype`` (f32 or bf16).

    CPU tensors run :func:`int8_matmul_dequant_reference`. CUDA tensors
    launch the kernel, which masks any M and takes K a multiple of 32 and
    N of 8 (:func:`supports`); anything else raises.
    """
    if x_q.device.type == "cpu":
        return int8_matmul_dequant_reference(x_q, x_scale, w_q, w_scale,
                                             bias=bias, relu=relu,
                                             out_dtype=out_dtype)
    return _launch("int8_matmul_dequant", x_q, x_scale, w_q, w_scale, bias,
                   relu, out_dtype)


def int8_matmul_dequant_3d(x_q: torch.Tensor, x_scale: torch.Tensor,
                           w_q: torch.Tensor, w_scale: torch.Tensor, *,
                           bias: Optional[torch.Tensor] = None,
                           relu: bool = False,
                           out_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """The 3-D entry: x_q [B, G, K] int8, x_scale [B, G] -> [B, G, N], the
    kernel run on the [B * G, K] view of a contiguous ``x_q``. CPU tensors
    run :func:`int8_matmul_dequant_3d_reference`."""
    if x_q.device.type == "cpu":
        return int8_matmul_dequant_3d_reference(x_q, x_scale, w_q, w_scale,
                                                bias=bias, relu=relu,
                                                out_dtype=out_dtype)
    b, g, k = x_q.shape
    if x_scale.shape != (b, g):
        raise ValueError(f"int8_matmul_dequant_3d: shapes x_q "
                         f"{tuple(x_q.shape)}, x_scale {tuple(x_scale.shape)}")
    if not (x_q.is_contiguous() and x_scale.is_contiguous()):
        raise ValueError("int8_matmul_dequant_3d: x_q and x_scale must be "
                         "contiguous")
    y = _launch("int8_matmul_dequant_3d", x_q.view(b * g, k),
                x_scale.view(b * g), w_q, w_scale, bias, relu, out_dtype)
    return y.view(b, g, -1)
