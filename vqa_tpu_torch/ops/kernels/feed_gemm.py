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

:func:`dequant_matmul_gated_logits` runs the same mainloop with a second
epilogue: MultiplyAttention's logits at inference, ``relu(x @ w + bias)``
contracted with a per-image gate, so that the [M, N] projection is never
written. It rounds where the unfused form rounds (the projection, the bias
and the ReLU in bf16) and sums the gated products in f32. That is the
entry the model calls (``models/encoder.py`` ``BaseEncoder.attend_feed``);
the plain :func:`dequant_matmul` stands for the TPU kernel as a library
entry: no model path calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqa_tpu_torch.ops.kernels import _build

# the kernel reads K in 64-deep stages, but x_q's rows need only be whole
# 16-byte TMA rows (TMA zero-fills the last stage past K); it writes column
# pairs of 8-column blocks of the wgmma accumulator; M is any
_K_STEP, _N_STEP = 16, 8
# the output tile's columns: the gated epilogue writes one partial logit a
# row for each
_TILE_N = 256


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


def _operands(kernel: str, x_q: torch.Tensor, x_scale: torch.Tensor,
              w: torch.Tensor, *more):
    """(w as [N, K], the scales in w's dtype), each operand and each of
    ``more`` (name, tensor, dtype) checked for the kernel."""
    w_nk = w.t().contiguous()
    scale = x_scale.to(w.dtype)
    for name, t, dt in (("x_q", x_q, torch.int8), ("x_scale", scale, w.dtype),
                        ("w", w_nk, torch.bfloat16), *more):
        _build.check_operand(kernel, name, t, dt, x_q.device)
    if x_q.data_ptr() % 16:
        raise ValueError(f"{kernel}: x_q must be 16-byte aligned (TMA)")
    return w_nk, scale


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
    w_nk, scale = _operands("dequant_matmul", x_q, x_scale, w)
    out = torch.empty((m, n), dtype=w.dtype, device=x_q.device)
    _build.launch("dequant_matmul", "dequant_matmul_forward", x_q.device,
                  x_q, scale, w_nk, out, m, k, n)
    return out


def dequant_matmul_gated_logits_reference(
        x_q: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
        bias: torch.Tensor, gate: torch.Tensor, objs: int) -> torch.Tensor:
    """Plain PyTorch version, the unfused composition at its rounding
    points: the projection in ``w``'s dtype, the bias added and the ReLU
    taken in that dtype, then the logit ``einsum("bnd,bd->bn")`` with the
    gate, in the promoted dtype, which is the output's. x_q [M, K] int8,
    x_scale [M], w [K, N], bias [N], gate [M / objs, N] -> [M]."""
    y = dequant_matmul_reference(x_q, x_scale, w)
    vp = F.relu(y + bias.to(y.dtype)).reshape(-1, objs, y.shape[-1])
    dt = torch.promote_types(vp.dtype, gate.dtype)
    return torch.einsum("bnd,bd->bn", vp.to(dt), gate.to(dt)).reshape(-1)


def _gated_rules(m: int, k: int, n: int, objs: int, w_dtype: torch.dtype,
                 gate_dtype: torch.dtype) -> None:
    _rules(m, k, n, w_dtype)
    if objs < 1 or m % objs:
        raise ValueError(f"dequant_matmul_gated_logits: M={m} must be a "
                         f"whole number of images of objs={objs} rows")
    _build.check_dtype("dequant_matmul_gated_logits", "gate", gate_dtype,
                       torch.bfloat16)


def supports_gated_logits(m: int, k: int, n: int, objs: int,
                          w_dtype: torch.dtype,
                          gate_dtype: torch.dtype) -> bool:
    """Whether the gated kernel takes x_q [m, k] times a ``w_dtype`` w [k,
    n], ``objs`` rows an image, with a ``gate_dtype`` gate."""
    return _build.holds(_gated_rules, m, k, n, objs, w_dtype, gate_dtype)


def dequant_matmul_gated_logits(x_q: torch.Tensor, x_scale: torch.Tensor,
                                w: torch.Tensor, bias: torch.Tensor,
                                gate: torch.Tensor, objs: int
                                ) -> torch.Tensor:
    """``sum_n relu(((x_q * x_scale) @ w)[m, n] + bias[n]) * gate[m // objs,
    n]`` [M], without the [M, N] projection in device memory.

    CPU tensors run :func:`dequant_matmul_gated_logits_reference`, in the
    unfused form's dtype. CUDA tensors launch the kernel under the rules of
    :func:`dequant_matmul`, with M a multiple of ``objs`` and a bf16 gate
    (:func:`supports_gated_logits`); anything else raises. The kernel
    rounds the projection, the bias and the ReLU to bf16 as the unfused
    form does, sums the gated products in f32 and writes one f32 partial a
    row for each 256-column tile of w, summed here in a fixed order: the
    output is f32, the unfused form's logits before their last rounding.
    """
    if x_q.device.type == "cpu":
        return dequant_matmul_gated_logits_reference(x_q, x_scale, w, bias,
                                                     gate, objs)
    m, k = x_q.shape
    n = w.shape[1]
    if (w.shape != (k, n) or x_scale.shape != (m,) or bias.shape != (n,)
            or objs < 1 or gate.shape != (m // objs, n)):
        raise ValueError(
            f"dequant_matmul_gated_logits: shapes x_q {tuple(x_q.shape)}, "
            f"x_scale {tuple(x_scale.shape)}, w {tuple(w.shape)}, bias "
            f"{tuple(bias.shape)}, gate {tuple(gate.shape)}, objs={objs}")
    _gated_rules(m, k, n, objs, w.dtype, gate.dtype)
    bias, gate = bias.to(w.dtype).contiguous(), gate.contiguous()
    w_nk, scale = _operands("dequant_matmul_gated_logits", x_q, x_scale, w,
                            ("bias", bias, w.dtype),
                            ("gate", gate, torch.bfloat16))
    partials = torch.empty((-(-n // _TILE_N), m), dtype=torch.float32,
                           device=x_q.device)
    _build.launch("dequant_matmul_gated_logits",
                  "dequant_matmul_gated_forward", x_q.device, x_q, scale,
                  w_nk, bias, gate, partials, m, k, n, objs)
    return partials.sum(dim=0)
