"""The arithmetic of the plain references: float32 matrix products with
TF32 off, or, for the control, products computed in float8 (e4m3): both
operands and the result rounded to e4m3 under one scale a tensor (its
largest magnitude to 448), the step below bfloat16 that a
lower-precision path would take. The rounding passes gradients straight
through.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0    # the largest finite float8_e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale (amax -> 448), back
    in float32; the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x.detach())


class Precision:
    """``mm(x, w_t)``: ``x @ w_t`` in float32 (``"f32"``) or in float8
    (``"fp8"``)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
        x, w_t = x.float(), w_t.float()
        if self.name == "fp8":
            return _fp8(torch.matmul(_fp8(x), _fp8(w_t)))
        return torch.matmul(x, w_t)


def exact_float32() -> None:
    """Float32 products stay float32 on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
