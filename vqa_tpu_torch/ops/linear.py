"""Weight-normed fully-connected building blocks.

Counterparts of ``vqa_tpu/ops/linear.py``:

- ``WNDense``: a Linear under weight normalization with a *scalar* gain
  (torch ``weight_norm(nn.Linear(...), dim=None)``): ``W = g * V / ||V||_F``,
  ``g`` initialised to ``||V||_F``. Parameters are declared by hand as
  ``weight_v`` [out, in], a 0-dim ``weight_g`` and ``bias`` [out], the names
  the reference's state_dict uses.
- ``FCNet``: the N-layer ReLU MLP of ``WNDense``s with dropout between
  hidden layers and a ReLU after the *last* layer, held as the Sequential
  ``main`` in the reference's slot layout (Linear, ReLU, Dropout, ...), so
  its parameters are ``main.{i}.*``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from vqa_tpu_torch.ops.kernels import feed_gemm


def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-bound, bound) in place (torch's Linear and RNN default init)."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class WNDense(nn.Module):
    """Linear layer with scalar weight normalization (torch dim=None)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.weight_v = nn.Parameter(
            uniform_(torch.empty(out_dim, in_dim), bound, generator))
        self.weight_g = nn.Parameter(self.weight_v.detach().norm())
        self.bias = (nn.Parameter(uniform_(torch.empty(out_dim), bound,
                                           generator))
                     if bias else None)

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        """``g * rsqrt(sum(v^2)) * v`` [out, in] in ``dtype``. The scale is
        computed in the parameter dtype over the full kernel, as in JAX."""
        v = self.weight_v
        scale = self.weight_g * torch.rsqrt(torch.sum(v * v))
        return (scale * v).to(dtype)

    def forward(self, x: torch.Tensor, *,
                x_scale: Optional[torch.Tensor] = None,
                use_kernel: bool = False) -> torch.Tensor:
        """``x @ W.T + b``. An int8 ``x`` is a quantized activation with
        per-row scales ``x_scale``: the product is ``(x * x_scale) @ W.T`` in
        the scale's dtype, through the dequant-GEMM kernel when
        ``use_kernel``, else through its plain version."""
        if x.dtype == torch.int8:
            if x_scale is None:
                raise ValueError("an int8 input needs x_scale")
            w = self.weight(x_scale.dtype)
            gemm = (feed_gemm.dequant_matmul if use_kernel
                    else feed_gemm.dequant_matmul_reference)
            y = gemm(x.reshape(-1, x.shape[-1]), x_scale.reshape(-1), w.t())
            y = y.reshape(*x.shape[:-1], -1)
        else:
            y = torch.matmul(x, self.weight(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def fold_vector(self, x: torch.Tensor) -> torch.Tensor:
        """``x * W[0]`` for an out_dim == 1 layer: folds this projection into
        an elementwise factor. Drops the scalar bias, which is exact only
        where a softmax follows (MultiplyAttention at inference)."""
        if self.weight_v.shape[0] != 1:
            raise ValueError("fold_vector needs a [1, in] kernel")
        return x * self.weight(x.dtype)[0]


class FCNet(nn.Module):
    """Non-linear fully-connected network (reference modules.py:13-60).

    layer == 1 or mid_dim == 0:  WNDense(in->out), ReLU
    else:                        WNDense(in->mid), ReLU, Dropout,
                                 [WNDense(mid->mid), ReLU, Dropout] * (layer-2),
                                 WNDense(mid->out), ReLU
    """

    def __init__(self, in_dim: int, out_dim: int, mid_dim: int = 0,
                 layer: int = 1, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if layer == 1 or mid_dim == 0:
            slots = [WNDense(in_dim, out_dim, generator=generator)]
        else:
            slots = [WNDense(in_dim, mid_dim, generator=generator),
                     nn.ReLU(), nn.Dropout(dropout)]
            for _ in range(layer - 2):
                slots += [WNDense(mid_dim, mid_dim, generator=generator),
                          nn.ReLU(), nn.Dropout(dropout)]
            slots.append(WNDense(mid_dim, out_dim, generator=generator))
        slots.append(nn.ReLU())
        self.main = nn.Sequential(*slots)

    def forward(self, x: torch.Tensor, *,
                x_scale: Optional[torch.Tensor] = None,
                use_kernel: bool = False) -> torch.Tensor:
        """``x_scale``/``use_kernel`` go to the first layer, for an int8 ``x``
        (see :meth:`WNDense.forward`)."""
        x = self.main[0](x, x_scale=x_scale, use_kernel=use_kernel)
        return self.main[1:](x)
