"""Weight-normed fully-connected building blocks and plain Linears.

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
- ``Dense``: a plain Linear (``weight`` [out, in], optional ``bias``), the
  JAX package's ``_Dense`` and the GCN's bias-free direction weights.
- ``DotProduct``: the bilinear similarity ``(a Wa + ba) (b Wb + bb)^T`` of
  the correlated graph conv, and its ``similarity_parts`` form.
- ``LReLUNet``: a bias-free Linear and a LeakyReLU, the Q-Relevant head's
  layer, held as the reference's Sequential ``main`` (``main.0.weight``).

``WNDense`` and ``Dense`` take a tensor-parallel slice of their output
dimension (``parallel/mesh.py`` ``shard_params`` sets ``tp``): the product
with the slice, then the all-gather of the slices; ``WNDense``'s weight norm
sums its squares over every slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqa_tpu_torch.ops.kernels import feed_gemm
from vqa_tpu_torch.ops.quant import int8_dot


def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-bound, bound) in place (torch's Linear and RNN default init)."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class WNDense(nn.Module):
    """Linear layer with scalar weight normalization (torch dim=None)."""

    tp = None     # a parallel.mesh.ModelShard once shard_params slices it

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
        computed in the parameter dtype over the full kernel, as in JAX; a
        sharded layer returns its slice, the sum all-reduced over the
        slices."""
        v = self.weight_v
        sq = torch.sum(v * v)
        if self.tp is not None:
            sq = self.tp.total(sq)
        scale = self.weight_g * torch.rsqrt(sq)
        if self.tp is not None:
            scale = self.tp.enter(scale)
        return (scale * v).to(dtype)

    def forward(self, x: torch.Tensor, *,
                x_scale: Optional[torch.Tensor] = None,
                use_kernel: bool = False, int8_gemm: bool = False,
                relu: bool = False) -> torch.Tensor:
        """``x @ W.T + b``, then the ReLU with ``relu``. An int8 ``x`` is a
        quantized activation with per-row scales ``x_scale``; the output is
        in the scale's dtype. With ``int8_gemm`` it goes through the int8
        GEMM (:meth:`int8_forward`, ``use_kernel`` picking the 3-D kernel
        entry); else the product is ``(x * x_scale) @ W.T``, through the
        dequant-GEMM kernel when ``use_kernel`` and the kernel takes the
        shape (``feed_gemm.supports``), else its plain version."""
        if self.tp is not None:
            x = self.tp.enter(x)
        if x.dtype == torch.int8:
            if x_scale is None:
                raise ValueError("an int8 input needs x_scale")
            if int8_gemm:
                return self.int8_forward(x, x_scale, use_pallas=use_kernel,
                                         relu=relu)
            w = self.weight(x_scale.dtype)
            x2 = x.reshape(-1, x.shape[-1])
            gemm = (feed_gemm.dequant_matmul
                    if use_kernel and feed_gemm.supports(*x2.shape, w.shape[0],
                                                         w.dtype)
                    else feed_gemm.dequant_matmul_reference)
            y = gemm(x2, x_scale.reshape(-1), w.t())
            y = y.reshape(*x.shape[:-1], -1)
        else:
            y = torch.matmul(x, self.weight(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        y = F.relu(y) if relu else y
        return y if self.tp is None else self.tp.gather(y)

    def int8_forward(self, x_q: torch.Tensor, x_scale: torch.Tensor, *,
                     use_pallas: bool = False,
                     in_cols: Optional[int] = None, add_bias: bool = True,
                     relu: bool = False) -> torch.Tensor:
        """The int8 GEMM of ``vqa_tpu``'s WNDense (ops/quant.py int8_dot):
        the weight-normed kernel in the parameter dtype (its first
        ``in_cols`` inputs), quantized per output column; the bias and the
        ReLU in the epilogue; the output in the scale's dtype."""
        w = self.weight(self.weight_v.dtype)
        if in_cols is not None:
            w = w[:, :in_cols]
        return int8_dot(x_q, x_scale, w.t(), out_dtype=x_scale.dtype,
                        use_pallas=use_pallas,
                        bias=self.bias if add_bias else None, relu=relu)

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
                use_kernel: bool = False,
                int8_gemm: bool = False) -> torch.Tensor:
        """``x_scale``/``use_kernel``/``int8_gemm`` go to the first layer,
        for an int8 ``x`` (see :meth:`WNDense.forward`), which applies the
        ReLU of the next slot itself: in the int8 GEMM's epilogue."""
        x = self.main[0](x, x_scale=x_scale, use_kernel=use_kernel,
                         int8_gemm=int8_gemm, relu=True)
        return self.main[2:](x)


class Dense(nn.Module):
    """A plain Linear, ``weight`` [out, in] and ``bias`` [out] (the JAX
    package's ``_Dense``): the product in the input's dtype, then the bias
    in that dtype. Init U(-1/sqrt(in), 1/sqrt(in)) unless ``bound`` is
    given; ``zero_bias`` starts the bias at 0; ``bias=False`` declares
    none."""

    tp = None     # a parallel.mesh.ModelShard once shard_params slices it

    def __init__(self, in_dim: int, out_dim: int,
                 bound: Optional[float] = None, zero_bias: bool = False, *,
                 bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        default = 1.0 / math.sqrt(in_dim)
        self.weight = nn.Parameter(uniform_(torch.empty(out_dim, in_dim),
                                            bound or default, generator))
        self.bias = None
        if bias:
            self.bias = nn.Parameter(
                torch.zeros(out_dim) if zero_bias
                else uniform_(torch.empty(out_dim), default, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        y = torch.matmul(x, self.weight.to(x.dtype).t())
        y = y if self.bias is None else y + self.bias.to(x.dtype)
        return y if self.tp is None else self.tp.gather(y)


class LReLUNet(nn.Module):
    """Bias-free Linear + LeakyReLU (reference modules.py:62-77), as the
    reference's ``Sequential(Linear(bias=False), LeakyReLU)`` named ``main``,
    so that its one parameter is ``main.0.weight`` [out, in]. The product
    runs in the input's dtype."""

    def __init__(self, in_dim: int, out_dim: int, neg_slope: float = 0.01, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.main = nn.Sequential(Dense(in_dim, out_dim, bias=False,
                                        generator=generator),
                                  nn.LeakyReLU(neg_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


class DotProduct(nn.Module):
    """Bilinear similarity (reference modules.py:80-95): a [B, m, a_dim],
    b [B, n, b_dim] -> ``(a Wa + ba) @ (b Wb + bb)^T`` [B, m, n], with the
    reference's torch names ``wa.weight`` [out, a_dim], ``wa.bias``, ``wb.*``.
    """

    def __init__(self, a_dim: int, b_dim: int, out_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.wa = Dense(a_dim, out_dim, generator=generator)
        self.wb = Dense(b_dim, out_dim, generator=generator)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The reference-shaped form (training)."""
        return torch.einsum("bik,bjk->bij", self.wa(a), self.wb(b))

    def similarity_parts(self, a: torch.Tensor, aq=None):
        """``DotProduct(a, a)`` as ``alpha_ij = (a C) a^T |_ij + u_i + w_j``
        with ``C = Wa Wb^T`` (f32), ``u = a (Wa bb) + ba.bb``, ``w = a (Wb
        ba)``: one [*, in] @ [in, in] GEMM in place of the two out_dim
        projections (exact algebra). ``aq``: the row-quantized (a_q, scale)
        of ``a``, so that ``a C`` runs as an int8 GEMM. Returns (ac [B, n,
        in] in a's dtype, u [B, n], w [B, n])."""
        wa, ba = self.wa.weight.t(), self.wa.bias      # [in, out], [out]
        wb, bb = self.wb.weight.t(), self.wb.bias
        c = torch.matmul(wa.to(torch.float32), wb.to(torch.float32).t())
        if aq is not None:
            ac = int8_dot(aq[0], aq[1], c, out_dtype=a.dtype)
        else:
            ac = torch.matmul(a, c.to(a.dtype))
        u = torch.matmul(a, torch.matmul(wa, bb).to(a.dtype)) \
            + torch.dot(ba, bb).to(a.dtype)
        w = torch.matmul(a, torch.matmul(wb, ba).to(a.dtype))
        return ac, u, w
