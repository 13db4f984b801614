"""Relation-aware graph convolutions (ReGAT) over the boxes of an image
(counterpart of ``vqa_tpu/ops/gcn.py``).

- ``BaseGraphConv``: ``graph @ (feature @ W) + bias``.
- ``DirectedGraphConv``: ``w2(f) + adj @ w0(f) + adj @ w1(f)`` plus the
  per-label bias ``sum_j bias[graph[i, j]]``. The direction weights that
  share the adjacency are folded, ``adj @ (f (w0 + w1))``: one GEMM.
- ``CorrelatedGraphConv``: the directed conv re-weighted by the ReLU'd
  bilinear correlation ``alpha`` propagated through the adjacency and
  softmaxed over axis 1 (the reference's ``nn.Softmax(dim=1)``). At
  inference with ``use_pallas`` the graph-local chain runs as the
  ``gcn_chain_fused`` kernel.
- ``GCN``: conv -> dropout -> ReLU stack, its convs registered as
  ``conv{i}`` (the intended model: the reference's plain list hides them).

Spans (``vqa_tpu_torch/tracing.py``): ``vqa.gcn.project`` around a layer's
GEMMs over the boxes' features (w_self, the folded direction weight and,
for the correlated conv, ``similarity_parts``), ``vqa.gcn.chain`` around
the correlated conv's graph-local rest (the correlation product, its ReLU
and the fused chain or its plain form). :data:`ROUTES` counts
``CorrelatedGraphConv.attend``'s calls by the route of that rest:
``fused`` (``gcn_chain_fused``) or ``plain`` (the softmax through
autograd, as training and ``need_alpha`` take it).

With ``use_int8``, inference quantizes the layer input by rows once and runs
the w_self, folded-direction and ``a C`` projections as int8 GEMMs
(``ops/quant.py``). The JAX package calls them without ``use_pallas`` (its
XLA route over the flattened rows); here they take the 2-D entry of the
same hand-written kernel, bit-identical to the 3-D one. Training runs the
float projections and the reference-shaped ``DotProduct``.

Parameters carry the torch names of the port's convert table: ``w{i}.weight``
[out, in] (bias-free), ``label_bias`` [L, out], ``dot_product.wa.weight`` /
``.bias``, ``dot_product.wb.*``; ``BaseGraphConv`` holds ``weight`` [in,
out] and ``bias``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqa_tpu_torch import tracing
from vqa_tpu_torch.ops.kernels import gcn_chain
from vqa_tpu_torch.ops.linear import Dense, DotProduct, uniform_
from vqa_tpu_torch.ops.quant import int8_dot, quantize_rows

ROUTES = {"fused": 0, "plain": 0}


def reset_routes() -> None:
    for name in ROUTES:
        ROUTES[name] = 0


def label_bias_sum(graph: torch.Tensor, bias: torch.Tensor,
                   num_labels: int) -> torch.Tensor:
    """``sum_j bias[graph[b, i, j]]`` -> [B, N, out]: label counts [B, N,
    num_labels] @ bias [num_labels, out], in the bias dtype."""
    return torch.matmul(gcn_chain.label_counts(graph, num_labels, bias.dtype),
                        bias)


class BaseGraphConv(nn.Module):
    """Kipf-style conv ``graph @ (feature @ W) + b`` (reference gcn.py:16-51),
    ``graph`` read as float weights."""

    def __init__(self, in_dim: int, out_dim: int, num_labels: int = 12,
                 use_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del num_labels
        stdv = 1.0 / math.sqrt(out_dim)
        self.weight = nn.Parameter(uniform_(torch.empty(in_dim, out_dim),
                                            stdv, generator))
        self.bias = (nn.Parameter(uniform_(torch.empty(out_dim), stdv,
                                           generator)) if use_bias else None)

    def forward(self, feature: torch.Tensor, graph: torch.Tensor
                ) -> torch.Tensor:
        out = torch.matmul(feature, self.weight.to(feature.dtype))
        out = torch.matmul(graph.to(out.dtype), out)
        return out if self.bias is None else out + self.bias.to(out.dtype)


class DirectedGraphConv(nn.Module):
    """Direction-typed conv with a per-label bias (reference gcn.py:54-110):
    ``w[dir-1](f) + sum_{i < dir-1} adj @ w[i](f) + sum_j bias[graph[:, :,
    j]]``, without the residual the reference's comment mentions."""

    def __init__(self, in_dim: int, out_dim: int, num_labels: int = 12,
                 dir_num: int = 3, use_pallas: bool = False,
                 use_int8: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_labels = num_labels
        self.dir_num = dir_num
        self.use_pallas = use_pallas
        self.use_int8 = use_int8
        for i in [dir_num - 1, *range(dir_num - 1)]:   # JAX's order: self first
            self.add_module(f"w{i}", Dense(in_dim, out_dim, bias=False,
                                           generator=generator))
        self.label_bias = nn.Parameter(uniform_(
            torch.empty(num_labels, out_dim), 1.0 / math.sqrt(out_dim),
            generator))

    def _quantized_input(self, feature: torch.Tensor):
        """The row-quantized layer input that every int8 GEMM of the layer
        reads (inference with ``use_int8``), else None."""
        return quantize_rows(feature) if self.use_int8 and not self.training \
            else None

    def project(self, feature: torch.Tensor, fq=None):
        """The layer's GEMMs: (out_self, the folded direction projection or
        None). ``fq``: the quantized input, for the int8 GEMMs."""
        def dense(w: torch.Tensor) -> torch.Tensor:
            if fq is not None:
                return int8_dot(fq[0], fq[1], w.t(), out_dtype=feature.dtype)
            return torch.matmul(feature, w.to(feature.dtype).t())

        out = dense(getattr(self, f"w{self.dir_num - 1}").weight)
        ws = [getattr(self, f"w{i}").weight for i in range(self.dir_num - 1)]
        # sum_i adj @ (f W_i) == adj @ (f sum_i W_i): one GEMM, in the
        # parameter dtype as in JAX
        proj = dense(sum(ws[1:], start=ws[0])) if ws else None
        return out, proj

    def combine(self, out: torch.Tensor, proj: Optional[torch.Tensor],
                graph: torch.Tensor) -> torch.Tensor:
        """``out + adj @ proj + sum_j label_bias[graph[:, :, j]]``."""
        if proj is not None:
            adj = (graph != 0).to(out.dtype)
            out = out + torch.matmul(adj, proj)
        return out + label_bias_sum(graph, self.label_bias.to(out.dtype),
                                    self.num_labels)

    def forward(self, feature: torch.Tensor, graph: torch.Tensor
                ) -> torch.Tensor:
        with tracing.span("vqa.gcn.project", device=True):
            parts = self.project(feature, self._quantized_input(feature))
        return self.combine(*parts, graph)


class CorrelatedGraphConv(DirectedGraphConv):
    """The directed conv re-weighted by the bilinear correlation alpha
    (reference gcn.py:113-168)."""

    def __init__(self, in_dim: int, out_dim: int, num_labels: int = 12,
                 dir_num: int = 3, use_pallas: bool = False,
                 use_int8: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, num_labels, dir_num, use_pallas,
                         use_int8, generator=generator)
        self.dot_product = DotProduct(in_dim, in_dim, out_dim,
                                      generator=generator)

    def attend(self, feature: torch.Tensor, graph: torch.Tensor,
               need_alpha: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(out [B, N, out], alpha [B, N, N]). At inference with
        ``use_pallas`` (and without ``need_alpha``) the chain after the
        projections runs as the ``gcn_chain_fused`` kernel where it takes
        the shapes (``gcn_chain.supports``), which forms no alpha: None is
        returned for it."""
        fused = (self.use_pallas and not self.training and self.dir_num >= 2
                 and not need_alpha and gcn_chain.supports(
                     *feature.shape[:2], self.label_bias.shape[1],
                     self.num_labels, feature.dtype))
        # two spans: the GEMMs over the boxes' features, then the
        # graph-local chain
        with tracing.span("vqa.gcn.project", device=True):
            fq = self._quantized_input(feature)
            out_self, proj = self.project(feature, fq)
            parts = (None if self.training
                     else self.dot_product.similarity_parts(feature, aq=fq))
        with tracing.span("vqa.gcn.chain", device=True):
            if parts is None:
                alpha = self.dot_product(feature, feature)
            else:
                # alpha = (f C) f^T + u_i + w_j; the [36, 36] contraction
                # stays a batched product, as it stays in XLA
                fc, u, w = parts
                alpha = (torch.einsum("bik,bjk->bij", fc, feature)
                         + u[:, :, None] + w[:, None, :])
            alpha = torch.relu(alpha)
            ROUTES["fused" if fused else "plain"] += 1
            if fused:
                out = gcn_chain.gcn_chain_fused(
                    out_self, proj, alpha, graph.to(torch.int32).contiguous(),
                    self.label_bias.to(out_self.dtype),
                    num_labels=self.num_labels)
                return out, None
            out = self.combine(out_self, proj, graph)
            adj = (graph != 0).to(feature.dtype)
            alpha = torch.softmax(torch.matmul(adj, alpha), dim=1)  # gcn.py:117
            return torch.matmul(alpha, out), alpha

    def forward(self, feature: torch.Tensor, graph: torch.Tensor
                ) -> torch.Tensor:
        return self.attend(feature, graph)[0]


def get_graph_conv(conv_type: str):
    """String-keyed factory (reference gcn.py:9-14)."""
    return {"base": BaseGraphConv, "direct": DirectedGraphConv,
            "corr": CorrelatedGraphConv}[conv_type]


class GCN(nn.Module):
    """conv -> dropout -> ReLU, ``conv_layer`` times (reference
    gcn.py:171-215), the convs registered as ``conv{i}``."""

    def __init__(self, in_dim: int, out_dim: int, num_labels: int = 12,
                 conv_layer: int = 1, conv_type: str = "corr",
                 dropout: float = 0.5, use_pallas: bool = False,
                 use_int8: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_type = conv_type
        self.conv_layer = conv_layer
        conv_cls = get_graph_conv(conv_type)
        extra = ({"use_pallas": use_pallas, "use_int8": use_int8}
                 if conv_type != "base" else {})
        for i in range(conv_layer):
            self.add_module(f"conv{i}", conv_cls(
                in_dim if i == 0 else out_dim, out_dim, num_labels,
                generator=generator, **extra))
        self.drop = nn.Dropout(dropout)

    def forward(self, feature: torch.Tensor, graph: torch.Tensor,
                get_alpha: bool = False):
        """-> feature [B, N, out]; with ``get_alpha``, (feature, the alphas
        of the correlated convs)."""
        alphas: List[torch.Tensor] = []
        for i in range(self.conv_layer):
            conv = getattr(self, f"conv{i}")
            if get_alpha and self.conv_type == "corr":
                feature, alpha = conv.attend(feature, graph, need_alpha=True)
                alphas.append(alpha)
            else:
                feature = conv(feature, graph)
            feature = F.relu(self.drop(feature))
        return (feature, alphas) if get_alpha else feature
