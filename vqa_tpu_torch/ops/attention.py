"""Top-down attention over the image boxes.

Counterparts of ``vqa_tpu/ops/attention.py``. Both modules return
[B, num_objs, 1] weights, a softmax over the boxes. In beam mode the
question is [B, k, q_dim] against boxes shared by the k beams of an image,
and the weights are [B, k, num_objs, 1], a softmax over axis 2. The
v-side projection ``project_v`` has no question input, so a decoder
computes it once per batch and passes it to every step as ``v_cache``;
``project_v_int8`` is the same projection as one int8 GEMM over the int8
feed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqa_tpu_torch.ops.kernels import feed_gemm
from vqa_tpu_torch.ops.linear import FCNet, WNDense


class ConcatAttention(nn.Module):
    """softmax_objs(WN([v; q]) -> ReLU -> WN -> 1), held as the reference's
    Sequential ``sequence`` (Linear, ReLU, Linear). The concat projection
    is split exactly: ``[v; q] @ W == v @ W_v + q @ W_q``."""

    def __init__(self, v_dim: int, q_dim: int, hidden_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.v_dim = v_dim
        self.sequence = nn.Sequential(
            WNDense(v_dim + q_dim, hidden_dim, generator=generator),
            nn.ReLU(),
            WNDense(hidden_dim, 1, generator=generator))

    def project_v(self, v: torch.Tensor) -> torch.Tensor:
        """The v rows of the concat projection, without the bias (it joins
        on the question side): v [B, objs, v_dim] -> [B, objs, hidden]."""
        w = self.sequence[0].weight(v.dtype)
        return torch.matmul(v, w[:, :self.v_dim].t())

    def project_v_int8(self, img_q: torch.Tensor, img_scale: torch.Tensor,
                       use_pallas: bool) -> torch.Tensor:
        """``project_v`` of the dequantized feed ``img_q * img_scale``, in
        the scale's dtype: the v rows of the concat kernel as one int8 GEMM
        over the payload (``use_pallas`` picks the kernel's 3-D entry)."""
        return self.sequence[0].int8_forward(
            img_q, img_scale, use_pallas=use_pallas, in_cols=self.v_dim,
            add_bias=False)

    def forward(self, v: Optional[torch.Tensor], q: torch.Tensor, *,
                v_cache: Optional[torch.Tensor] = None) -> torch.Tensor:
        """v [B, objs, v_dim] (or its projection ``v_cache``), q [B, q_dim]
        -> [B, objs, 1]; q [B, k, q_dim] -> [B, k, objs, 1]."""
        fc0, fc1 = self.sequence[0], self.sequence[2]
        vp = v_cache if v_cache is not None else self.project_v(v)
        w = fc0.weight(q.dtype)
        qp = torch.matmul(q, w[:, self.v_dim:].t()) + fc0.bias.to(q.dtype)
        if q.dim() == 3:
            logits = fc1(F.relu(vp[:, None] + qp[:, :, None, :]))
            return torch.softmax(logits, dim=2)
        logits = fc1(F.relu(vp + qp[:, None, :]))
        return torch.softmax(logits, dim=1)


class MultiplyAttention(nn.Module):
    """softmax_objs(WN(dropout(FCNet(v) * FCNet(q)))) (attention.py:55-86).

    At inference dropout is the identity, so ``(vp * qp) @ w`` folds exactly
    into ``vp @ (qp * w)``: a contraction over hidden for each (batch, box)
    in place of the [B, objs, hidden] joint tensor. The scalar bias drops
    out under the softmax. Training keeps the joint form for dropout.
    """

    def __init__(self, v_dim: int, q_dim: int, hidden_dim: int,
                 dropout: float = 0.2, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.W_v = FCNet(v_dim, hidden_dim, generator=generator)
        self.W_q = FCNet(q_dim, hidden_dim, generator=generator)
        self.linear = WNDense(hidden_dim, 1, generator=generator)
        self.drop = nn.Dropout(dropout)

    def project_v(self, v: torch.Tensor) -> torch.Tensor:
        """``W_v`` of v [B, objs, v_dim] -> [B, objs, hidden]."""
        return self.W_v(v)

    def project_v_int8(self, img_q: torch.Tensor, img_scale: torch.Tensor,
                       use_pallas: bool) -> torch.Tensor:
        """``W_v`` of the dequantized feed ``img_q * img_scale`` [B, objs,
        v_dim] -> [B, objs, hidden] in the scale's dtype, as one int8 GEMM
        over the payload with the ReLU in its epilogue (``use_pallas``
        picks the kernel's 3-D entry)."""
        return self.W_v.main[0].int8_forward(img_q, img_scale,
                                             use_pallas=use_pallas, relu=True)

    def attend_int8(self, img_q: torch.Tensor, img_scale: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
        """The weights of q [B, q_dim] over the int8 feed ``img_q *
        img_scale`` [B, objs, v_dim], as :meth:`forward` gives them at
        inference, through the gated dequant GEMM: the bias, ReLU and
        folded logit run in its epilogue at the unfused form's rounding
        points, and the [B, objs, hidden] projection is never formed. The
        caller checks that the kernel takes the shapes
        (``feed_gemm.supports_gated_logits``)."""
        fc = self.W_v.main[0]
        b, objs, k = img_q.shape
        wq = self.linear.fold_vector(self.W_q(q))          # [B, hidden]
        w = fc.weight(img_scale.dtype)
        logits = feed_gemm.dequant_matmul_gated_logits(
            img_q.reshape(-1, k), img_scale.reshape(-1), w.t(), fc.bias, wq,
            objs)
        # the logits and the softmax in the unfused form's dtype
        out_dt = torch.promote_types(w.dtype, wq.dtype)
        return torch.softmax(logits.view(b, objs).to(out_dt), dim=-1)[..., None]

    def forward(self, v: Optional[torch.Tensor], q: torch.Tensor, *,
                v_cache: Optional[torch.Tensor] = None) -> torch.Tensor:
        """v [B, objs, v_dim] (or its projection ``v_cache``), q [B, q_dim]
        -> [B, objs, 1]; q [B, k, q_dim] -> [B, k, objs, 1]."""
        vp = v_cache if v_cache is not None else self.W_v(v)
        qp = self.W_q(q)                                 # [B(, k), hidden]
        beam = q.dim() == 3
        if not self.training:
            wq = self.linear.fold_vector(qp)             # [B(, k), hidden]
            # the joint form's dtype: (vp * qp) promotes
            out_dt = torch.promote_types(vp.dtype, wq.dtype)
            logits = torch.einsum("bnd,bkd->bkn" if beam else "bnd,bd->bn",
                                  vp.to(out_dt), wq.to(out_dt))
            return torch.softmax(logits, dim=-1)[..., None]
        if beam:
            joint = self.drop(vp[:, None] * qp[:, :, None, :])
            return torch.softmax(self.linear(joint), dim=2)
        joint = self.drop(vp * qp[:, None, :])
        return torch.softmax(self.linear(joint), dim=1)


def set_att(att_type: str):
    """String-keyed factory (reference attention.py:11-15)."""
    return {"base": ConcatAttention, "new": MultiplyAttention}[att_type]
