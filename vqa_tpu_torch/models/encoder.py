"""Up-Down question/visual encoder (counterpart of ``vqa_tpu/models/encoder.py``
``BaseEncoder``).

Batch dict: ``q`` [B, q_len] int tokens, and either ``img`` [B, objs, v_dim]
float features or the int8 feed ``img_q`` [B, objs, v_dim] int8 with
per-box scales ``img_scale`` [B, objs] (the features are
``img_q * img_scale[..., None]`` in the scale's dtype).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from vqa_tpu_torch.ops.attention import MultiplyAttention, set_att
from vqa_tpu_torch.ops.embedding import WordEmbedding
from vqa_tpu_torch.ops.kernels import lazyv_pool
from vqa_tpu_torch.ops.linear import FCNet
from vqa_tpu_torch.ops.rnn import SentenceEmbedding


class BaseEncoder(nn.Module):
    """Word embedding -> question GRU (last padded step) -> top-down
    attention over the boxes (reference encoder.py:96-183).

    ``use_pallas`` routes inference through the hand-written kernels: the
    question GRU (see :class:`SentenceEmbedding`) and, on a bf16 int8 feed,
    the dequant-GEMM v-projection and the lazy-v pooling.
    """

    def __init__(self, ntoken: int, v_dim: int, embed_dim: int,
                 hidden_dim: int, rnn_layer: int = 1, dropout: float = 0.5,
                 rnn_type: str = "GRU", att_type: str = "base",
                 att_dropout: float = 0.2, use_pallas: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_pallas = use_pallas
        self.embedding = WordEmbedding(ntoken, embed_dim, generator=generator)
        # torch applies RNN dropout only between stacked layers
        self.q_rnn = SentenceEmbedding(embed_dim, hidden_dim,
                                       rnn_layer=rnn_layer, dropout=dropout,
                                       rnn_type=rnn_type,
                                       use_pallas=use_pallas,
                                       generator=generator)
        att_kwargs = {"dropout": att_dropout} if att_type == "new" else {}
        self.attention = set_att(att_type)(v_dim, hidden_dim, hidden_dim,
                                           generator=generator, **att_kwargs)
        self.q_net = FCNet(hidden_dim, hidden_dim, generator=generator)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Returns ``q`` [B, hidden] and ``v_att`` [B, objs, 1], plus

        - dense feed: ``v`` = v_att * img [B, objs, v_dim];
        - int8 feed: ``v_q8`` (= img_q), ``v_w`` = v_att * img_scale
          [B, objs] (so the attended features are ``v_w[..., None] * v_q8``)
          and their sum over the boxes ``v_sum`` [B, v_dim]. The dequantized
          features and ``v_att * v`` are never formed, so there is no ``v``.
        """
        q = self.q_rnn(self.embedding(batch["q"]))          # [B, hidden]
        if "img_q" not in batch:
            v = batch["img"]
            v_att = self.attention(v, q)
            return {"v": v_att * v, "q": self.q_net(q), "v_att": v_att}

        img_q, img_scale = batch["img_q"], batch["img_scale"]
        # the kernels take bf16 operands: an f32 model runs the plain path,
        # as the GRU kernel's own bf16 rule does
        use_kernel = (self.use_pallas and not self.training
                      and img_scale.dtype == torch.bfloat16)
        if isinstance(self.attention, MultiplyAttention):
            vp = self.attention.project_v_int8(img_q, img_scale, use_kernel)
            v_att = self.attention(None, q, v_cache=vp)
        else:   # ConcatAttention reads dense features
            v_att = self.attention(
                img_q.to(img_scale.dtype) * img_scale[..., None], q)
        w = v_att[..., 0] * img_scale.to(v_att.dtype)
        pool = lazyv_pool.pool_int8 if use_kernel \
            else lazyv_pool.pool_int8_reference
        return {"q": self.q_net(q), "v_att": v_att, "v_q8": img_q, "v_w": w,
                "v_sum": pool(w, img_q)}
