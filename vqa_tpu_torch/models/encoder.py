"""Question/visual encoders (counterparts of ``vqa_tpu/models/encoder.py``
``BaseEncoder``, ``RelationEncoder`` and ``CaptionEncoder``).

Batch dict: ``q`` [B, q_len] int tokens, and either ``img`` [B, objs, v_dim]
float features or the int8 feed ``img_q`` [B, objs, v_dim] int8 with
per-box scales ``img_scale`` [B, objs] (the features are
``img_q * img_scale[..., None]`` in the scale's dtype); optionally the
caption ``c`` [B, c_len] int tokens with its length ``cap_len`` [B]; for
the relation encoder ``graph`` [B, objs, objs] int spatial labels (and
``sem_graph`` with ``use_sem``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from vqa_tpu_torch.ops.attention import MultiplyAttention, set_att
from vqa_tpu_torch.ops.embedding import WordEmbedding
from vqa_tpu_torch.ops.gcn import GCN
from vqa_tpu_torch.ops.kernels import lazyv_pool
from vqa_tpu_torch.ops.linear import FCNet
from vqa_tpu_torch.ops.rnn import SentenceEmbedding


def _caption(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             embedding: WordEmbedding) -> Dict[str, torch.Tensor]:
    """Add the embedded caption ``c`` [B, c_len, embed], its tokens
    ``c_target`` and ``cap_len`` where the batch has a caption."""
    if "c" in batch:
        out["c"] = embedding(batch["c"])
        out["c_target"] = batch["c"]
        out["cap_len"] = batch["cap_len"]
    return out


class CaptionEncoder(nn.Module):
    """Caption-only encoder (reference encoder.py:66-94): the visual
    features pass through as ``v`` and the caption is embedded. On the int8
    feed ``v`` is the dequantized features in the scale's dtype, with the
    factored form beside it, ``v_q8`` (the payload) and ``v_w`` (the scales:
    there is no attention to fold in), which the caption scan reads."""

    def __init__(self, ntoken: int, embed_dim: int,
                 frozen_embedding: Optional[np.ndarray] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = WordEmbedding(ntoken, embed_dim,
                                       frozen_table=frozen_embedding,
                                       generator=generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding(tokens)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        if "img_q" in batch:
            img_q, img_scale = batch["img_q"], batch["img_scale"]
            out = {"v": img_q.to(img_scale.dtype) * img_scale[..., None],
                   "v_q8": img_q, "v_w": img_scale}
        else:
            out = {"v": batch["img"]}
        return _caption(out, batch, self.embedding)


class BaseEncoder(nn.Module):
    """Word embedding -> question GRU (last padded step) -> top-down
    attention over the boxes (reference encoder.py:96-183).

    ``use_pallas`` routes inference through the hand-written kernels: the
    question GRU (see :class:`SentenceEmbedding`) and, on a bf16 int8 feed,
    the dequant-GEMM v-projection and the lazy-v pooling. Those kernels have
    no backward: in training mode the plain versions run, with dropout
    active, as in the JAX package. ``use_int8`` runs the attention's
    v-projection over the int8 feed as one int8 GEMM at inference
    (``ops/quant.py``; ``use_pallas`` picks the kernel's 3-D entry, as it
    picks JAX's 3-D Pallas kernel).

    On the int8 feed the outputs follow their readers: ``with_v_sum`` (a
    VQA predictor reads the pooled ``v_sum``) and ``with_v`` (a caption
    decoder reads the attended features ``v``). ``frozen_embedding``: a
    GloVe table in place of the learned word embedding.
    """

    def __init__(self, ntoken: int, v_dim: int, embed_dim: int,
                 hidden_dim: int, rnn_layer: int = 1, dropout: float = 0.5,
                 rnn_type: str = "GRU", att_type: str = "base",
                 att_dropout: float = 0.2, use_pallas: bool = False,
                 use_int8: bool = False, *,
                 with_v: bool = False, with_v_sum: bool = True,
                 frozen_embedding: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_pallas = use_pallas
        self.use_int8 = use_int8
        self.with_v = with_v
        self.with_v_sum = with_v_sum
        self.embedding = WordEmbedding(ntoken, embed_dim,
                                       frozen_table=frozen_embedding,
                                       generator=generator)
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

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The word embedding, for the caption decoders and the beam search
        (encoder.py:113-116)."""
        return self.embedding(tokens)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Returns ``q`` [B, hidden] and ``v_att`` [B, objs, 1], plus

        - dense feed: ``v`` = v_att * img [B, objs, v_dim];
        - int8 feed: ``v_q8`` (= img_q), ``v_w`` = v_att * img_scale
          [B, objs] (so the attended features are ``v_w[..., None] * v_q8``)
          and, with ``with_v_sum``, their sum over the boxes ``v_sum``
          [B, v_dim]; with ``with_v``, ``v`` = v_att * (img_q * img_scale),
          rounded as JAX rounds it: the dequantized features in the scale's
          dtype, then the product. Without it the dequantized features and
          ``v_att * v`` are never formed;
        - with a caption ``c`` in the batch: ``c`` embedded [B, c_len,
          embed], ``c_target`` (= the tokens) and ``cap_len``.
        """
        return _caption(self._visual(batch), batch, self.embedding)

    def _visual(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        q = self.q_rnn(self.embedding(batch["q"]))          # [B, hidden]
        if "img_q" not in batch:
            v = batch["img"]
            v_att = self.attention(v, q)
            return {"v": v_att * v, "q": self.q_net(q), "v_att": v_att}

        img_q, img_scale = batch["img_q"], batch["img_scale"]
        # the kernels take bf16 operands: an f32 model runs the plain path,
        # as the GRU kernel's own bf16 rule does (the int8 GEMM takes both)
        use_kernel = (self.use_pallas and not self.training
                      and img_scale.dtype == torch.bfloat16)
        int8_gemm = self.use_int8 and not self.training
        concat = not isinstance(self.attention, MultiplyAttention)
        # the dequantized features, only where a reader needs them dense
        v = (img_q.to(img_scale.dtype) * img_scale[..., None]
             if self.with_v or (concat and not int8_gemm) else None)
        if int8_gemm:
            vp = self.attention.project_v_int8(img_q, img_scale,
                                               use_kernel=self.use_pallas,
                                               use_int8=True)
            v_att = self.attention(v, q, v_cache=vp)
        elif concat or (v is not None and not use_kernel):
            # the same product as project_v_int8's plain path, from the
            # features already formed (the JAX package's training path)
            v_att = self.attention(v, q)
        else:
            vp = self.attention.project_v_int8(img_q, img_scale,
                                               use_kernel=use_kernel)
            v_att = self.attention(None, q, v_cache=vp)
        w = v_att[..., 0] * img_scale.to(v_att.dtype)
        out = {"q": self.q_net(q), "v_att": v_att, "v_q8": img_q, "v_w": w}
        if self.with_v_sum:
            pool = (lazyv_pool.pool_int8
                    if use_kernel and lazyv_pool.supports(*img_q.shape, w.dtype)
                    else lazyv_pool.pool_int8_reference)
            out["v_sum"] = pool(w, img_q)
        if self.with_v:
            out["v"] = v_att * v
        return out


class RelationEncoder(BaseEncoder):
    """ReGAT (reference encoder.py:186-272): the base encoder's attended
    features ``v`` through one GCN per relation, the spatial one over
    ``batch["graph"]``, the implicit one over the fully connected graph
    (``ones - eye``), the semantic one (15 labels) over
    ``batch["sem_graph"]``, summed into the new ``v``.

    On the int8 feed it reads the dense attended features ``v_att * (img_q
    * img_scale)``, rounded as JAX rounds them, and forms no pooled
    ``v_sum``; its output drops ``v_q8`` and ``v_w``, which no longer
    describe ``v``.
    """

    def __init__(self, ntoken: int, v_dim: int, embed_dim: int,
                 hidden_dim: int, rnn_layer: int = 1, dropout: float = 0.5,
                 rnn_type: str = "GRU", att_type: str = "base",
                 att_dropout: float = 0.2, use_pallas: bool = False,
                 use_int8: bool = False, *, conv_layer: int = 1,
                 conv_type: str = "corr", use_imp: bool = False,
                 use_spa: bool = True, use_sem: bool = False,
                 frozen_embedding: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(ntoken, v_dim, embed_dim, hidden_dim, rnn_layer,
                         dropout, rnn_type, att_type, att_dropout,
                         use_pallas, use_int8, with_v=True, with_v_sum=False,
                         frozen_embedding=frozen_embedding,
                         generator=generator)
        if not (use_imp or use_spa or use_sem):
            raise ValueError("Should use at least one relation")
        kw = dict(conv_layer=conv_layer, conv_type=conv_type, dropout=dropout,
                  use_pallas=use_pallas, use_int8=use_int8,
                  generator=generator)
        # the branches in the JAX package's order: implicit, spatial, semantic
        self.branches = [name for name, on in (("implicit", use_imp),
                                               ("spatial", use_spa),
                                               ("semantic", use_sem)) if on]
        for name in self.branches:
            self.add_module(f"{name}_encoder", GCN(
                v_dim, v_dim, num_labels=15 if name == "semantic" else 12,
                **kw))

    def _graph(self, name: str, batch: Dict[str, torch.Tensor],
               v: torch.Tensor) -> torch.Tensor:
        if name == "implicit":
            n = v.shape[1]
            imp = torch.ones(n, n, dtype=torch.int32, device=v.device) \
                - torch.eye(n, dtype=torch.int32, device=v.device)
            return imp.expand(v.shape[0], n, n)
        return batch["graph" if name == "spatial" else "sem_graph"].to(torch.int32)

    def forward(self, batch: Dict[str, torch.Tensor], graph_alpha: bool = False):
        """The base encoder's outputs with ``v`` replaced by the sum of the
        GCN branches; with ``graph_alpha``, the alphas of the last branch's
        correlated convs instead."""
        out = super().forward(batch)
        v = out["v"]
        output_v, g_att = None, []
        for name in self.branches:
            new_v = getattr(self, f"{name}_encoder")(
                v, self._graph(name, batch, v), graph_alpha)
            if graph_alpha:
                new_v, g_att = new_v
            output_v = new_v if output_v is None else output_v + new_v
        if graph_alpha:
            return g_att
        out["v"] = output_v
        for key in ("v_sum", "v_q8", "v_w"):
            out.pop(key, None)
        return out
