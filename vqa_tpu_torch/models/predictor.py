"""VQA answer heads (counterparts of ``vqa_tpu/models/predictor.py``
``BasePredictor``, ``BaseCaptionPredictor`` and ``PredictorwithCaption``).

The base heads' classifier is an FCNet, whose trailing ReLU makes the
"logits" non-negative, as in the reference (modules.py:55). The Q-Relevant
head ends in a sigmoid, and the losses treat its probabilities as logits
(the reference's double squash, kept).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from vqa_tpu_torch.ops.caption import CaptionEmbedding
from vqa_tpu_torch.ops.linear import FCNet, LReLUNet
from vqa_tpu_torch.ops.rnn import SentenceEmbedding


class BasePredictor(nn.Module):
    """``v.sum(1) -> FCNet``, joint ``q * v``, weight-normed classifier
    (reference predictor.py:54-93)."""

    def __init__(self, v_dim: int, hidden_dim: int, ans_dim: int,
                 cls_layer: int = 2, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.v_net = FCNet(v_dim, hidden_dim, generator=generator)
        self.classifier = FCNet(hidden_dim, ans_dim, mid_dim=2 * hidden_dim,
                                layer=cls_layer, dropout=dropout,
                                generator=generator)

    def forward(self, embed: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Encoder output -> [B, ans_dim]. Reads the pooled ``v_sum`` of the
        int8 feed when present, else sums ``v`` over the boxes."""
        joint = embed["q"] * self.v_net(_pooled(embed))
        return self.classifier(joint)


class BaseCaptionPredictor(BasePredictor):
    """The VQA-E head (``base-cap``, reference predictor.py:96-140): the
    base head with the embedded caption read too, by a 1-layer GRU
    ``c_rnn`` (its last padded step; never the GRU kernel, as in the JAX
    package) and an FCNet ``c_net``; the joint is ``q * (c + v)``."""

    def __init__(self, v_dim: int, embed_dim: int, hidden_dim: int,
                 ans_dim: int, cls_layer: int = 2, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(v_dim, hidden_dim, ans_dim, cls_layer, dropout,
                         generator=generator)
        self.c_rnn = SentenceEmbedding(embed_dim, hidden_dim, rnn_type="GRU",
                                       generator=generator)
        self.c_net = FCNet(hidden_dim, hidden_dim, dropout=dropout,
                           generator=generator)

    def forward(self, embed: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Encoder output, the embedded caption ``c`` included ->
        [B, ans_dim]."""
        c = self.c_net(self.c_rnn(embed["c"]))
        joint = embed["q"] * (c + self.v_net(_pooled(embed)))
        return self.classifier(joint)


class PredictorwithCaption(nn.Module):
    """The Q-Relevant head (``q-cap``, reference predictor.py:144-213):
    LReLU layers and the gated :class:`CaptionEmbedding`. ``v_net`` runs
    box by box on the attended features ``v`` [B, objs, v_dim]; the caption
    embedding reads their sum; the caption-weighted fusion softmaxes over
    the *hidden* axis (predictor.py:202), then weights the projected boxes
    by it; the output is ``sigmoid(cls_net(...))``, probabilities. The
    reference's ``cls_layer`` is accepted and unused, as in the JAX
    package."""

    def __init__(self, v_dim: int, embed_dim: int, hidden_dim: int,
                 ans_dim: int, cls_layer: int = 2, dropout: float = 0.5,
                 neg_slope: float = 0.01, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del cls_layer
        kw = dict(neg_slope=neg_slope, generator=generator)
        self.v_net = LReLUNet(v_dim, hidden_dim, **kw)
        self.caption_embedding = CaptionEmbedding(
            embed_dim, hidden_dim, hidden_dim, hidden_dim, dropout=dropout,
            **kw)
        self.c_net = LReLUNet(hidden_dim, hidden_dim, **kw)
        self.vq_net = LReLUNet(hidden_dim, hidden_dim, **kw)
        self.joint_net = LReLUNet(hidden_dim, hidden_dim, **kw)
        self.vqc_net = LReLUNet(hidden_dim, hidden_dim, **kw)
        self.cls_net = LReLUNet(hidden_dim, ans_dim, **kw)

    def forward(self, embed: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Encoder output with the attended ``v``, ``q``, the embedded
        caption ``c`` and optionally ``cap_len`` -> [B, ans_dim] in (0, 1)."""
        v_proj = self.v_net(embed["v"])                     # [B, objs, H]
        v = v_proj.sum(dim=1)
        c = self.caption_embedding(v, embed["q"], embed["c"],
                                   embed.get("cap_len"))
        c = self.c_net(c)
        joint = torch.softmax(self.joint_net(c * self.vq_net(v)), dim=1)
        v = self.vqc_net(torch.sum(joint[:, None, :] * v_proj, dim=1))
        return torch.sigmoid(self.cls_net(embed["q"] * (v + c)))


def _pooled(embed: Dict[str, torch.Tensor]) -> torch.Tensor:
    return embed["v_sum"] if "v_sum" in embed else embed["v"].sum(dim=1)
