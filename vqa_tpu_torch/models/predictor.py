"""Up-Down VQA answer head (counterpart of ``vqa_tpu/models/predictor.py``
``BasePredictor``).

The classifier is an FCNet, whose trailing ReLU makes the "logits"
non-negative, as in the reference (modules.py:55).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from vqa_tpu_torch.ops.linear import FCNet


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
        v = embed["v_sum"] if "v_sum" in embed else embed["v"].sum(dim=1)
        joint = embed["q"] * self.v_net(v)
        return self.classifier(joint)
