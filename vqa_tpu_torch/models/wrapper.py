"""Model composition and the VQA metric and loss (counterpart of
``vqa_tpu/models/wrapper.py``).

This slice of the port holds the Up-Down VQA inference path: the base
encoder and the base predictor. ``set_model`` raises ``NotImplementedError``
for every type or option outside it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vqa_tpu_torch.models.encoder import BaseEncoder
from vqa_tpu_torch.models.predictor import BasePredictor


def compute_score(predict: torch.Tensor, target: torch.Tensor,
                  get_label: bool = False):
    """VQA soft score (reference wrapper.py:8-22): ``one_hot(argmax) *
    target`` [B, ans_dim], and optionally the argmax labels [B]."""
    labels = torch.argmax(predict, dim=1)
    scores = F.one_hot(labels, predict.shape[1]).to(target.dtype) * target
    if get_label:
        return scores, labels
    return scores


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def instance_bce_with_logits(predict: torch.Tensor,
                             target: torch.Tensor) -> torch.Tensor:
    """Mean BCE-with-logits times the number of answers (wrapper.py:25-29),
    computed in at least f32."""
    predict, target = _at_least_f32(predict), _at_least_f32(target)
    loss = F.binary_cross_entropy_with_logits(predict, target)
    return loss * predict.shape[1]


class VQAModel(nn.Module):
    """Encoder + VQA predictor (reference wrapper.py:39-123)."""

    def __init__(self, encoder: nn.Module, predictor: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.predictor = predictor

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, None]:
        """(predict [B, ans_dim], caption); this slice has no caption
        decoder, so caption is None."""
        return self.predictor(self.encoder(batch)), None

    def forward_vqa(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Eval path: (scores [B, ans], labels [B], target [B, ans])
        (wrapper.py:113-118). Call it in eval mode."""
        target = _at_least_f32(batch["a"])
        predict, _ = self(batch)
        score, label = compute_score(predict, target, get_label=True)
        return score, label, target

    def get_att(self, batch: Dict[str, torch.Tensor]):
        """(predict, v_att) for visualization (wrapper.py:107-110)."""
        embed = self.encoder(batch)
        return self.predictor(embed), embed["v_att"]


def set_model(encoder_type: str = "base",
              predictor_type: str = "base",
              decoder_type: str = "base",
              ntoken: int = 0,
              v_dim: int = 0,
              embed_dim: int = 0,
              hidden_dim: int = 0,
              decoder_hidden_dim: int = 0,
              rnn_layer: int = 1,
              ans_dim: int = 0,
              cls_layer: int = 2,
              c_len: int = 20,
              dropout: float = 0.5,
              neg_slope: float = 0.01,
              rnn_type: str = "GRU",
              att_type: str = "base",
              att_dropout: float = 0.2,
              conv_layer: int = 2,
              conv_type: str = "corr",
              use_spa: bool = True,
              use_imp: bool = False,
              use_sem: bool = False,
              use_mtl: bool = False,
              frozen_embedding: Optional[np.ndarray] = None,
              use_pallas: bool = False,
              use_int8: bool = False,
              *,
              generator: Optional[torch.Generator] = None) -> VQAModel:
    """Model factory with ``vqa_tpu``'s signature. Parameters are made on the
    CPU in f32 from ``generator``; the caller moves the model with
    ``model.to(device, dtype)``. The decoder, relation-encoder and MTL
    arguments belong to types this slice does not hold."""
    del decoder_hidden_dim, c_len, neg_slope, conv_layer, conv_type
    del use_spa, use_imp, use_sem, use_mtl
    not_yet = "is not ported yet (ROADMAP.md Queue 1)"
    if encoder_type != "base":
        raise NotImplementedError(f"encoder_type {encoder_type!r} {not_yet}")
    if predictor_type != "base":
        raise NotImplementedError(
            f"predictor_type {predictor_type!r} {not_yet}")
    if decoder_type != "none":
        raise NotImplementedError(f"decoder_type {decoder_type!r} {not_yet}")
    if frozen_embedding is not None:
        raise NotImplementedError(f"a frozen GloVe embedding {not_yet}")
    if use_int8:
        raise NotImplementedError(
            "use_int8 needs the int8_matmul kernel, which is not ported yet "
            "(ROADMAP.md Queue 2, int8_matmul.py)")
    encoder = BaseEncoder(ntoken, v_dim, embed_dim, hidden_dim,
                          rnn_layer=rnn_layer, dropout=dropout,
                          rnn_type=rnn_type, att_type=att_type,
                          att_dropout=att_dropout, use_pallas=use_pallas,
                          generator=generator)
    predictor = BasePredictor(v_dim, hidden_dim, ans_dim, cls_layer=cls_layer,
                              dropout=dropout, generator=generator)
    return VQAModel(encoder, predictor)
