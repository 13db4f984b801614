"""Model composition and the VQA metric and loss (counterpart of
``vqa_tpu/models/wrapper.py``).

The port holds the Up-Down inference paths: the base encoder with the base
VQA predictor, the Base/BUTD caption decoders, or both. ``set_model`` raises
``NotImplementedError`` for every type or option outside them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vqa_tpu_torch.models.encoder import BaseEncoder
from vqa_tpu_torch.models.generator import set_decoder
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
    """Encoder + optional VQA predictor + optional caption generator
    (reference wrapper.py:39-123). With both heads and ``use_mtl`` it holds
    the MTL uncertainty weights ``log_vars`` [2]."""

    def __init__(self, encoder: nn.Module, predictor: Optional[nn.Module] = None,
                 generator: Optional[nn.Module] = None, use_mtl: bool = False):
        super().__init__()
        self.encoder = encoder
        self.predictor = predictor
        self.generator = generator
        self.use_mtl = use_mtl
        if self.mtl_active:
            self.log_vars = nn.Parameter(torch.zeros(2))

    @property
    def mtl_active(self) -> bool:
        # single-task configurations ignore use_mtl (wrapper.py:50)
        return self.use_mtl and self.predictor is not None \
            and self.generator is not None

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[Optional[torch.Tensor],
                           Optional[Dict[str, torch.Tensor]]]:
        """(predict [B, ans_dim], caption): each None without its head; the
        caption is the generator's teacher-forced output, which needs the
        caption ``c`` and ``cap_len`` in the batch."""
        embed = self.encoder(batch)
        caption = self.generator(embed) if self.generator is not None else None
        predict = self.predictor(embed) if self.predictor is not None else None
        return predict, caption

    def forward_vqa(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Eval path: (scores [B, ans], labels [B], target [B, ans])
        (wrapper.py:113-118). Call it in eval mode."""
        target = _at_least_f32(batch["a"])
        predict = self.predictor(self.encoder(batch))
        score, label = compute_score(predict, target, get_label=True)
        return score, label, target

    def forward_cap(self, batch: Dict[str, torch.Tensor]
                    ) -> Optional[Dict[str, torch.Tensor]]:
        """Caption-only forward (wrapper.py:164-168)."""
        if self.generator is None:
            return None
        return self.generator(self.encoder(batch))

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
    ``model.to(device, dtype)``. The relation-encoder arguments belong to
    types the port does not hold yet."""
    del neg_slope, conv_layer, conv_type, use_spa, use_imp, use_sem
    not_yet = "is not ported yet (ROADMAP.md Queue 1)"
    if encoder_type != "base":
        raise NotImplementedError(f"encoder_type {encoder_type!r} {not_yet}")
    if predictor_type not in ("base", "none"):
        raise NotImplementedError(
            f"predictor_type {predictor_type!r} {not_yet}")
    if decoder_type not in ("base", "butd", "none"):
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
                          with_v=decoder_type != "none",
                          with_v_sum=predictor_type != "none",
                          generator=generator)
    predictor = (BasePredictor(v_dim, hidden_dim, ans_dim,
                               cls_layer=cls_layer, dropout=dropout,
                               generator=generator)
                 if predictor_type == "base" else None)
    decoder = set_decoder(decoder_type, ntoken, decoder_hidden_dim, c_len,
                          dropout=dropout, rnn_type=rnn_type,
                          att_type=att_type, att_dropout=att_dropout,
                          v_dim=v_dim, embed_dim=embed_dim,
                          generator=generator)
    return VQAModel(encoder, predictor, decoder, use_mtl=use_mtl)
