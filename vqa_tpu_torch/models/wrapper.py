"""Model composition and the VQA metric and loss (counterpart of
``vqa_tpu/models/wrapper.py``).

The port holds the encoders ``base``, ``relation`` (ReGAT) and ``cap``,
the VQA heads ``base``, ``base-cap`` (VQA-E, which reads the caption too)
and ``q-cap`` (Q-Relevant, the gated caption embedding), and the Base/BUTD
caption decoders over any of the encoders (the relation encoder with a
decoder is GCN-LSTM), each alone or with both heads, for inference and for
training through ``get_loss`` (the MTL uncertainty weighting with both
heads) or the max-relevance step of ``training/select.py``, with a learned
or a frozen GloVe word embedding.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vqa_tpu_torch import tracing
from vqa_tpu_torch.models.encoder import (
    BaseEncoder, CaptionEncoder, RelationEncoder)
from vqa_tpu_torch.models.generator import set_decoder, token_mean
from vqa_tpu_torch.models.predictor import (
    BaseCaptionPredictor, BasePredictor, PredictorwithCaption)


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


def ce_for_language_model(predict: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor, token_count=None
                          ) -> torch.Tensor:
    """Masked token cross-entropy, the mean over valid positions
    (wrapper.py:68-79): predict [B, T, ntoken], target [B, T], mask [B, T];
    ``lse - logit[target]`` in at least f32. ``token_count``: see
    :func:`token_mean`."""
    predict = _at_least_f32(predict)
    lse = torch.logsumexp(predict, dim=-1)
    tgt = torch.gather(predict, -1, target[..., None].long())[..., 0]
    return token_mean(torch.sum((lse - tgt) * mask), torch.sum(mask),
                      token_count)


class VQAModel(nn.Module):
    """Encoder + optional VQA predictor + optional caption generator
    (reference wrapper.py:39-123). With both heads and ``use_mtl`` it holds
    the MTL uncertainty weights ``log_vars`` [2]. ``fused_cap_loss``: the
    caption loss of ``get_loss`` goes through the decoder's
    ``caption_loss`` (the vocab head after the steps, in chunks), else the
    teacher-forced forward and ``ce_for_language_model``."""

    def __init__(self, encoder: nn.Module, predictor: Optional[nn.Module] = None,
                 generator: Optional[nn.Module] = None, use_mtl: bool = False,
                 fused_cap_loss: bool = True):
        super().__init__()
        self.encoder = encoder
        self.predictor = predictor
        self.generator = generator
        self.use_mtl = use_mtl
        self.fused_cap_loss = fused_cap_loss
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
        with tracing.span("vqa.forward", device=True):
            embed = self.encoder(batch)
            caption = (self.generator(embed) if self.generator is not None
                       else None)
            predict = (self.predictor(embed) if self.predictor is not None
                       else None)
        return predict, caption

    def get_loss(self, batch: Dict[str, torch.Tensor], *,
                 seed: Optional[int] = None, token_count=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The joint training loss and its metrics (wrapper.py:114-152):
        ``train/loss`` (VQA BCE), ``train/score`` (summed soft score) and
        ``train/cap/loss`` (caption CE), as device tensors. With ``log_vars``
        the loss is ``sum_i exp(-s_i) L_i + s_i``. Dropout follows the
        module's mode; ``seed`` is the caption scan's dropout seed;
        ``token_count`` the caption CE's count map (:func:`token_mean`)."""
        embed = self.encoder(batch)
        loss_cap = None
        if self.generator is not None and self.fused_cap_loss:
            loss_cap = self.generator.caption_loss(
                embed, seed=seed, token_count=token_count)["loss"]
        elif self.generator is not None:
            caption = self.generator(embed)
            loss_cap = ce_for_language_model(caption["predict"],
                                             caption["target"],
                                             caption["mask"], token_count)
        predict = self.predictor(embed) if self.predictor is not None else None
        # the uncertainty weights exp(-s_i) in f32, as the losses: in bf16
        # they would round by up to 2**-9, a bias in the joint loss that
        # JAX's compiler does not have (it keeps excess precision there)
        log_vars = self.log_vars.float() if self.mtl_active else None
        # (a VQA head alone on the int8 feed forms no dense "v")
        loss = torch.zeros((), dtype=torch.float32,
                           device=next(iter(embed.values())).device)
        writes: Dict[str, torch.Tensor] = {}
        if predict is not None:
            target = _at_least_f32(batch["a"])
            loss_vqa = instance_bce_with_logits(predict, target)
            writes["train/loss"] = loss_vqa
            writes["train/score"] = torch.sum(compute_score(predict, target))
            loss = loss + (torch.exp(-log_vars[0]) * loss_vqa + log_vars[0]
                           if log_vars is not None else loss_vqa)
        if loss_cap is not None:
            writes["train/cap/loss"] = loss_cap
            loss = loss + (torch.exp(-log_vars[1]) * loss_cap + log_vars[1]
                           if log_vars is not None else loss_cap)
        return loss, writes

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


def resolve_device(device=None) -> torch.device:
    """The device an entry point of the port runs on: ``device`` where the
    caller gives one, else the first CUDA device. Without CUDA the caller
    must ask for the CPU: the port never falls back to it silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the port "
            "on the CPU (its kernels then run their plain versions)")
    return torch.device("cuda", 0)


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
              generator: Optional[torch.Generator] = None,
              device=None) -> VQAModel:
    """Model factory with ``vqa_tpu``'s signature. Parameters are drawn in
    f32 on the CPU from ``generator`` (so a seed gives the same weights on
    any device), then moved to ``device``: ``cuda:0`` unless the caller
    asks for another, and an error where there is no CUDA device and no
    ``device`` was given. ``frozen_embedding``: a GloVe table
    (``ops/embedding.py`` ``load_glove_table``) in place of the encoder's
    learned word embedding. The ``q-cap`` head reads the attended
    features box by box, so its base encoder forms the dense ``v`` on the
    int8 feed too, and no pooled ``v_sum``."""
    if encoder_type not in ("base", "relation", "cap"):
        raise ValueError(f"unknown encoder_type: {encoder_type}")
    if predictor_type not in ("base", "base-cap", "q-cap", "none"):
        raise ValueError(f"unknown predictor_type: {predictor_type}")
    if decoder_type not in ("base", "butd", "none"):
        raise ValueError(f"unknown decoder_type: {decoder_type}")
    target = resolve_device(device)    # fails before any weight is drawn
    common = dict(rnn_layer=rnn_layer, dropout=dropout, rnn_type=rnn_type,
                  att_type=att_type, att_dropout=att_dropout,
                  use_pallas=use_pallas, use_int8=use_int8,
                  frozen_embedding=frozen_embedding, generator=generator)
    if encoder_type == "relation":
        encoder = RelationEncoder(ntoken, v_dim, embed_dim, hidden_dim,
                                  conv_layer=conv_layer, conv_type=conv_type,
                                  use_imp=bool(use_imp), use_spa=bool(use_spa),
                                  use_sem=bool(use_sem), **common)
    elif encoder_type == "cap":
        encoder = CaptionEncoder(ntoken, embed_dim, frozen_embedding,
                                 generator=generator)
    else:
        encoder = BaseEncoder(
            ntoken, v_dim, embed_dim, hidden_dim,
            with_v=decoder_type != "none" or predictor_type == "q-cap",
            with_v_sum=predictor_type in ("base", "base-cap"), **common)
    head = dict(cls_layer=cls_layer, dropout=dropout, generator=generator)
    if predictor_type == "base":
        predictor = BasePredictor(v_dim, hidden_dim, ans_dim, **head)
    elif predictor_type == "base-cap":
        predictor = BaseCaptionPredictor(v_dim, embed_dim, hidden_dim,
                                         ans_dim, **head)
    elif predictor_type == "q-cap":
        predictor = PredictorwithCaption(v_dim, embed_dim, hidden_dim,
                                         ans_dim, neg_slope=neg_slope, **head)
    else:
        predictor = None
    decoder = set_decoder(decoder_type, ntoken, decoder_hidden_dim, c_len,
                          dropout=dropout, rnn_type=rnn_type,
                          att_type=att_type, att_dropout=att_dropout,
                          pallas_att=use_pallas, v_dim=v_dim,
                          embed_dim=embed_dim, generator=generator)
    return VQAModel(encoder, predictor, decoder, use_mtl=use_mtl).to(target)
