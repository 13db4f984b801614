"""Q-Relevant max-relevance training: every candidate caption is scored,
and the loss backpropagates only from the most relevant one (counterpart
of ``vqa_tpu/training/select.py``).

The reference declares ``train_select`` with a ``pass`` body; both packages
implement the strategy its README states: *use all captions, but only
backprop the loss from the most relevant one*. Each step runs the VQA head
on all ``n_cap`` candidates of every question at once (the rows expanded
as [B, n_cap, ...] -> [B * n_cap, ...], each question's candidates
adjacent), takes the candidate with the lowest VQA loss (a detached
``argmin``, the first on ties), and sends the VQA loss and the caption loss
through that candidate alone.

The caption loss is the decoder's teacher-forced forward and
``ce_for_language_model``, as in the JAX package, not the fused
``caption_loss`` route of ``get_loss``: the step launches no
decode-attention kernel. The sigmoid output of the ``q-cap`` head is
treated as logits by ``per_sample_bce``, the reference's double squash.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from vqa_tpu_torch.models.wrapper import (
    VQAModel, _at_least_f32, ce_for_language_model, compute_score)
from vqa_tpu_torch.training.optim import Optimizer
from vqa_tpu_torch.training.state import TrainState, make_train_step

# the encoder's inputs among the all-candidates batch's keys
_ENCODER_KEYS = ("img", "img_q", "img_scale", "q", "graph", "sem_graph")


def per_sample_bce(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits of each row, the mean over answers times their
    number (``instance_bce_with_logits`` without the batch mean), in at
    least f32: [B, A] -> [B]."""
    predict, target = _at_least_f32(predict), _at_least_f32(target)
    loss = torch.clamp(predict, min=0) - predict * target \
        + torch.log1p(torch.exp(-predict.abs()))
    return loss.mean(dim=-1) * predict.shape[-1]


def _attended_v(embed: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The attended features [B, objs, v_dim]; on an int8 feed whose encoder
    formed none, ``v_att * (img_q * img_scale)`` as the JAX encoder forms
    them (the dequantized features in the scale's dtype, then the
    product)."""
    if "v" in embed:
        return embed["v"]
    scale = batch["img_scale"]
    return embed["v_att"] * (batch["img_q"].to(scale.dtype) * scale[..., None])


def get_select_loss(mdl: VQAModel, batch: Dict[str, torch.Tensor],
                    seed: Optional[int] = None, token_count=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The joint loss with each question's most relevant caption selected.

    ``batch``: the visual feed (``img``, or ``img_q`` / ``img_scale``),
    ``q`` [B, q_len], ``a`` [B, A], ``c_all`` [B, n_cap, c_len] and
    ``cap_len_all`` [B, n_cap]. Dropout follows the module's mode; ``seed``
    is unused (the caption loss runs no counter-based scan);
    ``token_count``: the caption CE's count map (``generator.token_mean``).
    Returns the
    loss and ``train/loss``, ``train/score`` (of the selected candidates'
    predictions) and, with a decoder, ``train/cap/loss``.
    """
    del seed
    embed = mdl.encoder({k: batch[k] for k in _ENCODER_KEYS if k in batch})
    v, q = _attended_v(embed, batch), embed["q"]
    c_all, cap_len_all = batch["c_all"], batch["cap_len_all"]
    b, n_cap, c_len = c_all.shape

    # every candidate's VQA prediction: each question's rows repeated in
    # place, so that row b * n_cap + j is question b with caption j
    c_emb = mdl.encoder.embed(c_all)                       # [B, n, T, E]
    predict = mdl.predictor({
        "v": v.repeat_interleave(n_cap, dim=0),
        "q": q.repeat_interleave(n_cap, dim=0),
        "c": c_emb.reshape(b * n_cap, c_len, -1),
        "cap_len": cap_len_all.reshape(b * n_cap)})       # [B * n, A]
    target = _at_least_f32(batch["a"])
    per = per_sample_bce(predict, target.repeat_interleave(n_cap, dim=0)
                         ).reshape(b, n_cap)

    # the most relevant candidate has the lowest VQA loss; the choice is
    # not differentiated, the chosen path is
    sel = torch.argmin(per.detach(), dim=1)                # [B]
    rows = torch.arange(b, device=sel.device)
    loss_vqa = per[rows, sel].mean()
    sel_predict = predict.reshape(b, n_cap, -1)[rows, sel]
    writes = {"train/loss": loss_vqa,
              "train/score": torch.sum(compute_score(sel_predict, target))}

    log_vars = mdl.log_vars if mdl.mtl_active else None
    loss = (torch.exp(-log_vars[0]) * loss_vqa + log_vars[0]
            if log_vars is not None else loss_vqa)
    if mdl.generator is not None:
        c_sel = c_all[rows, sel]                           # [B, T]
        caption = mdl.generator({"v": v, "c": mdl.encoder.embed(c_sel),
                                 "c_target": c_sel,
                                 "cap_len": cap_len_all[rows, sel]})
        loss_cap = ce_for_language_model(caption["predict"],
                                         caption["target"], caption["mask"],
                                         token_count)
        writes["train/cap/loss"] = loss_cap
        loss = loss + (torch.exp(-log_vars[1]) * loss_cap + log_vars[1]
                       if log_vars is not None else loss_cap)
    return loss, writes


def make_train_select_step(model: VQAModel, optimizer: Optimizer,
                           compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                           mesh=None) -> Callable[[TrainState, Dict],
                                                  Dict[str, torch.Tensor]]:
    """The max-relevance training step, with ``make_train_step``'s contract
    (the casts over f32 masters, the clip, Adamax, the seeds of
    ``step_seeds``, the mesh) and :func:`get_select_loss` as its loss."""
    return make_train_step(model, optimizer, compute_dtype,
                           loss_fn=get_select_loss, mesh=mesh)
