"""Plain PyTorch reference of Up-Down VQA (Anderson et al., arXiv:1707.07998)
and of its VQA-E multi-task training (Li et al., arXiv:1803.07464) with
the Up-Down two-cell caption decoder.

Written from the models' equations. The parameters come as a dict keyed
by the state_dict names of the reference implementation's torch modules
(Jayie/vqa-collection: ``weight_v`` / ``weight_g`` of a weight-normed
Linear with a scalar gain, ``nn.GRU``'s ``weight_ih_l0``, FCNet's
``main.{i}``), which is how the benchmark hands the same tensors to the
program and to this file. Everything is float32 (TF32 off) unless a
:class:`~vqabench.reference.precision.Precision` of ``"fp8"`` rounds the
operands of each product, as the control does.

- Question: word embedding -> one GRU layer over the padded question, its
  last step ``h``.
- Top-down attention (``att_type="new"``): ``vp = ReLU(WN(W_v) v + b)``,
  ``qp = ReLU(WN(W_q) h + b)``, logits ``WN(w) (vp * qp) + b`` with
  attention dropout on ``vp * qp`` in training, softmax over the boxes.
- Answer: ``ReLU(WN h + b) * ReLU(WN (sum_n att_n v_n) + b)``, then the
  classifier ``ReLU(WN2 dropout(ReLU(WN1 x + b1)) + b2)`` (the trailing
  ReLU is the reference's).
- Caption (BUTD): the word GRU over [h2; mean of the attended features;
  previous word], dropout, a Linear query, the decoder's own top-down
  attention over the attended features, the language GRU over [pooled;
  query], dropout, the vocabulary Linear; cross-entropy over the tokens
  before each caption's end.
- Joint loss: ``exp(-s0) L_vqa + s0 + exp(-s1) L_cap + s1`` with learned
  ``s`` (``log_vars``), ``L_vqa`` the binary cross-entropy summed over the
  answers and averaged over the rows.

Features come as the int8 payload and its per-box scales; the reference
forms ``img_q * img_scale`` itself.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from vqabench.reference import philox
from vqabench.reference.precision import Precision

Params = Dict[str, torch.Tensor]


def wn(P: Params, name: str) -> torch.Tensor:
    """The weight-normed matrix ``g * v / ||v||_F`` of layer ``name``."""
    v = P[name + ".weight_v"].float()
    return P[name + ".weight_g"].float() * v / v.norm()


def fc_relu(P: Params, name: str, x: torch.Tensor, prec: Precision):
    return torch.relu(prec.mm(x, wn(P, name).t()) + P[name + ".bias"].float())


def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh, prec: Precision, gi_extra=None):
    """torch's GRU cell, gate order r, z, n; ``gi_extra``: input gates of
    further input rows, computed apart."""
    gi = prec.mm(x, w_ih.float().t()) + b_ih.float()
    if gi_extra is not None:
        gi = gi + gi_extra
    gh = prec.mm(h, w_hh.float().t()) + b_hh.float()
    H = h.shape[1]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1 - z) * n + z * h


def question(P: Params, q: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The question GRU's last padded step [B, H]."""
    emb = P["encoder.embedding.weight"].float()[q.long()]
    pre = "encoder.q_rnn.rnn."
    w_hh = P[pre + "weight_hh_l0"]
    h = emb.new_zeros(q.shape[0], w_hh.shape[1])
    for t in range(q.shape[1]):
        h = gru_cell(emb[:, t], h, P[pre + "weight_ih_l0"], w_hh,
                     P[pre + "bias_ih_l0"], P[pre + "bias_hh_l0"], prec)
    return h


def top_down(P: Params, pre: str, vp, qv, prec: Precision, keep=None,
             scale: float = 1.0):
    """Softmax over the boxes of ``WN(w) (vp * qp) + b``, with ``qp`` the
    query's projection; ``keep`` [B, boxes, H] the dropout mask of the
    joint, its survivors times ``scale``."""
    qp = fc_relu(P, pre + ".W_q.main.0", qv, prec)
    joint = vp * qp[:, None, :]
    if keep is not None:
        joint = joint * (keep.to(joint.dtype) * scale)
    logits = prec.mm(joint, wn(P, pre + ".linear").t())[..., 0] \
        + P[pre + ".linear.bias"].float()
    return torch.softmax(logits, dim=1)


def encode(P: Params, batch, prec: Precision, masks=None):
    """The encoder: question state, attention, attended features."""
    h = question(P, batch["q"], prec)
    feats = batch["img_q"].float() * batch["img_scale"].float()[..., None]
    vp = fc_relu(P, "encoder.attention.W_v.main.0", feats, prec)
    keep = None if masks is None else masks["att"]
    att = top_down(P, "encoder.attention", vp, h, prec, keep,
                   None if masks is None else masks["att_scale"])
    v_sum = torch.einsum("bn,bnd->bd", att, feats)
    return {"h": h, "att": att, "feats": feats, "v_sum": v_sum,
            "q": fc_relu(P, "encoder.q_net.main.0", h, prec)}


def answer_logits(P: Params, enc, prec: Precision, masks=None):
    """The VQA head's output [B, answers] (non-negative)."""
    joint = enc["q"] * fc_relu(P, "predictor.v_net.main.0", enc["v_sum"], prec)
    x = fc_relu(P, "predictor.classifier.main.0", joint, prec)
    if masks is not None:
        x = x * (masks["cls"].to(x.dtype) * masks["cls_scale"])
    return fc_relu(P, "predictor.classifier.main.3", x, prec)


def answer(P: Params, batch, prec: Precision) -> torch.Tensor:
    """Inference: answer logits [B, answers] of a batch (q, img_q,
    img_scale)."""
    return answer_logits(P, encode(P, batch, prec), prec)


def caption_nll(P: Params, enc, batch, prec: Precision, scan=None):
    """(summed token NLL, token count) of the teacher-forced BUTD decoder
    over the caption ``c`` [B, L] before each ``cap_len``. ``scan``: the
    dropout of the steps, ``(seed, row0, p_drop, p_att)``, or None."""
    c, cap_len = batch["c"].long(), batch["cap_len"]
    v = enc["att"][..., None] * enc["feats"]                  # [B, N, D]
    B, N, D = v.shape
    g = "generator."
    H = P[g + "word_rnn.weight_hh"].shape[1]
    emb = P["encoder.embedding.weight"].float()
    v_mean = v.mean(dim=1)
    vp = fc_relu(P, g + "attention.W_v.main.0", v, prec)
    h1 = v.new_zeros(B, H)
    h2 = v.new_zeros(B, H)
    total = v.new_zeros(())
    steps = c.shape[1] - 1
    valid = (torch.arange(steps, device=v.device)[None, :]
             < (cap_len.long()[:, None] - 1)).float()
    if scan is not None:
        seed, row0, p_drop, p_att = scan
        th_h, sc_h = philox.keep_law(p_drop)
        th_a, sc_a = philox.keep_law(p_att)
    # the word GRU's input is [h2; v_mean; word]: the mean feature's gates
    # are the same at every step, so they are computed once
    w_ih = P[g + "word_rnn.weight_ih"].float()
    gi_mean = prec.mm(v_mean, w_ih[:, H:H + D].t())
    w_step = torch.cat([w_ih[:, :H], w_ih[:, H + D:]], dim=1)
    for t in range(steps):
        x = torch.cat([h2, emb[c[:, t]]], dim=1)
        h1 = gru_cell(x, h1, w_step, P[g + "word_rnn.weight_hh"],
                      P[g + "word_rnn.bias_ih"], P[g + "word_rnn.bias_hh"],
                      prec, gi_mean)
        hd, keep_att = h1, None
        if scan is not None:
            k1 = philox.keep(seed, t, row0, B, 1, H, th_h, 1, v.device)[:, 0]
            hd = h1 * (k1.float() * sc_h)
            keep_att = philox.keep(seed, t, row0, B, N, H, th_a, 0, v.device)
        hq = prec.mm(hd, P[g + "h1_fcnet.weight"].float().t()) \
            + P[g + "h1_fcnet.bias"].float()
        att = top_down(P, g + "attention", vp, hq, prec, keep_att,
                       sc_a if scan is not None else 1.0)
        att_v = torch.einsum("bn,bnd->bd", att, v)
        h2 = gru_cell(torch.cat([att_v, hq], dim=1), h2,
                      P[g + "language_rnn.weight_ih"],
                      P[g + "language_rnn.weight_hh"],
                      P[g + "language_rnn.bias_ih"],
                      P[g + "language_rnn.bias_hh"], prec)
        feat = h2
        if scan is not None:
            k2 = philox.keep(seed, t, row0, B, 1, H, th_h, 2, v.device)[:, 0]
            feat = h2 * (k2.float() * sc_h)
        logits = prec.mm(feat, P[g + "h2_fcnet.weight"].float().t()) \
            + P[g + "h2_fcnet.bias"].float()
        nll = torch.logsumexp(logits, dim=1) \
            - logits.gather(1, c[:, t + 1, None])[:, 0]
        total = total + (nll * valid[:, t]).sum()
    return total, valid.sum()


def has_caption(P: Params) -> bool:
    return "generator.word_rnn.weight_ih" in P


def loss_parts(P: Params, batch, prec: Precision, masks=None, scan=None):
    """Summed VQA BCE and, with a caption decoder, the summed caption NLL
    and its token count, of one block of rows."""
    enc = encode(P, batch, prec, masks)
    logits = answer_logits(P, enc, prec, masks)
    bce = F.binary_cross_entropy_with_logits(logits, batch["a"].float(),
                                             reduction="sum")
    if not has_caption(P):
        return bce, None, None
    nll, count = caption_nll(P, enc, batch, prec, scan)
    return bce, nll, count
