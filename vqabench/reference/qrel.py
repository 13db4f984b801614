"""Plain PyTorch reference of Q-Relevant's max-relevance training step
(Wu, Hu and Mooney, "Generating Question Relevant Captions to Aid Visual
Question Answering", ACL 2019, arXiv:1906.00513) with the Up-Down encoder,
the ``q-cap`` head and the BUTD caption decoder under the MTL weighting.

Written from the equations of the reference implementation
(github.com/Jayie/vqa-collection, modules/predictor.py:144-213 and
modules/modules.py:202-306); parameters come as a dict keyed by its torch
modules' state_dict names, as in :mod:`vqabench.reference.updown`, whose
encoder, weight norm and GRU cell this file reuses. Float32, TF32 off
(:func:`~vqabench.reference.precision.exact_float32`), or float8 products
for the control. Imports nothing of the port, JAX or ``vqa_tpu``.

- Encoder (dense features ``img``): the question GRU's last padded step
  ``h``, the top-down attention over the boxes, the attended features
  ``v = att * img`` and ``q = ReLU(WN h + b)``.
- Head, for each (question, caption) pair; ``L(x) = LeakyReLU_0.01(W x)``
  without bias: ``v_proj = L_v(v_n)`` box by box, ``s = sum_n v_proj``;
  the caption embedding (below) ``e``; ``c = L_c(e)``; the fusion
  ``w = softmax_hidden(L_joint(c * L_vq(s)))`` (the softmax over the
  hidden axis, predictor.py:202); ``f = L_vqc(sum_n w * v_proj_n)``
  (``= L_vqc(w * s)``); the output ``sigmoid(L_cls(q * (f + c)))``.
- Caption embedding (modules.py:246-306, the commented per-step form,
  since ``forward_all`` cannot run): the word GRU over the embedded
  caption ``h_t``; ``g_t = sigmoid(drop(h_t * L_gv(s)) + drop(h_t *
  L_gq(q)))``; the caption GRU over ``g_t * h_t``; ``L_fc``; the
  element-wise max over the valid steps, the padded steps counting as 0.
- Per-candidate loss: BCE-with-logits of the sigmoid output (the
  reference's double squash) summed over the answers; each question keeps
  its candidate of lowest loss (the first on ties, not differentiated).
- Caption loss: the chosen caption through the teacher-forced BUTD decoder
  (word GRU over [h2; mean feature; word], dropout, the query Linear, the
  decoder's top-down attention with its dropout, the language GRU,
  dropout, the vocabulary Linear), the mean NLL over the tokens before
  each caption's end.
- Joint loss: ``exp(-s0) L_vqa + s0 + exp(-s1) L_cap + s1``.

Dropout: every mask of a step is drawn from torch's generator under the
step's torch seed (:func:`vqabench.reference.train.step_seeds`), in the
order and at the shapes at which the modules draw them: the encoder's
attention [B, boxes, H]; the caption gates' two [B * n, T, H] (the
candidates of a question adjacent); then, decoder step by step, the word
state [B, H], the attention's joint [B, boxes, H] and the language state
[B, H].

Gradients: one pass without autograd scores every candidate; a second
pass, ``block`` questions at a time, runs the encoder, the chosen
candidate's head and the decoder with autograd. The gradient of the
chosen loss flows through the chosen candidate alone, so the two passes
give the step's gradients.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from vqabench.reference import train as ref_train
from vqabench.reference import updown
from vqabench.reference.precision import Precision

Params = Dict[str, torch.Tensor]
NEG_SLOPE = 0.01
HEAD = "predictor."
CAPTION = "predictor.caption_embedding."
DECODER = "generator."
# the planted faults of the reference: the candidate chosen, or the axis of
# the head's fusion softmax
FAULTS = ("first", "argmax", "boxes")


def lrelu(P: Params, name: str, x: torch.Tensor, prec: Precision):
    """A bias-free Linear and LeakyReLU (slope 0.01)."""
    return F.leaky_relu(prec.mm(x, P[name + ".main.0.weight"].float().t()),
                        NEG_SLOPE)


def linear(P: Params, name: str, x: torch.Tensor, prec: Precision):
    return prec.mm(x, P[name + ".weight"].float().t()) \
        + P[name + ".bias"].float()


def gru(P: Params, pre: str, x: torch.Tensor, prec: Precision):
    """A one-layer GRU (``nn.GRU``'s names under ``pre``) over x [R, T, in]
    from a zero state -> every step's state [R, T, H]."""
    w_hh = P[pre + "weight_hh_l0"]
    h = x.new_zeros(x.shape[0], w_hh.shape[1])
    out = []
    for t in range(x.shape[1]):
        h = updown.gru_cell(x[:, t], h, P[pre + "weight_ih_l0"], w_hh,
                            P[pre + "bias_ih_l0"], P[pre + "bias_hh_l0"], prec)
        out.append(h)
    return torch.stack(out, dim=1)


def _kept(x: torch.Tensor, keep, scale: float):
    return x if keep is None else x * (keep.float() * scale)


# ------------------------------------------------------------------ masks


def draw_masks(seed: int, rows: int, n_cap: int, cfg: dict, dtype: torch.dtype,
               device: torch.device) -> Dict:
    """The keep masks of one step (the module docstring's order), drawn as
    the step's ``nn.Dropout`` calls draw them on tensors of ``dtype``."""
    N, H, T = cfg["num_objs"], cfg["hidden_dim"], cfg["c_len"]
    Hd = cfg["decoder_hidden_dim"]
    p_drop, p_att = cfg["dropout"], cfg["att_dropout"]

    def draw(shape, p):
        return F.dropout(torch.ones(shape, dtype=dtype, device=device), p,
                         True) != 0

    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        masks = {"att": draw((rows, N, H), p_att),
                 "gate_v": draw((rows * n_cap, T, H), p_drop),
                 "gate_q": draw((rows * n_cap, T, H), p_drop),
                 "decoder": [(draw((rows, Hd), p_drop),
                              draw((rows, N, Hd), p_att),
                              draw((rows, Hd), p_drop))
                             for _ in range(T - 1)]}
    masks["drop_scale"] = 1.0 / (1.0 - p_drop)
    masks["att_scale"] = 1.0 / (1.0 - p_att)
    return masks


def _rows(masks: Dict, lo: int, hi: int, n_cap: int, sel=None) -> Dict:
    """The masks of questions ``lo .. hi``; with ``sel`` (their chosen
    candidates), the caption gates' rows of the chosen candidates alone."""
    out = dict(masks)
    out["att"] = masks["att"][lo:hi]
    for k in ("gate_v", "gate_q"):
        m = masks[k][lo * n_cap:hi * n_cap]
        if sel is not None:
            m = m.view(hi - lo, n_cap, *m.shape[1:])[
                torch.arange(hi - lo, device=m.device), sel]
        out[k] = m
    out["decoder"] = [tuple(k[lo:hi] for k in step)
                      for step in masks["decoder"]]
    return out


# ---------------------------------------------------------------- forward


def encode(P: Params, img: torch.Tensor, q: torch.Tensor, prec: Precision,
           masks: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The Up-Down encoder on dense features: ``v`` [B, boxes, D] (the
    attended features) and ``q`` [B, H] (``q_net`` of the question)."""
    h = updown.question(P, q, prec)
    feats = img.float()
    vp = updown.fc_relu(P, "encoder.attention.W_v.main.0", feats, prec)
    keep = None if masks is None else masks["att"]
    att = updown.top_down(P, "encoder.attention", vp, h, prec, keep,
                          None if masks is None else masks["att_scale"])
    return {"v": att[..., None] * feats,
            "q": updown.fc_relu(P, "encoder.q_net.main.0", h, prec)}


def caption_embedding(P: Params, s: torch.Tensor, q: torch.Tensor,
                      c_emb: torch.Tensor, cap_len: torch.Tensor,
                      prec: Precision, masks: Optional[Dict] = None):
    """The gated caption embedding [R, H] of the embedded captions c_emb
    [R, T, E] of valid lengths ``cap_len`` [R], for the summed box
    projections ``s`` [R, H] and the questions ``q`` [R, H]."""
    h = gru(P, CAPTION + "word_rnn.rnn.", c_emb, prec)
    jv = h * lrelu(P, CAPTION + "attention.W_v", s, prec)[:, None, :]
    jq = h * lrelu(P, CAPTION + "attention.W_q", q, prec)[:, None, :]
    if masks is not None:
        jv = _kept(jv, masks["gate_v"], masks["drop_scale"])
        jq = _kept(jq, masks["gate_q"], masks["drop_scale"])
    gate = torch.sigmoid(jv + jq)
    out = lrelu(P, CAPTION + "fcnet",
                gru(P, CAPTION + "caption_rnn.rnn.", gate * h, prec), prec)
    step = torch.arange(c_emb.shape[1], device=c_emb.device)[None, :, None]
    out = torch.where(step < cap_len.long()[:, None, None], out,
                      torch.zeros_like(out))
    return out.amax(dim=1)


def head(P: Params, v_proj: torch.Tensor, q: torch.Tensor,
         c_emb: torch.Tensor, cap_len: torch.Tensor, prec: Precision,
         masks: Optional[Dict] = None, fault: Optional[str] = None):
    """The q-cap head's output [R, answers] in (0, 1) from the projected
    boxes ``v_proj`` [R, boxes, H]. ``fault == "boxes"``: the fusion
    forms a logit for each box, ``L_joint(c * L_vq(v_proj_n))``, and
    softmaxes over the boxes in place of the hidden axis."""
    s = v_proj.sum(dim=1)
    c = lrelu(P, HEAD + "c_net",
              caption_embedding(P, s, q, c_emb, cap_len, prec, masks), prec)
    if fault == "boxes":
        w = torch.softmax(lrelu(P, HEAD + "joint_net", c[:, None, :]
                                * lrelu(P, HEAD + "vq_net", v_proj, prec),
                                prec), dim=1)
        fused = (w * v_proj).sum(dim=1)
    else:
        w = torch.softmax(lrelu(P, HEAD + "joint_net",
                                c * lrelu(P, HEAD + "vq_net", s, prec), prec),
                          dim=1)
        fused = w * s        # sum_n w * v_proj_n, w the same for every box
    f = lrelu(P, HEAD + "vqc_net", fused, prec)
    return torch.sigmoid(lrelu(P, HEAD + "cls_net", q * (f + c), prec))


def candidate_bce(predict: torch.Tensor, target: torch.Tensor):
    """BCE-with-logits of each row summed over the answers: [R, A] -> [R]."""
    return F.binary_cross_entropy_with_logits(
        predict, target.float(), reduction="none").sum(dim=-1)


def pick(per: torch.Tensor, fault: Optional[str] = None) -> torch.Tensor:
    """Each question's chosen candidate [B] of its losses ``per`` [B, n]:
    the lowest (the first on ties); ``fault``: the first candidate always,
    or the highest loss."""
    if fault == "first":
        return torch.zeros(per.shape[0], dtype=torch.long, device=per.device)
    if fault == "argmax":
        return torch.argmax(per, dim=1)
    return torch.argmin(per, dim=1)


def caption_nll(P: Params, v: torch.Tensor, c: torch.Tensor,
                cap_len: torch.Tensor, prec: Precision,
                masks: Optional[Dict] = None):
    """(summed token NLL, token count) of the teacher-forced BUTD decoder
    over the captions ``c`` [B, T] before each ``cap_len``, the dropout of
    ``masks["decoder"]`` (one (word state, attention joint, language
    state) triple a step) where given."""
    c = c.long()
    B = v.shape[0]
    g = DECODER
    H = P[g + "word_rnn.weight_hh"].shape[1]
    emb = P["encoder.embedding.weight"].float()
    v_mean = v.mean(dim=1)
    vp = updown.fc_relu(P, g + "attention.W_v.main.0", v, prec)
    h1 = v.new_zeros(B, H)
    h2 = v.new_zeros(B, H)
    steps = c.shape[1] - 1
    valid = (torch.arange(steps, device=v.device)[None, :]
             < (cap_len.long()[:, None] - 1)).float()
    total = v.new_zeros(())
    for t in range(steps):
        k1 = ka = k2 = None
        if masks is not None:
            k1, ka, k2 = masks["decoder"][t]
        x = torch.cat([h2, v_mean, emb[c[:, t]]], dim=1)
        h1 = updown.gru_cell(x, h1, P[g + "word_rnn.weight_ih"],
                             P[g + "word_rnn.weight_hh"],
                             P[g + "word_rnn.bias_ih"],
                             P[g + "word_rnn.bias_hh"], prec)
        scale = 1.0 if masks is None else masks["drop_scale"]
        hq = linear(P, g + "h1_fcnet", _kept(h1, k1, scale), prec)
        att = updown.top_down(P, g + "attention", vp, hq, prec, ka,
                              1.0 if masks is None else masks["att_scale"])
        att_v = torch.einsum("bn,bnd->bd", att, v)
        h2 = updown.gru_cell(torch.cat([att_v, hq], dim=1), h2,
                             P[g + "language_rnn.weight_ih"],
                             P[g + "language_rnn.weight_hh"],
                             P[g + "language_rnn.bias_ih"],
                             P[g + "language_rnn.bias_hh"], prec)
        logits = linear(P, g + "h2_fcnet", _kept(h2, k2, scale), prec)
        nll = torch.logsumexp(logits, dim=1) \
            - logits.gather(1, c[:, t + 1, None])[:, 0]
        total = total + (nll * valid[:, t]).sum()
    return total, valid.sum()


# ------------------------------------------------------------------- step


def candidate_losses(P: Params, batch, prec: Precision, masks: Dict,
                     block: int, fault: Optional[str] = None):
    """Every candidate's VQA loss [B, n] (no autograd), ``block``
    questions at a time."""
    B, n = batch["c_all"].shape[:2]
    emb = P["encoder.embedding.weight"].float()
    out = []
    with torch.no_grad():
        for lo in range(0, B, block):
            hi = min(B, lo + block)
            m = _rows(masks, lo, hi, n) if masks is not None else None
            enc = encode(P, batch["img"][lo:hi], batch["q"][lo:hi], prec, m)
            v_proj = lrelu(P, HEAD + "v_net", enc["v"], prec)
            c = batch["c_all"][lo:hi].long().reshape((hi - lo) * n, -1)
            pred = head(P, v_proj.repeat_interleave(n, dim=0),
                        enc["q"].repeat_interleave(n, dim=0), emb[c],
                        batch["cap_len_all"][lo:hi].reshape(-1), prec, m,
                        fault)
            out.append(candidate_bce(
                pred, batch["a"][lo:hi].repeat_interleave(n, dim=0)
            ).view(hi - lo, n))
    return torch.cat(out)


def loss_and_grads(P: Params, batch, run_seed: int, step: int, cfg: dict,
                   prec: Precision, block: int, mask_dtype: torch.dtype,
                   fault: Optional[str] = None):
    """The step's loss (a float), every candidate's VQA loss [B, n] and
    the chosen candidates [B], with the gradients left in ``P``'s
    ``.grad``."""
    torch_seed, _ = ref_train.step_seeds(run_seed, step)
    B, n = batch["c_all"].shape[:2]
    masks = draw_masks(torch_seed, B, n, cfg, mask_dtype, batch["q"].device)
    per = candidate_losses(P, batch, prec, masks, block, fault)
    sel = pick(per, fault)
    rows = torch.arange(B, device=sel.device)
    c_sel = batch["c_all"][rows, sel].long()
    len_sel = batch["cap_len_all"][rows, sel]
    steps = c_sel.shape[1] - 1
    count = torch.clamp(len_sel.long() - 1, 0, steps).sum().float() \
        .clamp_min(1.0)
    emb = P["encoder.embedding.weight"]
    for p in P.values():
        p.grad = None
    total = 0.0
    for lo in range(0, B, block):
        hi = min(B, lo + block)
        m = _rows(masks, lo, hi, n, sel[lo:hi])
        enc = encode(P, batch["img"][lo:hi], batch["q"][lo:hi], prec, m)
        v_proj = lrelu(P, HEAD + "v_net", enc["v"], prec)
        pred = head(P, v_proj, enc["q"], emb.float()[c_sel[lo:hi]],
                    len_sel[lo:hi], prec, m, fault)
        bce = candidate_bce(pred, batch["a"][lo:hi]).sum()
        nll, _ = caption_nll(P, enc["v"], c_sel[lo:hi], len_sel[lo:hi], prec,
                             m)
        s = P["log_vars"].float()
        loss = (torch.exp(-s[0]) * bce / B + torch.exp(-s[1]) * nll / count
                + (s[0] + s[1]) * ((hi - lo) / B))
        loss.backward()
        total += float(loss.detach())
    return total, per, sel


def run_steps(P0: Params, batches: List[Dict], run_seed: int, steps: int,
              cfg: dict, prec: Precision, block: int,
              mask_dtype: torch.dtype, fault: Optional[str] = None):
    """``steps`` max-relevance steps from the parameters ``P0`` (copied) on
    ``batches[0 .. steps - 1]``: the loss, the clip and Adamax of
    :mod:`vqabench.reference.train`. Returns (losses, the first step's
    clipped gradients, the parameters after the last step, each step's
    candidate losses, each step's chosen candidates).

    ``fault``: ``"half"`` leaves out the second half of each batch and
    takes the means over the rest; ``"first"``, ``"argmax"``, ``"boxes"``
    (:data:`FAULTS`) as :func:`pick` and :func:`head` plant them."""
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in P0.items()}
    opt = ref_train.Adamax(P, cfg["lr"])
    losses, first, pers, sels = [], None, [], []
    model_fault = fault if fault in FAULTS else None
    for s in range(steps):
        batch = batches[s]
        if fault == "half":
            half = batch["q"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        loss, per, sel = loss_and_grads(P, batch, run_seed, s, cfg, prec,
                                        block, mask_dtype, model_fault)
        losses.append(loss)
        pers.append(per)
        sels.append(sel)
        ref_train.clip_([p.grad for p in P.values()], cfg["max_norm"])
        if s == 0:
            first = {k: p.grad.detach().clone() for k, p in P.items()}
        opt.step(P)
    return losses, first, {k: p.detach() for k, p in P.items()}, pers, sels
