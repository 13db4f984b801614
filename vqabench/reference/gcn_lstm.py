"""Plain PyTorch reference of GCN-LSTM training (Yao, Pan, Li and Mei,
"Exploring Visual Relationship for Image Captioning", ECCV 2018,
arXiv:1809.07041) as the port composes it: ReGAT's relation encoder with
one correlated graph convolution over the spatial graph, under the BUTD
caption decoder, trained on the caption cross-entropy alone.

Parameters and precision follow :mod:`vqabench.reference.updown`, whose
question GRU, top-down attention and caption decoder this file reads:
a dict keyed by the program's state_dict names, float32 (TF32 off) unless
a :class:`~vqabench.reference.precision.Precision` of ``"fp8"`` rounds the
operands of each product. Imports nothing of the port, JAX or ``vqa_tpu``.

- Encoder: the question GRU's last padded step, the top-down attention
  over the boxes (its dropout on the joint), the attended features ``f =
  att_i v_i`` [B, 36, 2048] (:func:`vqabench.reference.updown.encode`).
- Graph stage, :func:`graph_conv`, unfolded as
  :func:`vqabench.reference.regat.graph_conv` writes it (the program folds
  ``w0 + w1``; training runs the two correlation projections as the
  reference writes them)::

      out   = w2(f) + adj @ w0(f) + adj @ w1(f) + sum_j label_bias[graph[i, j]]
      alpha = softmax(adj @ ReLU((f Wa^T + ba)(f Wb^T + bb)^T), dim=1)
      v'    = ReLU(dropout_0.5(alpha @ out))

  with ``adj = graph != 0``.
- Decoder: BUTD's two GRU cells over ``v'``, teacher-forced over
  ``c_len - 1`` steps with the scan's Philox dropout masks
  (:func:`vqabench.reference.updown.caption_nll`).
- Loss: the summed token NLL over the program's token count, the tokens
  before each caption's end over the whole batch (at least 1).

Dropout: the encoder attention's [B, boxes, H] mask and then the graph
stage's [B, boxes, D] mask are drawn from torch's generator under the
step's torch seed (:func:`vqabench.reference.train.step_seeds`), as the
two ``nn.Dropout`` calls draw them on tensors of the step's compute dtype;
the decoder's from the counter-based masks of
:mod:`vqabench.reference.philox` under the step's scan seed.

Gradients by autograd, ``block`` rows at a time; then the global-norm clip
and Adamax of :mod:`vqabench.reference.train`. The question's ``q_net``
feeds no loss here (it is the VQA head's input), so its gradient is zero,
as the program's optimizer, which skips it, leaves it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from vqabench.reference import regat, updown
from vqabench.reference import train as ref_train
from vqabench.reference.precision import Precision

Params = updown.Params
CONV = regat.CONV
# the planted faults of the reference: the decoder reads the attended
# features and not the graph stage's output; the correlation softmaxed
# over axis 2; the label bias left out; the graph stage's dropout left out
FAULTS = ("no_graph", "softmax_axis2", "no_label_bias", "no_gcn_dropout")


def draw_masks(seed: int, rows: int, cfg: dict, dtype: torch.dtype,
               device: torch.device) -> Dict:
    """The torch-drawn keep masks of one step: the encoder attention's,
    then the graph stage's, as the step's ``nn.Dropout`` calls draw them
    on tensors of ``dtype``."""
    N, H, D = cfg["num_objs"], cfg["hidden_dim"], cfg["v_dim"]
    p_drop, p_att = cfg["dropout"], cfg["att_dropout"]

    def draw(shape, p):
        return F.dropout(torch.ones(shape, dtype=dtype, device=device), p,
                         True) != 0

    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        masks = {"att": draw((rows, N, H), p_att),
                 "gcn": draw((rows, N, D), p_drop)}
    masks["att_scale"] = 1.0 / (1.0 - p_att)
    masks["gcn_scale"] = 1.0 / (1.0 - p_drop)
    return masks


def graph_conv(P: Params, f: torch.Tensor, graph: torch.Tensor,
               prec: Precision, fault: Optional[str] = None) -> torch.Tensor:
    """:func:`vqabench.reference.regat.graph_conv`'s equations (the same
    operations, so the same bits without a fault), with the faults
    ``softmax_axis2`` and ``no_label_bias`` planted where they act."""
    lin = regat._linear
    g = graph.long()
    adj = (g != 0).float()
    out = (lin(P, CONV + "w2", f, prec, bias=False)
           + prec.mm(adj, lin(P, CONV + "w0", f, prec, bias=False))
           + prec.mm(adj, lin(P, CONV + "w1", f, prec, bias=False)))
    if fault != "no_label_bias":
        label_bias = P[CONV + "label_bias"].float()
        for j in range(g.shape[2]):
            out = out + label_bias[g[:, :, j]]
    a = lin(P, CONV + "dot_product.wa", f, prec)
    b = lin(P, CONV + "dot_product.wb", f, prec)
    alpha = prec.mm(a, b.transpose(1, 2))
    alpha = torch.softmax(prec.mm(adj, torch.relu(alpha)),
                          dim=2 if fault == "softmax_axis2" else 1)
    return prec.mm(alpha, out)


def caption_nll(P: Params, batch, prec: Precision, masks=None, scan=None,
                fault: Optional[str] = None):
    """(summed token NLL, token count) of one block of rows: the encoder,
    the graph stage and the teacher-forced decoder. ``masks``: the block's
    rows of :func:`draw_masks`; ``scan``: the decoder's dropout, as
    :func:`vqabench.reference.updown.caption_nll` takes it."""
    enc = updown.encode(P, batch, prec, masks)
    f = enc["att"][..., None] * enc["feats"]
    if fault == "no_graph":
        v = f
    else:
        v = graph_conv(P, f, batch["graph"], prec, fault)
        if masks is not None and fault != "no_gcn_dropout":
            v = v * (masks["gcn"].to(v.dtype) * masks["gcn_scale"])
        v = torch.relu(v)
    # the decoder reads att * feats: hand it v' with unit weights
    return updown.caption_nll(P, {"att": torch.ones_like(v[..., 0]),
                                  "feats": v}, batch, prec, scan)


def loss_and_grads(P: Params, batch, run_seed: int, step: int, cfg: dict,
                   prec: Precision, block: int, mask_dtype: torch.dtype,
                   fault: Optional[str] = None) -> float:
    """The step's loss (a float) with the gradients left in ``P``'s
    ``.grad`` (zero for a leaf that no loss reads), computed ``block``
    rows at a time."""
    torch_seed, scan_seed = ref_train.step_seeds(run_seed, step)
    B = batch["q"].shape[0]
    masks = draw_masks(torch_seed, B, cfg, mask_dtype, batch["q"].device)
    steps = batch["c"].shape[1] - 1
    count = torch.clamp(batch["cap_len"].long() - 1, 0, steps).sum() \
        .float().clamp_min(1.0)
    for p in P.values():
        p.grad = None
    total = 0.0
    for lo in range(0, B, block):
        hi = min(B, lo + block)
        sub = {k: v[lo:hi] for k, v in batch.items()}
        m = {k: (v[lo:hi] if torch.is_tensor(v) else v)
             for k, v in masks.items()}
        nll, _ = caption_nll(P, sub, prec, m,
                             (scan_seed, lo, cfg["dropout"],
                              cfg["att_dropout"]), fault)
        loss = nll / count
        loss.backward()
        total += float(loss.detach())
    for p in P.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return total


def run_steps(P0: Params, batches: List[Dict], run_seed: int, steps: int,
              cfg: dict, prec: Precision, block: int,
              mask_dtype: torch.dtype, fault: Optional[str] = None):
    """``steps`` training steps from the parameters ``P0`` (copied) on
    ``batches[0 .. steps - 1]``: the loss above, the clip and Adamax of
    :mod:`vqabench.reference.train`. Returns (losses, the first step's
    clipped gradients, the parameters after the last step).

    ``fault``: ``"half"`` leaves out the second half of each batch and
    takes the means over the rest; the others (:data:`FAULTS`) as
    :func:`caption_nll` and :func:`graph_conv` plant them."""
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in P0.items()}
    opt = ref_train.Adamax(P, cfg["lr"])
    losses, first = [], None
    model_fault = fault if fault in FAULTS else None
    for s in range(steps):
        batch = batches[s]
        if fault == "half":
            half = batch["q"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        losses.append(loss_and_grads(P, batch, run_seed, s, cfg, prec, block,
                                     mask_dtype, model_fault))
        ref_train.clip_([p.grad for p in P.values()], cfg["max_norm"])
        if s == 0:
            first = {k: p.grad.detach().clone() for k, p in P.items()}
        opt.step(P)
    return losses, first, {k: p.detach() for k, p in P.items()}
