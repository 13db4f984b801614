"""Plain PyTorch reference of ReGAT's spatial relation model (Li et al.,
arXiv:1903.12314) as the reference implementation runs it
(github.com/Jayie/vqa-collection: ``modules/encoder.py:186-272``
``RelationEncoder``, ``modules/gcn.py:113-215`` ``CorrelatedGraphConv`` and
``GCN``, ``util/relation.py:3-45`` the spatial labels), with one correlated
graph convolution over the spatial graph (CONFIGS.md config 5).

Parameters and precision follow ``vqabench/reference/updown.py``, whose
question GRU and top-down attention this file reads: a dict keyed by the
program's state_dict names, float32 (TF32 off) unless a
:class:`~vqabench.reference.precision.Precision` of ``"fp8"`` rounds the
operands of each product.

- Attended features: ``f = att_i v_i`` [B, 36, 2048] (Up-Down's encoder).
- The convolution, unfolded as the reference writes it (the program folds
  ``w0 + w1`` into one weight and ``Wa Wb^T`` into one matrix; this file
  does neither, so that it checks that algebra rather than repeats it)::

      out   = w2(f) + adj @ w0(f) + adj @ w1(f) + sum_j label_bias[graph[i, j]]
      alpha = (f Wa^T + ba) (f Wb^T + bb)^T
      new   = softmax(adj @ ReLU(alpha), dim=1) @ out

  with ``adj = graph != 0``; then the GCN's ReLU (its dropout is off at
  inference).
- Answer: the sum of the new features over the boxes, then Up-Down's base
  predictor.

:func:`spatial_labels` is the reference's spatial label rule, vectorized,
quirks included (see its docstring); the benchmark's graphs come from it.
"""

from __future__ import annotations

import torch

from vqabench.reference import updown
from vqabench.reference.precision import Precision

Params = updown.Params
CONV = "encoder.spatial_encoder.conv0."


def _linear(P: Params, name: str, x: torch.Tensor, prec: Precision,
            bias: bool = True) -> torch.Tensor:
    """``x @ W^T (+ b)`` of a plain Linear ``name`` (``weight`` [out, in])."""
    y = prec.mm(x, P[name + ".weight"].float().t())
    return y + P[name + ".bias"].float() if bias else y


def graph_conv(P: Params, f: torch.Tensor, graph: torch.Tensor,
               prec: Precision, pre: str = CONV) -> torch.Tensor:
    """One correlated graph convolution [B, N, D] -> [B, N, D], before the
    GCN's ReLU; ``graph`` [B, N, N] integer labels."""
    g = graph.long()
    adj = (g != 0).float()
    out = (_linear(P, pre + "w2", f, prec, bias=False)
           + prec.mm(adj, _linear(P, pre + "w0", f, prec, bias=False))
           + prec.mm(adj, _linear(P, pre + "w1", f, prec, bias=False)))
    label_bias = P[pre + "label_bias"].float()
    for j in range(g.shape[2]):
        out = out + label_bias[g[:, :, j]]
    a = _linear(P, pre + "dot_product.wa", f, prec)
    b = _linear(P, pre + "dot_product.wb", f, prec)
    alpha = prec.mm(a, b.transpose(1, 2))
    alpha = torch.softmax(prec.mm(adj, torch.relu(alpha)), dim=1)
    return prec.mm(alpha, out)


def answer(P: Params, batch, prec: Precision) -> torch.Tensor:
    """Inference: answer logits [B, answers] of a batch (q, img_q,
    img_scale, graph)."""
    enc = updown.encode(P, batch, prec)
    f = enc["att"][..., None] * enc["feats"]
    v = torch.relu(graph_conv(P, f, batch["graph"], prec))
    return updown.answer_logits(P, dict(enc, v_sum=v.sum(dim=1)), prec)


def spatial_labels(boxes: torch.Tensor, width: float, height: float
                   ) -> torch.Tensor:
    """The spatial labels [B, N, N] (int64) of boxes [B, N, 4] (x0, y0, x1,
    y1) on images of ``width`` x ``height``, in float64, as the reference's
    ``relation_graph`` fills them: for each pair i < j, ``(out[i, j], out[j,
    i]) = spatial_relation(box_i, box_j)``, the diagonal 0. For a = box_i,
    b = box_j, with the intersection box ``I``, in this order:

    - ``I == b`` exactly: (1, 2); ``I == a`` exactly: (2, 1);
    - IoU >= 0.5: (3, 3), with the intersection's area taken as the product
      of its extents even where both are negative (disjoint boxes then
      have a positive "area");
    - centre distance <= half the image diagonal: (k(delta), k(delta +
      180)) with ``delta = degrees(atan2(dx, dy)) - 90`` and ``k(x) =
      ceil((x mod 360) / 45) + 3``, so a delta that is a multiple of 360
      gives 3, the overlap's label;
    - else (0, 0).
    """
    x = boxes.to(torch.float64)
    a, b = x[:, :, None, :], x[:, None, :, :]
    ix0 = torch.maximum(a[..., 0], b[..., 0])
    iy0 = torch.maximum(a[..., 1], b[..., 1])
    ix1 = torch.minimum(a[..., 2], b[..., 2])
    iy1 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.stack([ix0, iy0, ix1, iy1], dim=-1)
    is_b = (inter == b).all(dim=-1)
    is_a = (inter == a).all(dim=-1)

    def area(t):
        return (t[..., 3] - t[..., 1]) * (t[..., 2] - t[..., 0])

    iou = area(inter) / (area(a) + area(b) - area(inter))
    ca = torch.stack([a[..., 0] + (a[..., 2] - a[..., 0]) / 2,
                      a[..., 1] + (a[..., 3] - a[..., 1]) / 2], dim=-1)
    cb = torch.stack([b[..., 0] + (b[..., 2] - b[..., 0]) / 2,
                      b[..., 1] + (b[..., 3] - b[..., 1]) / 2], dim=-1)
    d = cb - ca
    near = (torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
            / (float(width) ** 2 + float(height) ** 2) ** 0.5) <= 0.5
    delta = torch.rad2deg(torch.atan2(d[..., 0], d[..., 1])) - 90

    def bucket(t):
        return torch.ceil(torch.remainder(t, 360) / 45) + 3

    def label(first, second, turn):
        out = torch.where(near, bucket(delta + turn), torch.zeros_like(delta))
        out = torch.where(iou >= 0.5, torch.full_like(out, 3), out)
        out = torch.where(is_a, torch.full_like(out, second), out)
        return torch.where(is_b, torch.full_like(out, first), out)

    ab = label(1, 2, 0).long()        # out[i, j] for i < j
    ba = label(2, 1, 180).long()      # out[j, i] for i < j
    n = x.shape[1]
    upper = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
    return torch.where(upper, ab, torch.where(upper.t(), ba.transpose(1, 2),
                                              torch.zeros_like(ab)))
