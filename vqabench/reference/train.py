"""Plain reference of the first training steps: the joint loss of
:mod:`vqabench.reference.updown` with its dropout masks drawn afresh, its
gradients by autograd in blocks of rows, the global-norm clip and Adamax
(Kingma and Ba, arXiv:1412.6980, section 7.1), written out.

Seeds. Step ``s`` of a run with seed ``r`` draws its dropout from two
seeds made by SplitMix64 (Steele et al., OOPSLA 2014):
``x = mix(r ^ mix(s))``, the torch generator seed ``x >> 1`` and the
caption scan's 32-bit seed ``mix(x ^ 0x5EED0A77) & (2**32 - 1)``. The
encoder's attention and the classifier draw their masks from torch's
generator under the first, in that order, as ``nn.Dropout`` does on
tensors of the step's compute dtype; the caption scan's from the
counter-based masks of :mod:`vqabench.reference.philox` under the second.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from vqabench.reference import updown
from vqabench.reference.precision import Precision

MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def step_seeds(run_seed: int, step: int):
    """(torch generator seed, caption-scan seed) of training step ``step``."""
    x = _mix((run_seed & MASK64) ^ _mix(step))
    return x >> 1, _mix(x ^ 0x5EED0A77) & 0xFFFFFFFF


def torch_masks(seed: int, rows: int, boxes: int, hidden: int,
                cls_width: int, p_att: float, p_drop: float,
                dtype: torch.dtype, device: torch.device):
    """The encoder-attention and classifier keep masks of one step, drawn
    as the step's two ``nn.Dropout`` calls draw them."""
    devices = [device.index or 0] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        att = F.dropout(torch.ones((rows, boxes, hidden), dtype=dtype,
                                   device=device), p_att, True) != 0
        cls = F.dropout(torch.ones((rows, cls_width), dtype=dtype,
                                   device=device), p_drop, True) != 0
    return {"att": att, "att_scale": 1.0 / (1.0 - p_att),
            "cls": cls, "cls_scale": 1.0 / (1.0 - p_drop)}


def _rows(batch: Dict[str, torch.Tensor], lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def loss_and_grads(P: Dict[str, torch.Tensor], batch, run_seed: int,
                   step: int, cfg: dict, prec: Precision, block: int,
                   mask_dtype: torch.dtype):
    """The step's loss (a float) with the gradients left in ``P``'s
    ``.grad`` (leaves that require grad), computed ``block`` rows at a
    time."""
    torch_seed, scan_seed = step_seeds(run_seed, step)
    B, N = batch["img_q"].shape[:2]
    H = cfg["hidden_dim"]
    masks = torch_masks(torch_seed, B, N, H, 2 * H, cfg["att_dropout"],
                        cfg["dropout"], mask_dtype, batch["q"].device)
    caption = updown.has_caption(P)
    count = None
    if caption:
        steps = batch["c"].shape[1] - 1
        count = torch.clamp(batch["cap_len"].long() - 1, 0, steps).sum() \
            .float().clamp_min(1.0)
    for p in P.values():
        p.grad = None
    total = 0.0
    for lo in range(0, B, block):
        hi = min(B, lo + block)
        sub = _rows(batch, lo, hi)
        m = {"att": masks["att"][lo:hi], "att_scale": masks["att_scale"],
             "cls": masks["cls"][lo:hi], "cls_scale": masks["cls_scale"]}
        scan = (scan_seed, lo, cfg["dropout"], cfg["att_dropout"])
        bce, nll, _ = updown.loss_parts(P, sub, prec, m, scan)
        if caption:
            s = P["log_vars"].float()
            loss = (torch.exp(-s[0]) * bce / B + torch.exp(-s[1]) * nll / count
                    + (s[0] + s[1]) * ((hi - lo) / B))
        else:
            loss = bce / B
        loss.backward()
        total += float(loss.detach())
    return total


def clip_(grads: List[torch.Tensor], max_norm: float) -> float:
    """Scale the gradients so that their global norm is at most
    ``max_norm`` (coefficient ``max_norm / (norm + 1e-6)``); the norm
    before."""
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return float(norm)


class Adamax:
    """Adamax: ``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g| + eps)``,
    ``p -= lr / (1 - b1**t) * m / u``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.u = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        rate = self.lr / (1 - self.b1 ** self.t)
        for k, p in params.items():
            g = p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.u[k] = torch.maximum(self.u[k] * self.b2, g.abs() + self.eps)
            p.sub_(rate * self.m[k] / self.u[k])


def run_steps(P0: Dict[str, torch.Tensor], batches, run_seed: int, steps: int,
              cfg: dict, prec: Precision, block: int,
              mask_dtype: torch.dtype, fault: Optional[str] = None):
    """``steps`` training steps from the parameters ``P0`` (copied) on
    ``batches[0 .. steps - 1]``. Returns (losses, the first step's
    clipped gradients, the parameters after the last step).

    ``fault`` plants a fault in the reference, to read what the
    comparison makes of it: ``"half"`` leaves out the second half of each
    batch and takes the means over the rest."""
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in P0.items()}
    opt = Adamax(P, cfg["lr"])
    losses, first = [], None
    for s in range(steps):
        batch = batches[s]
        if fault == "half":
            batch = _rows(batch, 0, batch["q"].shape[0] // 2)
        losses.append(loss_and_grads(P, batch, run_seed, s, cfg, prec, block,
                                     mask_dtype))
        grads = [p.grad for p in P.values()]
        clip_(grads, cfg["max_norm"])
        if s == 0:
            first = {k: p.grad.detach().clone() for k, p in P.items()}
        opt.step(P)
    return losses, first, {k: p.detach() for k, p in P.items()}
