"""Optimizer and learning-rate schedule of the reference training recipe
(counterpart of ``vqa_tpu/training/optim.py``).

- Adamax (``torch.optim.Adamax``) with three parameter groups: ``enc`` (the
  encoder and the MTL ``log_vars``) at ``lr``, ``vqa`` (the predictor) at
  ``max(lr_vqa, lr)``, ``cap`` (the caption generator) at ``max(lr_cap,
  lr)``. Training ``log_vars`` is the JAX package's deliberate divergence
  from the reference, which left them out of every group.
- Global-norm clip, ``torch.nn.utils.clip_grad_norm_`` (coefficient
  ``max_norm / (norm + 1e-6)``, applied when below 1). Over a
  tensor-parallel model (``parallel/mesh.py`` ``shard_params``) each
  sharded gradient's sum of squares is all-reduced over the ``model``
  group and each replicated one counts once, so the coefficient is
  ``clip_grad_norm_``'s on the full model.
- StepLR by epoch: the factor ``gamma ** ((epoch - warm_up) // step_size)``
  after ``warm_up`` epochs, with ``epoch = update // steps_per_epoch``.

``tests/test_train_parity.py`` pins the JAX chain to these torch semantics.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from vqa_tpu_torch import tracing


def steplr_factor(epoch: int, warm_up: int, step_size: int,
                  gamma: float) -> float:
    """torch StepLR's factor at a (0-indexed) training epoch."""
    if step_size == 0:
        return 1.0
    return gamma ** (max(0, epoch - warm_up) // step_size)


def group_of(name: str) -> str:
    """The parameter group of a model parameter by its top-level module."""
    top = name.split(".")[0]
    return {"predictor": "vqa", "generator": "cap"}.get(top, "enc")


class Optimizer:
    """Clip, then Adamax by groups at the StepLR learning rate of the update
    being made. :meth:`step` issues no host synchronisation."""

    def __init__(self, adamax: torch.optim.Adamax, max_norm: float,
                 warm_up: int, step_size: int, gamma: float,
                 steps_per_epoch: int, sharded: List[torch.Tensor] = (),
                 model_group: Optional[object] = None):
        self.adamax = adamax
        self.max_norm = max_norm
        self.warm_up, self.step_size, self.gamma = warm_up, step_size, gamma
        self.steps_per_epoch = steps_per_epoch
        self.params: List[torch.Tensor] = [
            p for g in adamax.param_groups for p in g["params"]]
        # the parameters that are slices of a tensor-parallel layer, and
        # the group that holds their other slices
        self.sharded = {id(p) for p in sharded}
        self.model_group = model_group

    def lr_factor(self, update: int) -> float:
        return steplr_factor(update // self.steps_per_epoch, self.warm_up,
                             self.step_size, self.gamma)

    def step(self, update: int) -> torch.Tensor:
        """Clip the gradients and apply update number ``update`` (0-based);
        returns the gradient norm before clipping, as a device tensor."""
        with tracing.span("vqa.step.optimizer"):
            factor = self.lr_factor(update)
            for g in self.adamax.param_groups:
                g["lr"] = g["base_lr"] * factor
            norm = self.clip()
            self.adamax.step()
        return norm

    def clip(self) -> torch.Tensor:
        """Scale the gradients by the global-norm clip's coefficient;
        returns the norm before clipping."""
        if self.model_group is None:
            return nn.utils.clip_grad_norm_(self.params, self.max_norm)
        grads = [(p.grad, id(p) in self.sharded) for p in self.params
                 if p.grad is not None]
        whole = sum(g.float().pow(2).sum() for g, s in grads if not s)
        split = sum(g.float().pow(2).sum() for g, s in grads if s)
        dist.all_reduce(split, group=self.model_group)
        norm = torch.sqrt(whole + split)
        coef = torch.clamp(self.max_norm / (norm + 1e-6), max=1.0)
        for g, _ in grads:
            g.mul_(coef)
        return norm


def make_optimizer(model: nn.Module, lr: float, lr_vqa: float = 0.0,
                   lr_cap: float = 0.0, max_norm: float = 0.25,
                   warm_up: int = 0, step_size: int = 0, gamma: float = 0.5,
                   steps_per_epoch: int = 1, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """The full update (clip -> Adamax by groups -> StepLR) for ``model``'s
    parameters, named as in ``model.named_parameters()``; a model sharded
    by ``parallel.mesh.shard_params`` clips over its full gradient."""
    rates = {"enc": lr, "vqa": max(lr_vqa, lr), "cap": max(lr_cap, lr)}
    groups: Dict[str, List[torch.Tensor]] = {k: [] for k in rates}
    for name, p in model.named_parameters():
        groups[group_of(name)].append(p)
    param_groups = [{"params": ps, "lr": rates[k], "base_lr": rates[k],
                     "name": k} for k, ps in groups.items() if ps]
    adamax = torch.optim.Adamax(param_groups, lr=lr, betas=(b1, b2), eps=eps)
    layout = getattr(model, "tp_layout", {})
    shard = getattr(model, "tp_shard", None)
    return Optimizer(adamax, max_norm, warm_up, step_size, gamma,
                     steps_per_epoch,
                     sharded=[p for n, p in model.named_parameters()
                              if n in layout],
                     model_group=shard.group if shard is not None else None)
