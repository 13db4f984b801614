"""Train state and step factories (counterpart of
``vqa_tpu/training/state.py``).

One training step: the loss through ``VQAModel.get_loss`` (or another loss
of the model, as the max-relevance step's in ``training/select.py``) with
dropout active, its gradients, the clip and the grouped Adamax update
(``training/optim.py``). Mixed precision follows the JAX package, not
``torch.autocast``: the f32 master parameters are cast to ``compute_dtype``
inside the loss (``torch.func.functional_call``), so autograd returns f32
gradients and the optimizer moments stay f32; the float inputs of the batch
are cast too, and so are the float buffers (a frozen GloVe table, whose
rows then enter the model as a learned table's do; the JAX package keeps
that constant in f32), and the losses upcast to f32
(``models/wrapper.py``).

Each step's dropout draws from a seed that is a function of (run seed,
step), as ``fold_in(rng, step)``: torch's generators for the encoder's and
predictor's dropout, and one 32-bit seed for the caption scan's
counter-based masks, reused by its backward. The step returns its metrics as
device tensors and issues no host synchronisation.

Over a mesh (``parallel/mesh.py``; ``mesh=`` of :func:`make_train_step`)
the step is JAX's mesh step on the global batch, each data rank holding
its rows:

- the data rank is folded into both seeds, so the data ranks draw
  different masks for their rows, and the ranks of one ``model`` group,
  which compute the same activations, draw the same ones;
- the caption CE divides by the token count of the global batch (its mean
  over the data group, ``mesh.data_token_count``), so that the mean of the
  ranks' losses is the global loss; the per-sample means (the VQA BCE)
  average right as they are, since the shards' batches are equal;
- after the backward every gradient, and every metric, is averaged over
  the data group in one coalesced all-reduce (``train/score``, a sum, is
  summed); a sharded head's gradients are its slice's.

DDP is not used: its reducer hooks the module's parameters, while the loss
runs through ``functional_call`` over the compute-dtype casts of them, and
the caption scan's backward calls ``autograd.grad`` itself, so no hook of
DDP's would see these gradients.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from vqa_tpu_torch.models.wrapper import VQAModel
from vqa_tpu_torch.parallel import mesh as mesh_lib
from vqa_tpu_torch.training.optim import Optimizer

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """SplitMix64's output function (Steele et al., OOPSLA 2014)."""
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_seeds(run_seed: int, step: int, data_rank: int = 0
               ) -> Tuple[int, int]:
    """(torch generator seed, 32-bit caption-scan seed) of one step on one
    data rank (rank 0: the single-process seeds)."""
    s = _mix64((run_seed & _MASK64) ^ _mix64(step))
    if data_rank:
        s = _mix64(s ^ _mix64(data_rank ^ 0xDA7A0000))
    return s >> 1, _mix64(s ^ 0x5EED0A77) & 0xFFFFFFFF


class TrainState:
    """The f32 model, its optimizer, the number of steps taken and the
    64-bit run seed."""

    def __init__(self, model: VQAModel, optimizer: Optimizer, seed: int = 1111,
                 step: int = 0):
        self.model, self.optimizer = model, optimizer
        self.seed, self.step = seed, step


TokenCount = Optional[Callable[[torch.Tensor], torch.Tensor]]
LossFn = Callable[[VQAModel, Dict, int, TokenCount],
                  Tuple[torch.Tensor, Dict]]


def joint_loss(model: VQAModel, batch: Dict, seed: int,
               token_count: TokenCount = None):
    """The joint training loss, ``VQAModel.get_loss``."""
    return model.get_loss(batch, seed=seed, token_count=token_count)


class _Loss(nn.Module):
    """A loss of the model as a module's forward, for ``functional_call``."""

    def __init__(self, model: VQAModel, loss_fn: LossFn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch, seed, token_count):
        return self.loss_fn(self.model, batch, seed, token_count)


def _cast_floats(tree: Dict, dtype: Optional[torch.dtype]) -> Dict:
    if dtype is None:
        return dict(tree)
    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in tree.items()}


def backward_step(model: VQAModel, batch: Dict, run_seed: int, step: int,
                  compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                  loss_fn: LossFn = joint_loss, data_rank: int = 0,
                  token_count: TokenCount = None) -> Dict[str, torch.Tensor]:
    """The loss of training step ``step`` on data rank ``data_rank``
    (dropout active, drawn from (run seed, step, data rank)) and its
    gradients, left in the f32 parameters' ``.grad``. ``loss_fn(model,
    batch, scan_seed, token_count) -> (loss, writes)``; ``token_count`` maps
    the batch's caption-token count to the one the caption CE divides by
    (over a mesh, ``mesh.data_token_count``). Returns ``loss`` and the
    ``train/*`` writes, detached."""
    model.train()
    torch_seed, scan_seed = step_seeds(run_seed, step, data_rank)
    params = {"model." + n: p for n, p in model.named_parameters()}
    buffers = {"model." + n: b for n, b in model.named_buffers()}
    dev = next(iter(params.values())).device
    with torch.random.fork_rng(
            devices=[dev.index or 0] if dev.type == "cuda" else []):
        torch.manual_seed(torch_seed)
        loss, writes = functional_call(
            _Loss(model, loss_fn),
            _cast_floats({**params, **buffers}, compute_dtype),
            (_cast_floats(batch, compute_dtype), scan_seed, token_count))
        for p in model.parameters():
            p.grad = None
        loss.backward()
    metrics = {k: v.detach() for k, v in writes.items()}
    metrics["loss"] = loss.detach()
    return metrics


# metrics that sum over the batch's rows (the others are means)
SUMMED_METRICS = ("train/score",)


def reduce_over_data(model: VQAModel, metrics: Dict[str, torch.Tensor],
                     mesh) -> None:
    """Average every gradient and metric over the mesh's data group, in
    place (one all-reduce); the summed metrics are summed."""
    n = mesh_lib.axis_size(mesh, "data")
    if n == 1:
        return
    for k in SUMMED_METRICS:
        if k in metrics:
            metrics[k] = metrics[k] * n
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    mesh_lib.reduce_data_mean(grads + list(metrics.values()), mesh)


def make_train_step(model: VQAModel, optimizer: Optimizer,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                    loss_fn: LossFn = joint_loss, mesh=None
                    ) -> Callable[[TrainState, Dict], Dict[str, torch.Tensor]]:
    """``step(state, batch) -> metrics``: one update of ``state.model``.

    ``batch`` holds device tensors (the Loader's keys; over a ``mesh``, this
    data rank's rows); ``compute_dtype`` None trains in the parameters' own
    dtype; ``loss_fn`` is the loss (see :func:`backward_step`). Metrics:
    ``loss`` and the ``train/*`` writes of the loss, plus ``grad_norm``, of
    the global batch.
    """
    data_rank = mesh_lib.axis_rank(mesh, "data")
    token_count = mesh_lib.data_token_count(mesh)

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        metrics = backward_step(model, batch, state.seed, state.step,
                                compute_dtype, loss_fn, data_rank,
                                token_count)
        reduce_over_data(model, metrics, mesh)
        metrics["grad_norm"] = optimizer.step(state.step)
        state.step += 1
        return metrics

    return step


def make_eval_step(model: VQAModel) -> Callable:
    """VQA evaluation: ``batch -> (score [B], label [B], bound [B])``, the
    soft score of the argmax answer and the best reachable score."""

    def eval_step(batch):
        model.eval()
        with torch.inference_mode():
            score, label, target = model.forward_vqa(batch)
        return score.sum(dim=1), label, target.max(dim=1).values

    return eval_step


def make_infer_step(model: VQAModel) -> Callable:
    """Batched inference: ``batch -> answer logits [B, ans_dim]``."""

    def infer_step(batch):
        model.eval()
        with torch.inference_mode():
            return model(batch)[0]

    return infer_step
