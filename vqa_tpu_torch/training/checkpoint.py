"""Checkpoint save and restore: the port's own format.

Same artifact layout as the JAX package (``checkpoint/<exp>/epoch_{n}.ckpt``,
``best_model.ckpt``) and the same complete payload, in ``torch.save`` form:
``{"model": state_dict, "optimizer": Adamax state_dict (moments included),
"step", "seed", "epoch", "best_score"}``. The JAX package's flax msgpack
files are not read here; a JAX checkpoint comes over by converting its
parameters (``tools/convert.py``) on a machine with jax.

A reference checkpoint, ``torch.save(model.state_dict())`` of the
reference's model, is read as it is: the port's parameter names are the
reference's. It serves evaluation, decoding and a warm start, not a
training resume. Reference files carry no GCN convs (the reference keeps
them in a plain list that ``state_dict`` does not see), so
:func:`restore_params` takes those from the model it loads into.

Writes are atomic: the payload goes to a temporary file beside the target,
is flushed and fsynced, then renamed over it, so an interrupted save leaves
the previous file (or none), never a partial one.

Under several processes rank 0 alone writes. A tensor-parallel model's
slices (``parallel/mesh.py`` ``shard_params``), and their Adamax moments,
are gathered into full tensors first (a collective: every rank calls the
save), and a load cuts the full tensors to the slices the model holds, so
a checkpoint written under any mesh loads under any other, and in one
process.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from vqa_tpu_torch.parallel import mesh as mesh_lib
from vqa_tpu_torch.training.state import TrainState


def _to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and copied to the CPU
    (the copy is taken now, so later in-place updates do not reach it)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _moment_layout(state: TrainState) -> Dict[str, int]:
    """The sharded dimension of each Adamax moment, by its key
    ``{optimizer index}.{moment}`` (the index is the parameter's position
    in the optimizer's groups)."""
    layout = getattr(state.model, "tp_layout", {})
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {f"{i}.{k}": layout[names[id(p)]]
            for i, p in enumerate(state.optimizer.params)
            if names[id(p)] in layout for k in ("exp_avg", "exp_inf")}


def _map_moments(opt_state: Dict[str, Any], state: TrainState,
                 fn) -> Dict[str, Any]:
    """``opt_state`` with its sharded moments replaced by
    ``fn(moments, layout, shard)`` (``mesh.gather_shards`` or
    ``split_shards``)."""
    layout = _moment_layout(state)
    if not layout:
        return opt_state
    moments = {f"{i}.{k}": v for i, st in opt_state["state"].items()
               for k, v in st.items() if f"{i}.{k}" in layout}
    mapped = fn(moments, layout, state.model.tp_shard)
    per = {i: {k: mapped.get(f"{i}.{k}", v) for k, v in st.items()}
           for i, st in opt_state["state"].items()}
    return {**opt_state, "state": per}


def _host_payload(state: TrainState, epoch: int, best_score: float = 0.0
                  ) -> Optional[Dict[str, Any]]:
    """The checkpoint payload of ``state`` with full tensors, copied to the
    host; None on a rank that does not write (the gather of the slices is
    collective, so every rank calls this)."""
    model = mesh_lib.full_state_dict(state.model)
    optimizer = _map_moments(state.optimizer.adamax.state_dict(), state,
                             mesh_lib.gather_shards)
    if not mesh_lib.is_main():
        return None
    return {"model": _to_host(model), "optimizer": _to_host(optimizer),
            "step": int(state.step), "seed": int(state.seed),
            "epoch": int(epoch), "best_score": float(best_score)}


def _write_payload(path: str, payload: Dict[str, Any]) -> None:
    """``torch.save`` to ``path`` atomically (tmp + fsync + rename)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(fd)             # the rename itself reaches the disk
    finally:
        os.close(fd)


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    best_score: float = 0.0) -> None:
    """Write ``state`` to ``path`` (rank 0; every rank calls it)."""
    payload = _host_payload(state, epoch, best_score)
    if payload is not None:
        _write_payload(path, payload)


class Checkpointer:
    """Asynchronous saves on one background thread. The host copy of the
    state is taken on the caller, so training may go on updating it; the
    serialization and fsync run on the thread. Give each asynchronous save
    its own path (two overlapped writers to one path could land in either
    order): the training loop saves ``best_model.ckpt`` synchronously."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []

    def save_checkpoint_async(self, path: str, state: TrainState, epoch: int,
                              best_score: float = 0.0) -> None:
        payload = _host_payload(state, epoch, best_score)
        if payload is not None:
            self._pending.append(
                self._pool.submit(_write_payload, path, payload))

    def wait_for_checkpoints(self) -> None:
        """Join the outstanding saves, raising the first one's error."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait_for_checkpoints()
        self._pool.shutdown()


def _read(path: str) -> Dict[str, Any]:
    # a payload of tensors, dicts, lists and numbers: no code is unpickled
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state: Optional[TrainState] = None
                    ) -> Dict[str, Any]:
    """Load a checkpoint. Without ``state`` returns the payload; with it,
    restores the model's parameters, the optimizer (moments and all), the
    step and the run seed into ``state`` and returns ``{"state", "epoch",
    "best_score"}``."""
    payload = _read(path)
    if state is None:
        return payload
    if _is_state_dict(payload) or not payload.get("optimizer"):
        raise ValueError(
            f"{path} has no optimizer state (a parameters-only checkpoint): "
            "it supports eval/decode (load_params) or a warm start "
            "(merge_params), not a training resume")
    state.model.load_state_dict(
        mesh_lib.local_state_dict(state.model, payload["model"]))
    state.optimizer.adamax.load_state_dict(
        _map_moments(payload["optimizer"], state, mesh_lib.split_shards))
    state.step = int(payload["step"])
    state.seed = int(payload["seed"])
    return {"state": state, "epoch": int(payload["epoch"]),
            "best_score": float(payload["best_score"])}


def _is_state_dict(payload: Dict[str, Any]) -> bool:
    """A bare ``state_dict`` (a reference checkpoint): tensors only."""
    return all(torch.is_tensor(v) for v in payload.values())


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` alone (for eval, decode, warm start), from
    the port's checkpoint or from a bare ``state_dict`` file."""
    payload = _read(path)
    return payload if _is_state_dict(payload) else payload["model"]


_GCN_CONV = re.compile(r"^encoder\.[a-z]+_encoder\.conv\d+\.")


def restore_params(model: torch.nn.Module,
                   params: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict(params)``, strict but for the relation
    encoder's GCN convs (``encoder.*_encoder.conv*``), which a reference
    checkpoint lacks: those ``params`` misses keep the model's values, as
    ``merge_params`` keeps them. Any other missing or unexpected key
    raises ``KeyError`` naming it. A tensor-parallel model takes its slices
    of the full tensors."""
    params = mesh_lib.local_state_dict(model, params)
    own = model.state_dict()
    fill = [k for k in own if k not in params and _GCN_CONV.match(k)]
    missing = [k for k in own if k not in params and k not in fill]
    unexpected = [k for k in params if k not in own]
    if missing or unexpected:
        raise KeyError(f"the checkpoint does not fit the model: missing "
                       f"{missing}, unexpected {unexpected}")
    model.load_state_dict({**params, **{k: own[k] for k in fill}})


def merge_params(target: Dict[str, torch.Tensor],
                 loaded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Non-strict warm start, as ``load_state_dict(..., strict=False)``
    with a shape check: entries present in both with equal shapes come from
    ``loaded``; unknown or mismatched ones keep ``target``'s."""
    return {k: (loaded[k] if k in loaded and loaded[k].shape == v.shape
                else v) for k, v in target.items()}
