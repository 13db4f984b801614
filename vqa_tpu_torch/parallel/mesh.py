"""Process mesh and shardings: data parallel x tensor parallel over
``torch.distributed`` (counterpart of ``vqa_tpu/parallel/mesh.py``).

PyTorch's idiom is one process per GPU, so JAX's ``('data', 'model')``
device mesh becomes a mesh of process ranks (a ``DeviceMesh`` with those
two dimension names, rank ``d * n_model + m`` at cell ``(d, m)``):

- ``data``: each data rank holds its own rows of the global batch (the
  Loader's shards, ``Loader.for_process``); the training step averages the
  gradients over the data group (``training/state.py``).
- ``model``: the ranks of one data row see the same rows; the wide output
  heads (``classifier``, ``fcnet``, ``h2_fcnet``, ``cls_net``) hold a slice
  of their output dimension each, the layout of JAX's ``param_shardings``.
  A sharded layer multiplies by its slice, then all-gathers the slices
  (:class:`ModelShard`); XLA inserted those collectives for JAX, here they
  are written out, the all-reduce of the weight norm's sum of squares
  included.

Launching several processes: ``torchrun --nproc_per_node N -m
vqa_tpu_torch.main ...`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT``), or the JAX entry point's variables:
``VQA_TPU_MULTIHOST=1 VQA_TPU_COORD=host:port VQA_TPU_NPROCS=N
VQA_TPU_PROC_ID=i`` in each of N processes. Without either, the process is
a world of one.

The backend rule (:func:`backend_for`): ``nccl`` where the ranks run on
CUDA and each rank of a host has a card of its own; ``gloo`` on the CPU,
and where the ranks of a host share a card (NCCL refuses two ranks on one
card). The ranks of a host are torchrun's ``LOCAL_WORLD_SIZE`` where it is
set, else counted by host name at the rendezvous (:func:`host_place`). A
world of one process creates no process group and has no mesh (None), the
one path of the library's single-process callers. Gloo reduces and
broadcasts CUDA tensors but cannot all-gather them, so a tensor-parallel
mesh on CUDA needs NCCL.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

# modules whose output dimension shards over 'model' (JAX's _TP_SUFFIXES):
# the answer classifier, the decoders' vocab projections and the q-cap
# head's last layer, the only weights wide enough to be worth splitting
TP_MODULES = ("classifier", "fcnet", "h2_fcnet", "cls_net")
# the 2-D weights and the biases inside them; torch keeps [out, in], so
# the output dimension is dim 0 of both
_TP_LEAVES = {"weight": 2, "weight_v": 2, "bias": 1}


@dataclass(frozen=True)
class Distributed:
    """This process's place in the world: its rank, the world size, the
    backend (None without a process group), its device, and whether
    :func:`init_distributed` created a process group (then the caller
    destroys it)."""
    rank: int
    world: int
    backend: Optional[str]
    device: torch.device
    created: bool


def _launch_env() -> Optional[Dict[str, Union[int, str]]]:
    """The rendezvous address, this rank, the world size, and the local
    rank and ranks on this host where the launcher gives them (torchrun's
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, else None: :func:`host_place`
    counts them), from the JAX entry point's variables or torchrun's; None
    for a world of one."""
    env = os.environ
    if env.get("VQA_TPU_MULTIHOST") and env.get("VQA_TPU_COORD"):
        world, rank = int(env["VQA_TPU_NPROCS"]), int(env["VQA_TPU_PROC_ID"])
        url = f"tcp://{env['VQA_TPU_COORD']}"
    elif "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        world, rank, url = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    elif env.get("VQA_TPU_MULTIHOST"):
        raise RuntimeError("VQA_TPU_MULTIHOST is set without VQA_TPU_COORD "
                           "(host:port), VQA_TPU_NPROCS and VQA_TPU_PROC_ID, "
                           "and torchrun's variables are absent")
    else:
        return None
    local = ("LOCAL_RANK" in env and "LOCAL_WORLD_SIZE" in env)
    return {"url": url, "rank": rank, "world": world,
            "local_rank": int(env["LOCAL_RANK"]) if local else None,
            "local_world": int(env["LOCAL_WORLD_SIZE"]) if local else None}


def host_place(store, rank: int, world: int, host: Optional[str] = None):
    """(local rank, ranks on this host): every rank posts its host name to
    the rendezvous ``store`` and counts the ranks that share it, the local
    rank being this rank's place among them in rank order. A launch over
    several hosts (``VQA_TPU_COORD`` on another machine) thus counts the
    cards each host's ranks share, not the world's."""
    host = socket.gethostname() if host is None else host
    store = dist.PrefixStore("vqa_tpu_hosts", store)
    store.set(str(rank), host)
    hosts = [store.get(str(r)).decode() for r in range(world)]
    return hosts[:rank].count(host), hosts.count(host)


def backend_for(device_type: str, world: int, local_world: int):
    """(backend, why): the rule of this module's docstring, for a world of
    more than one process."""
    if device_type != "cuda":
        return "gloo", "the ranks run on the CPU"
    cards = torch.cuda.device_count()
    if local_world > cards:
        return "gloo", (f"{local_world} ranks share {cards} card(s) on this "
                        "host, and NCCL takes one rank a card")
    return "nccl", "each rank has a card of its own"


def init_distributed(device: str = "cuda") -> Distributed:
    """Join the process group the environment describes (the counterpart
    of the JAX entry point's ``jax.distributed.initialize``) and return
    this rank's place and device: ``cuda:{local rank % device_count}`` for
    ``device`` "cuda", the device itself otherwise. A rank that asks for
    CUDA without a CUDA device raises, as ``resolve_device`` does. A world
    of one process creates no group (its mesh is None). Prints the rank,
    the backend and why the backend was chosen."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available; "
                           "pass device 'cpu' (--device cpu) to run on the CPU")

    def place(local_rank: int) -> torch.device:
        if dev.type != "cuda":
            return dev
        out = dev if dev.index is not None else torch.device(
            "cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(out)
        return out

    launch = _launch_env()
    if launch is None:
        out = place(0)
        print(f"init_distributed: a world of one process, device {out}, no "
              "process group", flush=True)
        return Distributed(0, 1, None, out, created=False)
    rank, world = int(launch["rank"]), int(launch["world"])
    store, _, _ = next(dist.rendezvous(str(launch["url"]), rank, world))
    local_rank, local_world = launch["local_rank"], launch["local_world"]
    if local_world is None:
        local_rank, local_world = host_place(store, rank, world)
    out = place(int(local_rank))
    backend, why = backend_for(out.type, world, int(local_world))
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg", store),
                            rank=rank, world_size=world)
    print(f"init_distributed: rank {rank} of {world} ({local_world} on this "
          f"host), device {out}, backend {backend} ({why})", flush=True)
    return Distributed(rank, world, backend, out, created=True)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1
              ) -> Optional[DeviceMesh]:
    """The ``('data', 'model')`` mesh over the world's ranks (row-major:
    rank ``d * n_model + m``). Default: every rank on ``data``. Without a
    process group the world is this process alone, and its 1x1 mesh is
    None."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    # n_data >= 1 catches n_model > world early, as JAX's make_mesh does
    if not (n_data >= 1 and n_model >= 1):
        raise ValueError(f"degenerate mesh {n_data}x{n_model} on {world} "
                         "processes")
    if n_data * n_model > world:
        raise ValueError(f"need {n_data * n_model} processes, have {world}")
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh leaves ranks of the "
                         f"{world} processes without a cell")
    if not dist.is_initialized():
        return None
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(world).reshape(n_data, n_model)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(("data", "model").index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_main() -> bool:
    """Whether this process writes the run's artifacts: global rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (a decision every rank must share)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_object(obj):
    """Every rank's ``obj``, in rank order (host objects; pickled)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def replicate(mesh: Optional[DeviceMesh], tensors: Iterable[torch.Tensor],
              axis: Optional[str] = None) -> None:
    """Broadcast ``tensors`` in place from the first rank of the world, or
    of this rank's ``axis`` group (a sharded tensor is the same only along
    ``data``)."""
    if mesh is None:
        return
    group = mesh.get_group(axis) if axis else None
    src = dist.get_global_rank(group, 0) if group is not None else 0
    if group is not None and dist.get_world_size(group) == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def replicate_global(mesh: Optional[DeviceMesh], state) -> None:
    """Make every rank hold rank 0's training state: the model's parameters
    and buffers and the optimizer's state (its moments), each broadcast in
    place; a parameter sharded along ``model``, and its moments, from the
    first rank of its ``data`` group. Every rank builds the same weights
    from the run's seed, so this only guards that contract."""
    if mesh is None:
        return
    model = state.model
    sharded = set(getattr(model, "tp_layout", {}))
    adamax = state.optimizer.adamax
    whole, split = [], []
    for name, p in model.named_parameters():
        moments = [v for v in adamax.state.get(p, {}).values()
                   if torch.is_tensor(v) and v.dim() > 0]
        (split if name in sharded else whole).extend([p.data] + moments)
    whole.extend(b for b in model.buffers())
    replicate(mesh, whole)
    replicate(mesh, split, axis="data")


def batch_shardings(mesh: Optional[DeviceMesh], batch: Dict
                    ) -> Dict[str, Optional[str]]:
    """For each entry of a global batch, ``"data"`` where its leading axis
    splits evenly over the data ranks, else None (every rank takes it
    whole), JAX's rule."""
    n = axis_size(mesh, "data")
    return {k: "data" if getattr(v, "ndim", 0) >= 1 and v.shape[0] % n == 0
            else None for k, v in batch.items()}


def shard_batch(mesh: Optional[DeviceMesh], batch: Dict) -> Dict:
    """This data rank's part of a global ``batch`` (arrays or tensors), as
    JAX lays out ``P('data')``: contiguous blocks of rows, block ``r`` on
    data rank ``r``; the entries that do not split stay whole. A
    multi-process run's Loader (``Loader.for_process``) hands each process
    its own rows, which need no cut."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    out = {}
    for k, spec in batch_shardings(mesh, batch).items():
        v = batch[k]
        if spec == "data":
            rows = v.shape[0] // n
            v = v[r * rows:(r + 1) * rows]
        out[k] = v
    return out


# -- tensor parallelism ------------------------------------------------------


class _Enter(torch.autograd.Function):
    """Identity; the gradient is summed over the group. A replicated input
    of a sharded product gets from each rank only its slice's part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Total(torch.autograd.Function):
    """All-reduced sum over the group; the gradient (replicated, as the
    sum is) passes through to each rank's addend unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather of the slices along the last dimension; the gradient of
    the (replicated) whole gives each rank its own slice back."""

    @staticmethod
    def forward(ctx, y, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None, None, None


@dataclass(frozen=True)
class ModelShard:
    """A sharded layer's place on the ``model`` axis: slice ``rank`` of
    ``size`` along its output dimension, with ``group`` the ranks that hold
    the other slices. Each collective differentiates as the layer's full
    product would (Megatron's "f" and "g" operators)."""
    group: object
    rank: int
    size: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group) if x.requires_grad else x

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return _Total.apply(x, self.group)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(y, self.group, self.rank, self.size)


def _tp_dim(name: str, param: torch.Tensor) -> Optional[int]:
    """JAX's ``_param_spec`` on a torch name: dim 0 of a 2-D weight or a
    bias inside a TP module, else None."""
    parts = name.split(".")
    if not any(p in TP_MODULES for p in parts[:-1]):
        return None
    return 0 if _TP_LEAVES.get(parts[-1]) == param.dim() else None


def param_shardings(model: nn.Module, mesh: Union[DeviceMesh, int, None]
                    ) -> Dict[str, Optional[int]]:
    """For each parameter name, the dimension sharded along ``model``, or
    None (replicated): the layout of JAX's ``param_shardings``, falling back
    to replication where the dimension does not divide by the axis size.
    ``mesh``: the mesh, or the size of its ``model`` axis."""
    n_model = mesh if isinstance(mesh, int) else axis_size(mesh, "model")
    out = {}
    for name, p in model.named_parameters():
        dim = _tp_dim(name, p)
        out[name] = dim if dim is not None and p.shape[dim] % n_model == 0 \
            else None
    return out


def shard_params(model: nn.Module, mesh: Optional[DeviceMesh]
                 ) -> Dict[str, int]:
    """Turn the parameters that :func:`param_shardings` shards into this
    rank's slices, in place, and give their layers the :class:`ModelShard`
    their forward uses. Build the optimizer after this. Records the layout
    as ``model.tp_layout`` ({name: dim}) and the shard as
    ``model.tp_shard``; returns the layout. A mesh whose ``model`` axis is
    1, or a model none of whose head dimensions divides by it, shards
    nothing and stays replicated, as JAX's layout does."""
    if getattr(model, "tp_layout", None):
        return model.tp_layout
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    if n == 1:
        return {}
    layout = {k: v for k, v in param_shardings(model, mesh).items()
              if v is not None}
    if not layout:
        return {}
    shard = ModelShard(mesh.get_group("model"), r, n)
    for mod_name, mod in model.named_modules():
        own = [pn for pn, _ in mod.named_parameters(recurse=False)
               if f"{mod_name}.{pn}" in layout]
        if not own:
            continue
        if not hasattr(mod, "tp"):
            raise TypeError(f"{mod_name} ({type(mod).__name__}) has no "
                            "tensor-parallel forward")
        for pn in own:
            full = getattr(mod, pn)
            dim = layout[f"{mod_name}.{pn}"]
            setattr(mod, pn, nn.Parameter(
                full.detach().chunk(n, dim)[r].clone()))
        mod.tp = shard
    model.tp_layout, model.tp_shard = layout, shard
    return layout


def gather_shards(tensors: Dict[str, torch.Tensor], layout: Dict[str, int],
                  shard: Optional[ModelShard]) -> Dict[str, torch.Tensor]:
    """``tensors`` with each entry named in ``layout`` all-gathered from its
    slices into the full tensor (a collective of the ``model`` group)."""
    out = dict(tensors)
    for name, dim in layout.items():
        if name in tensors:
            t = tensors[name].detach().contiguous()
            parts = [torch.empty_like(t) for _ in range(shard.size)]
            dist.all_gather(parts, t, group=shard.group)
            out[name] = torch.cat(parts, dim=dim)
    return out


def split_shards(tensors: Dict[str, torch.Tensor], layout: Dict[str, int],
                 shard: Optional[ModelShard]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`gather_shards`: each full entry named in
    ``layout`` cut to this rank's slice."""
    out = dict(tensors)
    for name, dim in layout.items():
        if name in tensors:
            out[name] = tensors[name].chunk(shard.size, dim)[shard.rank].clone()
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with the sharded entries gathered (collective
    under tensor parallelism)."""
    return gather_shards(model.state_dict(), getattr(model, "tp_layout", {}),
                         getattr(model, "tp_shard", None))


def local_state_dict(model: nn.Module, full: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` cut to the slices ``model`` holds."""
    return split_shards(full, getattr(model, "tp_layout", {}),
                        getattr(model, "tp_shard", None))


def data_token_count(mesh: Optional[DeviceMesh]):
    """The caption CE's count map over the ``data`` group: a rank's count
    to the mean count of the group, so that a loss dividing a rank's sum by
    it averages, over the data ranks, to the global sum over the global
    count (the single-process loss of the global batch). None where the
    group is one rank."""
    n = axis_size(mesh, "data")
    if n == 1:
        return None
    group = mesh.get_group("data")

    def count(c: torch.Tensor) -> torch.Tensor:
        total = c.detach().clone()
        dist.all_reduce(total, group=group)
        return total / n

    return count


def reduce_data_mean(tensors, mesh: Optional[DeviceMesh]) -> None:
    """Replace each tensor by its mean over the ``data`` group, in place,
    with one all-reduce of their coalesced f32 copy."""
    n = axis_size(mesh, "data")
    tensors = list(tensors)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    flat /= n
    offset = 0
    with torch.no_grad():
        for t in tensors:
            k = t.numel()
            t.copy_(flat[offset:offset + k].view_as(t))
            offset += k
