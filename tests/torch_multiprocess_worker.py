"""One rank of tests/test_torch_multiprocess.py's multi-process runs.

Started in a fresh interpreter (never forked: the test process has imported
jax) with the ``VQA_TPU_MULTIHOST`` variables, it joins the gloo process
group through ``vqa_tpu_torch.parallel.mesh.init_distributed`` and runs the
cases of ``spec.json`` in the directory it is given, writing
``{case}_rank{r}.pt`` there. It imports the port alone, never jax.

Cases (``kind``):

- ``step``: the model of ``weights`` sliced over the case's mesh, three
  f32 steps of ``make_train_step`` (or the max-relevance step) on this
  data rank's rows of each global batch; records step 0's averaged raw
  gradients, the losses, the gradient norms and the final parameters
  (gathered), the sliced parameters, and this rank's caption-token count.
- ``dropout``: the same local rows on every rank, one training-mode
  backward at dropout 0.5 / 0.2; records the loss and the step seeds.
- ``evaluate``: ``evaluate`` over ``Loader.for_process`` shards of the
  synthetic val split, and (rank 0) over one unsharded Loader.
- ``replicate``: weights moved by the rank, then ``replicate_global``.
- ``checkpoint``: a one-process checkpoint loaded under tensor
  parallelism (this rank's slices recorded), then a step and a save under
  tensor parallelism (this rank's slices after the step recorded).
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vqa_tpu_torch.data.dataset import set_dataset  # noqa: E402
from vqa_tpu_torch.data.loader import Loader  # noqa: E402
from vqa_tpu_torch.models.wrapper import set_model  # noqa: E402
from vqa_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from vqa_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from vqa_tpu_torch.training.optim import make_optimizer  # noqa: E402
from vqa_tpu_torch.training.select import (  # noqa: E402
    get_select_loss, make_train_select_step)
from vqa_tpu_torch.training.state import (  # noqa: E402
    TrainState, backward_step, joint_loss, make_eval_step, make_train_step,
    reduce_over_data, step_seeds)
from vqa_tpu_torch.training.train import evaluate  # noqa: E402

SEED = 7


def tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def build(case, mesh):
    model = set_model(**case["dims"], device="cpu")
    model.load_state_dict(torch.load(case["weights"], weights_only=True))
    mesh_lib.shard_params(model, mesh)
    opt = make_optimizer(model, **case["opt"])
    state = TrainState(model, opt, seed=SEED)
    mesh_lib.replicate_global(mesh, state)
    return model, opt, state


def full_grads(model):
    grads = {n: p.grad for n, p in model.named_parameters()}
    return mesh_lib.gather_shards(grads, getattr(model, "tp_layout", {}),
                                  getattr(model, "tp_shard", None))


def run_step(case, mesh):
    model, opt, state = build(case, mesh)
    select = case.get("select", False)
    loss_fn = get_select_loss if select else joint_loss
    factory = make_train_select_step if select else make_train_step
    batches = [tensors(mesh_lib.shard_batch(mesh, b))
               for b in torch.load(case["batches"], weights_only=False)]
    metrics = backward_step(model, batches[0], SEED, 0, None, loss_fn,
                            mesh_lib.axis_rank(mesh, "data"),
                            mesh_lib.data_token_count(mesh))
    reduce_over_data(model, metrics, mesh)
    grads0 = full_grads(model)
    step = factory(model, opt, compute_dtype=None, mesh=mesh)
    out = [step(state, b) for b in batches]
    b0 = batches[0]
    lens = b0["cap_len_all"][:, 0] if select else b0.get("cap_len")
    return {"losses": [m["loss"].item() for m in out],
            "grad_norms": [m["grad_norm"].item() for m in out],
            "metrics0": {k: v.item() for k, v in out[0].items()},
            "grads0": grads0, "params": mesh_lib.full_state_dict(model),
            "layout": dict(getattr(model, "tp_layout", {})),
            "tokens": None if lens is None
            else int((lens - 1).clamp(min=0).sum())}


def run_dropout(case, mesh):
    model, _, _ = build(case, mesh)
    batch = tensors(torch.load(case["batches"], weights_only=False)[0])
    metrics = backward_step(model, batch, SEED, 0, None, joint_loss,
                            mesh_lib.axis_rank(mesh, "data"))
    return {"loss": metrics["loss"].item(),
            "seeds": step_seeds(SEED, 0, mesh_lib.axis_rank(mesh, "data"))}


def run_replicate(case, mesh):
    """Each rank moves its weights by its rank before ``replicate_global``:
    afterwards every rank holds rank 0's (slices of the) weights."""
    model = set_model(**case["dims"], device="cpu")
    model.load_state_dict(torch.load(case["weights"], weights_only=True))
    mesh_lib.shard_params(model, mesh)
    state = TrainState(model, make_optimizer(model, **case["opt"]), seed=SEED)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(float(torch.distributed.get_rank()))
    mesh_lib.replicate_global(mesh, state)
    return {"model": {k: v.clone() for k, v in model.state_dict().items()}}


def run_evaluate(case, mesh):
    root = case["root"]
    model = set_model(**case["dims"], ans_dim=root["ans_dim"],
                      ntoken=root["ntoken"], v_dim=root["v_dim"],
                      generator=torch.Generator().manual_seed(3),
                      device="cpu")
    ds = set_dataset(root["annot"], root["feature_root"], root["ans_dim"],
                     is_val=True, dataset_type="vqa")
    with open(root["index_path"]) as f:
        ans_index = json.load(f)
    eval_step = make_eval_step(model)
    sharded = Loader.for_process(ds, case["batch_size"], mesh=mesh)
    out = {"shard_len": len(sharded), "num_samples": sharded.num_samples,
           "score": evaluate(eval_step, sharded, "cpu", mesh=mesh),
           "metric": evaluate(eval_step, sharded, "cpu", mesh=mesh,
                              ans_index=ans_index)}
    if mesh_lib.is_main():
        whole = Loader(ds, case["batch_size"])
        out["single_score"] = evaluate(eval_step, whole, "cpu")
        out["single_metric"] = evaluate(eval_step, whole, "cpu",
                                        ans_index=ans_index)
    return out


def local_state(model, opt):
    moments = {n: {k: v.clone() for k, v in opt.adamax.state[p].items()}
               for n, p in model.named_parameters()}
    return {"model": {k: v.clone() for k, v in model.state_dict().items()},
            "moments": moments, "layout": dict(model.tp_layout)}


def run_checkpoint(case, mesh):
    model, opt, state = build(case, mesh)
    ckpt.load_checkpoint(case["single_ckpt"], state)
    loaded = local_state(model, opt)
    batch = tensors(mesh_lib.shard_batch(
        mesh, torch.load(case["batches"], weights_only=False)[0]))
    make_train_step(model, opt, compute_dtype=None, mesh=mesh)(state, batch)
    ckpt.save_checkpoint(case["tp_ckpt"], state, 0, 0.5)
    return {"loaded": loaded, "stepped": local_state(model, opt),
            "step": state.step}


RUN = {"step": run_step, "dropout": run_dropout, "evaluate": run_evaluate,
       "checkpoint": run_checkpoint, "replicate": run_replicate}


def main():
    out_dir = sys.argv[1]
    world = mesh_lib.init_distributed("cpu")
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "spec.json")) as f:
        cases = [c for c in json.load(f) if c["world"] == world.world]
    try:
        for case in cases:
            mesh = mesh_lib.make_mesh(*case["mesh"])
            result = RUN[case["kind"]](case, mesh)
            torch.save(result, os.path.join(
                out_dir, f"{case['name']}_rank{world.rank}.pt"))
            mesh_lib.barrier()
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
