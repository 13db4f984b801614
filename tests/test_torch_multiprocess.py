"""The port's data- and tensor-parallel training over torch.distributed
(vqa_tpu_torch/parallel/mesh.py) in 2, 3 and 4 gloo ranks on the CPU.

Each rank is a fresh interpreter (tests/torch_multiprocess_worker.py; this
process has imported jax, so never a fork). With the same weights (the
flax init converted by tools/convert.py) and the same seeded global
batches, at f32 and dropout 0:

- three steps of the MTL model over a DP 2x1, a TP 1x2 and a DP x TP 2x2
  mesh, of ReGAT over DP 2x1 and over a 1x3 model axis that none of its
  head dimensions divides (so nothing is sliced, as in JAX's layout), and
  of the max-relevance step over DP 2x1
  equal the port's single-process step on the global batch and vqa_tpu's
  make_mesh step on the same global batch (virtual CPU devices), in loss,
  step 0's gradients and the parameters, at tests/test_multichip.py's
  tolerance (rtol 2e-4, atol 1e-5); the batches give the two data ranks
  different caption-token counts, so a per-rank token mean would show;
- at dropout 0.5 / 0.2 the data ranks draw different masks and the ranks
  of one model group the same;
- a 2-rank evaluate over 23 questions (wrap-padded shards) equals the
  single-process score exactly;
- a checkpoint saved under TP 1x2 loads in one process bit for bit, and a
  single-process checkpoint loads into the TP slices bit for bit.

Weights whose gradients are f32 rounding noise (the softmax-shifting
attention biases, ReGAT's correlated DotProduct at this init; see
tests/test_torch_train.py and tests/test_torch_regat_train.py) are left
out of the parameter comparison, as those tests leave them out: Adamax
turns noise into full-size steps.
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vqa_tpu.parallel.mesh import param_shardings as jax_param_shardings
from vqa_tpu.parallel.mesh import shard_batch as jax_shard_batch
from vqa_tpu.tools.import_torch import import_reference_state_dict
from vqa_tpu.training import optim as jax_optim
from vqa_tpu.training.select import get_select_loss as jax_get_select_loss
from vqa_tpu.training.select import (
    make_train_select_step as jax_make_train_select_step)
from vqa_tpu.training.state import TrainState as JaxTrainState
from vqa_tpu.training.state import make_train_step as jax_make_train_step
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.parallel.dryrun import free_port, wait_ranks
from vqa_tpu_torch.tools.convert import (
    flax_to_state_dict, gcn_params_from_state_dict)
from vqa_tpu_torch.training import checkpoint as ckpt
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.select import get_select_loss
from vqa_tpu_torch.training.state import (
    TrainState, backward_step, joint_loss, make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multiprocess_worker.py")
B, Q_LEN, EMBED, HIDDEN, V_DIM, OBJS, NTOKEN, ANS, C_LEN, N_CAP = \
    4, 5, 12, 16, 32, 5, 40, 10, 7, 3
SEED, STEPS = 7, 3
TOL = dict(rtol=2e-4, atol=1e-5)
OPT = dict(lr=2e-3, lr_vqa=4e-3, lr_cap=3e-3, max_norm=0.25, warm_up=1,
           step_size=1, gamma=0.5, steps_per_epoch=2)
NOISE = ("encoder.attention.linear.bias", "generator.attention.linear.bias",
         "encoder.spatial_encoder.conv0.dot_product.")
COMMON = dict(ntoken=NTOKEN, v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN,
              decoder_hidden_dim=HIDDEN, ans_dim=ANS, c_len=C_LEN,
              dropout=0.0, att_dropout=0.0, att_type="new")
MODELS = {
    "mtl": dict(encoder_type="base", predictor_type="base",
                decoder_type="butd", use_mtl=True),
    "regat": dict(encoder_type="relation", predictor_type="base",
                  decoder_type="none", conv_type="corr", conv_layer=1),
    "select": dict(encoder_type="base", predictor_type="base-cap",
                   decoder_type="base", use_mtl=True),
}
# (case, model, world, (n_data, n_model))
STEP_CASES = [("mtl_dp", "mtl", 2, (2, 1)), ("mtl_tp", "mtl", 2, (1, 2)),
              ("mtl_dp_tp", "mtl", 4, (2, 2)),
              ("regat_dp", "regat", 2, (2, 1)),
              # no head dimension divides by 3: every weight replicated
              ("regat_tp3", "regat", 3, (1, 3)),
              ("select_dp", "select", 2, (2, 1))]
DROPOUT_CASES = [("dropout_dp", 2, (2, 1)), ("dropout_dp_tp", 4, (2, 2))]
VAL_QUESTIONS, VAL_BATCH = 23, 4


def make_batch(rng, model: str, feed: str):
    """A global batch whose two halves (the data ranks' rows) hold captions
    of different lengths: short in the first, long in the second."""
    half = B // 2
    lens = np.concatenate([rng.integers(2, 4, half),
                           rng.integers(5, C_LEN + 1, B - half)]).astype(np.int32)
    out = {"q": rng.integers(0, NTOKEN, (B, Q_LEN)).astype(np.int32),
           "a": (rng.integers(0, 4, (B, ANS)) / 3.0).astype(np.float32)}
    if model == "select":
        out["c_all"] = rng.integers(0, NTOKEN - 1,
                                    (B, N_CAP, C_LEN)).astype(np.int32)
        # every candidate of a row as long: the selection cannot even out
        # the ranks' token counts
        out["cap_len_all"] = np.repeat(lens[:, None], N_CAP, axis=1)
    else:
        out["c"] = rng.integers(0, NTOKEN - 1, (B, C_LEN)).astype(np.int32)
        out["cap_len"] = lens
    if model == "regat":
        out["graph"] = rng.integers(0, 12, (B, OBJS, OBJS)).astype(np.int32)
    x = rng.standard_normal((B, OBJS, V_DIM)).astype(np.float32)
    if feed == "dense" or model == "select":
        out["img"] = x
    else:
        scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
        out["img_q"] = np.clip(np.rint(x / scale[..., None]), -127,
                               127).astype(np.int8)
        out["img_scale"] = scale
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def twin_weights(model):
    """The port's seeded init of ``model`` as its state_dict, and as
    vqa_tpu's params (vqa_tpu.tools.import_torch, the GCN convs by
    tools/convert.py)."""
    port = set_model(**COMMON, **MODELS[model], device="cpu",
                     generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    gcn, rest = gcn_params_from_state_dict(sd)
    params, unmapped = import_reference_state_dict(rest)
    assert not unmapped, unmapped
    for conv_path, leaves in _flat(gcn):
        node = params
        for key in conv_path[:-1]:
            node = node.setdefault(key, {})
        node[conv_path[-1]] = leaves
    return sd, params


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def jax_mesh_run(model, params, batches, mesh_shape):
    """vqa_tpu's make_mesh step: step 0's gradients and three steps, the
    parameters sharded as tests/test_multichip.py shards them."""
    jm = jax_set_model(**COMMON, **MODELS[model])
    select = model == "select"
    n_data, n_model = mesh_shape
    mesh = jax_make_mesh(n_data=n_data, n_model=n_model,
                         devices=jax.devices()[:n_data * n_model])
    tx = jax_optim.make_optimizer(**OPT)
    sharded = jax.tree_util.tree_map(jax.device_put, params,
                                     jax_param_shardings(mesh, params))
    state = JaxTrainState(params=sharded, opt_state=tx.init(sharded),
                          step=jax.device_put(jnp.int32(0),
                                              NamedSharding(mesh, P())),
                          rng=jax.device_put(jax.random.key(0),
                                             NamedSharding(mesh, P())))
    method = jax_get_select_loss if select else "get_loss"

    def loss(p, b):
        return jm.apply({"params": p}, b, method=method,
                        deterministic=True)[0]

    grads0 = jax.jit(jax.grad(loss))(sharded,
                                     jax_shard_batch(mesh, to_jax(batches[0])))
    step = (jax_make_train_select_step if select else jax_make_train_step)(jm, tx)
    losses = []
    for b in batches:
        state, m = step(state, jax_shard_batch(mesh, to_jax(b)))
        losses.append(float(m["loss"]))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"losses": losses, "grads0": flax_to_state_dict(as_np(grads0)),
            "params": flax_to_state_dict(as_np(state.params))}


def port_single_run(model, weights, batches):
    """The port's single-process step on the global batches."""
    port = set_model(**COMMON, **MODELS[model], device="cpu")
    port.load_state_dict(weights)
    opt = make_optimizer(port, **OPT)
    state = TrainState(port, opt, seed=SEED)
    select = model == "select"
    backward_step(port, to_torch(batches[0]), SEED, 0, None,
                  get_select_loss if select else joint_loss)
    grads0 = {n: p.grad.clone() for n, p in port.named_parameters()}
    step = make_train_step(port, opt, compute_dtype=None,
                           loss_fn=get_select_loss if select else joint_loss)
    out = [step(state, to_torch(b)) for b in batches]
    return {"losses": [m["loss"].item() for m in out], "grads0": grads0,
            "grad_norms": [m["grad_norm"].item() for m in out],
            "metrics0": {k: v.item() for k, v in out[0].items()},
            "params": {k: v.clone() for k, v in port.state_dict().items()}}


def launch(world: int, out_dir: str):
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, VQA_TPU_MULTIHOST="1",
                   VQA_TPU_COORD=f"localhost:{port}",
                   VQA_TPU_NPROCS=str(world), VQA_TPU_PROC_ID=str(rank),
                   OMP_NUM_THREADS="1")
        env.pop("RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, out_dir], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(procs):
    for p, log in zip(procs, wait_ranks(procs, 240)):
        assert p.returncode == 0, log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the weights, batches and cases; start the 2- and 4-rank
    workers; compute the single-process and vqa_tpu references while they
    run; return everything the tests compare."""
    out = tmp_path_factory.mktemp("torch_mp")
    rng = np.random.default_rng(1111)
    cases, refs, weights = [], {}, {}
    batches = {}
    for model in MODELS:
        # one feed a model: each feed is a compile of vqa_tpu's step
        feed = "int8" if model == "mtl" else "dense"
        batches[model] = [make_batch(rng, model, feed) for _ in range(STEPS)]
        weights[model] = twin_weights(model)
        torch.save(weights[model][0], out / f"{model}_weights.pt")
        torch.save(batches[model], out / f"{model}_batches.pt")
    for name, model, world, mesh in STEP_CASES:
        cases.append(dict(name=name, kind="step", world=world, mesh=mesh,
                          dims={**COMMON, **MODELS[model]},
                          weights=str(out / f"{model}_weights.pt"),
                          batches=str(out / f"{model}_batches.pt"),
                          opt=OPT, select=model == "select"))
    for name, world, mesh in DROPOUT_CASES:
        cases.append(dict(name=name, kind="dropout", world=world, mesh=mesh,
                          dims={**COMMON, **MODELS["mtl"], "dropout": 0.5,
                                "att_dropout": 0.2},
                          weights=str(out / "mtl_weights.pt"),
                          batches=str(out / "mtl_batches.pt"), opt=OPT))
    cases.append(dict(name="replicate", kind="replicate", world=4,
                      mesh=(2, 2), dims={**COMMON, **MODELS["mtl"]},
                      weights=str(out / "mtl_weights.pt"), opt=OPT))
    root = make_synthetic_root(str(out / "data"), split="val2014",
                               num_images=4, num_questions=VAL_QUESTIONS,
                               seed=9)
    cases.append(dict(name="evaluate", kind="evaluate", world=2, mesh=(2, 1),
                      root=root, batch_size=VAL_BATCH,
                      dims=dict(encoder_type="base", predictor_type="base",
                                decoder_type="none", embed_dim=EMBED,
                                hidden_dim=HIDDEN, decoder_hidden_dim=HIDDEN,
                                att_type="new", dropout=0.0)))
    # a single-process checkpoint after one step, for the TP ranks to load
    port = set_model(**COMMON, **MODELS["mtl"], device="cpu")
    port.load_state_dict(weights["mtl"][0])
    state = TrainState(port, make_optimizer(port, **OPT), seed=SEED)
    make_train_step(port, state.optimizer, compute_dtype=None)(
        state, to_torch(batches["mtl"][1]))
    ckpt.save_checkpoint(str(out / "single.ckpt"), state, 0, 0.25)
    cases.append(dict(name="checkpoint", kind="checkpoint", world=2,
                      mesh=(1, 2), dims={**COMMON, **MODELS["mtl"]},
                      weights=str(out / "mtl_weights.pt"),
                      batches=str(out / "mtl_batches.pt"), opt=OPT,
                      single_ckpt=str(out / "single.ckpt"),
                      tp_ckpt=str(out / "tp.ckpt")))
    with open(out / "spec.json", "w") as f:
        json.dump(cases, f)

    procs = launch(2, str(out)) + launch(3, str(out)) + launch(4, str(out))
    try:
        # vqa_tpu's steps in threads: XLA compiles outside the GIL
        with ThreadPoolExecutor(len(STEP_CASES)) as pool:
            jax_runs = [pool.submit(jax_mesh_run, model, weights[model][1],
                                    batches[model], mesh)
                        for _, model, _, mesh in STEP_CASES]
            for model in MODELS:
                refs[("single", model)] = port_single_run(
                    model, weights[model][0], batches[model])
            for (name, *_), run in zip(STEP_CASES, jax_runs):
                refs[("jax", name)] = run.result()
    finally:
        finish(procs)

    def result(name, rank=0):
        return torch.load(out / f"{name}_rank{rank}.pt", weights_only=False)

    return {"refs": refs, "result": result, "out": out}


def assert_close(got, want, what, skip=()):
    assert set(got) == set(want), what
    for k in want:
        if any(k.startswith(s) for s in skip):
            continue
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=f"{what}: {k}", **TOL)


@pytest.mark.parametrize("name,model,world,mesh", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_mesh_steps_match_one_process_and_jax_mesh(runs, name, model, world,
                                                   mesh):
    """Loss, step 0's gradients and the parameters after three steps, of
    rank 0, against the port's single-process step on the global batch and
    vqa_tpu's make_mesh step (the gradient norms and the metrics against
    the former); every rank ends with the same parameters."""
    got = runs["result"](name)
    single = runs["refs"][("single", model)]
    # the heads are sliced where the model axis divides them, and only there
    assert bool(got["layout"]) == (name in ("mtl_tp", "mtl_dp_tp")), got["layout"]
    # the clip's global norm (over the slices under TP) and the step's
    # metrics of the global batch (train/score summed over the data ranks)
    np.testing.assert_allclose(got["grad_norms"], single["grad_norms"], **TOL)
    assert set(got["metrics0"]) == set(single["metrics0"])
    for k, v in single["metrics0"].items():
        np.testing.assert_allclose(got["metrics0"][k], v, err_msg=k, **TOL)
    for ref in (single, runs["refs"][("jax", name)]):
        np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
        assert_close(got["grads0"], ref["grads0"], f"{name} grads")
        assert_close(got["params"], ref["params"], f"{name} params", NOISE)
    for rank in range(1, world):
        other = runs["result"](name, rank)
        assert other["losses"] == got["losses"]
        for k, v in got["params"].items():
            assert torch.equal(other["params"][k], v), (name, rank, k)
    if model != "regat":
        # the data ranks' caption-token counts differ
        counts = [runs["result"](name, r)["tokens"] for r in range(world)]
        firsts = counts[::mesh[1]]
        assert len(set(firsts)) == mesh[0], counts


def test_tp_shards_the_heads(runs):
    """The TP runs really slice the heads: the weight-norm classifier and
    the vocab projection are among the gathered, sharded tensors."""
    from vqa_tpu_torch.parallel.mesh import param_shardings
    port = set_model(**COMMON, **MODELS["mtl"], device="cpu")
    layout = {k for k, v in param_shardings(port, 2).items() if v is not None}
    assert {"predictor.classifier.main.0.weight_v",
            "predictor.classifier.main.3.weight_v",
            "generator.h2_fcnet.weight", "generator.h2_fcnet.bias"} <= layout
    loaded = runs["result"]("checkpoint")["loaded"]
    assert set(loaded["layout"]) == layout
    assert loaded["model"]["generator.h2_fcnet.weight"].shape[0] == NTOKEN // 2


@pytest.mark.parametrize("name,world,mesh", DROPOUT_CASES,
                         ids=[c[0] for c in DROPOUT_CASES])
def test_dropout_masks_by_data_rank(runs, name, world, mesh):
    """Every rank runs the same rows at dropout 0.5 / 0.2: the ranks of one
    model group compute the same loss (their masks agree, the sharded
    heads' all-gathers included), the data ranks different ones, and both
    the torch seed and the caption scan's Philox seed differ by data
    rank."""
    got = [runs["result"](name, r) for r in range(world)]
    n_model = mesh[1]
    for d in range(mesh[0]):
        group = got[d * n_model:(d + 1) * n_model]
        assert all(g["loss"] == group[0]["loss"] for g in group)
        assert all(g["seeds"] == group[0]["seeds"] for g in group)
    firsts = got[::n_model]
    assert len({g["loss"] for g in firsts}) == mesh[0]
    for i in range(2):
        assert len({g["seeds"][i] for g in firsts}) == mesh[0]


def test_replicate_global_makes_every_rank_hold_rank_0s_weights(runs):
    """Over a 2x2 mesh every rank moved its weights by its rank number
    before replicate_global: afterwards the replicated tensors are rank
    0's everywhere, and each sharded head's slice is the one of the first
    rank of the data group (ranks 0 and 2 hold rank 0's, 1 and 3 rank
    1's)."""
    from vqa_tpu_torch.parallel.mesh import param_shardings
    port = set_model(**COMMON, **MODELS["mtl"], device="cpu")
    sharded = {k for k, v in param_shardings(port, 2).items() if v is not None}
    got = [runs["result"]("replicate", r)["model"] for r in range(4)]
    for rank in range(4):
        for k, v in got[rank].items():
            src = rank % 2 if k in sharded else 0
            assert torch.equal(v, got[src][k]), (rank, k)
    weights = torch.load(runs["out"] / "mtl_weights.pt", weights_only=True)
    for k, v in got[0].items():
        assert torch.equal(v, weights[k].chunk(2, 0)[0] if k in sharded
                           else weights[k]), k


def test_evaluate_two_ranks_equals_one_process(runs):
    """23 questions over 2 ranks (12 a shard, one wrap-padded repeat): the
    score, the bound and the answer-type breakdown equal one process's
    exactly."""
    got = [runs["result"]("evaluate", r) for r in range(2)]
    assert got[0]["shard_len"] == 3 and got[0]["num_samples"] == 12
    for g in got:
        assert g["score"] == got[0]["single_score"]
        assert g["metric"] == got[0]["single_metric"]
    assert 0.0 <= got[0]["score"][0] <= got[0]["score"][1]


def test_tp_checkpoint_round_trips_bit_for_bit(runs):
    """A single-process checkpoint cut into the TP 1x2 slices, and the TP
    run's checkpoint read back in one process: every parameter and Adamax
    moment equals its slice bit for bit."""
    out = runs["out"]
    for source, key in (("single.ckpt", "loaded"), ("tp.ckpt", "stepped")):
        full = ckpt.load_checkpoint(str(out / source))
        port = set_model(**COMMON, **MODELS["mtl"], device="cpu")
        state = TrainState(port, make_optimizer(port, **OPT), seed=SEED)
        ckpt.load_checkpoint(str(out / source), state)   # one process
        for k, v in port.state_dict().items():
            assert torch.equal(v, full["model"][k]), k
        for rank in range(2):
            shard = runs["result"]("checkpoint", rank)[key]
            for k, v in shard["model"].items():
                dim = shard["layout"].get(k)
                want = full["model"][k] if dim is None \
                    else full["model"][k].chunk(2, dim)[rank]
                assert torch.equal(v, want), (source, rank, k)
            for k, p in port.named_parameters():
                dim = shard["layout"].get(k)
                for m, v in shard["moments"][k].items():
                    want = state.optimizer.adamax.state[p][m]
                    if dim is not None and want.dim() > 0:
                        want = want.chunk(2, dim)[rank]
                    assert torch.equal(v, want), (source, rank, k, m)
    assert runs["result"]("checkpoint")["step"] == \
        ckpt.load_checkpoint(str(out / "tp.ckpt"))["step"] == 2
