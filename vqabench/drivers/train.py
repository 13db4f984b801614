"""Training steps on batches staged on the card.

Traffic parameters: ``batch``, ``batches`` (distinct batches staged from
the seed, taken in turn), ``caption`` (``{"shortest", "longest"}``: the
caption lengths drawn for each row, padded to the configuration's
``c_len``; absent for a VQA-only model), ``checked_steps`` (the first
steps the reference follows), ``reference_rows``, and the name of the
rate metric (``rate_metric``).

Set-up builds one training object: the program's model with f32 master
weights (the benchmark's), its optimizer (``make_optimizer``: clip, then
Adamax by groups) and ``make_train_step`` in the configuration's compute
dtype. It drives that object through its first ``checked_steps`` steps,
one batch each (no two share a row), through the window's own call, and
keeps what the check reads: each step's loss, the first gradient as the
optimizer holds it (Adamax's first moment after one step, over 1 - b1)
and the parameters after the checked steps. The window then goes on
stepping the same object, at most two steps in flight, until
``--seconds`` have passed.
"""

from __future__ import annotations

import statistics

import torch

from vqabench import common
from vqabench.reference import train as ref_train
from vqabench.reference.precision import Precision


# the numbers that decide ``correct``, where the traffic file gives a limit
COMPARED = ("grad_gap", "update_gap", "grad_diff", "grad_diff_median")
WARMUP_STEPS = 1       # steps after the checked ones, before the window


def stage(run, gen, B: int):
    cfg, tr, dev = run.config, run.traffic, run.device
    img_q, scales = common.features(gen, B, cfg["num_objs"], cfg["v_dim"])
    ids = common.answer_ids(gen, B, cfg["ans_dim"])
    batch = {"q": common.questions(gen, B, cfg["q_len"], cfg["ntoken"]),
             "img_q": img_q, "img_scale": scales,
             "a": common.soft_scores(ids, cfg["ans_dim"])}
    cap = tr.get("caption")
    if cap:
        batch["c"], batch["cap_len"] = common.captions(
            gen, B, cfg["c_len"], cfg["ntoken"], cap["shortest"],
            cap["longest"])
    return batch


def setup(run):
    with run.phase("import"):
        from vqa_tpu_torch.training.optim import make_optimizer
        from vqa_tpu_torch.training.state import TrainState, make_train_step

    cfg, tr, dev = run.config, run.traffic, run.device
    model, weights = common.build_model(run, torch.float32)
    gen = common.generator(dev, run.seed, common.INPUTS)
    with run.phase("stage"):
        batches = [stage(run, gen, tr["batch"]) for _ in range(tr["batches"])]
    with run.phase("optimizer"):
        opt = make_optimizer(model, lr=cfg["lr"], max_norm=cfg["max_norm"])
        run_seed = common.sub_seed(run.seed, common.TRAIN)
        ts = TrainState(model, opt, seed=run_seed)
        step = make_train_step(model, opt,
                               compute_dtype=getattr(torch, cfg["train_dtype"]))
    state = {"model": model, "opt": opt, "ts": ts, "step": step,
             "weights": weights, "batches": batches, "run_seed": run_seed}
    losses = []
    names = dict((id(p), n) for n, p in model.named_parameters())
    with run.phase("checked_steps"):
        for s in range(tr["checked_steps"]):
            losses.append(step(ts, batches[s])["loss"])
            if s == 0:
                b1 = opt.adamax.param_groups[0]["betas"][0]
                state["first_grad"] = {
                    names[id(p)]: opt.adamax.state[p]["exp_avg"] / (1 - b1)
                    for g in opt.adamax.param_groups for p in g["params"]}
        state["losses"] = [float(x) for x in losses]
        state["after"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
    with run.phase("warmup"):
        for s in range(WARMUP_STEPS):
            step(ts, batches[(tr["checked_steps"] + s) % len(batches)])
    return state


def window(run, state):
    tr = run.traffic
    batches, ts, step = state["batches"], state["ts"], state["step"]
    last = []

    def one():
        with run.span("vqabench.train_step"):
            last[:] = [step(ts, batches[ts.step % len(batches)])["loss"]]

    n, elapsed, quarters = common.back_to_back(run, one)
    state["window_loss"] = float(last[0])
    work = n * tr["batch"]
    return {"metrics": {tr["rate_metric"]: work / elapsed},
            "work": work, "steps": n, "elapsed_s": elapsed,
            "quarter_rates": [q * tr["batch"] * 4 / elapsed for q in quarters]}


def release(run, state):
    for k in ("model", "opt", "ts", "step"):
        state.pop(k, None)


def readings(run, state, prec: Precision, fault=None):
    """The compared numbers of the program's first steps against the
    reference's, or, with another ``prec`` or a ``fault``, of the
    reference so made against the sound reference: ``loss_gap`` (the
    widest relative gap of a step's loss), ``grad_gap`` and
    ``update_gap`` (the widest gap between a leaf's norm of the first
    gradient, or of the change over the checked steps, and the
    reference's, against the larger of the reference's norm of that leaf
    and of the median leaf of its module), ``grad_diff`` and
    ``grad_diff_median`` (the widest and the median norm of a leaf's
    first-gradient difference, against the same). A leaf's module is the
    first two parts of its name (``generator.attention``,
    ``encoder.q_rnn``): the caption decoder's attention, whose gradients
    lie some six orders below the VQA head's at initialisation, is held
    against its own leaves. Leaves whose reference gradient is under a
    thousandth of their module's median leaf's are left out
    (:func:`common.moved_leaves`)."""
    tr = run.traffic
    cfg = dict(run.config)
    steps = tr["checked_steps"]
    args = (state["weights"], state["batches"], state["run_seed"], steps,
            cfg, Precision("f32"), tr["reference_rows"],
            getattr(torch, cfg["train_dtype"]))
    if "reference" not in state:
        state["reference"] = ref_train.run_steps(*args)
    losses, first, after = state["reference"]
    ref_first = {k: float(g.norm()) for k, g in first.items()}
    ref_move = {k: float((after[k] - state["weights"][k].float()).norm())
                for k in after}
    if prec.name == "f32" and fault is None:
        p_losses, p_grads, p_after = (state["losses"], state["first_grad"],
                                      state["after"])
    else:
        p_losses, p_grads, p_after = ref_train.run_steps(
            *args[:5], prec, *args[6:], fault=fault)
    p_first = {k: float(g.norm()) for k, g in p_grads.items()}
    p_move = {k: float((p_after[k].float() - state["weights"][k].float()).norm())
              for k in p_after}
    p_diff = {k: float((p_grads[k].float() - first[k]).norm()) for k in first}
    leaves = common.moved_leaves(ref_first)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_losses, losses))
    grad_gap, grad_leaf = common.leaf_gaps(p_first, ref_first, leaves)
    move_gap, move_leaf = common.leaf_gaps(p_move, ref_move, leaves)
    diffs = common.relative_gaps(p_diff, {k: 0.0 for k in first}, leaves,
                                 scale=ref_first)
    diff_leaf = max(diffs, key=diffs.get)
    diff, diff_median = diffs[diff_leaf], statistics.median(diffs.values())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": move_gap,
            "grad_diff": diff, "grad_diff_median": diff_median,
            "grad_leaf": grad_leaf, "update_leaf": move_leaf,
            "diff_leaf": diff_leaf,
            "left_out": sorted(set(ref_first) - set(leaves)),
            "leaves": {k: [ref_first[k], ref_move[k], p_move[k], p_diff[k]]
                       for k in first}}


def check(run, state):
    r = readings(run, state, Precision("f32"))
    limits = run.traffic["limits"]
    compared = [(k, r[k], limits[k]) for k in COMPARED if k in limits]
    notes = {k: r[k] for k in ("loss_gap", "grad_leaf", "update_leaf",
                               "diff_leaf")}
    notes["window_loss"] = state["window_loss"]
    return compared, notes
