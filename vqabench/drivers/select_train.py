"""Q-Relevant's max-relevance training steps on batches staged on the card.

Traffic parameters: ``batch`` (questions a step), ``batches`` (distinct
batches staged from the seed, taken in turn), ``caption``
(``{"shortest", "longest"}``: each candidate caption's length, drawn
apart, padded to the configuration's ``c_len``), ``checked_steps`` (the
first steps the reference follows), ``reference_rows`` (questions a block
of the reference, with their candidates), the name of the rate metric
(``rate_metric``, questions a second) and ``limits``. The configuration
gives ``n_cap``, the candidate captions a question, and ``weight_gain``,
factors on named weights after :func:`vqabench.common.make_weights`.

Set-up builds the object that ``train_select`` trains: the program's
model with f32 master weights (the benchmark's), ``make_optimizer`` and
``make_train_select_step`` in the configuration's compute dtype. A batch
holds dense float32 features ``img`` (drawn as the int8 cells draw them,
then dequantized), ``q``, the soft scores ``a``, ``c_all`` [B, n_cap,
c_len] and ``cap_len_all`` [B, n_cap]. The first ``checked_steps`` steps
take one batch each; the check keeps each step's loss, the first gradient
as the optimizer holds it, the parameters after them and each step's
chosen captions, read at the caption decoder's input. The window then
steps the same object, at most two steps in flight, until ``--seconds``
have passed.
"""

from __future__ import annotations

import statistics

import torch

from vqabench import common
from vqabench.drivers import train
from vqabench.reference import qrel
from vqabench.reference.precision import Precision

# the numbers that decide ``correct``: the training driver's, and the
# selection's gap (:func:`_selection`), which holds the pick itself (a
# worse candidate picked for a few percent of the questions moves the
# gradients by less than the bf16 round-off does); the steps before the
# window, and the window itself: the training driver's
COMPARED = train.COMPARED + ("select_gap",)
WARMUP_STEPS = train.WARMUP_STEPS
window, release = train.window, train.release


def stage(run, gen, B: int):
    cfg, cap = run.config, run.traffic["caption"]
    n, T = cfg["n_cap"], cfg["c_len"]
    img_q, scales = common.features(gen, B, cfg["num_objs"], cfg["v_dim"])
    ids = common.answer_ids(gen, B, cfg["ans_dim"])
    q = common.questions(gen, B, cfg["q_len"], cfg["ntoken"])
    c, cap_len = common.captions(gen, B * n, T, cfg["ntoken"],
                                 cap["shortest"], cap["longest"])
    return {"img": img_q.float() * scales[..., None], "q": q,
            "a": common.soft_scores(ids, cfg["ans_dim"]),
            "c_all": c.view(B, n, T), "cap_len_all": cap_len.view(B, n)}


def chosen(c_all: torch.Tensor, c_sel: torch.Tensor) -> torch.Tensor:
    """The candidate [B] whose tokens are the chosen caption's (the first
    such one)."""
    return (c_all == c_sel[:, None, :]).all(dim=-1).int().argmax(dim=1)


def setup(run):
    with run.phase("import"):
        from vqa_tpu_torch.training import select
        from vqa_tpu_torch.training.optim import make_optimizer
        from vqa_tpu_torch.training.state import TrainState

    cfg, tr, dev = run.config, run.traffic, run.device
    select.reset_rows()
    model, weights = common.build_model(run, torch.float32)
    with run.phase("gains"):
        for name, gain in cfg["weight_gain"].items():
            weights[name].mul_(gain)
        model.load_state_dict(weights, strict=True)
    gen = common.generator(dev, run.seed, common.INPUTS)
    with run.phase("stage"):
        batches = [stage(run, gen, tr["batch"]) for _ in range(tr["batches"])]
    with run.phase("optimizer"):
        opt = make_optimizer(model, lr=cfg["lr"], max_norm=cfg["max_norm"])
        run_seed = common.sub_seed(run.seed, common.TRAIN)
        ts = TrainState(model, opt, seed=run_seed)
        step = select.make_train_select_step(
            model, opt, compute_dtype=getattr(torch, cfg["train_dtype"]))
    state = {"model": model, "opt": opt, "ts": ts, "step": step,
             "weights": weights, "batches": batches, "run_seed": run_seed}
    losses, picks = [], []
    names = dict((id(p), n) for n, p in model.named_parameters())
    hook = model.generator.register_forward_pre_hook(
        lambda mod, args: picks.append(args[0]["c_target"]))
    try:
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
    finally:
        hook.remove()
    state["chosen"] = [chosen(batches[s]["c_all"], c)
                       for s, c in enumerate(picks)]
    with run.phase("warmup"):
        for s in range(WARMUP_STEPS):
            step(ts, batches[(tr["checked_steps"] + s) % len(batches)])
    return state


def _selection(pers, ref_sels, sels):
    """(the share of the questions whose chosen candidate is the
    reference's; the widest gap between the reference's loss of the chosen
    candidate and its lowest, over its median candidate loss), over the
    checked steps (the rows both hold)."""
    agree, gap, n = 0, 0.0, 0
    for per, ref, got in zip(pers, ref_sels, sels):
        rows = min(len(ref), len(got))
        per, ref, got = per[:rows], ref[:rows], got[:rows].to(ref.device)
        agree += int((ref == got).sum())
        n += rows
        lost = per.gather(1, got[:, None])[:, 0] - per.min(dim=1).values
        gap = max(gap, float(lost.max() / per.median()))
    return agree / n, gap


def readings(run, state, prec: Precision, fault=None):
    """The compared numbers of the program's first steps against the
    reference's, or, with another ``prec`` or a ``fault``
    (:func:`vqabench.reference.qrel.run_steps`), of the reference so made
    against the sound reference: ``loss_gap``, ``grad_gap``,
    ``update_gap``, ``grad_diff`` and ``grad_diff_median`` as
    :func:`vqabench.drivers.train.readings` defines them, ``select_gap``
    and the note ``select_agree`` (:func:`_selection`; two candidates
    within round-off may swap, which moves the agreement but hardly the
    gap)."""
    tr = run.traffic
    cfg = dict(run.config)
    args = (state["weights"], state["batches"], state["run_seed"],
            tr["checked_steps"], cfg, Precision("f32"), tr["reference_rows"],
            getattr(torch, cfg["train_dtype"]))
    if "reference" not in state:
        state["reference"] = qrel.run_steps(*args)
    losses, first, after, pers, ref_sels = state["reference"]
    ref_first = {k: float(g.norm()) for k, g in first.items()}
    ref_move = {k: float((after[k] - state["weights"][k].float()).norm())
                for k in after}
    if prec.name == "f32" and fault is None:
        p_losses, p_grads, p_after, sels = (
            state["losses"], state["first_grad"], state["after"],
            state["chosen"])
    else:
        p_losses, p_grads, p_after, _, sels = qrel.run_steps(
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
    agree, gap = _selection(pers, ref_sels, sels)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": move_gap,
            "grad_diff": diffs[diff_leaf],
            "grad_diff_median": statistics.median(diffs.values()),
            "select_agree": agree, "select_gap": gap,
            "grad_leaf": grad_leaf, "update_leaf": move_leaf,
            "diff_leaf": diff_leaf,
            "left_out": sorted(set(ref_first) - set(leaves)),
            "leaves": {k: [ref_first[k], ref_move[k], p_move[k], p_diff[k]]
                       for k in first}}


def check(run, state):
    from vqa_tpu_torch.training.select import ROWS

    r = readings(run, state, Precision("f32"))
    limits = run.traffic["limits"]
    compared = [(k, r[k], limits[k]) for k in COMPARED if k in limits]
    notes = {k: r[k] for k in ("loss_gap", "select_agree",
                               "grad_leaf", "update_leaf", "diff_leaf")}
    notes["window_loss"] = state["window_loss"]
    notes["rows"] = dict(ROWS)
    return compared, notes
