"""GCN-LSTM's training steps (the relation encoder under the BUTD caption
loss) on batches staged on the card, with their spatial graphs.

Traffic parameters: those of :mod:`vqabench.drivers.train`, and
``image`` and ``box_side``, from which each image's boxes are drawn as
:mod:`vqabench.drivers.staged_regat` draws them.

A batch holds what :func:`vqabench.drivers.train.stage` stages for a
caption model but the answers, which no head of this model reads: the
question, the int8 payload and its scales, the caption and its length;
and the spatial graph [B, boxes, boxes] int32 of the reference's label
rule (:func:`vqabench.reference.regat.spatial_labels`). Set-up is
``train.setup``'s with the relation model built as ``staged_regat`` builds
it (the configuration's relation keys passed on), and with a zero first
gradient for the leaves that no loss reaches (the question's ``q_net``,
which the optimizer skips). The window is ``train.window``'s, with
``gcn.ROUTES`` counted over it; the check is ``train.check``'s against
:func:`vqabench.reference.gcn_lstm.run_steps`.
"""

from __future__ import annotations

import contextlib

import torch

from vqabench import common
from vqabench.drivers import staged_regat, train
from vqabench.reference import gcn_lstm, regat
from vqabench.reference.precision import Precision

COMPARED = train.COMPARED
release = train.release


def stage(run, gen, B: int):
    cfg, tr = run.config, run.traffic
    N, cap = cfg["num_objs"], tr["caption"]
    img_q, scales = common.features(gen, B, N, cfg["v_dim"])
    batch = {"q": common.questions(gen, B, cfg["q_len"], cfg["ntoken"]),
             "img_q": img_q, "img_scale": scales}
    batch["c"], batch["cap_len"] = common.captions(
        gen, B, cfg["c_len"], cfg["ntoken"], cap["shortest"], cap["longest"])
    batch["graph"] = regat.spatial_labels(
        staged_regat.boxes(gen, B, N, tr["image"], tr["box_side"]),
        *tr["image"]).to(torch.int32)
    return batch


def setup(run):
    with run.phase("import"):
        from vqa_tpu_torch.training.optim import make_optimizer
        from vqa_tpu_torch.training.state import TrainState, make_train_step

    cfg, tr, dev = run.config, run.traffic, run.device
    model, weights = staged_regat.build_model(run, torch.float32)
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
                    names[id(p)]: (opt.adamax.state[p]["exp_avg"] / (1 - b1)
                                   if p in opt.adamax.state
                                   else torch.zeros_like(p))
                    for g in opt.adamax.param_groups for p in g["params"]}
        state["losses"] = [float(x) for x in losses]
        state["after"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
    with run.phase("warmup"):
        for s in range(train.WARMUP_STEPS):
            step(ts, batches[(tr["checked_steps"] + s) % len(batches)])
    return state


def window(run, state):
    """``train.window``; ``state["routes"]``: its steps and the correlated
    conv's calls by route over them (None where the program has no
    counter)."""
    from vqa_tpu_torch.ops import gcn

    routes = getattr(gcn, "ROUTES", None)
    before = dict(routes or {})
    out = train.window(run, state)
    state["routes"] = ({"steps": out["steps"],
                        **{k: v - before[k] for k, v in routes.items()}}
                       if routes is not None else None)
    return out


@contextlib.contextmanager
def _reference():
    """``train.readings`` and ``train.check`` with this cell's reference in
    place of :mod:`vqabench.reference.train` (the same ``run_steps``
    signature)."""
    saved = train.ref_train
    train.ref_train = gcn_lstm
    try:
        yield
    finally:
        train.ref_train = saved


def readings(run, state, prec: Precision, fault=None):
    """``train.readings``' numbers against
    :func:`vqabench.reference.gcn_lstm.run_steps`, or, with another
    ``prec`` or a ``fault`` (``"half"`` or one of
    :data:`vqabench.reference.gcn_lstm.FAULTS`), of the reference so made
    against the sound reference."""
    with _reference():
        return train.readings(run, state, prec, fault)


def check(run, state):
    with _reference():
        compared, notes = train.check(run, state)
    notes["gcn_routes"] = state["routes"]
    return compared, notes
