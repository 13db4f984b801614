"""Answering with ReGAT's spatial model (CONFIGS.md config 5), the features
and the spatial graphs already on the card.

Traffic parameters: those of :mod:`vqabench.drivers.staged_answer`, and
``image`` ([width, height] in pixels) and ``box_side`` ([least, most], a
box's width and height as shares of the image's), from which each
image's boxes are drawn.

Set-up builds the relation model with ``set_model``, passing the
configuration's relation keys too (``set_model``'s own default is two
graph convolutions, config 5 has one), in the serving dtype with the
benchmark's weights, and stages the batches: questions, the int8 payload
and its scales, as ``staged_answer`` stages them, and the spatial graphs
[B, boxes, boxes] int32. An image's boxes have centres uniform over the
image and sides log-uniform over ``box_side``, clipped to the image; the
labels are the reference's rule (:func:`vqabench.reference.regat.spatial_labels`).
The window, the calls and the check are ``staged_answer``'s, with ReGAT's
reference judging the answers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vqabench import common
from vqabench.drivers.staged_answer import CHECKED_CALLS, call, release, window
from vqabench.reference import regat
from vqabench.reference.precision import Precision

__all__ = ["setup", "window", "release", "judge", "check", "build_model",
           "boxes"]

# set_model's keyword arguments of the relation encoder
RELATION_ARGS = ("conv_layer", "conv_type", "use_spa", "use_imp", "use_sem")


def build_model(run, dtype: torch.dtype):
    """The program's relation model for the run's configuration, in
    ``dtype``, with the benchmark's weights loaded; returns (model,
    weights)."""
    cfg, device = run.config, run.device
    from vqa_tpu_torch.models.wrapper import set_model

    keys = common.MODEL_ARGS + RELATION_ARGS
    with run.phase("set_model"):
        model = set_model(**{k: cfg[k] for k in keys if k in cfg},
                          generator=torch.Generator().manual_seed(0),
                          device=device).to(dtype)
    with run.phase("weights"):
        shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
        weights = common.make_weights(shapes, run.seed, device, dtype)
        model.load_state_dict(weights, strict=True)
    return model, weights


def boxes(gen: torch.Generator, rows: int, objs: int, image, side):
    """Boxes [rows, objs, 4] (x0, y0, x1, y1) in float64 pixels: centres
    uniform over the image, width and height log-uniform between
    ``side[0]`` and ``side[1]`` of the image's, clipped to the image."""
    w, h = image
    u = torch.rand((rows, objs, 4), generator=gen, device=gen.device,
                   dtype=torch.float64)
    lo, hi = math.log(side[0]), math.log(side[1])
    cx, cy = u[..., 0] * w, u[..., 1] * h
    bw = torch.exp(lo + (hi - lo) * u[..., 2]) * w
    bh = torch.exp(lo + (hi - lo) * u[..., 3]) * h
    return torch.stack([(cx - bw / 2).clamp(0, w), (cy - bh / 2).clamp(0, h),
                        (cx + bw / 2).clamp(0, w), (cy + bh / 2).clamp(0, h)],
                       dim=-1)


def setup(run):
    with run.phase("import"):
        from vqa_tpu_torch.training.state import make_infer_step

    cfg, tr, dev = run.config, run.traffic, run.device
    dtype = getattr(torch, cfg["serve_dtype"])
    model, weights = build_model(run, dtype)
    gen = common.generator(dev, run.seed, common.INPUTS)
    B, N = tr["batch"], cfg["num_objs"]
    batches = []
    with run.phase("stage"):
        for _ in range(tr["batches"]):
            q = common.questions(gen, B, cfg["q_len"], cfg["ntoken"])
            img_q, scales = common.features(gen, B, N, cfg["v_dim"])
            graph = regat.spatial_labels(
                boxes(gen, B, N, tr["image"], tr["box_side"]), *tr["image"])
            batches.append({"q": q, "img_q": img_q,
                            "img_scale": scales.to(dtype),
                            "graph": graph.to(torch.int32)})
    state = {"model": model, "infer": make_infer_step(model),
             "weights": weights, "batches": batches, "calls": []}
    with run.phase("warmup"):
        for i in range(len(batches)):
            call(run, state, i).cpu()
    state["calls"].clear()
    return state


def judge(run, state, prec: Precision):
    """The widest gap over the checked calls' answers, the program's or,
    for another ``prec``, the answers that the reference in that
    precision puts first; as a share of the median best logit."""
    cfg, tr = run.config, run.traffic
    ntoken = cfg["ntoken"]
    rng = np.random.default_rng(common.sub_seed(run.seed, common.SAMPLE))
    calls = state["calls"]
    picks = sorted(rng.choice(len(calls), size=min(CHECKED_CALLS, len(calls)),
                              replace=False))
    ref = Precision("f32")
    P = {k: v.float() for k, v in state["weights"].items()}
    worst, bests, n = 0.0, [], 0
    rows = tr["reference_rows"]
    for c in picks:
        which, out = calls[c]
        batch = state["batches"][which]
        for lo in range(0, out.shape[1], rows):
            hi = min(out.shape[1], lo + rows)
            sub = {k: v[lo:hi] for k, v in batch.items()}
            q, words = sub["q"], sub["q"] < ntoken
            with torch.no_grad():
                for i in range(out.shape[0]):
                    ids = out[i - 1, lo:hi] if i else torch.zeros_like(q[:, 0])
                    b = dict(sub, q=torch.where(words, (q + ids[:, None])
                                                % ntoken, q))
                    logits = regat.answer(P, b, ref)
                    given = out[i, lo:hi]
                    if prec.name != "f32":
                        given = regat.answer(P, b, prec).argmax(dim=1)
                    gap, best = common.answer_gap(logits, given)
                    worst = max(worst, gap)
                    bests.append(best)
                    n += hi - lo
    return worst / float(np.median(bests)), n


def check(run, state):
    gap, n = judge(run, state, Precision("f32"))
    return [("answer_gap", gap, run.traffic["limits"]["answer_gap"])], \
        {"answers_checked": n}
