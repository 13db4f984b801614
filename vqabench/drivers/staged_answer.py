"""Answering with the features already on the card.

Traffic parameters: ``batch`` (questions a forward), ``chain`` (forwards a
call, each one's answers perturbing the next one's question words, so no
forward can be skipped or reordered), ``batches`` (distinct batches staged
from the seed, taken in turn), ``reference_rows``, and the name of the
rate metric it reports (``rate_metric``). The reference judges every
answer of one call of the window, drawn from the seed.

Set-up builds the program's model in the serving dtype with the
benchmark's weights, stages the batches (questions with their padding,
the int8 payload and its scales) and runs one call on each. The window
issues calls back to back, at most two in flight, until ``--seconds``
have passed, and waits for the last; the rate is every question answered
over the whole window. Each forward goes through the program's
``make_infer_step`` (``VQAModel.forward`` in eval mode).
"""

from __future__ import annotations

import numpy as np
import torch

from vqabench import common
from vqabench.reference import updown
from vqabench.reference.precision import Precision

CHECKED_CALLS = 1      # window calls whose every answer the reference judges


def setup(run):
    with run.phase("import"):
        from vqa_tpu_torch.training.state import make_infer_step

    cfg, tr, dev = run.config, run.traffic, run.device
    dtype = getattr(torch, cfg["serve_dtype"])
    model, weights = common.build_model(run, dtype)
    gen = common.generator(dev, run.seed, common.INPUTS)
    B = tr["batch"]
    batches = []
    with run.phase("stage"):
        for _ in range(tr["batches"]):
            q = common.questions(gen, B, cfg["q_len"], cfg["ntoken"])
            img_q, scales = common.features(gen, B, cfg["num_objs"],
                                            cfg["v_dim"])
            batches.append({"q": q, "img_q": img_q,
                            "img_scale": scales.to(dtype)})
    state = {"model": model, "infer": make_infer_step(model),
             "weights": weights, "batches": batches, "calls": []}
    with run.phase("warmup"):
        for i in range(len(batches)):
            call(run, state, i).cpu()
    state["calls"].clear()
    return state


def call(run, state, which: int) -> torch.Tensor:
    """One call: ``chain`` forwards on staged batch ``which``; returns its
    answers [chain, B] and keeps them for the check."""
    batch = state["batches"][which]
    ntoken = run.config["ntoken"]
    q = batch["q"]
    words = q < ntoken
    out = torch.empty((run.traffic["chain"], q.shape[0]), dtype=torch.int64,
                      device=q.device)
    ids = torch.zeros_like(out[0])
    for i in range(run.traffic["chain"]):
        qi = torch.where(words, (q + ids[:, None]) % ntoken, q)
        logits = state["infer"](dict(batch, q=qi))
        ids = torch.argmax(logits, dim=1, out=out[i])
    state["calls"].append((which, out))
    return out


def window(run, state):
    nb, B, chain = len(state["batches"]), run.traffic["batch"], run.traffic["chain"]

    def one():
        with run.span("vqabench.call"):
            call(run, state, len(state["calls"]) % nb)

    n, elapsed, quarters = common.back_to_back(run, one)
    work = n * chain * B
    return {"metrics": {run.traffic["rate_metric"]: work / elapsed},
            "work": work, "steps": n * chain, "elapsed_s": elapsed,
            "quarter_rates": [q * chain * B * 4 / elapsed for q in quarters]}


def release(run, state):
    for k in ("model", "infer"):
        state.pop(k, None)


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
            ids = torch.zeros_like(out[0, lo:hi])
            with torch.no_grad():
                for i in range(out.shape[0]):
                    qi = torch.where(words, (q + ids[:, None]) % ntoken, q)
                    b = dict(sub, q=qi)
                    logits = updown.answer(P, b, ref)
                    given = out[i, lo:hi]
                    if prec.name != "f32":
                        given = updown.answer(P, b, prec).argmax(dim=1)
                    gap, best = common.answer_gap(logits, given)
                    worst = max(worst, gap)
                    bests.append(best)
                    n += hi - lo
                    ids = out[i, lo:hi]
    med = float(np.median(bests))
    return worst / med, n


def check(run, state):
    gap, n = judge(run, state, Precision("f32"))
    return [("answer_gap", gap, run.traffic["limits"]["answer_gap"])], \
        {"answers_checked": n}
