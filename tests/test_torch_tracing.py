"""The port's spans (``vqa_tpu_torch/tracing.py``): nothing while no
profiler runs; under ``torch.profiler`` each phase of a training step, the
caption scan and each module of the forward in the trace and in the
totals; the CLI's ``--profile_dir`` trace with the step's and the feed's
spans."""

import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqa_tpu_torch import tracing
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader
from vqa_tpu_torch.data.synthetic import make_synthetic_root
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.training import train as port_train
from vqa_tpu_torch.training.logging import Logger
from vqa_tpu_torch.training.optim import make_optimizer
from vqa_tpu_torch.training.state import (
    TrainState, make_infer_step, make_train_step)

B, Q_LEN, NTOKEN, V_DIM, OBJS, ANS, C_LEN = 4, 5, 30, 16, 4, 7, 6
PHASES = ("vqa.step.cast", "vqa.step.forward", "vqa.step.backward",
          "vqa.step.optimizer")
SCAN = ("vqa.decode_scan.forward", "vqa.decode_scan.backward")
MODULES = ("vqa.encoder.question", "vqa.encoder.attention",
           "vqa.encoder.pool", "vqa.predictor")


def model_of(kind: str):
    """A tiny Up-Down (VQA head alone) or VQA-E MTL (BUTD decoder, the
    custom-backward scan) model on the CPU."""
    decoder = "butd" if kind == "mtl" else "none"
    return set_model(encoder_type="base", predictor_type="base",
                     decoder_type=decoder, ntoken=NTOKEN, v_dim=V_DIM,
                     embed_dim=8, hidden_dim=16, decoder_hidden_dim=16,
                     ans_dim=ANS, c_len=C_LEN, att_type="new",
                     use_mtl=kind == "mtl", use_pallas=True,
                     generator=torch.Generator().manual_seed(3),
                     device="cpu")


def batch_of(feed: str, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, OBJS, V_DIM, generator=g)
    out = {"q": torch.randint(0, NTOKEN, (B, Q_LEN), generator=g),
           "a": torch.randint(0, 4, (B, ANS), generator=g) / 3.0,
           "c": torch.randint(0, NTOKEN - 1, (B, C_LEN), generator=g),
           "cap_len": torch.randint(2, C_LEN + 1, (B,), generator=g)}
    if feed == "dense":
        out["img"] = x
    else:
        scale = torch.clamp_min(x.abs().amax(-1) / 127.0, 1e-8)
        out["img_q"] = torch.round(x / scale[..., None]).clamp(-127, 127
                                                              ).to(torch.int8)
        out["img_scale"] = scale
    return out


def two_steps(kind: str, dtype=torch.bfloat16):
    model = model_of(kind)
    state = TrainState(model, make_optimizer(model, lr=2e-3), seed=5)
    step = make_train_step(model, state.optimizer, compute_dtype=dtype)
    for s in range(2):
        step(state, batch_of("int8", s))
    return state


def profiled(fn):
    """Run ``fn`` under torch's profiler on the CPU, the totals cleared
    first; returns (fn's result, the names of the profiler's events)."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


@pytest.fixture
def no_clock_no_range(monkeypatch):
    """The span's clock and torch's range both raise when called."""
    def boom(*args, **kwargs):
        raise AssertionError("called with no profiler running")

    tracing.reset()
    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)


@pytest.mark.parametrize("work", ["spans", "updown-step", "mtl-step",
                                  "forward"])
def test_off_without_a_profiler(no_clock_no_range, work):
    """No profiler: one shared no-op context, no range, no clock read, no
    totals, through bare spans and through the port's step and forward."""
    if work == "spans":
        a = tracing.span("vqa.step")
        b = tracing.span("vqa.forward", device=True)
        assert a is b is tracing.span("x", args=3)
        with a, b:
            pass
    elif work == "forward":
        make_infer_step(model_of("updown"))(batch_of("int8"))
    else:
        two_steps(work.split("-")[0])
    assert tracing.totals() == {}


@pytest.mark.parametrize("kind", ["updown", "mtl"])
def test_on_under_the_profiler_each_phase_counts_a_step(kind):
    _, names = profiled(lambda: two_steps(kind))
    totals = tracing.totals()
    want = ("vqa.step",) + PHASES + (SCAN if kind == "mtl" else ())
    for name in want:
        assert totals[name]["count"] == 2, name
        assert totals[name]["host_ms"] > 0, name
        assert totals[name]["stream_ms"] is None, name
        assert name in names, name
    if kind == "updown":
        assert not set(SCAN) & set(totals)
    # the four phases cover the step, and no more than it
    step = totals["vqa.step"]["host_ms"]
    phases = sum(totals[n]["host_ms"] for n in PHASES)
    assert 0.9 * step <= phases <= step
    # the scan is part of the step's forward and backward
    if kind == "mtl":
        for scan, phase in zip(SCAN, PHASES[1:3]):
            assert totals[scan]["host_ms"] <= totals[phase]["host_ms"]


@pytest.mark.parametrize("kind,feed", [("updown", "int8"), ("updown", "dense"),
                                       ("mtl", "int8")])
def test_module_spans_count_one_a_forward(kind, feed):
    model = model_of(kind)
    infer = make_infer_step(model)
    _, names = profiled(lambda: infer(batch_of(feed)))
    totals = tracing.totals()
    for name in ("vqa.forward",) + MODULES:
        assert totals[name]["count"] == 1, name
        assert name in names, name
        # the CPU has no stream to time
        assert totals[name]["stream_ms"] is None
    inner = sum(totals[n]["host_ms"] for n in MODULES)
    assert inner <= totals["vqa.forward"]["host_ms"]


def test_totals_after_the_profiler_and_reset():
    profiled(lambda: two_steps("updown", None))
    first = tracing.totals()
    with tracing.span("vqa.step"):      # the profiler has stopped
        pass
    assert tracing.totals() == first
    tracing.reset()
    assert tracing.totals() == {}


def test_threads_add_to_one_total():
    """Spans on more threads than cores, switching often: no update is
    lost (the totals take a lock)."""
    threads, each = 2 * (torch.get_num_threads() + 4), 200
    done = []

    def work():
        for _ in range(each):
            with tracing.span("vqa.feed.batch"):
                pass
        done.append(1)

    interval = sys.getswitchinterval()
    tracing.reset()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool) and len(done) == threads
    assert tracing.totals()["vqa.feed.batch"]["count"] == threads * each


def test_the_cli_profile_holds_the_step_and_the_feed(tmp_path):
    """``train(profile_dir=..., profile_steps=(1, 3))`` writes the trace of
    steps 1 and 2: the optimizer's span twice, with the feed's spans of the
    batch drawn meanwhile: its staging on the loop's thread, and its
    assembly on the Loader's producer thread (the CLI's default Loader,
    with enough batches that the producer still has work in the window)."""
    root = make_synthetic_root(str(tmp_path / "data"), num_images=4,
                               num_questions=32, v_dim=V_DIM)
    make_synthetic_root(str(tmp_path / "data"), split="val2014",
                        num_images=2, num_questions=4, v_dim=V_DIM, seed=9)
    model = set_model(encoder_type="base", predictor_type="base",
                      decoder_type="none", ntoken=root["ntoken"],
                      v_dim=root["v_dim"], embed_dim=8, hidden_dim=16,
                      ans_dim=root["ans_dim"],
                      generator=torch.Generator().manual_seed(1),
                      device="cpu")

    def loader(train: bool, **kw):
        ds = set_dataset(root["annot"], root["feature_root"], root["ans_dim"],
                         is_train=train, is_val=not train,
                         dataset_type="vqa")
        return Loader(ds, 4, **kw)

    out = tmp_path / "profile"
    port_train.train(model=model, lr=2e-3,
                     train_loader=loader(True),
                     val_loader=loader(False),
                     logger=Logger("tracing", root=str(tmp_path)),
                     save_path=str(tmp_path / "run"), num_epoches=1,
                     profile_dir=str(out), profile_steps=(1, 3))
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans = [e["name"] for e in ranges]
    assert spans.count("vqa.step.optimizer") == 2
    assert spans.count("vqa.step") == 2
    assert "vqa.feed.batch" in spans and "vqa.feed.stage" in spans
    tid = {e["name"]: e["tid"] for e in ranges}
    assert tid["vqa.feed.stage"] == tid["vqa.step"] != tid["vqa.feed.batch"]
    totals = tracing.totals()
    assert totals["vqa.step"]["count"] == 2
    assert [totals[n]["count"] for n in PHASES] == [2] * 4
