"""The readers of the program's spans (source ``program_span``): the
span's total over the window's steps, nothing where the span is absent,
the program lacks the spans or the run has no trace; and a traced tiny
training run on the CPU that reads the step's phases."""

from __future__ import annotations

import sys
import types

import pytest

from vqabench import manifest
from vqabench.tests.conftest import run_tiny

BENCH = manifest.load()
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]
# each reader's spans and the total it reads
READS = {
    "step_host_ms.cast": ("host_ms", ["vqa.step.cast"]),
    "step_host_ms.forward": ("host_ms", ["vqa.step.forward"]),
    "step_host_ms.backward": ("host_ms", ["vqa.step.backward"]),
    "step_host_ms.optimizer": ("host_ms", ["vqa.step.optimizer"]),
    "step_host_ms.decode_scan": ("host_ms", ["vqa.decode_scan.forward",
                                             "vqa.decode_scan.backward"]),
    "forward_stream_ms.question": ("stream_ms", ["vqa.encoder.question"]),
    "forward_stream_ms.attention": ("stream_ms", ["vqa.encoder.attention"]),
    "forward_stream_ms.pool": ("stream_ms", ["vqa.encoder.pool"]),
    "forward_stream_ms.predictor": ("stream_ms", ["vqa.predictor"]),
}


class Readings:
    def __init__(self, steps: int, trace=object()):
        self.trace = trace
        self.measurement = {"steps": steps, "work": steps, "elapsed_s": 1.0}


def with_totals(monkeypatch, totals):
    import vqa_tpu_torch.tracing as tracing

    monkeypatch.setattr(tracing, "totals", lambda: totals)


def test_every_span_metric_has_its_reads():
    assert {m["name"] for m in SPAN_METRICS} == set(READS)


@pytest.mark.parametrize("name", sorted(READS))
def test_a_reader_divides_its_spans_by_the_steps(name, monkeypatch):
    key, spans = READS[name]
    totals = {n: {"count": 8, "host_ms": 10.0 * (i + 1), "stream_ms": None}
              for i, n in enumerate(spans)}
    if key == "stream_ms":
        for i, n in enumerate(spans):
            totals[n]["stream_ms"] = 6.0 * (i + 1)
    totals["vqa.step"] = {"count": 8, "host_ms": 999.0, "stream_ms": 99.0}
    with_totals(monkeypatch, totals)
    want = sum(totals[n][key] for n in spans) / 4
    assert manifest.reader(name)(Readings(4)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READS))
def test_a_reader_reads_nothing_without_its_span(name, monkeypatch):
    key, spans = READS[name]
    other = {"vqa.step": {"count": 1, "host_ms": 5.0, "stream_ms": 5.0}}
    with_totals(monkeypatch, other)
    assert manifest.reader(name)(Readings(4)) is None
    # a span timed on the host alone has no stream total
    with_totals(monkeypatch, {n: {"count": 1, "host_ms": 5.0,
                                  "stream_ms": None} for n in spans})
    if key == "stream_ms":
        assert manifest.reader(name)(Readings(4)) is None
    # no trace, or no step
    assert manifest.reader(name)(Readings(4, trace=None)) is None
    assert manifest.reader(name)(Readings(0)) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_a_program_without_the_spans_reads_nothing(name, monkeypatch):
    """The parent of the spans has no ``vqa_tpu_torch.tracing``."""
    monkeypatch.setitem(sys.modules, "vqa_tpu_torch.tracing", None)
    assert manifest.reader(name)(Readings(4)) is None
    monkeypatch.setitem(sys.modules, "vqa_tpu_torch.tracing",
                        types.ModuleType("vqa_tpu_torch.tracing"))
    assert manifest.reader(name)(Readings(4)) is None


def test_a_traced_cpu_training_run_reads_the_step_phases(cpu_threads):
    from vqa_tpu_torch import tracing

    tracing.reset()
    result = run_tiny("updown-train", trace=True)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    phases = [f"step_host_ms.{k}" for k in
              ("cast", "forward", "backward", "optimizer")]
    assert all(got[m] > 0 for m in phases)
    assert "step_host_ms.decode_scan" not in got
    totals = tracing.totals()
    steps = totals["vqa.step"]["count"]
    assert sum(got[m] for m in phases) * steps <= totals["vqa.step"]["host_ms"]
    tracing.reset()
