"""ReGAT's yardstick and readers (``regat-answer-staged``): the
``gcn_chain`` bound at the cell's batch against ``chip_smoke.py``'s count
of the same call, the model FLOPs of one answer against a hand count of
the folded products, and the graph spans' readers."""

from __future__ import annotations

import sys

import pytest
import torch

from vqabench import graph_roofline, manifest, roofline

ROOT = str(manifest.ROOT)
CFG = manifest.config(manifest.load(), "regat-spatial")
B = manifest.traffic("staged-regat-b8192")["batch"]


def test_the_chain_bound_is_chip_smokes():
    """``chip_smoke.py`` phase 11: the bytes of the chain's operands and
    output, its products, bf16; its bound is in ms."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    N, D = CFG["num_objs"], CFG["v_dim"]
    meta = dict(device="meta")
    chain = (torch.empty(B, N, D, dtype=torch.bfloat16, **meta),
             torch.empty(B, N, D, dtype=torch.bfloat16, **meta),
             torch.empty(B, N, N, dtype=torch.bfloat16, **meta),
             torch.empty(B, N, N, dtype=torch.int32, **meta),
             torch.empty(12, D, dtype=torch.bfloat16, **meta))
    out = torch.empty(B, N, D, dtype=torch.bfloat16, **meta)
    ops = 2.0 * B * N * (N * (2 * D + N) + 12 * D)
    want_ms, what, _ = smoke.bound(smoke.nbytes(*chain, out), ops, "bf16")
    least, kind = graph_roofline.gcn_chain(B, N, D, CFG["num_labels"])
    assert least * 1e3 == pytest.approx(want_ms, rel=1e-12)
    assert kind == what == "bytes"


def test_answer_flops_count_the_folded_products():
    N, D = 36, 2048
    graph = 2 * (3 * N * D * D       # w_self, w0 + w1, f C
                 + N * D * N         # the correlation
                 + N * N * N         # adj @ ReLU(alpha)
                 + 2 * N * N * D     # adj @ proj, alpha @ o
                 + N * 12 * D)       # label counts @ label_bias
    assert graph_roofline.graph_flops(CFG) == graph
    assert graph_roofline.answer_flops(CFG) == roofline.answer_flops(CFG) + graph
    assert 0.78 < graph / graph_roofline.answer_flops(CFG) < 0.79


class Readings:
    def __init__(self, steps: int, trace=object()):
        self.trace = trace
        self.measurement = {"steps": steps, "work": steps, "elapsed_s": 1.0}


READS = {"forward_stream_ms.graph": "vqa.encoder.graph",
         "forward_stream_ms.gcn_project": "vqa.gcn.project",
         "forward_stream_ms.gcn_chain": "vqa.gcn.chain"}


@pytest.mark.parametrize("name", sorted(READS))
def test_a_graph_span_reader_divides_its_span_by_the_forwards(name,
                                                              monkeypatch):
    import vqa_tpu_torch.tracing as tracing

    totals = {n: {"count": 8, "host_ms": 50.0, "stream_ms": 6.0 * (i + 1)}
              for i, n in enumerate(sorted(READS.values()))}
    monkeypatch.setattr(tracing, "totals", lambda: totals)
    assert manifest.reader(name)(Readings(4)) == pytest.approx(
        totals[READS[name]]["stream_ms"] / 4)
    monkeypatch.setattr(tracing, "totals", lambda: {})
    assert manifest.reader(name)(Readings(4)) is None
