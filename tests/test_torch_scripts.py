"""The port's path benchmarks (``vqa_tpu_torch/scripts``) on the CPU at tiny
dims: the timing helpers, each script's rows in the JAX script's format
with each row's launch report,
finite training losses, the modes left out, and ``bench_feed``'s JSON
against the root ``scripts/bench_feed.py`` at the same arguments.
"""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from vqa_tpu_torch.ops.kernels import _build
from vqa_tpu_torch.scripts import _bench_util, bench_beam, bench_feed, bench_regat, bench_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(NTOKEN=64, EMBED=12, HIDDEN=16, VDIM=32, NOBJ=6, QLEN=5)
BF16 = torch.bfloat16


def shrink(monkeypatch, module, **extra):
    monkeypatch.setattr(module, "DEVICE", "cpu")
    for name, value in {**TINY, **extra}.items():
        assert hasattr(module, name), name
        monkeypatch.setattr(module, name, value)


def rows(out: str, unit: str):
    """The names of the stdout rows in a JAX script's row format
    (``f"{name:44s} {ms:8.1f} ms   ({rate:,.0f} unit)"``)."""
    pattern = re.compile(r"^(.+?) +(\d+\.\d) ms(/step)?   \(([\d,]+) " + re.escape(unit) + r"\)$")
    lines = [ln for ln in out.splitlines() if ln and not ln.startswith("device:")]
    matches = [pattern.match(ln) for ln in lines]
    assert lines and all(matches), out
    for ln, m in zip(lines, matches):
        assert ln.startswith(f"{m.group(1):44s} {float(m.group(2)):8.1f} ms"), ln
    return [m.group(1) for m in matches]


def test_timed_and_chained_ms_on_cpu_tensors():
    calls = []

    def step(c, inc):
        calls.append(1)
        return c + inc

    carry, inc = torch.zeros(4), torch.ones(4)
    ms = _bench_util.chained_ms(step, carry, (inc,), reps=5, warmup=1, iters=2)
    assert ms > 0 and len(calls) == 3 * 5
    fetched = []
    s = _bench_util.timed(lambda x: fetched.append(x) or x * 2, torch.ones(2),
                          warmup=1, iters=3)
    assert s > 0 and len(fetched) == 4


def launch_lines(err: str):
    """The rows' stderr ``launches`` lines: (row name, its launches)."""
    reports = [json.loads(ln.split(" ", 1)[1]) for ln in err.splitlines()
               if ln.startswith("launches {")]
    return [(r["row"], r["launches"]) for r in reports]


def test_report_launches_gives_the_change_since_the_copy(monkeypatch, capsys):
    counts = dict.fromkeys(_build.LAUNCHES, 3)
    monkeypatch.setattr(_build, "LAUNCHES", counts)
    before = _bench_util.launch_counts()
    counts["vocab_topk_lse"] += 2
    counts["int8_matmul_dequant"] += 1
    assert before["vocab_topk_lse"] == 3
    _bench_util.report_launches("B=8 row", before)
    [(row, launches)] = launch_lines(capsys.readouterr().err)
    assert row == "B=8 row" and set(launches) == set(counts)
    assert {k: n for k, n in launches.items() if n} == {
        "vocab_topk_lse": 2, "int8_matmul_dequant": 1}


def test_bench_beam_rows_and_modes_left_out(monkeypatch, capsys):
    shrink(monkeypatch, bench_beam, C_LEN=6, BATCH=8, WARMUP=1, ITERS=1)
    assert bench_beam.main(["fused"]) == 0
    out = capsys.readouterr()
    names = ["B=8 bfloat16 plain-vocab S=1", "B=8 bfloat16 fused-vocab S=1"]
    assert rows(out.out, "captions/s") == names
    # on the CPU the wrappers run their plain versions: each row, no launch
    assert [(row, any(n.values())) for row, n in launch_lines(out.err)] == [
        (name, False) for name in names]
    for mode in ("approx", "streams"):
        assert bench_beam.main([mode]) == 2
        out = capsys.readouterr()
        assert out.out == "" and "not ported" in out.err


def test_bench_regat_default_and_full_rows(monkeypatch, capsys):
    shrink(monkeypatch, bench_regat, ANS=16, REPS=2, BATCH=8, FULL_BATCHES=(4, 8))
    assert bench_regat.main([]) == 0
    out = capsys.readouterr()
    names = ["B=8 bfloat16 chained", "B=8 bfloat16 +int8 chained"]
    assert rows(out.out, "q/s") == names
    assert [(row, any(n.values())) for row, n in launch_lines(out.err)] == [
        (name, False) for name in names]
    assert bench_regat.main(["full"]) == 0
    assert rows(capsys.readouterr().out, "q/s") == [
        "B=4 float32 per-call", "B=4 bfloat16 per-call", "B=8 bfloat16 per-call",
        "B=8 bfloat16 chained", "B=8 bfloat16 chained", "B=8 bfloat16 +int8 chained"]


def test_bench_train_vqa_rows(monkeypatch, capsys):
    shrink(monkeypatch, bench_train, ANS=16, WARMUP=0, ITERS=1, REPS=2)
    assert bench_train.main(["vqa"]) == 0
    out = capsys.readouterr()
    names = ["Up-Down VQA, B=512, bf16 mixed (train default)", "Up-Down VQA, B=4096, bf16 mixed"]
    assert rows(out.out, "q/s") == names
    assert [row for row, _ in launch_lines(out.err)] == names
    assert bench_train.main(["bogus"]) == 2


@pytest.mark.parametrize("kw", [
    dict(caption=True, fused_cap=False),                          # the r2 layout
    dict(caption=True, clen=12, feed="int8", pallas_att=True),   # pa
    dict(caption=True, clen=9),                                  # a c=9 bucket
    dict(encoder="relation"),                                    # regat
    dict(feed="int8"),                                           # vqa-int8
], ids=["mtl-stacked", "pa-int8", "mtl-c9", "regat", "vqa-int8"])
def test_bench_train_rows_have_finite_losses(monkeypatch, capsys, kw):
    shrink(monkeypatch, bench_train, ANS=16, WARMUP=0, ITERS=1, REPS=2)
    ms, losses = bench_train.run("row", compute_dtype=BF16, B=16, **kw)
    assert ms > 0 and losses.shape == (2,) and bool(torch.isfinite(losses).all())
    assert rows(capsys.readouterr().out, "q/s") == ["row"]


def test_bench_train_names_the_rows_it_leaves_out(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(bench_train, "DEVICE", "cpu")
    monkeypatch.setitem(bench_train.MODES, "vjp", lambda: ran.append("vjp"))
    assert bench_train.main(["vjp"]) == 0
    assert ran == ["vjp"]
    assert "nn.scan+remat (stock)" in capsys.readouterr().err


def load_root_bench_feed():
    spec = importlib.util.spec_from_file_location(
        "root_bench_feed", os.path.join(REPO, "scripts", "bench_feed.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def json_lines(out: str):
    """The one-line cell objects, then the indented best-per-feed object."""
    head, _, tail = out.partition('{\n  "best_per_feed"')
    cells = [json.loads(ln) for ln in head.splitlines() if ln.startswith("{")]
    return cells, json.loads('{\n  "best_per_feed"' + tail)


def test_bench_feed_json_matches_the_root_script(capsys):
    argv = ["--images", "4", "--questions", "48", "--batches", "8", "16", "--secs", "0.01"]
    assert bench_feed.main(argv) is None
    port_cells, port_best = json_lines(capsys.readouterr().out)
    root = load_root_bench_feed()
    import sys
    old = sys.argv
    sys.argv = ["bench_feed.py", *argv]
    try:
        root.main()
    finally:
        sys.argv = old
    root_cells, root_best = json_lines(capsys.readouterr().out)
    assert [sorted(c) for c in port_cells] == [sorted(c) for c in root_cells]
    assert [(c["feed"], c["batch"], c["prefetch"]) for c in port_cells] == \
        [(c["feed"], c["batch"], c["prefetch"]) for c in root_cells]
    assert len(port_cells) == 3 * 2 * 2
    assert sorted(port_best["best_per_feed"]) == sorted(root_best["best_per_feed"])
    for feed in ("int8", "f16", "f32"):
        assert bench_feed.bytes_per_question(feed) == root.bytes_per_question(feed)
    assert all(np.isfinite(c["feed_GBps"]) and c["questions_per_s"] > 0 for c in port_cells)
