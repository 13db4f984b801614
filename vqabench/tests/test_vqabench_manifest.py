"""BENCHMARK.json against the benchmark's contract, and a cell added by
files and entries alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from vqabench import manifest

ROOT = manifest.ROOT
BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metrics_agree_with_their_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    reports = {c: {n for n, m in e2e.items() if manifest.applies(m, c)}
               for c in cells}
    per_layer = {c: set() for c in cells}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert manifest.reader_file(m["name"]).is_file()
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reports[c], (m["name"], c)
            per_layer[c].add(m["name"])
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert per_layer[c], c


def test_configurations_and_traffic_are_found_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for w in BENCH["workloads"]:
        tr = manifest.traffic(w["traffic"])
        manifest.driver(tr["driver"])
        assert tr["limits"], w["name"]
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_reduced_names_no_width():
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                        r"projection|head|expan|per_tok")
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert not any(widths.search(k) for k in c["reduced"])


def test_a_dropped_in_configuration_and_mix_make_a_new_cell(tmp_path, cpu_threads):
    """A new cell takes a configuration file, a traffic file and entries
    in BENCHMARK.json, and no edit of a file that is there."""
    from vqabench.run import run_cell
    from vqabench.tests.conftest import TINY_CONFIG

    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "vqabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "vqabench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "vqabench/configs/updown-vqa.json").read_text())
    cfg.update(TINY_CONFIG, name="updown-tiny", use_pallas=False)
    (root / "vqabench/configs/updown-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "vqabench/traffic/staged-b32768.json").read_text())
    mix.update(batch=8, chain=2, reference_rows=8)
    (root / "vqabench/traffic/staged-tiny.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "updown-tiny",
                             "source": "https://arxiv.org/abs/1707.07998",
                             "file": "vqabench/configs/updown-tiny.json",
                             "reduced": [], "why": "a test's cell"})
    bench["workloads"].append({"name": "updown-tiny-staged",
                               "config": "updown-tiny",
                               "traffic": "staged-tiny", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "answer_qps" in (m["name"], m.get("moves")):
            m["workloads"].append("updown-tiny-staged")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data

    bench = manifest.load(root)
    cell = manifest.cell(bench, "updown-tiny-staged")
    config = manifest.config(bench, cell["config"], root)
    traffic = manifest.traffic(cell["traffic"], root / "vqabench")
    result = run_cell(bench, cell, config, traffic, 99, 0.2, False,
                      torch.device("cpu"))
    assert set(result["metrics"]) == {"answer_qps", "setup_s"}
    assert result["correct"] is True
    assert result["attempted"] > 0


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_reader_returns_nothing_without_a_trace(name):
    class Nothing:
        trace = None
        peak_bytes = 0
        measurement = {"work": 0, "steps": 0, "elapsed_s": 0.0}
        config = manifest.config(BENCH, BENCH["workloads"][1]["config"])
        traffic = {"batch": 1}

    assert manifest.reader(name)(Nothing()) is None
