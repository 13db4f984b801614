"""Each cell at tiny sizes on the CPU: the result object is well formed,
untraced and traced; the command refuses to run without a card, and in a
directory that holds the benchmark alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from vqabench import manifest
from vqabench.tests.conftest import CELLS, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_prints_a_well_formed_result(cell, cpu_threads):
    result = run_tiny(cell)
    assert list(result)[:5] == KEYS and list(result)[-1] == "compared"
    json.dumps(result)
    bench = manifest.load()
    want = {m["name"] for m in bench["end_to_end"] if manifest.applies(m, cell)}
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert result["correct"] is True and result["attempted"] > 0
    assert result["compared"]
    for c in result["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS[:1] + CELLS[2:3])
def test_a_traced_cpu_run_reports_no_device_metric(cell, cpu_threads):
    """The CPU has no device trace: the readers report nothing rather than
    a number under a device metric's name."""
    result = run_tiny(cell, trace=True)
    device_metrics = {m["name"] for m in manifest.load()["per_layer"]
                      if m["source"] == "device_trace"}
    assert not set(result["metrics"]) & device_metrics
    assert result["device"]["busy_s"] == 0.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "vqabench.run", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 17), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _command(manifest.ROOT)
    assert proc.returncode == 2 and proc.stdout == ""


def test_the_benchmark_alone_cannot_run(tmp_path):
    """In a directory with BENCHMARK.json and vqabench/ only, the program
    is missing: the command fails and prints no result."""
    shutil.copytree(manifest.HERE, tmp_path / "vqabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = _command(tmp_path, env)
    assert proc.returncode != 0 and proc.stdout == ""
