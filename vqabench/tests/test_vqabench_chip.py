"""On the card: each cell through the command, a short window, untraced
and traced (``python -m pytest vqabench/tests -m chip``, a few minutes)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from vqabench import manifest
from vqabench.tests.conftest import CELLS


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "vqabench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 1234567), "--seconds", "3",
         "--trace", str(trace)],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert proc.stderr.strip().splitlines()[-1].startswith("compared ")
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
