"""Shared set-up of the benchmark's own tests: each cell at tiny sizes on
the CPU (the program's kernels run their plain versions there).

Run from the repository root: ``python -m pytest vqabench/tests -q``.
Tests that need a card are marked ``chip`` and skip without one, deciding
inside the test.
"""

from __future__ import annotations

import copy

import pytest
import torch

from vqabench import manifest

TINY_CONFIG = dict(ntoken=50, embed_dim=12, hidden_dim=32,
                   decoder_hidden_dim=32, v_dim=32, num_objs=6, q_len=5,
                   c_len=6, ans_dim=20)
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def tiny(cell_name: str, bench=None):
    """(bench, cell, config, traffic) of a cell cut to CPU test sizes."""
    bench = bench or manifest.load()
    cell = manifest.cell(bench, cell_name)
    cfg = copy.deepcopy(manifest.config(bench, cell["config"]))
    cfg.update({k: v for k, v in TINY_CONFIG.items()
                if k in cfg or k in ("decoder_hidden_dim", "c_len")})
    tr = copy.deepcopy(manifest.traffic(cell["traffic"]))
    tr.update(batch=16, reference_rows=8)
    if tr.get("caption"):
        tr["caption"] = {"shortest": 2, "longest": 6}
    if "chain" in tr:
        tr["chain"] = 3
    return bench, cell, cfg, tr


def run_tiny(cell_name: str, trace: bool = False, seed: int = 12345678901,
             seconds: float = 0.3):
    from vqabench.run import run_cell

    bench, cell, cfg, tr = tiny(cell_name)
    return run_cell(bench, cell, cfg, tr, seed, seconds, trace,
                    torch.device("cpu"))


@pytest.fixture
def cpu_threads():
    """Few threads, so that the tests stay cheap beside other work."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
