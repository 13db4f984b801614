"""The control at a size that a test run holds: the reference computed in
float8 in the program's place must fail one of the cell's numbers, where
the program passes them, and so must each planted fault that the control
module reads. (On the card, at the cells' own sizes:
``python3 -m vqabench.control``; its readings set the limits, PERF.md.)"""

from __future__ import annotations

import pytest
import torch

from vqabench import control
from vqabench.tests.conftest import CELLS, tiny


def _fails(readings, limits):
    return any(readings[k] > limit for k, limit in limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell, cpu_threads):
    bench, c, cfg, tr = tiny(cell)
    if tr["driver"] != "train":
        # enough answers for near ties, where float8 picks another answer
        cfg.update(ans_dim=1000, hidden_dim=64, v_dim=64)
        tr.update(batch=512, reference_rows=512)
    out = control.readings(bench, c, cfg, tr, 777, 0.2, torch.device("cpu"))
    assert not _fails(out["program"], tr["limits"])
    assert _fails(out["control"], tr["limits"])
    for fault in ("half_batch", *control.ZEROED_KERNELS):
        if fault in out:
            assert _fails(out[fault], tr["limits"]), fault
