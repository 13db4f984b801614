"""Shared timing for the port's path benchmarks (counterpart of
``scripts/_bench_util.py``).

Two schemes:

- ``timed``: the best of ``iters`` calls, each ending in a host fetch of
  its result, on the host clock (the fetch waits for the device, so the
  time is the call's whole latency).
- ``chained_ms``: ``reps`` calls of ``step`` chained through ``carry``
  with no host synchronisation between them (each step's output is the
  next step's carry), timed by CUDA events and fetched once; it reports
  t(reps) / reps.

Both run on the device of the tensors they are given. On CPU tensors the
chain is timed on the host clock instead of CUDA events, so the tests can
call them.

Each row of a path benchmark also writes its kernel launches to stderr
(:func:`report_launches`): one line ``launches {"row": ..., "launches":
{kernel: n}}``, the change in ``_build.LAUNCHES`` over the row's warm-up
and timed calls, so a reader can hold a row's name against the kernels it
ran.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, Sequence

import torch

from vqa_tpu_torch.ops.kernels import _build

WARMUP, ITERS = 1, 3


def device_name(dev: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> "bfloat16", as the JAX scripts name dtypes."""
    return str(dtype).rsplit(".", 1)[-1]


def launch_counts() -> Dict[str, int]:
    """A copy of every kernel's launch count, to report a row against."""
    return dict(_build.LAUNCHES)


def report_launches(row: str, before: Dict[str, int]) -> None:
    """The stderr line of ``row``'s kernel launches since ``before`` (a
    :func:`launch_counts`)."""
    launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    print("launches " + json.dumps({"row": row, "launches": launches}),
          file=sys.stderr, flush=True)


def timed(fn: Callable, *args, warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Best-of-``iters`` seconds for one call of ``fn(*args)`` and the host
    fetch of its result (a tensor)."""
    for _ in range(warmup):
        fn(*args).cpu()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args).cpu()
        best = min(best, time.perf_counter() - t0)
    return best


def chained_ms(step: Callable, carry: torch.Tensor, args: Sequence = (),
               reps: int = 8, warmup: int = WARMUP, iters: int = ITERS) -> float:
    """ms per ``step`` call, the best of ``iters`` chains of ``reps``;
    ``step(carry, *args) -> carry`` (same shape).

    The fetched value is the max of the final carry, which depends on every
    chained step, so the chain must have run whole before it is read. Max
    and not sum: when the carry is a dot product, a compiler may rewrite
    sum(dot(A, B)) algebraically, and max does not distribute over dot.
    """
    def run():
        c = carry
        for _ in range(reps):
            c = step(c, *args)
        return torch.amax(c.float())

    for _ in range(warmup):
        run().item()
    cuda = carry.device.type == "cuda"
    best = float("inf")
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            stop.record()
            out.item()
            ms = start.elapsed_time(stop)
        else:
            t0 = time.perf_counter()
            run().item()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms)
    return best / reps
