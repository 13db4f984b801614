"""Named spans of the port's phases, switched on by torch's profiler.

``with span("vqa.step.forward"):`` marks a phase. While no torch profiler
runs, :func:`span` returns one shared no-op context: no
``record_function``, no clock read, no allocation. While one runs
(``torch.profiler.profile``: the CLI's ``--profile_dir``, the benchmark's
``--trace 1``), a span

- enters ``torch.profiler.record_function(name)``, so that it sits in the
  profiler's trace beside the device operations, on the same clock;
- adds its host time (``time.perf_counter_ns``) to an in-memory total of
  its name;
- with ``device=True``, where CUDA is in use, records a pair of CUDA
  events on the current stream, from a pool; they are resolved only when
  :func:`totals` is read, so nothing synchronises inside the window.

The switch is torch's process-wide flag of a running profiler
(``torch.autograd.profiler._is_profiler_enabled``), read once a span.
torch's own per-thread check (``torch.autograd._profiler_enabled()``)
reads false on a Python thread that the profiler does not trace, such as
the ``Loader``'s producer; the totals count such a thread's spans, and the
trace holds them only where the profiler traces every thread, as the
CLI's ``--profile_dir`` one does. The totals gather every thread's spans
(autograd's worker threads included) and cover what ran while a
profiler was on, since the process started or since :func:`reset`.

:func:`backward_span` times the backward of a stage of the forward: the
same span, opened where the gradient reaches the stage's output and
closed where its input's gradient is complete, by two tensor hooks that
it registers only while a profiler runs and the stage takes a gradient.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_host: Dict[str, List[int]] = {}          # name -> [count, ns]
_stream: Dict[str, float] = {}            # name -> resolved ms
_pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
_pool: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []


def span(name: str, device: bool = False, args: Optional[object] = None):
    """A context over one phase named ``name``; ``device``: also time it on
    the current CUDA stream; ``args``: shown with the range in the trace
    (``str(args)``)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, args)


class _Span:
    __slots__ = ("name", "events", "range", "t0")

    def __init__(self, name: str, device: bool, args):
        self.name = name
        self.range = torch.profiler.record_function(
            name, None if args is None else str(args))
        self.events = None
        if device and torch.cuda.is_initialized():
            with _lock:
                self.events = _pool.pop() if _pool else (
                    torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.range.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        with _lock:
            total = _host.setdefault(self.name, [0, 0])
            total[0] += 1
            total[1] += ns
            if self.events is not None:
                _pending.append((self.name, *self.events))
        self.range.__exit__(*exc)
        return False


def backward_span(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    """Time the backward of the stage that maps ``x`` to ``y`` as the span
    ``name``: a hook on ``y`` opens it when the gradient reaches ``y``, a
    hook on ``x`` closes it when ``x``'s gradient is complete. The hooks
    are registered only while a profiler runs and both tensors take a
    gradient; otherwise nothing is inserted."""
    if not (_profiler._is_profiler_enabled and x.requires_grad
            and y.requires_grad):
        return
    opened: List[_Span] = []

    def open_span(grad):
        if not opened:
            opened.append(_Span(name, True, None).__enter__())

    def close_span(grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    y.register_hook(open_span)
    x.register_hook(close_span)


def _resolve() -> None:
    """Fold the recorded event pairs into the stream totals and return
    them to the pool (waits for the last one to complete)."""
    with _lock:
        pending = _pending[:]
        _pending.clear()
    for name, start, end in pending:
        end.synchronize()
        ms = start.elapsed_time(end)
        with _lock:
            _stream[name] = _stream.get(name, 0.0) + ms
            _pool.append((start, end))


def totals() -> Dict[str, Dict[str, Optional[float]]]:
    """``{name: {"count", "host_ms", "stream_ms"}}`` of the spans so far;
    ``stream_ms`` is None for a span timed on the host alone."""
    _resolve()
    with _lock:
        return {name: {"count": count, "host_ms": ns / 1e6,
                       "stream_ms": _stream.get(name)}
                for name, (count, ns) in _host.items()}


def reset() -> None:
    """Clear the totals."""
    _resolve()
    with _lock:
        _host.clear()
        _stream.clear()
