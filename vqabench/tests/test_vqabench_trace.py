"""The trace reduction on a hand-made event list that offers only the
methods the card's torch gives its kineto events: busy time, idle gaps
named by the innermost host event of the window's thread, kernels by
name."""

from __future__ import annotations

import pytest

from vqabench.trace import WINDOW, Summary


class Event:
    def __init__(self, name, start, end, cuda=False, tid=1, annotation=False):
        self._n, self._s, self._e = name, start, end
        self._cuda, self._tid, self._ann = cuda, tid, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann

    def start_thread_id(self):
        return self._tid


EVENTS = [
    Event(WINDOW, 0, 1000),
    Event(WINDOW, 0, 1000, cuda=True, annotation=True),   # the card's copy
    Event("vqabench.call", 0, 600),
    Event("aten::mm", 100, 200),
    Event("loader thread", 0, 1000, tid=2),
    Event("gemm_kernel", 150, 400, cuda=True),
    Event("gemm_kernel", 350, 500, cuda=True),
    Event("pool_int8_kernel", 700, 800, cuda=True),
    Event("before the window", -50, -10, cuda=True),
]


def test_busy_idle_and_kernels():
    s = Summary(EVENTS)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy() == [[150, 500], [700, 800]]
    assert s.busy_s() == pytest.approx(450e-9)
    assert s.kernels("gemm_kernel") == (pytest.approx(400e-9), 2)
    assert s.launches() == 3
    assert s.device_ops()[0] == ["gemm_kernel", pytest.approx(400e-9)]


def test_idle_gaps_are_named_by_the_window_threads_innermost_event():
    gaps = dict(Summary(EVENTS).idle_gaps())
    # [0, 150) mid 75: the call; [500, 700) mid 600: the call's end;
    # [800, 1000) mid 900: only the window range
    assert gaps == {"vqabench.call": pytest.approx(350e-9),
                    WINDOW: pytest.approx(200e-9)}


def test_a_trace_without_the_window_range_is_refused():
    with pytest.raises(RuntimeError):
        Summary(EVENTS[2:])
