"""The traced run: torch.profiler over the window, reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need.

The window is marked by a range of the benchmark's own
(``vqabench.window``); the benchmark's calls into the program carry
ranges of their own too (``vqabench.call``, ``vqabench.train_step``), so
an idle gap of the card can be named by what the host was doing: the
innermost event of the window's thread that covers the gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

WINDOW = "vqabench.window"
NAME_CHARS = 120


def _is_device(e) -> bool:
    """A kernel, copy or fill on the card: a CUDA event that is not the
    card's copy of a host range."""
    return "cuda" in str(e.device_type()).lower() and not e.is_user_annotation()


class Summary:
    """Device intervals and host events of the traced window."""

    def __init__(self, events):
        dev, host, win = [], [], None
        for e in events:
            name = e.name()
            start, end = e.start_ns(), e.end_ns()
            if _is_device(e):
                dev.append((start, end, name))
            elif name == WINDOW and "cuda" not in str(e.device_type()).lower():
                win = (start, end, e.start_thread_id())
            else:
                host.append((start, end, name, e.start_thread_id()))
        if win is None:
            raise RuntimeError("the trace holds no window range")
        self.t0, self.t1, tid = win
        self.device = sorted(d for d in dev if d[1] > self.t0 and d[0] < self.t1)
        self.host = sorted((s, -e, n) for s, e, n, t in host
                           if t == tid and e > self.t0 and s < self.t1
                           and e > s)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self):
        """The merged busy intervals of the card within the window."""
        out: List[List[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernels(self, pattern: str):
        """(device seconds, launches) of the kernels whose name holds
        ``pattern``."""
        hits = [e - s for s, e, n in self.device if pattern in n]
        return sum(hits) / 1e9, len(hits)

    def launches(self) -> int:
        return sum(1 for *_, n in self.device)

    def device_ops(self, top: int = 10):
        by: Dict[str, int] = defaultdict(int)
        for s, e, n in self.device:
            by[n[:NAME_CHARS]] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """The card's idle time in the window, summed by the host event
        that covers each gap's middle (the innermost one)."""
        busy = self.busy()
        gaps, edge = [], self.t0
        for s, e in busy:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        starts = [h[0] for h in self.host]
        by: Dict[str, int] = defaultdict(int)
        stack: List[tuple] = []
        i = 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
            mid = (a + b) // 2
            j = bisect.bisect_right(starts, mid)
            while i < j:
                s, neg_e, n = self.host[i]
                while stack and -stack[-1][1] < s:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and -stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2][:NAME_CHARS] if stack else "(no host event)"
            by[name] += b - a
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda x: -x[1])[:top]]


class Tracer:
    """torch.profiler over the window when ``enabled``."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled, self.cuda = enabled, cuda
        self.prof = None
        self.summary: Optional[Summary] = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            kinds = [ProfilerActivity.CPU]
            if self.cuda:
                kinds.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=kinds)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = Summary(
                    self.prof.profiler.kineto_results.events())
            self.prof = None
        return False
