"""The program's spans (``vqa_tpu_torch.tracing``), read for the per-layer
metrics of source ``program_span``: a span's total over the traced window,
by step or by forward (the window's ``steps``).

The spans switch on only under a profiler, so they hold the traced window
alone (set-up and the check run untraced, and each run is one process).
A run without a trace, or a program without the spans, reads nothing.
"""

from __future__ import annotations


def per_step(r, key: str, *names: str):
    """The summed ``key`` (``host_ms`` or ``stream_ms``) of the spans
    ``names`` over the window's steps, or None where none of them holds
    it."""
    if r.trace is None or not r.measurement["steps"]:
        return None
    try:
        from vqa_tpu_torch.tracing import totals
    except ImportError:
        return None
    found = [t[key] for n, t in totals().items()
             if n in names and t[key] is not None]
    if not found:
        return None
    return sum(found) / r.measurement["steps"]
