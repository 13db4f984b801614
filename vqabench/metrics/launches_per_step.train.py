"""Device operations (kernels, copies, fills) a training step in the
traced window; nothing where the trace holds none (no card)."""


def read(r):
    if r.trace is None or not r.measurement["steps"] or not r.trace.launches():
        return None
    return r.trace.launches() / r.measurement["steps"]
