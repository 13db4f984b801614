"""The card's idle share of the traced window, %: 1 - busy / window.
Read for every ``device_idle_pct.<kind>`` metric."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.launches():
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
