"""The device's idle share of a traced window."""


def pct(trace):
    if trace is None or trace.window_s <= 0.0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
