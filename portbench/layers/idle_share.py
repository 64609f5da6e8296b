"""Percent of the traced window that no kernel, copy or set on the card covers."""


def read(trace, window: dict):
    if trace is None or not trace.busy:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
