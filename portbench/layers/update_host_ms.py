"""Host time of ``suite.update`` (the benchmark's own span, before the synchronize), the mean over every update."""


def read(trace, window: dict):
    times = window["host_update_s"]
    return 1e3 * sum(times) / len(times) if times else None
