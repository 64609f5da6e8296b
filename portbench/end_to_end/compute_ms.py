"""All the window's ``compute()`` time, each from the call to its values on the host (the host's clock), over
the computes completed; a run's computes together span far more than the host clock's error."""


def read(window: dict):
    times = window["compute_ms"]
    return sum(times) / len(times) if times else None
