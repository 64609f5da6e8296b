"""The 95th percentile (nearest rank) of every update of the window, each timed by CUDA events from the
call to the end of its work on the card."""
from work import p95


def read(window: dict):
    return p95(window["update_ms"]) if window["update_ms"] else None
