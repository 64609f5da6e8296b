"""Percent of the memory roofline a ``compute()`` reaches: the least time for every buffered row read once
and the values written once, at the card's published bandwidth, over the compute's device time."""
from work import roofline_share


def read(trace, window: dict):
    if trace is None:
        return None
    computes = trace.spans.get("compute", [])
    device_s = trace.device_s_within(computes)
    if not computes or device_s <= 0:
        return None
    return roofline_share(window["compute_bytes"] * len(computes), device_s, window["peaks"]["hbm_bytes_per_s"])
