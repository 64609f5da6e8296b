"""Percent of the memory roofline an update reaches: the least time for its inputs read once and the suite's
states written once, at the card's published bandwidth, over its device time (from the call to the end of
the synchronize after it), summed over every update of the traced window."""
from work import roofline_share


def read(trace, window: dict):
    if trace is None:
        return None
    steps = trace.steps()
    device_s = trace.device_s_within(steps)
    if not steps or device_s <= 0:
        return None
    least = sum(window["update_bytes"][: len(steps)])
    return roofline_share(least, device_s, window["peaks"]["hbm_bytes_per_s"])
