"""Host time of the input checks an update makes: the port's outermost ``validate`` ranges inside each
``suite.update`` (the benchmark's update span), summed, over the updates, in ms."""


def read(trace, window: dict):
    program = getattr(trace, "program", None)
    updates = trace.spans.get("update", []) if trace is not None else []
    if not program or not updates:
        return None
    host_s = sum(e - s for _, s, e in program.ranges_in("validate", updates, outermost=True)) / 1e9
    return 1e3 * host_s / len(updates)
