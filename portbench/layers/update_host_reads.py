"""Blocking reads of the card's values on the host an update makes: the port's ``host-read`` ranges inside each
``suite.update``, over the updates."""


def read(trace, window: dict):
    program = getattr(trace, "program", None)
    updates = trace.spans.get("update", []) if trace is not None else []
    if not program or not updates:
        return None
    return len(program.ranges_in("host-read", updates)) / len(updates)
