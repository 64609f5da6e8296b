"""Device time an update spends on the canonicalization: ops launched inside the port's ``canonicalize`` ranges
(the one-hot of both sides, the arg-max back) inside each ``suite.update``, over the updates, in ms."""


def read(trace, window: dict):
    program = getattr(trace, "program", None)
    updates = trace.spans.get("update", []) if trace is not None else []
    if not program or not updates:
        return None
    return 1e3 * program.device_s_launched_in("canonicalize", updates) / len(updates)
