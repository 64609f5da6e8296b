"""Device time an update spends on its bincounts (``utils/data._bincount``, the hand kernel on the card): ops
launched inside the port's ``counts`` ranges inside each ``suite.update``, over the updates, in ms."""


def read(trace, window: dict):
    program = getattr(trace, "program", None)
    updates = trace.spans.get("update", []) if trace is not None else []
    if not program or not updates:
        return None
    return 1e3 * program.device_s_launched_in("counts", updates) / len(updates)
