"""Device time a ``compute()`` spends sorting the buffered scores: ops launched inside the port's ``curve-sort``
ranges inside each compute span, over the computes, in ms."""


def read(trace, window: dict):
    program = getattr(trace, "program", None)
    computes = trace.spans.get("compute", []) if trace is not None else []
    if not program or not computes:
        return None
    return 1e3 * program.device_s_launched_in("curve-sort", computes) / len(computes)
