"""Device time a ``compute()`` spends on the curves' tie runs (the distinct thresholds and the counts at them):
ops launched inside the port's ``curve-ties`` ranges inside each compute span, over the computes, in ms."""


def read(trace, window: dict):
    program = getattr(trace, "program", None)
    computes = trace.spans.get("compute", []) if trace is not None else []
    if not program or not computes:
        return None
    return 1e3 * program.device_s_launched_in("curve-ties", computes) / len(computes)
