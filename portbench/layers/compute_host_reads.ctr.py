"""Host reads of the card a ``compute()`` makes: profiler counts of ``aten::item``,
``aten::_local_scalar_dense`` and ``aten::nonzero`` inside the compute spans, over the computes."""
from devtrace import HOST_READ_OPS


def read(trace, window: dict):
    if trace is None:
        return None
    computes = trace.spans.get("compute", [])
    if not computes:
        return None
    return trace.count_host_ops(HOST_READ_OPS, computes) / len(computes)
