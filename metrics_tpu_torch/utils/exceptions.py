"""User-facing error types (reference ``src/torchmetrics/utilities/exceptions.py``).

Only the types this package raises. The JAX package's failure-domain hierarchy
(`metrics_tpu/utils/exceptions.py`) belongs to its engine, deferral and sync
planes, which are not ported yet.
"""
from __future__ import annotations


class MetricsUserError(Exception):
    """Raised on incorrect use of the metrics API (e.g. ``forward`` on a synced metric)."""


__all__ = ["MetricsUserError"]
