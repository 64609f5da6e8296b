"""User-facing error types (reference ``src/torchmetrics/utilities/exceptions.py``).

Only the types this package raises, with the names and bases of the JAX
package's (`metrics_tpu/utils/exceptions.py`): ``MetricsUserError``, the base
``FaultError`` and the sync domain's ``SyncFault`` and ``SyncConfigFault``.
The other failure domains belong to the JAX package's engine, deferral and
journal planes, which are not ported.
"""
from __future__ import annotations

from typing import Optional


class MetricsUserError(Exception):
    """Raised on incorrect use of the metrics API (e.g. ``forward`` on a synced metric)."""


class FaultError(Exception):
    """Base of the classified failures: ``domain`` names the stage that failed,
    ``site`` where it was raised, ``recoverable`` whether a retry may succeed."""

    domain: str = "runtime"
    recoverable: bool = True

    def __init__(self, message: str = "", *, site: Optional[str] = None):
        super().__init__(message or f"{type(self).__name__} at site {site!r}")
        self.site = site


class SyncFault(FaultError):
    """Distributed synchronisation failure: a collective across processes
    failed, or the sync configuration does not fit the live world. The
    metric's local state is left as it was before the sync."""

    domain = "sync"


class SyncConfigFault(SyncFault, ValueError):
    """Invalid sync configuration: an unknown reduction spec, a custom spec
    without its callable, or metric trees whose packed layouts differ across
    processes. Also a ``ValueError``; structural, so a retry cannot help."""

    recoverable = False


__all__ = ["FaultError", "MetricsUserError", "SyncConfigFault", "SyncFault"]
