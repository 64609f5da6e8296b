"""User-facing error types and the classified failure domains.

JAX counterpart: `metrics_tpu/utils/exceptions.py` (``FAULT_DOMAINS`` `:22`,
the classes `:36-165`), with the same names, bases, ``domain`` and
``recoverable``; reference `src/torchmetrics/utilities/exceptions.py`, which
has only ``MetricsUserError``. Every fallback classifies what failed by its
domain, so counters, warning dedupe and the recovery policy key on the
domain and never on a message. The machinery that consumes the classes
(injection sites, degradation ladders, counters) is
:mod:`metrics_tpu_torch.ops.faults`; this module imports nothing, so any
module may raise these.
"""
from __future__ import annotations

from typing import Optional


class MetricsUserError(Exception):
    """Raised on incorrect use of the metrics API (e.g. ``forward`` on a synced metric)."""


#: The failure domains; every :class:`FaultError` subclass carries one as ``domain``.
FAULT_DOMAINS = (
    "trace",
    "compile",
    "runtime",
    "donation",
    "host",
    "sync",
    "journal",
    "ingest",
)


class FaultError(Exception):
    """Base of the classified failures.

    ``domain`` names the stage that failed (one of :data:`FAULT_DOMAINS`),
    ``site`` the site that raised (``"sync-pack"``, ``"journal-load"``, ...),
    and ``recoverable`` whether a demoted path may be tried again after
    clean steps: a trace failure is structural, the others may be transient.
    """

    domain: str = "runtime"
    recoverable: bool = True

    def __init__(self, message: str = "", *, site: Optional[str] = None):
        super().__init__(message or f"{type(self).__name__} at site {site!r}")
        self.site = site


class TraceFault(FaultError):
    """The program cannot be built for these inputs: structural, never retried for the same configuration."""

    domain = "trace"
    recoverable = False


class CompileFault(FaultError):
    """Building a program or kernel failed (e.g. out of memory while compiling)."""

    domain = "compile"


class RuntimeFault(FaultError):
    """Running an already-built program or kernel failed."""

    domain = "runtime"


class DonationFault(FaultError):
    """An input handed over for in-place reuse was used again, or reuse failed where a copy would not."""

    domain = "donation"


class HostOffloadFault(FaultError):
    """Moving states between the device and host memory failed."""

    domain = "host"


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


class SyncTimeoutFault(SyncFault):
    """A blocking collective exceeded its deadline (``METRICS_TPU_SYNC_DEADLINE_MS``):
    a peer hung or died mid-collective. Transient by nature."""


class EpochFault(SyncFault):
    """A collective was attempted under a stale world epoch: membership changed
    between the start of the sync and the collective. Local state is intact
    and the sync may be retried at the current epoch."""


class IngestFault(FaultError):
    """An ingestion gateway shed a payload under overload or quarantined it as poison."""

    domain = "ingest"


class JournalFault(FaultError):
    """State-journal failure: a record could not be written, or a stored one is
    torn, fails its checksum or does not fit the live metrics. A bad
    generation on load demotes to the previous one; only when every
    generation is bad does this reach the caller."""

    domain = "journal"


__all__ = [
    "FAULT_DOMAINS",
    "CompileFault",
    "DonationFault",
    "EpochFault",
    "FaultError",
    "HostOffloadFault",
    "IngestFault",
    "JournalFault",
    "MetricsUserError",
    "RuntimeFault",
    "SyncConfigFault",
    "SyncFault",
    "SyncTimeoutFault",
    "TraceFault",
]
