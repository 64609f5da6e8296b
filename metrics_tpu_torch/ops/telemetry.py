"""Flight recorder: one telemetry plane for the engine, sync, faults and the journal.

JAX counterpart: `metrics_tpu/ops/telemetry.py`, with the same public names,
span sites, counter keys, environment variables and defaults, so that one
deployment configures and scrapes both packages the same way. Four layers:

- **Span recorder**: a bounded ring of ``(step, owner, lane, site, t_start,
  dur, attrs)`` events. ``step`` is the monotonic fault/sync event index the
  ``failure_log`` stamps (:func:`metrics_tpu_torch.ops.faults.current_step`),
  so spans order against faults on one axis. Call sites guard with ``if
  telemetry.armed:``: a disarmed recorder (``METRICS_TPU_TELEMETRY=0`` or
  ``set_telemetry(False)``) costs one module-attribute read and allocates
  nothing; armed, a span is one tuple appended to a ``deque``. Spans measure
  the host clock (``time.perf_counter``), as JAX's do: a span around work
  queued on the card ends when the host returns, not when the card does.
- **Reset registry**: every counter-owning module registers its zeroing
  callback (:func:`register_reset`); :func:`reset_all` walks them, and with
  ``reset_warnings=True`` also clears the warn-once markers. The monotonic
  step index never resets.
- **Latency histograms**: every timed span also lands in a fixed log2-bucket
  histogram per site (:data:`_HIST_BOUNDS_S`, 1 µs to about 134 s, plus
  ``+Inf``), kept for the process's whole life. Declared per-site budgets
  (``METRICS_TPU_SLO_<SITE>_MS``) count violations and warn once per owner
  and site.
- **Profiler ranges**: while a ``torch.profiler`` records, the port opens a
  ``torch.profiler.record_function`` range named ``metrics_tpu_torch.<site>``
  (or ``<site>:<detail>``) around its layers (:data:`RANGE_SITES`) and around
  the timed ring sites of the suite, the engine and the sync planes
  (:class:`timed`), so that they land in the profiler's trace on the device
  events' clock, nested in the caller's own ranges. With no profiler
  recording, a range reads the profiler's enabled flag and allocates nothing.
  Ranges never enter the ring; :func:`export_trace` records the ring clock's
  offset to the profiler's, so that the two lie on one axis.

Faces: :func:`snapshot` (alias ``telemetry_snapshot``), one merged dict of
the planes the port has (the engine's cache and deferral counters, faults,
collectives, journal, recorder, latency, SLO, and a ``sync_health`` block
with world membership and the syncs in flight); :func:`prometheus_text`, its
Prometheus text exposition; :func:`trace_events` and :func:`export_trace`,
the ring as Chrome-trace/Perfetto JSON, with the program ledger under
``programLedger``. The engine's sampled device probes land in
:func:`observe_device_dispatch`. The snapshot has the JAX snapshot's keys: the
program ledger's summary (``programs``) and analyses, the program cache's
``progcache_*``, the autotuner's ``autotune_*`` and, once the image stack is
loaded, FID's ``fid_host_sqrtm*``.
"""
from __future__ import annotations

import functools
import json
import os
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch.autograd.profiler as _profiler

__all__ = [
    "LatencyHistogram",
    "RANGE_PREFIX",
    "RANGE_SITES",
    "SPAN_SITES",
    "SYNC_PHASE_SITES",
    "armed",
    "clear_spans",
    "device_dispatch_stats",
    "emit",
    "export_trace",
    "is_counter_key",
    "is_histogram_sample_key",
    "latency_stats",
    "now",
    "observe_device_dispatch",
    "prometheus_text",
    "ranged",
    "register_reset",
    "register_warning_reset",
    "reset_all",
    "reset_latency",
    "set_telemetry",
    "slo_limit_s",
    "slo_violations",
    "snapshot",
    "spans",
    "sync_phase_stats",
    "telemetry_snapshot",
    "telemetry_stats",
    "timed",
    "trace_events",
    "trace_range",
]

#: Every span site, by subsystem, under the JAX package's names: one table for both packages.
SPAN_SITES = {
    # engine (ops/engine.py; engine-compile marks a program's first run of a signature)
    "engine-enqueue": "one eager call enqueued into a pending queue (instant)",
    "engine-flush": "a pending queue flushed as stacked program(s)",
    "engine-build": "a program-cache miss built a new program",
    "engine-compile": "a dispatch compiled a new input signature",
    "engine-dispatch": "one cached-program launch (host wall: ends when the launch returns)",
    "device-dispatch": "one sampled device-inclusive dispatch wall (METRICS_TPU_DEVICE_PROBE_EVERY)",
    "host-lane": "one host fast-lane update (list append tier, instant)",
    # sync (parallel/sync.py + parallel/bucketing.py)
    "sync-pack": "coalesced pack: tree walk + byte concatenation",
    "sync-metadata": "coalesced metadata exchange (cat lane, or the first check of a static layout)",
    "sync-payload-gather": "coalesced payload all-gather",
    "sync-unpack": "coalesced unpack + reduce",
    "sync-gather": "per-state gather_all_tensors exchange (shape + payload)",
    "sync-dispatch": "async sync dispatched: pack + handoff to the dispatcher thread",
    "sync-force": "async sync forced: wait-for-wire + fence re-check + apply",
    "sync-quantize": "quantized payload lane encode (METRICS_TPU_SYNC_QUANT)",
    "sync-timeout": "a blocking collective hit the watchdog deadline (instant)",
    "sync-degrade-serve": "compute() served a local-only degraded value (instant)",
    "sync-quorum-serve": "compute() served the surviving-quorum aggregate (instant)",
    # world membership (parallel/sync.py)
    "epoch-bump": "the world epoch advanced on a membership transition (instant)",
    "peer-dead": "a peer rank was declared dead (instant)",
    "peer-rejoin": "a rank's dead mark cleared in the membership registry (instant)",
    "rank-rejoin": "a restarted rank restored its journal and re-entered the world",
    "checkpoint-barrier": "a fleet-wide journal at one agreed monotonic step",
    # fault ladders (ops/faults.py)
    "fault": "one classified fault recorded (instant; mirrors failure_log)",
    "ladder-demote": "a per-owner lane demoted (instant)",
    "ladder-promote": "a per-owner lane re-promoted (instant)",
    # journal (ops/journal.py)
    "journal-save": "one crash-consistent record packed + atomically written",
    "journal-load": "one record verified + restored",
    "journal-demote": "a journal generation failed verification (instant)",
    # suite (collections.py)
    "suite-step": "one whole-suite update/forward call",
    "suite-sync": "one whole-suite sync (coalesced + individual members)",
    # the fleet, tenant, program-cache and autotuner planes
    "fleet-gather": "one fleet metadata/blob exchange",
    "fleet-snapshot": "one cross-rank snapshot gather + merge",
    "fleet-trace": "one cross-rank span-ring gather + merged trace export",
    "window-close": "one fleet-agreed window close",
    "drift-report": "one PSI/KS drift computation over binned raw states",
    "funcore-handoff": "an in-graph state tree landed back into the stateful shell (instant)",
    "arena-update": "one multi-tenant arena update",
    "arena-close": "one arena-wide window close",
    "arena-journal": "one slab-granular arena save or restore",
    "progcache-load": "one persistent program-cache load",
    "progcache-store": "one persistent program-cache store",
    "ingest-offer": "one payload offered at the gateway door",
    "ingest-flush": "one staging drain",
    "autotune-sweep": "one variant sweep for a (kernel, shape class)",
    "autotune-install": "a sweep winner installed into the selection table (instant)",
    "fid-host-sqrtm": "FID's host-side float64 covariance square root",
}

#: The sync-protocol phases whose durations :func:`sync_phase_stats` reduces.
SYNC_PHASE_SITES = (
    "sync-pack",
    "sync-metadata",
    "sync-payload-gather",
    "sync-unpack",
    "sync-gather",
    "suite-sync",
    "sync-dispatch",
    "sync-force",
    "sync-quantize",
)

# ------------------------------------------------------------------ the gate
#: Hot-path guard: call sites check this one module attribute before calling
#: :func:`emit`, so a disarmed recorder costs one read and allocates nothing.
armed: bool = os.environ.get("METRICS_TPU_TELEMETRY", "1") not in ("0", "false", "off")

_DEFAULT_CAP = 4096
_TRANSITIONS_CAP = 32  # membership transitions a snapshot's sync_health carries


class _TelemetryWarnOwner:
    """Warn-dedupe anchor for this module's environment parse warnings."""


_ENV_WARN_OWNER = _TelemetryWarnOwner()

# Parses that run at import cannot reach ``faults.warn_fault`` (faults
# imports this module), so their warnings queue here as (env name, message)
# and drain at the first cold surface (snapshot, latency_stats, set_telemetry).
_pending_env_warnings: List[Tuple[str, str]] = []


def _flush_env_warnings() -> None:
    if not _pending_env_warnings:
        return
    from metrics_tpu_torch.ops import faults as _faults

    while _pending_env_warnings:
        env_name, message = _pending_env_warnings.pop(0)
        _faults.warn_fault(_ENV_WARN_OWNER, f"env:{env_name}", message)


def _env_cap() -> int:
    """Span-ring capacity (``METRICS_TPU_TELEMETRY_SPANS``, at least 16): unset or
    blank is the default; a value that is not an integer warns once, naming it."""
    raw = os.environ.get("METRICS_TPU_TELEMETRY_SPANS")
    if raw is None or not raw.strip():
        return _DEFAULT_CAP
    try:
        return max(16, int(raw))
    except ValueError:
        _pending_env_warnings.append(
            (
                "METRICS_TPU_TELEMETRY_SPANS",
                f"METRICS_TPU_TELEMETRY_SPANS={raw!r} is not an integer; falling back "
                f"to the default span-ring capacity ({_DEFAULT_CAP}).",
            )
        )
        return _DEFAULT_CAP


_ring: "deque[tuple]" = deque(maxlen=_env_cap())
_emitted: List[int] = [0]  # a list cell: emit() stays closure-free

#: Monotonic fault/sync event index provider, rebound by ``ops/faults`` at its
#: import to its ``current_step`` (this module must not import faults).
_step_provider: Callable[[], int] = lambda: 0  # noqa: E731


def now() -> float:
    """The span clock (``time.perf_counter``: monotonic, sub-µs)."""
    return time.perf_counter()


# ---------------------------------------------------------- profiler ranges
#: The prefix of every range the port opens in a ``torch.profiler`` trace.
RANGE_PREFIX = "metrics_tpu_torch."

#: The profiler-only sites of :func:`trace_range`, by layer. A range is named ``RANGE_PREFIX + site``, or
#: ``RANGE_PREFIX + site + ":" + detail``. The timed ring sites ``suite-step``, ``suite-sync``, ``engine-build``,
#: ``-compile``, ``-dispatch``, ``-flush`` and the timed ``sync-*`` sites open a range of their own name as well,
#: while the ring records them as before.
RANGE_SITES = {
    # metric (metric.py)
    "update": "one metric's wrapped update (detail: its class)",
    "compute": "one metric's wrapped compute (detail: its class)",
    "filter-kwargs": "a metric's keyword arguments filtered by its update's signature, as a suite passes them on",
    # validation (utils/checks.py and the curves' updates)
    "validate": "the classification input checks: the case, the shapes and the value checks",
    "host-read": "one blocking read of the card's values on the host (detail: what is read)",
    # classification functional and kernels
    "canonicalize": "both sides' canonical form: the class ids of a multi-class input, or the one-hot, top-k mask or"
                    " threshold (utils/checks.canon_stats() counts each form)",
    "counts": "a bincount by either route (utils/data._bincount)",
    "stat-scores": "the stat-scores family's tp/fp/tn/fn: from the class-pair histogram (its bincount inside), or the"
                   " one-hot's products and sums",
    "calibration-bins": "CalibrationError's per-bin counts and confidence sums",
    # curves and kernels
    "state-cat": "the buffered rows concatenated at compute",
    "curve-sort": "the curves' sort of the scores and the gathers into its order",
    "curve-ties": "the curves' tie runs: the distinct thresholds and the counts or ranks at them",
    "curve-area": "the curves' points and areas from the counts at the thresholds",
}

#: The ring's clock (``time.perf_counter`` seconds) to the profiler's (Unix-epoch nanoseconds), taken once:
#: a ring span at ``t_start`` began at ``t_start * 1e9 + _RING_TO_UNIX_NS`` on the profiler's clock.
_RING_TO_UNIX_NS = time.time_ns() - round(time.perf_counter() * 1e9)


class _NoRange:
    """A site's range while no profiler records: nothing is opened or closed."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NO_RANGE = _NoRange()


def _range_name(site: str, detail: Any) -> str:
    if detail is None:
        return RANGE_PREFIX + site
    return f"{RANGE_PREFIX}{site}:{detail if type(detail) is str else type(detail).__name__}"


def trace_range(site: str, detail: Any = None):
    """A context manager over one site's work: while a ``torch.profiler`` records, a
    ``record_function`` range named ``metrics_tpu_torch.<site>[:<detail>]`` (``detail``
    a string, or an object named by its type); otherwise a shared no-op, after one read
    of the profiler's enabled flag. Ranges go to the profiler only, never to the ring.

    Example:
        >>> from metrics_tpu_torch.ops import telemetry
        >>> with telemetry.trace_range("validate"):  # no profiler records: no range is opened
        ...     pass
        >>> telemetry._range_name("update", "JaccardIndex")
        'metrics_tpu_torch.update:JaccardIndex'
    """
    if not _profiler._is_profiler_enabled:
        return _NO_RANGE
    return _profiler.record_function(_range_name(site, detail))


def ranged(site: str, detail: Any = None) -> Callable[[Callable], Callable]:
    """Decorate a function whose whole body is one site's work: each call runs inside
    :func:`trace_range`'s range (the name is formed once, here).

    Example:
        >>> from metrics_tpu_torch.ops import telemetry
        >>> @telemetry.ranged("counts")
        ... def double(x):
        ...     return 2 * x
        >>> double(3)
        6
    """
    name = _range_name(site, detail)

    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def in_range(*args: Any, **kwargs: Any) -> Any:
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _profiler.record_function(name):
                return fn(*args, **kwargs)

        return in_range

    return decorate


class timed:
    """One timed ring site of :data:`SPAN_SITES` as a ``with`` block: its ring span and,
    while a profiler records, :func:`trace_range`'s range of the same name, both closed
    on every exit. The span is emitted on exit when the ring is armed and ``attrs`` is
    set: pass ``attrs`` in for a span on every exit, or set ``.attrs`` at the end of the
    block for a span of a block that completed. ``.t0`` is the block's start on the
    ring's clock (0.0 while the ring is disarmed).

    Example:
        >>> from metrics_tpu_torch.ops import telemetry
        >>> with telemetry.timed("sync-pack", "Doc", "sync") as span:
        ...     span.attrs = {"states": 2}  # the block completed: its span is emitted on exit
    """

    __slots__ = ("site", "owner", "lane", "attrs", "detail", "t0", "_range")

    def __init__(self, site: str, owner: Any = None, lane: Optional[str] = None,
                 attrs: Optional[Dict[str, Any]] = None, detail: Any = None) -> None:
        self.site, self.owner, self.lane, self.attrs, self.detail = site, owner, lane, attrs, detail
        self._range = None

    def __enter__(self) -> "timed":
        self.t0 = time.perf_counter() if armed else 0.0
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(_range_name(self.site, self.detail))
            self._range.__enter__()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.t0 and self.attrs is not None and armed:
            emit(self.site, self.owner, self.lane, self.t0, time.perf_counter() - self.t0, self.attrs)
        return False


# ------------------------------------------------------- latency histograms
#: Log2-spaced bucket upper bounds in seconds (1 µs doubling to ~134 s; above
#: the last, the implicit ``+Inf`` bucket). The JAX package's layout, literal.
_HIST_BOUNDS_S = (
    1e-06, 2e-06, 4e-06, 8e-06, 1.6e-05, 3.2e-05, 6.4e-05, 0.000128,
    0.000256, 0.000512, 0.001024, 0.002048, 0.004096, 0.008192, 0.016384,
    0.032768, 0.065536, 0.131072, 0.262144, 0.524288, 1.048576, 2.097152,
    4.194304, 8.388608, 16.777216, 33.554432, 67.108864, 134.217728,
)
_HIST_FAMILY = "latency_seconds"  # metrics_tpu_latency_seconds{site=...,le=...}
_HIST_SNAPSHOT_KEY = "latency_stats"
#: One ``le`` label per finite bound (its repr), then ``+Inf``: the cumulative exposition order.
_HIST_LABELS = tuple(repr(b) for b in _HIST_BOUNDS_S) + ("+Inf",)
_N_BUCKETS = len(_HIST_BOUNDS_S) + 1


def _bucket_quantile(counts: List[int], total: int, q: float, max_s: float) -> float:
    """Quantile ``q`` from bucket counts, linear inside the bucket that holds it
    (within 2x of exact: a log2 bucket is at most 2x wide), clamped to the
    observed maximum."""
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        prev = cum
        cum += c
        if cum >= rank:
            lo = _HIST_BOUNDS_S[i - 1] if i > 0 else 0.0
            hi = _HIST_BOUNDS_S[i] if i < len(_HIST_BOUNDS_S) else max_s
            est = lo + (hi - lo) * ((rank - prev) / c)
            return min(max_s, est) if max_s > 0 else est
    return max_s


class LatencyHistogram:
    """One log2-bucket latency histogram on the shared layout (:data:`_HIST_BOUNDS_S`).

    Example:
        >>> from metrics_tpu_torch.ops.telemetry import LatencyHistogram
        >>> h = LatencyHistogram()
        >>> for ms in (1, 1, 2, 40):
        ...     h.observe(ms / 1000.0)
        >>> block = h.stats()
        >>> block["count"], block["max_s"]
        (4, 0.04)
        >>> block["p50_s"] <= block["p95_s"] <= block["p99_s"] <= block["max_s"]
        True
    """

    __slots__ = ("counts", "sum_s", "max_s")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * _N_BUCKETS
        self.sum_s = 0.0
        self.max_s = 0.0

    def observe(self, dur_s: float) -> None:
        """Record one duration in seconds (non-positive values are ignored: instants carry no latency)."""
        if dur_s <= 0.0:
            return
        self.counts[bisect_left(_HIST_BOUNDS_S, dur_s)] += 1
        self.sum_s += dur_s
        if dur_s > self.max_s:
            self.max_s = dur_s

    def stats(self) -> Dict[str, Any]:
        """Exact ``count``/``sum_s``/``max_s``/``buckets`` (counters) and
        interpolated ``p50_s``/``p95_s``/``p99_s`` (gauges)."""
        total = sum(self.counts)
        block: Dict[str, Any] = {
            "count": total,
            "sum_s": self.sum_s,
            "max_s": self.max_s,
            "p50_s": 0.0,
            "p95_s": 0.0,
            "p99_s": 0.0,
            "buckets": dict(zip(_HIST_LABELS, self.counts)),
        }
        if total:
            for q, key in ((0.5, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s")):
                block[key] = _bucket_quantile(self.counts, total, q, self.max_s)
        return block


#: The per-site histograms, made up front for every registered site so that
#: an armed emit never allocates (an unregistered site allocates once).
_site_hists: Dict[str, LatencyHistogram] = {site: LatencyHistogram() for site in SPAN_SITES}


# ------------------------------------------------------------- SLO budgets
class _SLOWarnOwner:
    """Per-site warn-dedupe anchor for violations emitted with no owner instance."""


_SLO_UNSET = object()
_slo_limits: Dict[str, Any] = {}  # site -> budget in seconds, or None; filled at a site's first timed span
_slo_violations: Dict[str, int] = {}
_slo_warn_owners: Dict[str, _SLOWarnOwner] = {}


def _slo_env_name(site: str) -> str:
    return "METRICS_TPU_SLO_" + site.upper().replace("-", "_") + "_MS"


def slo_limit_s(site: str) -> Optional[float]:
    """The declared latency budget of ``site`` in seconds
    (``METRICS_TPU_SLO_<SITE>_MS``, the site upper-cased with ``-`` as ``_``),
    or None when unset or not positive. A value that is not a number warns
    once and leaves the budget off. Cached per site until :func:`reset_latency`."""
    limit = _slo_limits.get(site, _SLO_UNSET)
    if limit is not _SLO_UNSET:
        return limit
    env_name = _slo_env_name(site)
    raw = os.environ.get(env_name)
    limit = None
    if raw is not None and raw.strip():
        try:
            ms = float(raw)
            limit = ms / 1000.0 if ms > 0 else None
        except (TypeError, ValueError):
            from metrics_tpu_torch.ops import faults as _faults

            _faults.warn_fault(
                _ENV_WARN_OWNER,
                f"env:{env_name}",
                f"{env_name}={raw!r} is not a number; the {site} latency SLO stays OFF.",
            )
    _slo_limits[site] = limit
    return limit


def _note_slo_violation(site: str, owner: Any, dur: float, limit: float) -> None:
    """Count one budget violation and warn once per owner and site."""
    _slo_violations[site] = _slo_violations.get(site, 0) + 1
    from metrics_tpu_torch.ops import faults as _faults

    if owner is None or type(owner) is str:
        anchor = _slo_warn_owners.get(site)
        if anchor is None:
            anchor = _slo_warn_owners[site] = _SLOWarnOwner()
    else:
        anchor = owner
    _faults.warn_fault(
        anchor,
        f"slo:{site}",
        f"The {site} span ran {dur * 1e3:.3f} ms, over its declared "
        f"{limit * 1e3:.3f} ms budget ({_slo_env_name(site)}); violations count "
        "in the slo_violations_* family and in sync_health.",
    )


def set_telemetry(enabled: Optional[bool] = None, *, span_cap: Optional[int] = None) -> None:
    """Arm or disarm the recorder, or resize its ring (None leaves a knob as it
    is; takes precedence over ``METRICS_TPU_TELEMETRY``/``_TELEMETRY_SPANS``).
    Shrinking ``span_cap`` keeps the newest spans; the counters survive.

    Example:
        >>> from metrics_tpu_torch import set_telemetry
        >>> set_telemetry(False)   # disarmed: every site is one attribute read
        >>> set_telemetry(True, span_cap=4096)
    """
    global armed, _ring
    _flush_env_warnings()
    if enabled is not None:
        armed = bool(enabled)
    if span_cap is not None:
        cap = max(16, int(span_cap))
        if cap != _ring.maxlen:
            _ring = deque(_ring, maxlen=cap)


class _SpanRingWarnOwner:
    """Warn-dedupe anchor for the ring-overflow warning."""


_OVERFLOW_WARN_OWNER = _SpanRingWarnOwner()
_overflow_warned: List[bool] = [False]


def _warn_overflow() -> None:
    from metrics_tpu_torch.ops import faults as _faults

    _faults.warn_fault(
        _OVERFLOW_WARN_OWNER,
        "telemetry",
        f"The telemetry span ring overflowed its {_ring.maxlen}-span capacity; the oldest "
        "spans are being dropped (counted in spans_dropped). Raise METRICS_TPU_TELEMETRY_SPANS "
        "or set_telemetry(span_cap=...) to retain a longer window.",
    )


def _reset_overflow_warning() -> None:
    _overflow_warned[0] = False


def emit(
    site: str,
    owner: Any = None,
    lane: Optional[str] = None,
    t_start: float = 0.0,
    dur: float = 0.0,
    attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Record one span. Callers guard with ``if telemetry.armed:``; this does
    not check again. ``t_start=0.0`` stamps now (an instant); ``owner`` is
    the owning instance (kept as its type name) or a string. A timed span
    also lands in its site's histogram and is held to the site's budget."""
    _emitted[0] += 1
    if len(_ring) == _ring.maxlen and not _overflow_warned[0]:
        _overflow_warned[0] = True
        _warn_overflow()
    _ring.append(
        (
            _step_provider(),
            owner if (owner is None or type(owner) is str) else type(owner).__name__,
            lane,
            site,
            t_start if t_start else time.perf_counter(),
            dur,
            attrs,
        )
    )
    if dur > 0.0:
        h = _site_hists.get(site)
        if h is None:  # an unregistered site: allocated once
            h = _site_hists.setdefault(site, LatencyHistogram())
        h.counts[bisect_left(_HIST_BOUNDS_S, dur)] += 1
        h.sum_s += dur
        if dur > h.max_s:
            h.max_s = dur
        limit = _slo_limits.get(site, _SLO_UNSET)
        if limit is _SLO_UNSET:
            limit = slo_limit_s(site)
        if limit is not None and dur > limit:
            _note_slo_violation(site, owner, dur, limit)


_SPAN_KEYS = ("step", "owner", "lane", "site", "t_start", "dur", "attrs")


def spans() -> List[Dict[str, Any]]:
    """The recorded spans, oldest first, as dicts with keys ``step, owner, lane, site, t_start, dur, attrs``."""
    return [dict(zip(_SPAN_KEYS, row)) for row in _ring]


def clear_spans() -> None:
    _ring.clear()
    _emitted[0] = 0


def sync_phase_stats() -> Dict[str, Dict[str, float]]:
    """Count, total, mean and max seconds of each sync phase (:data:`SYNC_PHASE_SITES`)
    over the spans the ring holds now: gauges, which fall as old spans drop."""
    agg: Dict[str, Dict[str, float]] = {
        site: {"count": 0, "total_s": 0.0, "mean_s": 0.0, "max_s": 0.0} for site in SYNC_PHASE_SITES
    }
    for row in _ring:
        site, dur = row[3], row[5]
        if site not in agg or dur <= 0:
            continue
        d = agg[site]
        d["count"] += 1
        d["total_s"] += dur
        if dur > d["max_s"]:
            d["max_s"] = dur
    for d in agg.values():
        if d["count"]:
            d["mean_s"] = d["total_s"] / d["count"]
    return agg


def latency_stats() -> Dict[str, Dict[str, Any]]:
    """The histogram of every site that has seen a timed span, over the process's life.

    Example:
        >>> from metrics_tpu_torch.ops import telemetry
        >>> telemetry.emit("suite-sync", None, "sync", telemetry.now(), 0.002)
        >>> block = telemetry.latency_stats()["suite-sync"]
        >>> block["count"] >= 1 and block["buckets"]["0.002048"] >= 1
        True
    """
    _flush_env_warnings()
    out: Dict[str, Dict[str, Any]] = {}
    for site in sorted(_site_hists):
        h = _site_hists[site]
        if h.max_s > 0.0:
            out[site] = h.stats()
    return out


def slo_violations() -> Dict[str, int]:
    """Budget violations by site, plus ``total``: the ``slo_violations_*`` counter family."""
    out = {"total": sum(_slo_violations.values())}
    for site in sorted(_slo_violations):
        out[site] = _slo_violations[site]
    return out


_DEVICE_HIST_SITE = "device-dispatch"


def observe_device_dispatch(program: str, t_start: float, dur_s: float) -> None:
    """Land one probed, device-inclusive program wall (the engine's sampled
    synchronise): a ``device-dispatch`` span, and an observation in the
    program's own full-lifetime family ``device-dispatch:<program>``."""
    emit(_DEVICE_HIST_SITE, program, "engine", t_start, dur_s, {"program": program})
    site = _DEVICE_HIST_SITE + ":" + program
    h = _site_hists.get(site)
    if h is None:  # one allocation per program, at its first probe
        h = _site_hists.setdefault(site, LatencyHistogram())
    h.observe(dur_s)


def device_dispatch_stats() -> Dict[str, Dict[str, Any]]:
    """``{program: stats block}`` for every program with at least one probe."""
    prefix = _DEVICE_HIST_SITE + ":"
    return {site[len(prefix):]: h.stats() for site, h in sorted(_site_hists.items())
            if site.startswith(prefix) and h.max_s > 0.0}


def reset_latency() -> None:
    """Zero the histograms and the violation counters, and forget the cached
    budgets so that the environment is read again."""
    for h in _site_hists.values():
        h.counts = [0] * _N_BUCKETS
        h.sum_s = 0.0
        h.max_s = 0.0
    _slo_violations.clear()
    _slo_limits.clear()


def telemetry_stats() -> Dict[str, Any]:
    """The recorder's own counters (part of :func:`snapshot`)."""
    return {
        "telemetry_armed": armed,
        "spans_recorded": _emitted[0],
        "spans_retained": len(_ring),
        "spans_dropped": max(0, _emitted[0] - len(_ring)),
        "span_ring_cap": _ring.maxlen,
    }


# -------------------------------------------------------------- reset registry
_resets: List[Tuple[str, Callable[[], None]]] = []
_warning_resets: List[Tuple[str, Callable[[], None]]] = []


def _register(registry: List[Tuple[str, Callable[[], None]]], name: str, fn: Callable[[], None]) -> None:
    for i, (n, _) in enumerate(registry):
        if n == name:
            registry[i] = (name, fn)
            return
    registry.append((name, fn))


def register_reset(name: str, fn: Callable[[], None]) -> None:
    """Register one module's counter-zeroing callback (once per name; modules call it at import)."""
    _register(_resets, name, fn)


def register_warning_reset(name: str, fn: Callable[[], None]) -> None:
    """Register a warn-once-clearing callback, run only by ``reset_all(reset_warnings=True)``."""
    _register(_warning_resets, name, fn)


def reset_all(reset_warnings: bool = False) -> None:
    """Zero every registered counter plane, the spans included, in one walk.
    The monotonic step index is not reset. ``reset_warnings=True`` also
    clears the warn-once markers."""
    for _, fn in _resets:
        fn()
    if reset_warnings:
        for _, fn in _warning_resets:
            fn()


def _reset_telemetry_plane() -> None:
    clear_spans()
    reset_latency()


register_reset("telemetry", _reset_telemetry_plane)
register_warning_reset("telemetry", _reset_overflow_warning)


# --------------------------------------------------------------------- faces
def snapshot() -> Dict[str, Any]:
    """One merged monitoring dict: the engine's counters (``builds``, ``hits``,
    ``cached``, ``deferred_*``, ``device_probes``, ``program_analyses``), the
    program ledger's summary (``programs``), the fault counters and
    ``failure_log``, the collective counters, the journal counters, the recorder counters, the
    canonicalizations by form (``perf_canon_class_ids``, ``perf_canon_onehot``; the port's own), the
    monotonic step, a ``sync_health`` block, the sync phase statistics, the
    latency histograms and the SLO violations. Scrape this, or its
    :func:`prometheus_text` rendering.

    Example:
        >>> from metrics_tpu_torch import telemetry_snapshot
        >>> snap = telemetry_snapshot()
        >>> snap["snapshot_schema"]
        1
        >>> sorted(snap["sync_health"])  # doctest: +NORMALIZE_WHITESPACE
        ['consecutive_timeouts', 'dead_ranks', 'degraded', 'epoch', 'fault_domain_counts', 'inflight',
         'last_good_sync_step', 'monotonic_step', 'slo_violations', 'sync_deadline_timeouts',
         'sync_degraded_serves', 'sync_quorum_serves', 'transitions']
    """
    from metrics_tpu_torch.ops import engine as _engine
    from metrics_tpu_torch.parallel import sync as _psync
    from metrics_tpu_torch.utils import checks as _checks

    _flush_env_warnings()
    out: Dict[str, Any] = {"snapshot_schema": 1}
    out.update(_engine.engine_stats())  # the engine's, fault, collective and journal counters
    out.update(_checks.canon_stats())  # the port's own: canonicalizations by form
    out.update(telemetry_stats())
    out["monotonic_step"] = _step_provider()
    out["programs"] = _engine.program_summary()
    domain_counts: Dict[str, int] = {}
    for entry in out.get("failure_log", ()):
        domain_counts[entry["domain"]] = domain_counts.get(entry["domain"], 0) + 1
    wh = _psync.world_health()
    last_good = wh["last_good_sync_step"]
    out["sync_health"] = {
        "monotonic_step": _step_provider(),
        "degraded": bool(wh["degraded"]),
        "epoch": int(wh["epoch"]),
        "dead_ranks": len(wh["dead_ranks"]),
        "consecutive_timeouts": int(wh["consecutive_timeouts"]),
        # -1: no sync has completed yet (None would drop out of the exposition)
        "last_good_sync_step": -1 if last_good is None else int(last_good),
        "sync_degraded_serves": out.get("sync_degraded_serves", 0),
        "sync_quorum_serves": out.get("sync_quorum_serves", 0),
        "sync_deadline_timeouts": out.get("sync_deadline_timeouts", 0),
        "slo_violations": sum(_slo_violations.values()),
        "fault_domain_counts": domain_counts,
        "inflight": _psync.inflight_stats(),
        # the membership transitions, each with its monotonic step, newest _TRANSITIONS_CAP
        "transitions": [dict(t) for t in wh["transitions"][-_TRANSITIONS_CAP:]],
    }
    out["sync_phase_stats"] = sync_phase_stats()
    out[_HIST_SNAPSHOT_KEY] = latency_stats()
    out["slo_violations"] = slo_violations()
    # window and arena state (gauges: the streaming_ prefix) and gateway state (ingest_state_)
    from metrics_tpu_torch import ingest as _ingest
    from metrics_tpu_torch import streaming as _streaming

    out["streaming"] = _streaming.streaming_snapshot()
    out["ingest_state"] = _ingest.ingest_state()
    return out


telemetry_snapshot = snapshot


def _flat_numeric(prefix: str, value: Any) -> Iterator[Tuple[str, float]]:
    if isinstance(value, bool):
        yield prefix, 1.0 if value else 0.0
    elif isinstance(value, (int, float)) and value is not None:
        yield prefix, float(value)
    elif isinstance(value, dict):
        for k, v in value.items():
            key = f"{prefix}_{k}" if prefix else str(k)
            yield from _flat_numeric(key, v)


# The JAX package's classification of every flattened key, so that both packages render the same dict
# the same way.
_COUNTER_PREFIXES = (
    "builds", "hits", "deferred_", "fault_", "sync_", "journal_", "fleet_",
    "latency_", "slo_", "spans_recorded", "spans_dropped", "monotonic_step",
    "device_", "program_", "perf_",
    "window_", "drift_",
    "funcore_",
    "arena_",
    "progcache_",
    "ingest_",
    "autotune_",
    "fid_",
)
# ratios and percentiles recompute per read and can fall: gauges
_GAUGE_SUFFIXES = ("_ratio", "_p50_s", "_p95_s", "_p99_s", "_max_s")
# health state and ring-windowed statistics: gauges despite a counter prefix
_GAUGE_PREFIXES = ("sync_health_", "sync_phase_stats_", "streaming_", "ingest_state_")


def is_counter_key(key: str) -> bool:
    """Whether a flattened snapshot key is a monotonic counter (else a gauge)."""
    return (
        key.startswith(_COUNTER_PREFIXES)
        and not key.endswith(_GAUGE_SUFFIXES)
        and not key.startswith(_GAUGE_PREFIXES)
    )


def is_histogram_sample_key(key: str) -> bool:
    """Whether a flattened snapshot key is a histogram sample (a bucket count,
    ``_count`` or ``_sum_s`` under the latency plane): counters by
    :func:`is_counter_key`, but rendered only inside the histogram families and
    merged structurally by the fleet plane, never as flat scalars."""
    if not key.startswith(_HIST_SNAPSHOT_KEY + "_"):
        return False
    return "_buckets_" in key or key.endswith(("_count", "_sum_s"))


def _render_value(value: float) -> str:
    # integers exactly ('%g' would round a byte counter); floats by repr
    return str(int(value)) if float(value).is_integer() else repr(float(value))


def _histogram_exposition_lines(
    stats: Dict[str, Any],
    family: str = "",
    label_for: Optional[Callable[[str], str]] = None,
) -> List[str]:
    """A :func:`latency_stats`-shaped block as Prometheus histogram families:
    per site the cumulative ``le``-labelled ``_bucket`` samples ending at
    ``+Inf``, ``_sum`` and ``_count``, then one gauge family per percentile."""
    lines: List[str] = []
    if not stats:
        return lines
    name = family or ("metrics_tpu_" + _HIST_FAMILY)
    labels = label_for or (lambda site: f'site="{site}"')
    lines.append(f"# TYPE {name} histogram")
    for site, block in stats.items():
        block = block or {}
        buckets = block.get("buckets") or {}
        base = labels(site)
        cum = 0
        for label in _HIST_LABELS:
            cum += int(buckets.get(label, 0))
            lines.append(f'{name}_bucket{{{base},le="{label}"}} {cum}')
        lines.append(f'{name}_sum{{{base}}} {_render_value(float(block.get("sum_s", 0.0)))}')
        lines.append(f'{name}_count{{{base}}} {int(block.get("count", 0))}')
    for stat_key, suffix in (("p50_s", "p50"), ("p95_s", "p95"), ("p99_s", "p99"), ("max_s", "max")):
        lines.append(f"# TYPE {name}_{suffix} gauge")
        for site, block in stats.items():
            value = float((block or {}).get(stat_key, 0.0))
            lines.append(f"{name}_{suffix}{{{labels(site)}}} {_render_value(value)}")
    return lines


def prometheus_text(data: Optional[Dict[str, Any]] = None) -> str:
    """:func:`snapshot` (or ``data``) as a Prometheus text exposition: every
    numeric key (nested dicts flattened with ``_``) as one ``metrics_tpu_<key>``
    sample after its ``# TYPE`` line (counter or gauge), then the latency
    histograms. Non-numeric values (the failure log) are left out.

    Example:
        >>> from metrics_tpu_torch import prometheus_text
        >>> text = prometheus_text()
        >>> text.splitlines()[0].startswith("# TYPE metrics_tpu_")
        True
        >>> "metrics_tpu_sync_payload_collectives" in text
        True
    """
    data = snapshot() if data is None else data
    lines: List[str] = []
    flat_src = {k: v for k, v in data.items() if k not in ("failure_log", _HIST_SNAPSHOT_KEY)}
    for key, value in sorted(_flat_numeric("", flat_src)):
        name = "metrics_tpu_" + "".join(c if (c.isalnum() or c == "_") else "_" for c in key)
        kind = "counter" if is_counter_key(key) else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {_render_value(value)}")
    lines.extend(_histogram_exposition_lines(data.get(_HIST_SNAPSHOT_KEY) or {}))
    return "\n".join(lines) + "\n"


def _json_safe(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    try:
        return float(value)  # numpy and 0-d tensor scalars
    except Exception:  # noqa: BLE001 - repr is always renderable
        return repr(value)


def trace_events(rows: Optional[List[Dict[str, Any]]] = None) -> List[Dict[str, Any]]:
    """The ring (or ``rows``) as Chrome-trace events: one track per owner,
    complete slices (``ph: X``) for timed spans and instants (``ph: i``) for
    the others, timestamps in µs from the earliest span, sorted."""
    rows = spans() if rows is None else rows
    if not rows:
        return []
    t0 = min(r["t_start"] for r in rows)
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for r in rows:
        owner = r["owner"] or "global"
        tid = tids.setdefault(owner, len(tids) + 1)
        args: Dict[str, Any] = {"step": r["step"]}
        if r["lane"]:
            args["lane"] = r["lane"]
        if r["attrs"]:
            args.update(_json_safe(r["attrs"]))
        ev: Dict[str, Any] = {
            "name": r["site"],
            "cat": r["lane"] or "span",
            "pid": 0,
            "tid": tid,
            "ts": round((r["t_start"] - t0) * 1e6, 3),
            "args": args,
        }
        if r["dur"] > 0:
            ev["ph"] = "X"
            ev["dur"] = round(r["dur"] * 1e6, 3)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    events.sort(key=lambda e: e["ts"])
    meta: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "ts": 0, "args": {"name": "metrics_tpu"}}
    ]
    for owner, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid, "ts": 0, "args": {"name": owner}})
    return meta + events


def export_trace(path: str) -> int:
    """Write the recorded spans as Chrome-trace/Perfetto JSON (open it at
    https://ui.perfetto.dev or ``chrome://tracing``), with the numeric
    snapshot under ``snapshot`` and the program ledger
    (:func:`metrics_tpu_torch.ops.engine.program_report`) under ``programLedger``.
    ``otherData.clock`` lays the ring on a ``torch.profiler`` trace of the same
    process: ``ring_to_unix_ns`` takes a span's ``time.perf_counter`` start to the
    profiler's Unix-epoch nanoseconds, and ``ts_zero_unix_ns`` is the events' ``ts``
    0 on that clock. Returns the number of span events written.

    Example:
        >>> import os, tempfile
        >>> from metrics_tpu_torch import export_trace
        >>> path = os.path.join(tempfile.mkdtemp(), "trace.json")
        >>> _ = export_trace(path)
        >>> os.path.exists(path)
        True
    """
    from metrics_tpu_torch.ops import engine as _engine

    # the ledger first: its analyses run programs (seconds over a full cache), and the spans and the
    # snapshot are read after them, so that the file agrees with the ring as it stands when it is written
    ledger = _engine.program_report()
    snap = snapshot()
    rows = spans()
    events = trace_events(rows)
    clock = {"ring_clock": "time.perf_counter", "ring_to_unix_ns": _RING_TO_UNIX_NS}
    if rows:
        clock["ts_zero_unix_ns"] = round(min(r["t_start"] for r in rows) * 1e9) + _RING_TO_UNIX_NS
    doc = {
        "displayTimeUnit": "ms",
        "otherData": {"generator": "metrics_tpu_torch.ops.telemetry", "schema": 1, "clock": clock},
        "programLedger": _json_safe(ledger),
        "snapshot": _json_safe({k: v for k, v in snap.items() if k != "failure_log"}),
        "traceEvents": events,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, separators=(",", ":"))
    return max(0, len(events) - sum(1 for e in events if e["ph"] == "M"))
