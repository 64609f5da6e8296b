"""The admission-controlled ingestion gateway: columnar staging and SLO-driven admission.

JAX counterpart: `metrics_tpu/ingest.py`. :class:`IngestGateway` is the front
door a serving transport hands batched update payloads to, built on four
contracts, as in JAX:

- **Columnar staging.** A payload's dtype and trailing-shape signature is
  checked once per schema fingerprint; later payloads of the pinned
  fingerprint append their column references (no copy) to a bounded staging
  buffer. :meth:`IngestGateway.flush` drains staging into the target's own
  ``update()``: an arena's payloads ride :class:`~metrics_tpu_torch.arena.MetricArena`'s
  ``pow2_chunks``, a suite's replay through its deferral queue.
- **Admission control.** Staging is bounded by rows and bytes
  (``METRICS_TPU_INGEST_MAX_ROWS``, ``METRICS_TPU_INGEST_MAX_BYTES``). New SLO
  violations (``slo_violations()``) demote the gateway's ``ingest`` ladder
  lane: the watermarks shrink by ``METRICS_TPU_INGEST_DEGRADED_FACTOR``,
  same-schema arena payloads coalesce into one staged payload, and only then
  is the lowest-priority load shed. Clean flushes with no new violations
  re-promote.
- **Poison quarantine.** A schema mismatch or a NaN/Inf storm never raises
  and never reaches the target: it counts an ``ingest`` fault (site
  ``ingest-admit``), warns once a gateway and lands in a bounded ring.
- **Exact accounting.** Every offered row settles into one of admitted,
  coalesced, shed or quarantined, counted when it settles, so
  ``offered_rows == admitted + coalesced + shed + quarantined + staged`` at
  every instant (``staged`` is zero after a drain). Rows still staged at
  :meth:`~IngestGateway.close` settle as shed.

Columns may be numpy arrays or tensors; an arena target's rows go to its
device. Counters ``ingest_*`` (:func:`ingest_stats`) fold into
``engine_stats()``; gateway state rides ``telemetry_snapshot()['ingest_state']``
(:func:`ingest_state`). The fault sites ``ingest-admit`` (each offer) and
``ingest-shed`` (each staged payload of a flush) fire classified faults on
demand.
"""
from __future__ import annotations

import weakref
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.parallel import sync as _psync
from metrics_tpu_torch.utils.exceptions import IngestFault

__all__ = ["IngestGateway", "ingest_state", "ingest_stats"]

# Every offered row lands in exactly one settlement counter, counted when it settles.
_counters: Dict[str, int] = {
    "ingest_offered": 0,            # payloads offered
    "ingest_offered_rows": 0,       # rows offered (the identity's left side)
    "ingest_admitted_rows": 0,      # rows dispatched into the target by a flush
    "ingest_admitted_payloads": 0,  # staged payloads dispatched whole
    "ingest_coalesced_rows": 0,     # rows merged into a staged payload of their schema
    "ingest_shed_rows": 0,          # rows dropped under overload (evictions included)
    "ingest_shed_payloads": 0,
    "ingest_quarantined_rows": 0,   # poison rows (schema mismatch, NaN/Inf storm)
    "ingest_quarantined_payloads": 0,
    "ingest_quarantine_evictions": 0,  # the ring was full: its oldest entry dropped
    "ingest_flushes": 0,
    "ingest_flush_dispatches": 0,   # target.update() calls of the flushes
    "ingest_degraded_offers": 0,    # offers while the ladder lane is demoted
    "ingest_schema_validations": 0,  # full structural checks (one per schema)
    "ingest_apply_faults": 0,       # target failures at a flush (quarantined)
}


def ingest_stats() -> Dict[str, int]:
    """The ``ingest_*`` settlement counters (every key monotonic).

    Example:
        >>> from metrics_tpu_torch import ingest_stats
        >>> sorted(ingest_stats())[:3]
        ['ingest_admitted_payloads', 'ingest_admitted_rows', 'ingest_apply_faults']
    """
    return dict(_counters)


def _reset_ingest() -> None:
    for key in _counters:
        _counters[key] = 0


_telemetry.register_reset("ingest", _reset_ingest)

#: Every live gateway, held weakly.
_GATEWAYS: "weakref.WeakSet[IngestGateway]" = weakref.WeakSet()
_NAME_SEQ = [0]


def ingest_state() -> Dict[str, Any]:
    """Gateway state, not events: staging occupancy summed over the live gateways
    and one block per gateway (``telemetry_snapshot()['ingest_state']``; its
    flattened keys are gauges).

    Example:
        >>> from metrics_tpu_torch import ingest_state
        >>> state = ingest_state()
        >>> state["staging_rows"] >= 0 and "gateways" in state
        True
    """
    gateways: Dict[str, Any] = {}
    agg = {"staging_rows": 0, "staging_bytes": 0, "peak_bytes": 0,
           "degraded": 0, "quarantine_depth": 0, "gateway_count": 0}
    for gw in list(_GATEWAYS):
        st = gw.state()
        gateways[gw.name] = st
        agg["staging_rows"] += st["staging_rows"]
        agg["staging_bytes"] += st["staging_bytes"]
        agg["peak_bytes"] = max(agg["peak_bytes"], st["peak_bytes"])
        agg["degraded"] += int(st["degraded"])
        agg["quarantine_depth"] += st["quarantine_depth"]
        agg["gateway_count"] += 1
    agg["gateways"] = gateways
    return agg


# ------------------------------------------------------------------ env knobs
class _IngestWarnOwner:
    """Warn-once anchor for one knob's parse warning."""


_MAX_ROWS_OWNER = _IngestWarnOwner()
_MAX_BYTES_OWNER = _IngestWarnOwner()
_FLUSH_ROWS_OWNER = _IngestWarnOwner()
_DEGRADED_OWNER = _IngestWarnOwner()
_QUARANTINE_OWNER = _IngestWarnOwner()
_NANFRAC_OWNER = _IngestWarnOwner()


def _knob_max_rows() -> int:
    """Staging row watermark (``METRICS_TPU_INGEST_MAX_ROWS``, default 4096)."""
    return max(1, _psync._env_int("METRICS_TPU_INGEST_MAX_ROWS", 4096, owner=_MAX_ROWS_OWNER))


def _knob_max_bytes() -> int:
    """Staging byte watermark (``METRICS_TPU_INGEST_MAX_BYTES``, default 64 MiB)."""
    return max(1, _psync._env_int("METRICS_TPU_INGEST_MAX_BYTES", 64 << 20, owner=_MAX_BYTES_OWNER))


def _knob_flush_rows() -> int:
    """Auto-flush threshold in staged rows (``METRICS_TPU_INGEST_FLUSH_ROWS``, default 512)."""
    return max(1, _psync._env_int("METRICS_TPU_INGEST_FLUSH_ROWS", 512, owner=_FLUSH_ROWS_OWNER))


def _knob_degraded_factor() -> float:
    """Watermark factor while degraded (``METRICS_TPU_INGEST_DEGRADED_FACTOR``, default 0.5, in [0.01, 1])."""
    raw = _psync._env_float("METRICS_TPU_INGEST_DEGRADED_FACTOR", 0.5, owner=_DEGRADED_OWNER)
    return min(1.0, max(0.01, float(raw)))


def _knob_quarantine_cap() -> int:
    """Quarantine ring depth (``METRICS_TPU_INGEST_QUARANTINE_CAP``, default 16)."""
    return max(1, _psync._env_int("METRICS_TPU_INGEST_QUARANTINE_CAP", 16, owner=_QUARANTINE_OWNER))


def _knob_poison_nanfrac() -> float:
    """The non-finite fraction above which a float payload is poison
    (``METRICS_TPU_INGEST_POISON_NANFRAC``, default 0.5)."""
    raw = _psync._env_float("METRICS_TPU_INGEST_POISON_NANFRAC", 0.5, owner=_NANFRAC_OWNER)
    return min(1.0, max(0.0, float(raw)))


# ------------------------------------------------------------ column helpers
def _is_column(x: Any) -> bool:
    return hasattr(x, "dtype") and hasattr(x, "shape")


def _nbytes(c: Any) -> int:
    if isinstance(c, torch.Tensor):
        return c.numel() * c.element_size()
    return int(getattr(c, "nbytes", 0))


def _is_float(c: Any) -> bool:
    if isinstance(c, torch.Tensor):
        return c.dtype.is_floating_point
    return getattr(c.dtype, "kind", None) == "f"


def _concat(cols: List[Any]) -> Any:
    if any(isinstance(c, torch.Tensor) for c in cols):
        device = next(c.device for c in cols if isinstance(c, torch.Tensor))
        return torch.cat([torch.as_tensor(c, device=device) for c in cols])
    return np.concatenate([np.asarray(c) for c in cols])


def _take(c: Any, sel: np.ndarray) -> Any:
    if isinstance(c, torch.Tensor):
        return c.index_select(0, torch.from_numpy(sel).to(c.device))
    return np.asarray(c)[sel]


# -------------------------------------------------------------- staged payload
class _Segment:
    """One admitted payload's column references (concatenated once, at a flush)."""

    __slots__ = ("ids", "args", "kwargs", "rows", "nbytes", "coalesced")

    def __init__(self, ids, args, kwargs, rows, nbytes, coalesced):
        self.ids = ids
        self.args = args
        self.kwargs = kwargs
        self.rows = rows
        self.nbytes = nbytes
        self.coalesced = coalesced


class _StagedPayload:
    """One staging entry: segments of one schema fingerprint (degraded arena offers
    coalesce into an entry instead of adding one)."""

    __slots__ = ("key", "route", "priority", "segments", "rows", "nbytes")

    def __init__(self, key, route, priority):
        self.key = key
        self.route = route
        self.priority = priority
        self.segments: List[_Segment] = []
        self.rows = 0
        self.nbytes = 0

    def append(self, seg: _Segment) -> None:
        self.segments.append(seg)
        self.rows += seg.rows
        self.nbytes += seg.nbytes


def _occurrence_index(ids: np.ndarray) -> np.ndarray:
    """Each row's occurrence rank of its tenant id (0 for a tenant's first row in
    concatenation order, 1 for its second, ...). A flush issues one duplicate-free
    ``arena.update`` per rank, in order, so a tenant's rows apply in offer order."""
    occ = np.zeros(ids.size, dtype=np.int64)
    seen: Dict[int, int] = {}
    for i, tid in enumerate(ids.tolist()):
        k = seen.get(tid, 0)
        occ[i] = k
        seen[tid] = k + 1
    return occ


# ------------------------------------------------------------------ the gateway
class IngestGateway:
    """Admission-controlled front door for batched metric update payloads.

    ``target`` is a ``MetricArena`` (payloads carry ``tenant_ids``), a
    ``Mapping`` of suites (payloads carry ``route=<key>``), or anything with
    ``update()``. ``offer(*cols, tenant_ids=..., priority=..., route=..., **kwcols)``
    settles the payload at once, staged, coalesced, shed or quarantined, and
    returns ``{"outcome", "rows"}``; it never raises on a bad payload. The
    first valid payload of a route pins its schema fingerprint (dtypes,
    trailing shapes, keyword names); a mismatch later is quarantined.
    Constructor values take precedence over the ``METRICS_TPU_INGEST_*`` knobs.

    Example:
        >>> import numpy as np
        >>> from metrics_tpu_torch import MeanMetric, MetricArena, IngestGateway
        >>> arena = MetricArena(MeanMetric(device="cpu"), capacity=4, slab=4)
        >>> ids = arena.add(2)
        >>> gw = IngestGateway(arena, auto_flush=False)
        >>> out = gw.offer(np.asarray([[1.0], [3.0]], np.float32), tenant_ids=ids)
        >>> (out["outcome"], out["rows"])
        ('staged', 2)
        >>> gw.flush()["rows"]
        2
        >>> [round(float(v), 1) for v in arena.compute(ids)]
        [1.0, 3.0]
        >>> gw.close()
    """

    def __init__(
        self,
        target: Any,
        *,
        name: Optional[str] = None,
        auto_flush: bool = True,
        max_rows: Optional[int] = None,
        max_bytes: Optional[int] = None,
        flush_rows: Optional[int] = None,
        degraded_factor: Optional[float] = None,
        quarantine_cap: Optional[int] = None,
        poison_nanfrac: Optional[float] = None,
    ):
        from metrics_tpu_torch import arena as _arena

        self._target = target
        self._is_arena = isinstance(target, _arena.MetricArena)
        self._is_mapping = (not self._is_arena) and isinstance(target, Mapping)
        if not self._is_arena and not self._is_mapping and not callable(getattr(target, "update", None)):
            raise TypeError(
                "IngestGateway target must be a MetricArena, a Mapping of "
                f"suites, or expose update(); got {type(target).__name__}"
            )
        _NAME_SEQ[0] += 1
        self.name = name if name is not None else f"gw{_NAME_SEQ[0]}"
        self.auto_flush = bool(auto_flush)
        self.max_rows = int(max_rows) if max_rows is not None else _knob_max_rows()
        self.max_bytes = int(max_bytes) if max_bytes is not None else _knob_max_bytes()
        self.flush_rows = int(flush_rows) if flush_rows is not None else _knob_flush_rows()
        self.degraded_factor = float(degraded_factor) if degraded_factor is not None else _knob_degraded_factor()
        self.poison_nanfrac = float(poison_nanfrac) if poison_nanfrac is not None else _knob_poison_nanfrac()
        cap = int(quarantine_cap) if quarantine_cap is not None else _knob_quarantine_cap()
        self._quarantine: "deque[Dict[str, Any]]" = deque(maxlen=max(1, cap))
        self._staged: List[_StagedPayload] = []
        self._staged_by_key: Dict[Tuple[Any, ...], _StagedPayload] = {}
        self._pinned: Dict[Any, Tuple[Any, ...]] = {}  # route -> fingerprint
        self._staging_rows = 0
        self._staging_bytes = 0
        self._peak_bytes = 0
        # new slo_violations since this mark demote the lane; a clean flush walks back up
        self._slo_seen = int(_telemetry.slo_violations()["total"])
        self._closed = False
        _GATEWAYS.add(self)

    # ------------------------------------------------------------------ state
    @property
    def degraded(self) -> bool:
        return _faults.ladder(self, "ingest").demoted

    def state(self) -> Dict[str, Any]:
        """This gateway's gauges: staging occupancy, tier, quarantine depth."""
        lad = _faults.ladder(self, "ingest")
        return {
            "staging_rows": int(self._staging_rows),
            "staging_bytes": int(self._staging_bytes),
            "peak_bytes": int(self._peak_bytes),
            "staged_payloads": len(self._staged),
            "degraded": bool(lad.demoted),
            "quarantine_depth": len(self._quarantine),
            "pinned_schemas": len(self._pinned),
        }

    def quarantined(self) -> List[Dict[str, Any]]:
        """The quarantine ring, oldest first (reason, fingerprint, rows, error)."""
        return [dict(entry) for entry in self._quarantine]

    def _effective_limits(self) -> Tuple[int, int]:
        if _faults.ladder(self, "ingest").demoted:
            return (max(1, int(self.max_rows * self.degraded_factor)),
                    max(1, int(self.max_bytes * self.degraded_factor)))
        return self.max_rows, self.max_bytes

    # ------------------------------------------------------------- validation
    def _validate(self, route: Any, args: tuple, kwargs: dict, tenant_ids: Any):
        """Normalise and check one payload: ``(fingerprint, cols, kwcols, ids, rows,
        nbytes, error)``, with ``error`` a string so that poison settles and never raises."""
        try:
            cols = [a if _is_column(a) else np.asarray(a) for a in args]
            kwcols = {k: (kwargs[k] if _is_column(kwargs[k]) else np.asarray(kwargs[k])) for k in sorted(kwargs)}
        except (TypeError, ValueError) as err:
            return None, (), {}, None, 0, 0, f"non-array column: {err}"
        every = cols + list(kwcols.values())
        if not every:
            return None, (), {}, None, 0, 0, "empty payload (no columns)"
        for c in every:
            if getattr(c.dtype, "kind", None) == "O":
                return None, (), {}, None, 0, 0, f"non-numeric column dtype {c.dtype}"
            if len(c.shape) < 1:
                return None, (), {}, None, 0, 0, "scalar column (payloads are batched: ndim >= 1)"
        rows = int(every[0].shape[0])
        nbytes = 0
        for c in every:
            if int(c.shape[0]) != rows:
                return None, cols, kwcols, None, rows, 0, f"ragged leading axis: {int(c.shape[0])} != {rows}"
            nbytes += _nbytes(c)
        ids = None
        if self._is_arena:
            if tenant_ids is None:
                return None, cols, kwcols, None, rows, nbytes, "arena target requires tenant_ids"
            try:
                if isinstance(tenant_ids, torch.Tensor):
                    tenant_ids = tenant_ids.cpu().numpy()
                ids = np.asarray(tenant_ids, dtype=np.int64).ravel()
            except (TypeError, ValueError) as err:
                return None, cols, kwcols, None, rows, nbytes, f"bad tenant_ids: {err}"
            if int(ids.size) != rows:
                return None, cols, kwcols, None, rows, nbytes, f"tenant_ids length {int(ids.size)} != payload rows {rows}"
            if rows and int(ids.min()) < 0:
                return None, cols, kwcols, None, rows, nbytes, "negative tenant id"
            nbytes += int(ids.nbytes)
        elif tenant_ids is not None:
            return None, cols, kwcols, None, rows, nbytes, "tenant_ids only routes to MetricArena targets"
        if self._is_mapping and route not in self._target:
            return None, cols, kwcols, ids, rows, nbytes, f"unknown route {route!r}"
        fp = (
            route,
            len(cols),
            tuple((str(c.dtype), tuple(int(d) for d in c.shape[1:])) for c in every),
            tuple(kwcols),
            self._is_arena,
        )
        return fp, tuple(cols), kwcols, ids, rows, nbytes, None

    def _nonfinite_fraction(self, cols, kwcols) -> float:
        total = bad = 0
        for c in list(cols) + list(kwcols.values()):
            if not _is_float(c):
                continue
            if isinstance(c, torch.Tensor):
                size, finite = c.numel(), int(torch.isfinite(c).sum())
            else:
                try:
                    x = np.asarray(c)
                    size, finite = x.size, int(np.isfinite(x).sum())
                except (TypeError, ValueError):
                    continue  # a dtype numpy cannot test: unchecked, not poison
            total += size
            bad += size - finite
        return (bad / total) if total else 0.0

    # ------------------------------------------------------------- settlement
    def _settle_quarantine(self, rows: int, fp: Any, reason: str, exc: Optional[BaseException] = None,
                           domain: Optional[str] = None) -> Dict[str, Any]:
        """Land a poison payload in the quarantine ring: classified, counted, warned once."""
        error = exc if exc is not None else IngestFault(reason, site="ingest-admit")
        dom = domain if domain is not None else _faults.classify(error, "ingest")
        _faults.note_fault(dom, site="ingest-admit", owner=self, error=error)
        _faults.warn_fault(
            self, dom,
            f"ingest gateway {self.name!r} quarantined a poison payload "
            f"({rows} row(s)): {reason}. The target never saw it; inspect "
            f"IngestGateway.quarantined().",
        )
        if len(self._quarantine) == self._quarantine.maxlen:
            _counters["ingest_quarantine_evictions"] += 1
        self._quarantine.append({"reason": reason, "rows": int(rows), "fingerprint": repr(fp),
                                 "error": f"{type(error).__name__}: {error}"})
        _counters["ingest_quarantined_rows"] += int(rows)
        _counters["ingest_quarantined_payloads"] += 1
        return {"outcome": "quarantined", "rows": int(rows), "reason": reason}

    def _settle_shed(self, rows: int, payloads: int, reason: str, exc: Optional[BaseException] = None,
                     domain: Optional[str] = None) -> Dict[str, Any]:
        """Count rows dropped under overload (site ``ingest-shed``), warned once."""
        error = exc if exc is not None else IngestFault(reason, site="ingest-shed")
        dom = domain if domain is not None else _faults.classify(error, "ingest")
        _faults.note_fault(dom, site="ingest-shed", owner=self, error=error)
        _faults.warn_fault(
            self, dom,
            f"ingest gateway {self.name!r} is shedding load ({rows} row(s)): "
            f"{reason}. Sheds are counted exactly in ingest_shed_rows.",
        )
        _counters["ingest_shed_rows"] += int(rows)
        _counters["ingest_shed_payloads"] += int(payloads)
        return {"outcome": "shed", "rows": int(rows), "reason": reason}

    def _evict_lowest(self, floor_priority: int) -> bool:
        """Shed the lowest-priority staged payload below ``floor_priority``; False if none."""
        victim = None
        for p in self._staged:
            if p.priority < floor_priority and (victim is None or p.priority < victim.priority):
                victim = p
        if victim is None:
            return False
        self._staged.remove(victim)
        self._staged_by_key.pop(victim.key, None)
        self._staging_rows -= victim.rows
        self._staging_bytes -= victim.nbytes
        self._settle_shed(victim.rows, 1, f"staged priority-{victim.priority} payload evicted for "
                                          f"priority-{floor_priority} arrival under watermark pressure")
        return True

    # ------------------------------------------------------------------ offer
    def offer(self, *args: Any, tenant_ids: Any = None, priority: int = 0, route: Any = None,
              **kwargs: Any) -> Dict[str, Any]:
        """Offer one batched payload; returns its settlement at once.

        The columns are what the target's ``update()`` takes, rows on the
        leading axis. An arena's ``tenant_ids`` route each row (duplicates are
        fine: a flush splits them into duplicate-free updates); a Mapping's
        ``route`` picks the suite. A higher ``priority`` displaces staged
        lower-priority load when a watermark binds."""
        t0 = _telemetry.now() if _telemetry.armed else 0.0
        _counters["ingest_offered"] += 1
        fp, cols, kwcols, ids, rows, nbytes, error = self._validate(route, args, kwargs, tenant_ids)
        _counters["ingest_offered_rows"] += int(rows)
        if self._closed:
            return self._settle_shed(rows, 1, "gateway is closed")
        out = self._admit(fp, cols, kwcols, ids, rows, nbytes, error, priority=int(priority), route=route)
        if t0 and _telemetry.armed:
            _telemetry.emit(
                "ingest-offer", self.name, "ingest", t0, _telemetry.now() - t0,
                {"outcome": out["outcome"], "rows": int(rows), "staged_rows": int(self._staging_rows),
                 "degraded": bool(_faults.ladder(self, "ingest").demoted)},
            )
        return out

    def _admit(self, fp, cols, kwcols, ids, rows, nbytes, error, *, priority: int, route: Any) -> Dict[str, Any]:
        if _faults.armed:
            try:
                _faults.maybe_fail("ingest-admit")
            except Exception as exc:  # an injected admission fault settles as poison
                return self._settle_quarantine(rows, fp, "injected admission fault", exc,
                                               domain=_faults.classify(exc, "ingest"))
        if error is not None:
            return self._settle_quarantine(rows, fp, error)
        pinned = self._pinned.get(route)
        if pinned is None:
            _counters["ingest_schema_validations"] += 1  # the one full check this schema pays
            self._pinned[route] = fp
        elif fp != pinned:
            return self._settle_quarantine(rows, fp, "schema mismatch against the pinned fingerprint")
        if self.poison_nanfrac < 1.0:
            frac = self._nonfinite_fraction(cols, kwcols)
            if frac > self.poison_nanfrac:
                return self._settle_quarantine(rows, fp, f"NaN/Inf storm ({frac:.0%} non-finite)")
        # SLO backpressure: new violations demote the ingest lane
        lad = _faults.ladder(self, "ingest")
        slo_total = int(_telemetry.slo_violations()["total"])
        if slo_total > self._slo_seen:
            self._slo_seen = slo_total
            lad.demote("ingest", to="chunked")
            _faults.warn_fault(
                self, "ingest",
                f"ingest gateway {self.name!r} entered the degraded tier: SLO "
                f"budget violations reached {slo_total} — coalescing first, "
                "shedding lowest-priority load, never growing the tail.",
            )
        degraded = lad.demoted
        if degraded:
            _counters["ingest_degraded_offers"] += 1
        eff_rows, eff_bytes = self._effective_limits()
        key = (route, fp, priority)
        coalesce_into = self._staged_by_key.get(key) if (degraded and self._is_arena) else None
        # make room: evict lower-priority staged load, then (normal tier) flush, then shed the arrival
        while self._staging_rows + rows > eff_rows or self._staging_bytes + nbytes > eff_bytes:
            if self._evict_lowest(priority):
                coalesce_into = self._staged_by_key.get(key) if (degraded and self._is_arena) else None
                continue
            if self.auto_flush and self._staged and not degraded:
                self.flush()
                coalesce_into = None
                continue
            break
        if self._staging_rows + rows > eff_rows or self._staging_bytes + nbytes > eff_bytes:
            tier = "degraded" if degraded else "normal"
            return self._settle_shed(rows, 1, f"staging watermark exceeded ({tier} tier: "
                                              f"{eff_rows} rows / {eff_bytes} bytes)")
        coalesced = coalesce_into is not None
        seg = _Segment(ids, cols, kwcols, rows, nbytes, coalesced)
        if coalesced:
            coalesce_into.append(seg)
        else:
            payload = _StagedPayload(key, route, priority)
            payload.append(seg)
            self._staged.append(payload)
            self._staged_by_key[key] = payload
        self._staging_rows += rows
        self._staging_bytes += nbytes
        if self._staging_bytes > self._peak_bytes:
            self._peak_bytes = self._staging_bytes
        if self.auto_flush and self._staging_rows >= self.flush_rows:
            self.flush()
        return {"outcome": "coalesced" if coalesced else "staged", "rows": int(rows)}

    # ------------------------------------------------------------------ flush
    def flush(self) -> Dict[str, int]:
        """Drain staging into the target in offer order. Never raises: a target
        failure counts a fault, quarantines that payload, and the drain goes on.
        A clean drain with no new SLO violations walks the ladder's recovery edge."""
        if not self._staged:
            return {"dispatches": 0, "rows": 0}
        t0 = _telemetry.now() if _telemetry.armed else 0.0
        _counters["ingest_flushes"] += 1
        staged, self._staged = self._staged, []
        self._staged_by_key = {}
        dispatches = 0
        flushed_rows = 0
        clean = True
        for payload in staged:
            self._staging_rows -= payload.rows
            self._staging_bytes -= payload.nbytes
            try:
                if _faults.armed:
                    _faults.maybe_fail("ingest-shed")
                dispatches += self._dispatch(payload)
            except Exception as exc:  # a target or apply fault: settle it, keep draining
                clean = False
                _counters["ingest_apply_faults"] += 1
                self._settle_quarantine(payload.rows, payload.key[1], "flush-time apply fault", exc,
                                        domain=_faults.classify(exc, "ingest"))
                continue
            for seg in payload.segments:
                _counters["ingest_coalesced_rows" if seg.coalesced else "ingest_admitted_rows"] += seg.rows
            _counters["ingest_admitted_payloads"] += 1
            flushed_rows += payload.rows
        _counters["ingest_flush_dispatches"] += dispatches
        lad = _faults.ladder(self, "ingest")
        if lad.demoted and clean:
            slo_total = int(_telemetry.slo_violations()["total"])
            if slo_total <= self._slo_seen and lad.note_clean():
                lad.promote()
        if t0 and _telemetry.armed:
            _telemetry.emit("ingest-flush", self.name, "ingest", t0, _telemetry.now() - t0,
                            {"dispatches": dispatches, "rows": flushed_rows, "payloads": len(staged)})
        return {"dispatches": dispatches, "rows": flushed_rows}

    def _dispatch(self, payload: _StagedPayload) -> int:
        """Route one staged payload into the target. An arena's segments are
        concatenated (the gateway's one copy) and go in one duplicate-free
        ``arena.update`` per occurrence rank; a suite's replay segment by segment."""
        if self._is_arena:
            segs = payload.segments
            if len(segs) == 1:
                ids, cols, kwcols = segs[0].ids, segs[0].args, segs[0].kwargs
            else:
                ids = np.concatenate([s.ids for s in segs])
                cols = tuple(_concat([s.args[j] for s in segs]) for j in range(len(segs[0].args)))
                kwcols = {k: _concat([s.kwargs[k] for s in segs]) for k in segs[0].kwargs}
            occ = _occurrence_index(ids)
            calls = 0
            for level in range(int(occ.max()) + 1 if occ.size else 0):
                sel = np.flatnonzero(occ == level)
                if not sel.size:
                    continue
                self._target.update(ids[sel], *[_take(c, sel) for c in cols],
                                    **{k: _take(v, sel) for k, v in kwcols.items()})
                calls += 1
            return calls
        target = self._target[payload.route] if self._is_mapping else self._target
        calls = 0
        for seg in payload.segments:
            target.update(*seg.args, **seg.kwargs)
            calls += 1
        return calls

    # ------------------------------------------------------------------ close
    def close(self) -> None:
        """Settle still-staged rows as shed and retire the gateway (no row leaves the books)."""
        if self._closed:
            return
        self._closed = True
        if self._staged:
            rows = sum(p.rows for p in self._staged)
            payloads = len(self._staged)
            self._staged = []
            self._staged_by_key = {}
            self._staging_rows = 0
            self._staging_bytes = 0
            self._settle_shed(rows, payloads, "gateway closed with staged rows")
        _GATEWAYS.discard(self)

    def __del__(self):  # pragma: no cover - interpreter teardown, best effort
        try:
            if not self._closed and self._staged:
                _counters["ingest_shed_rows"] += sum(p.rows for p in self._staged)
                _counters["ingest_shed_payloads"] += len(self._staged)
        except Exception:  # noqa: BLE001 - no fault plumbing is left at teardown
            pass
