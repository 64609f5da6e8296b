"""Fleet observability: cross-rank snapshots, straggler attribution, merged multi-rank traces.

JAX counterpart: `metrics_tpu/ops/fleetobs.py`, ported with the same faces,
schema, merge rules and exposition:

- :func:`fleet_snapshot`: one epoch-fenced, deadline-guarded, retried blob
  gather of every rank's JSON-serialised ``telemetry_snapshot()``, merged into
  per-rank planes, aggregate planes (counters summed exactly, gauges
  min/median/max, the latency histograms merged by exact bucket sums with
  fleet percentiles re-interpolated from the merged buckets:
  :func:`merge_latency_stats`), dead-rank placeholders from the membership
  registry, the straggler report and ``world_health()``. In a world of one
  process the local plane is served directly, with zero collectives.
- :func:`straggler_report`: the slowest ranks per sync phase, by mean and by
  p95, with deviation-from-median scores; :func:`fleet_prometheus_text`
  renders the fleet view with ``rank`` and ``phase`` labels.
- :func:`export_fleet_trace`: the span rings gathered, aligned on paired
  payload-gather spans, one Perfetto process per rank.

The gather (:func:`_gather_blobs`, span site ``fleet-gather``) runs over the
port's sync planes: the metadata seam ``parallel.bucketing._host_allgather``
in the survivors' group while peers are declared dead, over Gloo on the CPU
or NCCL on the card (whose tensors then live on the current device), with
the sync planes' retry budget, deadline, epoch fence and ``sync-gather``
fault site.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.ops import telemetry as _telemetry

__all__ = [
    "FLEET_SCHEMA",
    "export_fleet_trace",
    "fleet_perf_report",
    "fleet_prometheus_text",
    "fleet_snapshot",
    "fleet_stats",
    "fleet_world",
    "local_rank",
    "merge_latency_stats",
    "merge_snapshots",
    "reset_fleet_stats",
    "straggler_report",
    "straggler_threshold",
]

#: Bumped only on breaking key changes to the :func:`fleet_snapshot` schema.
FLEET_SCHEMA = 1

# ------------------------------------------------------------------ counters
_counters: Dict[str, int] = {
    "fleet_snapshots": 0,
    "fleet_trace_exports": 0,
    "fleet_gathers": 0,
    "fleet_gather_bytes": 0,
}


def fleet_stats() -> Dict[str, int]:
    """Fleet-plane counters (surfaced inside :func:`fleet_snapshot`)."""
    return dict(_counters)


def reset_fleet_stats() -> None:
    for key in _counters:
        _counters[key] = 0


_telemetry.register_reset("fleetobs", reset_fleet_stats)


class _FleetWarnOwner:
    """Warn-dedupe anchor for fleet env-knob / merge warnings."""


_THRESHOLD_WARN_OWNER = _FleetWarnOwner()
_MERGE_WARN_OWNER = _FleetWarnOwner()
# distinct owner: the snapshot row-count warning and the trace dropped-row
# warning are different conditions — sharing one warn_fault slot would let
# whichever fires first permanently suppress the other
_TRACE_DROP_WARN_OWNER = _FleetWarnOwner()

#: Keys that are monotonic counters on ONE rank but must NOT sum across the
#: fleet: every rank carries the same kind of event axis, and "3 ranks at
#: step 100" is step skew (a min/median/max gauge signal), not 300 events.
FLEET_GAUGE_KEYS = frozenset({"monotonic_step"})


def _fleet_is_counter(key: str) -> bool:
    """The fleet-merge counter predicate: :func:`telemetry.is_counter_key`
    (the Prometheus-typing predicate) minus :data:`FLEET_GAUGE_KEYS` — the
    keys whose cross-rank sum is meaningless."""
    return _telemetry.is_counter_key(key) and key not in FLEET_GAUGE_KEYS


# ------------------------------------------------------------------ the world
def fleet_world() -> int:
    """The world the fleet plane gathers over: the live process count, or the
    membership registry's known (declared or transition-promoted) world when
    that is larger — a degraded cohort keeps its original rank numbering, and
    simulated/fake worlds declare themselves via ``set_expected_world``. A
    plain single process with no known world is a fleet of one: every face
    serves the local plane with ZERO collectives."""
    from metrics_tpu_torch.parallel import sync as _sync

    return max(_sync.world_size(), _sync._membership.known_world or 1)


def local_rank() -> int:
    """This process's rank in the fleet (0 in a single-process world)."""
    from metrics_tpu_torch.parallel import sync as _sync

    if _sync.distributed_available():
        return int(torch.distributed.get_rank())
    return 0


def straggler_threshold() -> float:
    """Deviation-from-median above which a rank is flagged as a straggler
    (``METRICS_TPU_STRAGGLER_THRESHOLD``, default 0.5 — 50% slower than the
    fleet median for some sync phase). An unparseable value warns once and
    uses the default."""
    from metrics_tpu_torch.parallel import sync as _sync

    return max(
        0.0, _sync._env_float("METRICS_TPU_STRAGGLER_THRESHOLD", 0.5, owner=_THRESHOLD_WARN_OWNER)
    )


def _participant_ranks(world: int, dead: Any) -> List[int]:
    """The ranks a host gather's rows map to: survivors ascending (the
    re-formed-transport convention — see ``sync.surviving_members``)."""
    dead = set(int(r) for r in (dead or ()))
    return [r for r in range(world) if r not in dead]


# ------------------------------------------------------------------ transport
def _transport() -> Tuple[Optional[Any], torch.device]:
    """The group a fleet gather runs in (the survivors while peers are declared dead,
    else every process) and the device its tensors live on (the card under NCCL)."""
    from metrics_tpu_torch.parallel import sync as _sync

    members = _sync.surviving_members()
    group = _sync.transport_group(members, members) if members is not None and _sync._live() else None
    on_card = _sync._live() and torch.distributed.get_backend(group) == "nccl"
    return group, torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")


def _gather_blobs(blob: bytes, *, owner: Any = None, site: str = "fleet-gather") -> List[bytes]:
    """All-gather one variable-length byte blob from every rank.

    Two host exchanges (a length vector, then the max-length-padded payload)
    riding the port's collective-protocol ladder: in-flight asynchronous syncs
    land first, the epoch fence is captured at entry and re-checked inside the
    retried closure before each issue (which fires the ``sync-gather`` fault
    site), every exchange runs under the watchdog deadline, and both
    collective slots are counted against the fence. Returns one ``bytes``
    entry per gather row (row order = survivors ascending). In a world of one
    process nothing is exchanged: the caller's own blob comes back."""
    from metrics_tpu_torch.ops import faults as _faults
    from metrics_tpu_torch.parallel import bucketing as _bucketing
    from metrics_tpu_torch.parallel import sync as _sync

    # collectives pair by issue order: any in-flight async sync must land first
    _sync.drain_inflight()
    fence = _sync.world_epoch()
    t0 = _telemetry.now() if _telemetry.armed else 0.0
    group, device = _transport()
    local = torch.frombuffer(bytearray(blob), dtype=torch.uint8) if blob else torch.zeros(0, dtype=torch.uint8)

    def _attempt() -> List[bytes]:
        _sync.check_epoch(fence, site=site, owner=owner)
        if _faults.armed:
            _faults.maybe_fail("sync-gather")
        lengths_rows = _sync.run_with_deadline(
            lambda: _bucketing._host_allgather(torch.tensor([len(blob)], dtype=torch.int64, device=device), group),
            site=site,
        )
        _sync.note_collective("shape", epoch=fence)
        lengths = lengths_rows.reshape(lengths_rows.shape[0], -1)[:, 0].cpu().tolist()
        max_len = max(1, int(max(lengths)))
        padded = torch.zeros(max_len, dtype=torch.uint8)
        padded[: len(blob)] = local
        rows = _sync.run_with_deadline(lambda: _bucketing._host_allgather(padded.to(device), group), site=site)
        rows = rows.reshape(rows.shape[0], -1).cpu()
        _sync.note_collective("payload", nbytes=int(rows.numel()), epoch=fence)
        n = min(rows.shape[0], len(lengths))
        return [rows[i, : int(lengths[i])].numpy().tobytes() for i in range(n)]

    out = _faults.retry_with_backoff(
        _attempt,
        attempts=_sync.sync_retries(),
        base_delay_s=_sync.sync_backoff_s(),
        owner=owner,
        site=site,
    )
    _counters["fleet_gathers"] += 1
    _counters["fleet_gather_bytes"] += sum(len(b) for b in out)
    if t0 and _telemetry.armed:
        _telemetry.emit(
            "fleet-gather", owner, "sync", t0, _telemetry.now() - t0,
            {"rows": len(out), "bytes": sum(len(b) for b in out), "epoch": fence},
        )
    return out


def _local_plane_text() -> str:
    """This rank's snapshot plane as its wire JSON: ``telemetry_snapshot()``
    minus the ``failure_log`` ring (per-entry error strings belong to the
    local trace, not the fleet gather — the per-domain counts already travel
    inside ``sync_health.fault_domain_counts``). The gather blob and the
    local plane both come from this ONE serialization, so they are
    byte-identical by construction."""
    snap = _telemetry.snapshot()
    plane = {k: v for k, v in snap.items() if k != "failure_log"}
    return json.dumps(_telemetry._json_safe(plane), separators=(",", ":"))


def _local_plane() -> Dict[str, Any]:
    return json.loads(_local_plane_text())


def _is_live_plane(plane: Any) -> bool:
    return isinstance(plane, dict) and not plane.get("dead") and not plane.get("missing") and not plane.get("corrupt")


# ------------------------------------------------------------------ the merge
def _median(values: List[float]) -> float:
    vals = sorted(values)
    n = len(vals)
    if not n:
        return 0.0
    mid = n // 2
    return float(vals[mid]) if n % 2 else float(vals[mid - 1] + vals[mid]) / 2.0


def merge_latency_stats(planes: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Merge the per-rank full-lifetime latency histogram planes
    (``latency_stats`` blocks) into one fleet histogram per site. Bucket
    counts, ``count`` and ``sum_s`` are plain counters on a SHARED bucket
    layout, so the merge is an EXACT sum — no min/median/max approximation,
    unlike the ring-windowed ``sync_phase_stats`` gauges. ``max_s`` maxes,
    and the fleet percentiles are re-interpolated from the MERGED bucket
    counts (never averaged across ranks — an average of per-rank p99s is
    not a fleet p99). Dead/missing/corrupt placeholder planes are excluded."""
    merged: Dict[str, _telemetry.LatencyHistogram] = {}
    known = set(_telemetry._HIST_LABELS)
    for _, plane in sorted(planes.items()):
        if not _is_live_plane(plane):
            continue
        for site, block in (plane.get("latency_stats") or {}).items():
            if not isinstance(block, dict):
                continue
            buckets = block.get("buckets") or {}
            if not set(buckets) <= known:
                # a mixed-version fleet shipped a DIFFERENT bucket layout:
                # merging its sums while dropping its unknown buckets would
                # corrupt the exact-sum contract silently — skip the block
                # whole and warn once (no-silent-caps)
                from metrics_tpu_torch.ops import faults as _faults

                _faults.warn_fault(
                    _MERGE_WARN_OWNER,
                    "fleet-merge-layout",
                    f"A rank's {site!r} latency histogram carries bucket labels "
                    "outside this build's layout (a mixed-version fleet?); its "
                    "block is excluded from the fleet merge rather than summed "
                    "inconsistently.",
                )
                continue
            h = merged.setdefault(site, _telemetry.LatencyHistogram())
            for i, label in enumerate(_telemetry._HIST_LABELS):
                h.counts[i] += int(buckets.get(label, 0))
            h.sum_s += float(block.get("sum_s", 0.0))
            h.max_s = max(h.max_s, float(block.get("max_s", 0.0)))
    return {site: merged[site].stats() for site in sorted(merged)}


def merge_snapshots(planes: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce per-rank snapshot planes into the aggregate plane: every
    flattened numeric key classified by the SAME predicate the Prometheus
    exposition types with (:func:`metrics_tpu_torch.ops.telemetry.is_counter_key`)
    — **counters summed exactly** (the dryrun certification pins aggregate ==
    sum of per-rank), gauges reduced to ``min``/``median``/``max``. The
    shared-monotonic-axis keys (:data:`FLEET_GAUGE_KEYS`) reduce as gauges —
    cross-rank step skew is the signal, a sum would be noise. The latency
    histogram planes additionally merge structurally under ``latency_stats``
    (exact bucket sums + fleet percentiles re-interpolated from the merged
    buckets — :func:`merge_latency_stats`). Dead / missing / corrupt
    placeholder planes are excluded."""
    counters: Dict[str, float] = {}
    gauge_values: Dict[str, List[float]] = {}
    merged_ranks: List[int] = []
    for rank, plane in sorted(planes.items()):
        if not _is_live_plane(plane):
            continue
        merged_ranks.append(rank)
        # the latency histogram plane merges STRUCTURALLY below (exact bucket
        # sums, percentiles re-interpolated); flattening it here too would
        # duplicate the bucket counters and min/median/max the per-rank
        # percentiles — the meaningless reduction this module exists to avoid
        numeric = {
            k: v
            for k, v in plane.items()
            if k not in ("failure_log", _telemetry._HIST_SNAPSHOT_KEY)
        }
        for key, value in _telemetry._flat_numeric("", numeric):
            if _fleet_is_counter(key):
                counters[key] = counters.get(key, 0) + value
            else:
                gauge_values.setdefault(key, []).append(value)
    # integer counters stay integers (floats are exact below 2**53; a fleet
    # of byte counters sums well inside that)
    counters_out: Dict[str, Any] = {
        k: int(v) if float(v).is_integer() else v for k, v in sorted(counters.items())
    }
    gauges_out: Dict[str, Dict[str, float]] = {
        k: {"min": float(min(v)), "median": _median(v), "max": float(max(v))}
        for k, v in sorted(gauge_values.items())
    }
    return {
        "counters": counters_out,
        "gauges": gauges_out,
        "latency_stats": merge_latency_stats(planes),
        "ranks_merged": merged_ranks,
    }


def merge_streaming(planes: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Merge the per-rank ``streaming`` snapshot blocks (the model-monitoring
    plane — ``metrics_tpu_torch.streaming``) into one fleet view.

    Window values are **fleet-agreed** (a close merges the stride state
    through one payload collective before packing, so every live rank's
    block for a given close id is identical) — the merge takes the first
    live rank's block per window rather than re-reducing, and spends its
    effort on the one thing that CAN differ: the window id each rank has
    reached. ``window_skew`` attributes that — per window name, the agreed
    (max) id, the max cross-rank skew, and each rank's lag behind the
    agreed id. A rank lagging its peers' window ids is a rank whose close
    loop stalled — the streaming twin of the straggler report."""
    windows: Dict[str, Dict[str, Any]] = {}
    drift: Dict[str, Dict[str, float]] = {}
    arenas: Dict[str, Dict[str, Any]] = {}
    per_rank_ids: Dict[str, Dict[int, int]] = {}
    for rank, plane in sorted(planes.items()):
        if not _is_live_plane(plane):
            continue
        block = plane.get("streaming")
        if not isinstance(block, dict):
            continue
        for name, win in (block.get("windows") or {}).items():
            if not isinstance(win, dict):
                continue
            windows.setdefault(name, win)
            try:
                per_rank_ids.setdefault(name, {})[rank] = int(win.get("window", 0))
            except (TypeError, ValueError):
                continue
        for name, scores in (block.get("drift") or {}).items():
            if isinstance(scores, dict):
                drift.setdefault(name, scores)
        # arena blocks ride the same first-live-rank discipline as window
        # values: every rank publishing an arena name holds that arena's
        # own state, and duplicate names across ranks are the same logical
        # arena restored fleet-wide
        for name, arena in (block.get("arenas") or {}).items():
            if isinstance(arena, dict):
                arenas.setdefault(name, arena)
    window_skew: Dict[str, Dict[str, Any]] = {}
    for name, ids in sorted(per_rank_ids.items()):
        agreed = max(ids.values())
        window_skew[name] = {
            "agreed": agreed,
            "max_skew": agreed - min(ids.values()),
            "per_rank_lag": {r: agreed - wid for r, wid in sorted(ids.items())},
        }
    return {"windows": windows, "drift": drift, "arenas": arenas, "window_skew": window_skew}


def straggler_report(planes: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Name the slowest ranks per sync phase, with deviation scores — both
    mean-based and **tail-aware**.

    Each live plane carries two per-phase latency views: the ring-windowed
    ``sync_phase_stats`` means and the full-lifetime ``latency_stats``
    percentiles. For every phase with data the report records the per-rank
    means, the fleet median, the slowest rank and its deviation
    ``(mean - median) / median`` — and, beside it, the per-rank **p95**
    latencies with the analogous tail deviation ``(p95 - median_p95) /
    median_p95`` (a rank whose mean looks fine but whose tail is 10x the
    fleet's is exactly the straggler the mean hides). ``stragglers`` lists
    the ranks whose worst deviation on EITHER measure exceeds
    :func:`straggler_threshold`, worst first; ``ranked`` orders every
    attributed rank the same way, naming the measure that flagged it."""
    live = {
        r: p
        for r, p in planes.items()
        if _is_live_plane(p) and isinstance(p.get("sync_phase_stats"), dict)
    }
    threshold = straggler_threshold()
    phases: Dict[str, Dict[str, Any]] = {}
    worst: Dict[int, Tuple[float, str, str]] = {}

    def _attribute(deviations: Dict[int, float], site: str, measure: str) -> None:
        for r, d in deviations.items():
            if r not in worst or d > worst[r][0]:
                worst[r] = (d, site, measure)

    for site in _telemetry.SYNC_PHASE_SITES:
        per_rank = {}
        per_rank_p95 = {}
        for r, plane in live.items():
            block = (plane.get("sync_phase_stats") or {}).get(site) or {}
            if float(block.get("count", 0)) > 0:
                per_rank[r] = float(block.get("mean_s", 0.0))
            lat = (plane.get("latency_stats") or {}).get(site) or {}
            if float(lat.get("count", 0)) > 0:
                per_rank_p95[r] = float(lat.get("p95_s", 0.0))
        entry: Dict[str, Any] = {
            "per_rank_mean_s": per_rank,
            "median_s": 0.0,
            "slowest_rank": None,
            "slowest_mean_s": 0.0,
            "deviation": 0.0,
            "per_rank_deviation": {},
            # the tail-aware plane (full-lifetime histogram p95 per rank)
            "per_rank_p95_s": per_rank_p95,
            "p95_median_s": 0.0,
            "tail_slowest_rank": None,
            "tail_deviation": 0.0,
            "per_rank_tail_deviation": {},
        }
        if per_rank:
            med = _median(list(per_rank.values()))
            deviations = {
                r: (v - med) / max(med, 1e-12) for r, v in per_rank.items()
            }
            slowest = max(per_rank, key=lambda r: per_rank[r])
            entry.update(
                median_s=med,
                slowest_rank=slowest,
                slowest_mean_s=per_rank[slowest],
                deviation=deviations[slowest],
                per_rank_deviation=deviations,
            )
            _attribute(deviations, site, "mean_s")
        if per_rank_p95:
            med95 = _median(list(per_rank_p95.values()))
            tail_devs = {
                r: (v - med95) / max(med95, 1e-12) for r, v in per_rank_p95.items()
            }
            tail_slowest = max(per_rank_p95, key=lambda r: per_rank_p95[r])
            entry.update(
                p95_median_s=med95,
                tail_slowest_rank=tail_slowest,
                tail_deviation=tail_devs[tail_slowest],
                per_rank_tail_deviation=tail_devs,
            )
            _attribute(tail_devs, site, "p95_s")
        phases[site] = entry
    ranked = [
        {"rank": r, "phase": site, "deviation": d, "measure": measure}
        for r, (d, site, measure) in sorted(worst.items(), key=lambda kv: -kv[1][0])
    ]
    return {
        "phases": phases,
        "ranked": ranked,
        "threshold": threshold,
        "stragglers": [row["rank"] for row in ranked if row["deviation"] >= threshold],
    }


# ------------------------------------------------------------------ the faces
def fleet_snapshot() -> Dict[str, Any]:
    """ONE merged fleet monitoring dict — the cross-rank face of
    ``telemetry_snapshot()``.

    In a multi-rank world, every rank's JSON-serialized snapshot rides one
    epoch-fenced, deadline-guarded blob gather (two collective slots: a
    length exchange + the padded payload — see :func:`_gather_blobs`) —
    a **collective**: every live rank must call it in lockstep, like
    ``sync()`` or ``checkpoint_barrier()``, so invoke it from the
    coordinated serving/eval loop, never from an unsynchronized per-rank
    poller. With a world size of 1 the local plane is served directly and
    **zero collectives are issued**. Keys:

    - ``fleet_schema`` — :data:`FLEET_SCHEMA`; bumped on breaking changes.
    - ``world_size`` / ``rank`` / ``epoch`` / ``gathered``.
    - ``ranks`` — per-rank planes keyed by rank: each live rank's snapshot
      (minus the ``failure_log`` ring); declared-dead ranks get a
      ``{"dead": True, ...}`` placeholder sourced from the membership
      registry; ranks the gather could not produce a row for get
      ``{"missing": True}``; an undecodable row gets ``{"corrupt": True}``.
    - ``aggregate`` — :func:`merge_snapshots` over the live planes
      (counters summed exactly; gauges min/median/max).
    - ``stragglers`` — :func:`straggler_report`.
    - ``streaming`` — :func:`merge_streaming`: the model-monitoring plane
      (fleet-agreed window values, drift scores, per-rank window-skew
      attribution).
    - ``world_health`` — the membership registry surface, folded in.
    - ``fleet_stats`` — this plane's own counters.

    Example:
        >>> from metrics_tpu_torch import fleet_snapshot
        >>> snap = fleet_snapshot()     # single process: local plane only
        >>> snap["fleet_schema"]
        1
        >>> snap["rank"] in snap["ranks"]
        True
    """
    from metrics_tpu_torch.parallel import sync as _sync

    t0 = _telemetry.now() if _telemetry.armed else 0.0
    wh = _sync.world_health()
    world = fleet_world()
    rank = local_rank()
    dead = set(wh.get("dead_ranks") or ())
    plane_text = _local_plane_text()
    gathered = False
    planes: Dict[int, Dict[str, Any]] = {}
    if world > 1:
        # the local plane arrives back through its own gather row — no
        # second parse of the multi-KB snapshot on the collective path
        payloads = _gather_blobs(plane_text.encode("utf-8"), site="fleet-snapshot")
        participants = _participant_ranks(world, dead)
        if len(payloads) != len(participants):
            # a row count the registry did not predict (e.g. a fake world
            # narrower than the declared one): map rows positionally and
            # mark the unaccounted-for live ranks missing
            from metrics_tpu_torch.ops import faults as _faults

            _faults.warn_fault(
                _MERGE_WARN_OWNER,
                "sync",
                f"fleet_snapshot gathered {len(payloads)} row(s) but the membership "
                f"registry expects {len(participants)} live rank(s) of {world}; mapping "
                "rows to the lowest live ranks and marking the rest missing.",
            )
        for r, raw in zip(participants, payloads):
            try:
                decoded = json.loads(raw.decode("utf-8"))
                if not isinstance(decoded, dict):
                    raise ValueError(f"rank plane must be an object, got {type(decoded).__name__}")
                planes[r] = decoded
            except (ValueError, UnicodeDecodeError):
                planes[r] = {"corrupt": True, "rank": r}
        for r in participants:
            if r not in planes:
                planes[r] = {"missing": True, "rank": r}
        gathered = True
    else:
        planes[rank] = json.loads(plane_text)
    # dead-rank placeholders, sourced from the membership registry: the
    # aggregate excludes them, the schema still names them
    for r in sorted(dead):
        if r not in planes:
            rec = (wh.get("peers") or {}).get(r) or {}
            planes[r] = {
                "dead": True,
                "rank": r,
                "declared_dead_epoch": rec.get("declared_dead_epoch"),
                "timeouts": rec.get("timeouts", 0),
            }
    _counters["fleet_snapshots"] += 1
    out = {
        "fleet_schema": FLEET_SCHEMA,
        "world_size": world,
        "rank": rank,
        "epoch": int(wh.get("epoch", 1)),
        "gathered": gathered,
        "dead_ranks": sorted(dead),
        "ranks": planes,
        "aggregate": merge_snapshots(planes),
        "stragglers": straggler_report(planes),
        "streaming": merge_streaming(planes),
        "world_health": wh,
        "fleet_stats": fleet_stats(),
    }
    if t0 and _telemetry.armed:
        _telemetry.emit(
            "fleet-snapshot", None, "sync", t0, _telemetry.now() - t0,
            {"world": world, "gathered": gathered, "ranks": len(planes)},
        )
    return out


def _prom_name(key: str) -> str:
    return "metrics_tpu_fleet_" + "".join(c if (c.isalnum() or c == "_") else "_" for c in key)


def fleet_prometheus_text(snap: Optional[Dict[str, Any]] = None) -> str:
    """Render a :func:`fleet_snapshot` as a Prometheus exposition with
    ``rank`` (and ``phase``) labels — the scrape face of the fleet plane.

    Families: fleet-level gauges (``world_size``, ``dead_ranks``, ``epoch``,
    ``gathered``), the aggregate counters (``metrics_tpu_fleet_<key>``,
    typed ``counter``) and aggregate gauges (``_min``/``_median``/``_max``),
    per-rank liveness/health gauges (``rank`` label), the per-rank sync
    phase statistics (``rank`` + ``phase`` labels, mean AND full-lifetime
    p95), the straggler deviation scores (mean-based and tail-aware), the
    model-monitoring families (``metrics_tpu_metric_value{name,window}``
    per-window metric values, ``metrics_tpu_drift_score{name,kind}`` PSI/KS
    scores, ``metrics_tpu_fleet_window_id{name}`` and the per-rank
    ``metrics_tpu_fleet_window_skew{rank,name}`` lag attribution), the
    ingestion-gateway families (``metrics_tpu_ingest_staging_rows`` /
    ``_staging_bytes`` / ``_degraded`` / ``_quarantine_depth``, with
    ``rank`` + ``gateway`` labels), and
    the latency **histogram** families: the fleet-merged
    ``metrics_tpu_fleet_latency_seconds{site=...,le=...}`` (exact bucket
    sums across ranks) and the rank-labelled
    ``metrics_tpu_fleet_rank_latency_seconds{rank=...,site=...,le=...}``.
    Samples of one family are grouped under a single ``# TYPE`` line, as
    the text format requires.

    .. warning:: With no ``snap`` argument this calls
       :func:`fleet_snapshot`, which in a multi-rank world is a
       **collective** — every live rank must enter it in lockstep, so do
       NOT wire the no-arg form into an independently-scraped per-rank
       ``/metrics`` endpoint. Gather once at a coordinated point in the
       serving loop and render the result (``fleet_prometheus_text(snap)``)
       from the scrape handler; the per-rank local exposition
       (:func:`metrics_tpu_torch.prometheus_text`) needs no coordination.

    Example:
        >>> from metrics_tpu_torch import fleet_prometheus_text
        >>> text = fleet_prometheus_text()
        >>> text.splitlines()[0]
        '# TYPE metrics_tpu_fleet_world_size gauge'
        >>> 'metrics_tpu_fleet_rank_live{rank="' in text
        True
    """
    snap = fleet_snapshot() if snap is None else snap
    families: List[Tuple[str, str, List[str]]] = []  # (name, kind, sample lines)

    def family(name: str, kind: str, samples: List[Tuple[str, float]]) -> None:
        if not samples:
            return
        lines = []
        for labels, value in samples:
            rendered = str(int(value)) if float(value).is_integer() else repr(float(value))
            lines.append(f"{name}{labels} {rendered}")
        families.append((name, kind, lines))

    family("metrics_tpu_fleet_world_size", "gauge", [("", snap["world_size"])])
    family("metrics_tpu_fleet_dead_ranks", "gauge", [("", len(snap["dead_ranks"]))])
    family("metrics_tpu_fleet_epoch", "gauge", [("", snap["epoch"])])
    family("metrics_tpu_fleet_gathered", "gauge", [("", 1 if snap["gathered"] else 0)])

    agg = snap.get("aggregate") or {}
    for key, value in (agg.get("counters") or {}).items():
        # histogram samples render as le-labelled families below, never as
        # flat counter scalars — the same is_histogram_sample_key carve-out
        # prometheus_text applies, so the two expositions cannot disagree
        if _telemetry.is_histogram_sample_key(key):
            continue
        family(_prom_name(key), "counter", [("", float(value))])
    for key, stats in (agg.get("gauges") or {}).items():
        for stat in ("min", "median", "max"):
            family(f"{_prom_name(key)}_{stat}", "gauge", [("", float(stats[stat]))])

    ranks = snap.get("ranks") or {}
    live_samples, dead_samples, degraded_samples = [], [], []
    phase_samples: Dict[str, List[Tuple[str, float]]] = {
        "count": [], "mean": [], "max": [], "total": [], "p95": []
    }
    per_rank_latency: Dict[str, Dict[str, Any]] = {}
    for rank in sorted(ranks):
        plane = ranks[rank]
        label = f'{{rank="{rank}"}}'
        alive = _is_live_plane(plane)
        live_samples.append((label, 1 if alive else 0))
        dead_samples.append((label, 1 if (isinstance(plane, dict) and plane.get("dead")) else 0))
        if alive:
            health = plane.get("sync_health") or {}
            degraded_samples.append((label, 1 if health.get("degraded") else 0))
            stats = plane.get("sync_phase_stats") or {}
            latency = plane.get("latency_stats") or {}
            for site in _telemetry.SYNC_PHASE_SITES:
                block = stats.get(site) or {}
                if not float(block.get("count", 0)):
                    continue
                plabel = f'{{rank="{rank}",phase="{site}"}}'
                phase_samples["count"].append((plabel, float(block.get("count", 0))))
                phase_samples["mean"].append((plabel, float(block.get("mean_s", 0.0))))
                phase_samples["max"].append((plabel, float(block.get("max_s", 0.0))))
                phase_samples["total"].append((plabel, float(block.get("total_s", 0.0))))
                lat = latency.get(site) or {}
                if float(lat.get("count", 0)) > 0:
                    # tail-aware twin of the mean sample: full-lifetime p95
                    phase_samples["p95"].append((plabel, float(lat.get("p95_s", 0.0))))
            for site, block in latency.items():
                # composite key carries rank + site through the shared
                # histogram renderer ('\x00' cannot appear in a site name)
                per_rank_latency[f"{rank}\x00{site}"] = block
    family("metrics_tpu_fleet_rank_live", "gauge", live_samples)
    family("metrics_tpu_fleet_rank_dead", "gauge", dead_samples)
    family("metrics_tpu_fleet_rank_degraded", "gauge", degraded_samples)
    family("metrics_tpu_fleet_sync_phase_count", "gauge", phase_samples["count"])
    family("metrics_tpu_fleet_sync_phase_mean_seconds", "gauge", phase_samples["mean"])
    family("metrics_tpu_fleet_sync_phase_max_seconds", "gauge", phase_samples["max"])
    family("metrics_tpu_fleet_sync_phase_total_seconds", "gauge", phase_samples["total"])
    family("metrics_tpu_fleet_sync_phase_p95_seconds", "gauge", phase_samples["p95"])

    stragglers = snap.get("stragglers") or {}
    dev_samples, tail_samples = [], []
    for site, entry in (stragglers.get("phases") or {}).items():
        for rank, dev in (entry.get("per_rank_deviation") or {}).items():
            dev_samples.append((f'{{rank="{rank}",phase="{site}"}}', float(dev)))
        for rank, dev in (entry.get("per_rank_tail_deviation") or {}).items():
            tail_samples.append((f'{{rank="{rank}",phase="{site}"}}', float(dev)))
    family("metrics_tpu_fleet_straggler_deviation", "gauge", dev_samples)
    family("metrics_tpu_fleet_straggler_tail_deviation", "gauge", tail_samples)
    flagged = [(f'{{rank="{r}"}}', 1.0) for r in stragglers.get("stragglers") or ()]
    family("metrics_tpu_fleet_straggler_flagged", "gauge", flagged)

    # the model-monitoring families (streaming.py): fleet-agreed per-window
    # METRIC VALUES (the first exposition of metric values, not system
    # telemetry), the agreed window ids, drift scores, and per-rank
    # window-skew attribution — names per the docs/observability.md table
    streaming = snap.get("streaming") or {}
    value_samples, id_samples = [], []
    for wname, block in (streaming.get("windows") or {}).items():
        if not isinstance(block, dict):
            continue
        id_samples.append((f'{{name="{wname}"}}', float(block.get("window", 0))))
        for wid, values in (block.get("values") or {}).items():
            for key, value in (values or {}).items():
                label_name = wname if key == "value" else f"{wname}.{key}"
                value_samples.append(
                    (f'{{name="{label_name}",window="{wid}"}}', float(value))
                )
    # the tenant-arena cohorts (arena.py): every cohort's newest computed
    # values join the SAME metric-value family, disambiguated by the
    # tenant_cohort label — one dashboard family for singleton windows and
    # million-tenant arenas alike
    tenant_samples = []
    for aname, block in (streaming.get("arenas") or {}).items():
        if not isinstance(block, dict):
            continue
        tenant_samples.append((f'{{name="{aname}"}}', float(block.get("tenants", 0))))
        for cohort, scalars in (block.get("cohorts") or {}).items():
            for key, value in (scalars or {}).items():
                label_name = aname if key == "value" else f"{aname}.{key}"
                value_samples.append(
                    (f'{{name="{label_name}",tenant_cohort="{cohort}"}}', float(value))
                )
        for wid, per_cohort in (block.get("values") or {}).items():
            for cohort, scalars in (per_cohort or {}).items():
                for key, value in (scalars or {}).items():
                    label_name = aname if key == "value" else f"{aname}.{key}"
                    value_samples.append(
                        (
                            f'{{name="{label_name}",tenant_cohort="{cohort}",window="{wid}"}}',
                            float(value),
                        )
                    )
    family("metrics_tpu_metric_value", "gauge", value_samples)
    family("metrics_tpu_fleet_window_id", "gauge", id_samples)
    family("metrics_tpu_fleet_arena_tenants", "gauge", tenant_samples)
    drift_samples = []
    for dname, scores in (streaming.get("drift") or {}).items():
        for kind in ("psi", "ks"):
            if isinstance(scores, dict) and kind in scores:
                drift_samples.append(
                    (f'{{name="{dname}",kind="{kind}"}}', float(scores[kind]))
                )
    family("metrics_tpu_drift_score", "gauge", drift_samples)
    skew_samples = []
    for wname, entry in (streaming.get("window_skew") or {}).items():
        for rank, lag in (entry.get("per_rank_lag") or {}).items():
            skew_samples.append((f'{{rank="{rank}",name="{wname}"}}', float(lag)))
    family("metrics_tpu_fleet_window_skew", "gauge", skew_samples)

    # the ingestion-gateway families (ingest.py): per-rank, per-gateway
    # staging occupancy, degraded-tier flags and quarantine depth — the
    # admission-control surface a fleet dashboard alerts on (the ingest_*
    # settlement counters already aggregate above as metrics_tpu_fleet_*)
    ingest_samples: Dict[str, List[Tuple[str, float]]] = {
        "staging_rows": [], "staging_bytes": [], "degraded": [], "quarantine_depth": []
    }
    for rank in sorted(ranks):
        plane = ranks[rank]
        if not _is_live_plane(plane):
            continue
        gw_blocks = ((plane.get("ingest_state") or {}).get("gateways")) or {}
        for gname, st in gw_blocks.items():
            if not isinstance(st, dict):
                continue
            glabel = f'{{rank="{rank}",gateway="{gname}"}}'
            ingest_samples["staging_rows"].append((glabel, float(st.get("staging_rows", 0))))
            ingest_samples["staging_bytes"].append((glabel, float(st.get("staging_bytes", 0))))
            ingest_samples["degraded"].append((glabel, 1.0 if st.get("degraded") else 0.0))
            ingest_samples["quarantine_depth"].append(
                (glabel, float(st.get("quarantine_depth", 0)))
            )
    family("metrics_tpu_ingest_staging_rows", "gauge", ingest_samples["staging_rows"])
    family("metrics_tpu_ingest_staging_bytes", "gauge", ingest_samples["staging_bytes"])
    family("metrics_tpu_ingest_degraded", "gauge", ingest_samples["degraded"])
    family("metrics_tpu_ingest_quarantine_depth", "gauge", ingest_samples["quarantine_depth"])

    lines: List[str] = []
    for name, kind, samples in families:
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(samples)
    # histogram families LAST (the scalar families above stay one TYPE line +
    # unlabelled/labelled samples; the renderer below emits its own headers):
    # the fleet-merged histograms (exact bucket sums, le-labelled) and the
    # rank-labelled per-rank histograms — same renderer prometheus_text uses,
    # so the local and fleet expositions cannot disagree about layout
    lines.extend(
        _telemetry._histogram_exposition_lines(
            agg.get("latency_stats") or {}, family="metrics_tpu_fleet_latency_seconds"
        )
    )

    def _rank_site_label(key: str) -> str:
        rank, site = key.split("\x00", 1)
        return f'rank="{rank}",site="{site}"'

    lines.extend(
        _telemetry._histogram_exposition_lines(
            per_rank_latency,
            family="metrics_tpu_fleet_rank_latency_seconds",
            label_for=_rank_site_label,
        )
    )
    return "\n".join(lines) + "\n"


def fleet_perf_report() -> Dict[str, Any]:
    """The cross-rank face of :func:`metrics_tpu_torch.ops.perf.perf_report`:
    every rank's step-latency decomposition merged into one fleet view.

    In a multi-rank world each rank's locally-computed report rides ONE
    epoch-fenced, deadline-guarded blob gather (:func:`_gather_blobs`) — a
    **collective**, every live rank in lockstep, like ``fleet_snapshot()``.
    With a world size of 1 the local report is served directly, zero
    collectives. Keys: per-rank ``reports`` (corrupt rows get a
    ``{"corrupt": True}`` placeholder), ``aggregate_phases`` — per-phase
    exclusive seconds SUMMED EXACTLY across live ranks (phase time is a
    duration counter over each rank's window, so the sum is the fleet's
    total attributed wall), and ``slowest_rank_per_phase`` — the rank
    spending the most wall in each phase, the per-phase twin of the
    straggler report.

    Example:
        >>> from metrics_tpu_torch import fleet_perf_report
        >>> report = fleet_perf_report()   # single process: local only
        >>> report["gathered"], report["rank"] in report["reports"]
        (False, True)
    """
    from metrics_tpu_torch.ops import perf as _perf
    from metrics_tpu_torch.parallel import sync as _sync

    local = _perf.perf_report()
    wh = _sync.world_health()
    world = fleet_world()
    rank = local_rank()
    dead = set(wh.get("dead_ranks") or ())
    reports: Dict[int, Dict[str, Any]] = {}
    gathered = False
    if world > 1:
        blob = json.dumps(_telemetry._json_safe(local), separators=(",", ":")).encode("utf-8")
        payloads = _gather_blobs(blob, site="fleet-snapshot")
        for r, raw in zip(_participant_ranks(world, dead), payloads):
            try:
                decoded = json.loads(raw.decode("utf-8"))
                if not isinstance(decoded, dict):
                    raise ValueError("rank report must be an object")
                reports[r] = decoded
            except (ValueError, UnicodeDecodeError):
                reports[r] = {"corrupt": True, "rank": r}
        gathered = True
    else:
        reports[rank] = local
    agg: Dict[str, float] = {p: 0.0 for p in _perf.PHASES}
    slowest: Dict[str, Tuple[int, float]] = {}
    for r, rep in sorted(reports.items()):
        if not _is_live_plane(rep):
            continue
        for p, block in (rep.get("phases") or {}).items():
            t = float((block or {}).get("total_s", 0.0))
            if p not in agg:
                continue  # unknown phase (mixed-version fleet): neither table
            agg[p] += t
            if t > 0 and (p not in slowest or t > slowest[p][1]):
                slowest[p] = (r, t)
    return {
        "fleet_schema": FLEET_SCHEMA,
        "world_size": world,
        "rank": rank,
        "gathered": gathered,
        "reports": reports,
        "aggregate_phases": {p: round(v, 6) for p, v in agg.items()},
        "slowest_rank_per_phase": {
            p: {"rank": r, "total_s": round(t, 6)} for p, (r, t) in sorted(slowest.items())
        },
    }


# ----------------------------------------------------------- merged trace
def _anchor_points(rows: List[Dict[str, Any]]) -> Dict[Tuple[str, int], float]:
    """Clock-alignment anchors: payload-collective spans carrying the
    lockstep ``seq`` ordinal. Every rank blocks inside the same collective,
    so same-seq spans mark (approximately) the same wall moment; the median
    pairwise difference recovers the per-rank clock offset."""
    anchors: Dict[Tuple[str, int], float] = {}
    for row in rows:
        attrs = row.get("attrs") or {}
        if row.get("site") in ("sync-payload-gather", "sync-gather") and "seq" in attrs:
            anchors[(row["site"], int(attrs["seq"]))] = float(row["t_start"]) + float(
                row.get("dur") or 0.0
            )
    return anchors


def export_fleet_trace(path: str) -> int:
    """Gather every rank's span ring and write ONE merged Perfetto JSON with
    one **process per rank** (``pid`` = rank, per-owner threads inside it),
    so a cross-rank sync timeline — who entered the collective late, whose
    unpack ran long — is visible in a single view.

    Ranks are aligned on the shared monotonic axis: paired payload-gather
    spans (identical lockstep ``seq`` ordinals) act as clock-offset anchors,
    and each rank's timestamps shift by the median anchor difference against
    the lowest-ranked participant (recorded under
    ``otherData.clock_offsets_s``; alignment is approximate — anchors mark
    the collective's *completion*, which skews by per-rank unblock order).
    With a world size of 1 the local ring exports directly, zero
    collectives. Returns the number of span events written; the output
    passes ``tools/trace_report.py --check``.

    Example:
        >>> import os, tempfile
        >>> from metrics_tpu_torch import export_fleet_trace
        >>> path = os.path.join(tempfile.mkdtemp(), "fleet-trace.json")
        >>> _ = export_fleet_trace(path)
        >>> os.path.exists(path)
        True
    """
    from metrics_tpu_torch.parallel import sync as _sync

    t0 = _telemetry.now() if _telemetry.armed else 0.0
    wh = _sync.world_health()
    world = fleet_world()
    rank = local_rank()
    dead = set(wh.get("dead_ranks") or ())
    local_doc = {
        "rank": rank,
        "spans": _telemetry.spans(),
        "snapshot": {k: v for k, v in _telemetry.snapshot().items() if k != "failure_log"},
    }
    docs: Dict[int, Dict[str, Any]] = {}
    if world > 1:
        blob = json.dumps(_telemetry._json_safe(local_doc), separators=(",", ":")).encode("utf-8")
        payloads = _gather_blobs(blob, site="fleet-trace")
        participants = _participant_ranks(world, dead)
        dropped: List[int] = []
        mismatched: List[int] = []
        for r, raw in zip(participants, payloads):
            try:
                decoded = json.loads(raw.decode("utf-8"))
                if isinstance(decoded, dict) and isinstance(decoded.get("spans"), list):
                    # rows key POSITIONALLY (survivors ascending — the same
                    # mapping fleet_snapshot uses); a row claiming another
                    # rank's number must not overwrite that rank's ring
                    if decoded.get("rank") not in (None, r):
                        mismatched.append(r)
                    docs[r] = decoded
                else:
                    dropped.append(r)
            except (ValueError, UnicodeDecodeError):
                dropped.append(r)
        if dropped or mismatched:
            # no-silent-caps: a rank whose ring was lost in transit must not
            # read as "that rank emitted no spans"
            from metrics_tpu_torch.ops import faults as _faults

            detail = []
            if dropped:
                detail.append(f"dropped undecodable row(s) for rank(s) {dropped}")
            if mismatched:
                detail.append(
                    f"row(s) at position(s) {mismatched} claimed a different rank "
                    "(kept under their positional rank)"
                )
            _faults.warn_fault(
                _TRACE_DROP_WARN_OWNER,
                "sync",
                "export_fleet_trace " + "; ".join(detail) + "; the merged trace may "
                "omit or misattribute those processes.",
            )
        if rank not in docs:
            docs[rank] = local_doc
    else:
        docs[rank] = local_doc

    # ---- clock alignment against the lowest-ranked participant ----
    ref = min(docs)
    ref_anchors = _anchor_points(docs[ref]["spans"])
    offsets: Dict[int, float] = {}
    for r, doc in sorted(docs.items()):
        if r == ref:
            offsets[r] = 0.0
            continue
        anchors = _anchor_points(doc["spans"])
        shared = sorted(set(ref_anchors) & set(anchors))
        offsets[r] = (
            _median([ref_anchors[k] - anchors[k] for k in shared]) if shared else 0.0
        )

    # ---- one process per rank ----
    aligned: List[Tuple[float, Dict[str, Any]]] = []
    meta: List[Dict[str, Any]] = []
    next_tid = 1
    for r, doc in sorted(docs.items()):
        meta.append(
            {"ph": "M", "name": "process_name", "pid": r, "tid": 0, "ts": 0,
             "args": {"name": f"rank {r}"}}
        )
        tids: Dict[str, int] = {}
        for row in doc["spans"]:
            owner = row.get("owner") or "global"
            tid = tids.get(owner)
            if tid is None:
                tid = tids[owner] = next_tid
                next_tid += 1
                meta.append(
                    {"ph": "M", "name": "thread_name", "pid": r, "tid": tid, "ts": 0,
                     "args": {"name": owner}}
                )
            args: Dict[str, Any] = {"step": row.get("step"), "rank": r}
            if row.get("lane"):
                args["lane"] = row["lane"]
            if row.get("attrs"):
                args.update(_telemetry._json_safe(row["attrs"]))
            ev: Dict[str, Any] = {
                "name": row.get("site"),
                "cat": row.get("lane") or "span",
                "pid": r,
                "tid": tid,
                "args": args,
            }
            dur = float(row.get("dur") or 0.0)
            if dur > 0:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            aligned.append((float(row["t_start"]) + offsets[r], ev))

    n_events = len(aligned)
    t_min = min(t for t, _ in aligned) if aligned else 0.0
    events: List[Dict[str, Any]] = []
    for t, ev in sorted(aligned, key=lambda kv: kv[0]):
        ev["ts"] = round(max(0.0, t - t_min) * 1e6, 3)
        events.append(ev)

    merged = merge_snapshots(
        {r: {k: v for k, v in (doc.get("snapshot") or {}).items()} for r, doc in docs.items()}
    )
    doc_out = {
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "metrics_tpu_torch.ops.fleetobs",
            "schema": FLEET_SCHEMA,
            "ranks": sorted(docs),
            "dead_ranks": sorted(dead),
            "clock_offsets_s": {str(r): offsets[r] for r in sorted(offsets)},
        },
        # the exact-summed counter plane plus the structurally-merged latency
        # histograms, so the trace report's latency digest works on a merged
        # fleet trace too
        "snapshot": dict(merged["counters"], latency_stats=merged["latency_stats"]),
        "traceEvents": meta + events,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc_out, fh, separators=(",", ":"))
    _counters["fleet_trace_exports"] += 1
    if t0 and _telemetry.armed:
        _telemetry.emit(
            "fleet-trace", None, "sync", t0, _telemetry.now() - t0,
            {"world": world, "ranks": len(docs), "events": n_events},
        )
    return n_events
