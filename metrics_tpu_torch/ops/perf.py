"""Performance attribution: where the time in the span ring went, reconciled and ranked.

JAX counterpart: `metrics_tpu/ops/perf.py`, ported as it is: the same phases,
the same site-to-phase map (:data:`SITE_PHASES`), the same report schema and
the same :data:`TOLERANCE`, over the port's own span ring
(:mod:`metrics_tpu_torch.ops.telemetry`). Every timed span is attributed to
one phase by an interval-exclusive nesting scan (:func:`_exclusive_spans`: a
child's wall is taken out of its nearest enclosing span, so phases sum to the
top-level wall and nothing counts twice); the phases are reconciled against a
wall the caller measured; the wire phase carries the bytes and rate of the
collectives; and the heaviest phases are ranked with their evidence.

The port emits the engine's sites (``engine-build``, ``engine-compile`` at a
program's first run of a signature, ``engine-dispatch``, ``engine-flush``),
the sampled ``device-dispatch`` probes, the ``sync-*`` family and the suite's
``suite-step`` and ``suite-sync``; each maps to JAX's phase for the same site.
Two readings differ in meaning on the card: ``engine-dispatch`` is the host
wall of an eager step's launches (it ends when they are queued), and
``device-dispatch`` is the probed wall up to a ``torch.cuda.synchronize``.
``programs`` is :func:`metrics_tpu_torch.ops.engine.program_report`, whose
facts are counted in PyTorch's terms instead of XLA's cost analysis.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.ops import telemetry as _telemetry

__all__ = [
    "PHASES",
    "SITE_PHASES",
    "TOLERANCE",
    "perf_report",
    "perf_stats",
    "phase_columns",
    "reset_perf_stats",
]

#: Reconciliation tolerance: phases must cover the measured wall within
#: this relative share (the certification pins it over a live suite loop).
TOLERANCE = 0.15

#: Span site -> phase. Sites absent here fold into the ``host`` phase.
#: ``sync-force``'s EXCLUSIVE time (its wall minus the nested unpack) is the
#: wait the caller actually blocked on for an in-flight collective — the
#: non-hidden wire; ``sync-dispatch``'s exclusive residual (after the nested
#: pack) is async bookkeeping; ``sync-quantize`` is payload serialization
#: work like the metadata exchange.
SITE_PHASES = {
    "suite-step": "enqueue",
    "engine-flush": "flush",
    "engine-build": "trace",
    "engine-compile": "compile",
    "engine-dispatch": "dispatch",
    "device-dispatch": "device",
    "suite-sync": "orchestrate",
    "sync-pack": "pack",
    "sync-metadata": "serialize",
    "sync-quantize": "serialize",
    "sync-payload-gather": "wire",
    "sync-gather": "wire",
    "sync-unpack": "unpack",
    "sync-dispatch": "orchestrate",
    "sync-force": "wire",
}

#: Every phase, in report order. ``step`` phases then ``sync`` phases then
#: the catch-all.
PHASES = (
    "enqueue", "flush", "trace", "compile", "dispatch", "device",
    "pack", "serialize", "wire", "unpack", "orchestrate", "host",
)

_STEP_PHASES = ("enqueue", "flush", "trace", "compile", "dispatch", "device")
_SYNC_PHASES = ("pack", "serialize", "wire", "unpack", "orchestrate")

_counters: Dict[str, int] = {"perf_reports": 0}


def perf_stats() -> Dict[str, int]:
    return dict(_counters)


def reset_perf_stats() -> None:
    for key in _counters:
        _counters[key] = 0


_telemetry.register_reset("perf", reset_perf_stats)


def _exclusive_spans(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Attribute every timed span its EXCLUSIVE duration (own wall minus the
    wall of spans nested inside it) via one stack scan over the interval
    tree. Host-side spans are emitted single-threaded, so intervals either
    nest or are disjoint; ties at the same start (a probed
    ``device-dispatch`` and its ``engine-dispatch`` sibling share
    ``t_start``) order the longer interval as the parent.

    Spans tagged ``overlapped`` in their attrs — the async sync lane's
    in-flight wire spans, emitted from the dispatcher thread — COEXIST with
    host compute instead of nesting inside it: a ``sync-dispatch`` →
    ``sync-force`` pair brackets an overlapped interval. They are excluded
    from the nesting scan (their wall would otherwise be double-counted
    against whatever host span they land inside, blowing the reconciliation)
    and returned with ``exclusive_s == 0`` and ``overlapped: True`` so the
    wire evidence can account them separately — the force span's exclusive
    wait is the only wall the host actually paid."""
    timed = [r for r in rows if (r.get("dur") or 0.0) > 0.0]
    inflight = [r for r in timed if (r.get("attrs") or {}).get("overlapped")]
    timed = [r for r in timed if not (r.get("attrs") or {}).get("overlapped")]
    timed.sort(key=lambda r: (r["t_start"], -(r["t_start"] + r["dur"])))
    eps = 1e-9
    stack: List[Tuple[float, Dict[str, Any]]] = []
    out: List[Dict[str, Any]] = []
    for r in timed:
        start = float(r["t_start"])
        dur = float(r["dur"])
        while stack and start >= stack[-1][0] - eps:
            stack.pop()
        rec = {
            "site": r.get("site"),
            "dur": dur,
            "attrs": r.get("attrs") or {},
            "child_s": 0.0,
            "parent": stack[-1][1]["site"] if stack else None,
            "top": not stack,
        }
        if stack:
            stack[-1][1]["child_s"] += dur
        out.append(rec)
        stack.append((start + dur, rec))
    for rec in out:
        rec["exclusive_s"] = max(0.0, rec["dur"] - rec["child_s"])
    for r in inflight:
        out.append(
            {
                "site": r.get("site"),
                "dur": float(r["dur"]),
                "attrs": r.get("attrs") or {},
                "child_s": 0.0,
                "parent": None,
                "top": False,
                "overlapped": True,
                "exclusive_s": 0.0,
            }
        )
    return out


def _phase_of(site: Any) -> str:
    return SITE_PHASES.get(site, "host")


def phase_columns(
    before: Dict[str, Dict[str, Any]], after: Dict[str, Dict[str, Any]]
) -> Dict[str, float]:
    """Per-phase total milliseconds between two ``telemetry.latency_stats()``
    snapshots: cheap windowed phase columns. Inclusive sums (a histogram has
    no intervals): a flush's nested dispatches count in both ``flush`` and
    ``dispatch``, the same way in every window, which is what a delta between
    two windows needs."""
    out: Dict[str, float] = {}
    for site, block in after.items():
        if site.startswith(_telemetry._DEVICE_HIST_SITE + ":"):
            continue  # per-program families: the aggregate site carries them
        prev = float((before.get(site) or {}).get("sum_s", 0.0))
        delta = float(block.get("sum_s", 0.0)) - prev
        if delta > 0:
            phase = _phase_of(site)
            out[phase] = out.get(phase, 0.0) + delta * 1000.0
    return {k: round(v, 4) for k, v in sorted(out.items())}


#: The span sites that ARE payload transports (carry wire bytes and count
#: as collectives in the wire evidence); the in-flight metadata/cross-check
#: exchanges and the force's wait wall are wire-phase time, not collectives.
_WIRE_TRANSPORT_SITES = ("sync-payload-gather", "sync-gather")


def _wire_evidence(recs: List[Dict[str, Any]], wire_s: float, sync_wall_s: float) -> Dict[str, Any]:
    nbytes = 0
    collectives = 0
    overlapped_s = 0.0
    waited_s = 0.0
    blocking_transport_s = 0.0
    for rec in recs:
        if rec.get("overlapped"):
            # in-flight wire spans (dispatcher thread): their wall coexists
            # with host compute — accounted here, never against host wall
            overlapped_s += rec["dur"]
            if rec["site"] in _WIRE_TRANSPORT_SITES:
                nbytes += int(rec["attrs"].get("bytes", 0) or 0)
                collectives += 1
            continue
        if rec["site"] == "sync-force":
            waited_s += float(rec["attrs"].get("waited_s", 0.0) or 0.0)
        elif _phase_of(rec["site"]) == "wire":
            collectives += 1
            nbytes += int(rec["attrs"].get("bytes", 0) or 0)
            blocking_transport_s += rec["exclusive_s"]
    # effective rate divides by TRANSPORT wall only: blocking transport
    # spans plus in-flight spans. The sync-force wait is wire-phase TIME for
    # attribution, but it covers the same window the in-flight span already
    # measures — adding it would double-count and understate the rate.
    transport_s = blocking_transport_s + overlapped_s
    # the hidden fraction: how much of the in-flight wire wall the host never
    # blocked on (waited_s is the force-side wait actually paid). 0.0 with no
    # async syncs in the window; >= 0.5 is the certification bar on the
    # simulated slow transport.
    hidden = 0.0
    if overlapped_s > 0:
        hidden = max(0.0, min(1.0, (overlapped_s - waited_s) / overlapped_s))
    return {
        "bytes_gathered": nbytes,
        "collectives": collectives,
        "effective_bytes_per_s": (nbytes / transport_s) if transport_s > 0 else 0.0,
        "wire_share_of_sync": (wire_s / sync_wall_s) if sync_wall_s > 0 else 0.0,
        "overlapped_wire_s": round(overlapped_s, 6),
        "forced_wait_s": round(waited_s, 6),
        "wire_hidden_fraction": round(hidden, 4),
    }


def _reconcile(attributed_s: float, measured_s: float) -> Dict[str, Any]:
    coverage = (attributed_s / measured_s) if measured_s > 0 else 0.0
    return {
        "attributed_s": round(attributed_s, 6),
        "measured_wall_s": round(measured_s, 6),
        "coverage": round(coverage, 4),
        "tolerance": TOLERANCE,
        "within_tolerance": measured_s > 0 and abs(coverage - 1.0) <= TOLERANCE,
    }


def _opportunity(phase: str, block: Dict[str, Any], report: Dict[str, Any]) -> str:
    """One evidence sentence per ranked phase (the 'why' next to the
    'where') — each names the roadmap lever that attacks it."""
    total_ms = block["total_s"] * 1e3
    n = block["spans"]
    if phase == "wire":
        w = report["sync"]["wire"]
        mbps = w["effective_bytes_per_s"] / 1e6
        if w.get("overlapped_wire_s", 0.0) > 0:
            return (
                f"{w['bytes_gathered']} B over {w['collectives']} collective(s) at "
                f"{mbps:.1f} MB/s effective; {w['wire_hidden_fraction']:.0%} of the "
                f"in-flight wire wall hidden behind compute (async sync) — raise the "
                "overlap window or shrink the payload (METRICS_TPU_SYNC_QUANT)"
            )
        return (
            f"{w['bytes_gathered']} B over {w['collectives']} collective(s) at "
            f"{mbps:.1f} MB/s effective — overlap the gather (sync_async futures) "
            "or shrink the payload (METRICS_TPU_SYNC_QUANT), ROADMAP #3"
        )
    if phase == "compile":
        return (
            f"{n} compile event(s), {total_ms:.1f} ms — AOT precompile + a "
            "persistent cross-process program cache removes this from steady "
            "state, ROADMAP #4"
        )
    if phase == "dispatch":
        mean_us = (block["total_s"] / n * 1e6) if n else 0.0
        return (
            f"{n} program dispatch(es), mean {mean_us:.1f} us host wall — raise "
            "the deferral window or arena-batch same-config suites, ROADMAP #2"
        )
    if phase == "device":
        worst = ""
        for row in report.get("programs") or ():
            rl = row.get("roofline") or {}
            if rl.get("bound") in ("compute-bound", "memory-bound"):
                worst = (
                    f"; heaviest: {row.get('program')} {rl['bound']} at "
                    f"{rl['achieved_flops_per_s'] / 1e9:.2f} GFLOP/s"
                )
                break
        return f"{n} probed dispatch(es), {total_ms:.1f} ms device-only wall{worst}"
    if phase == "enqueue":
        return (
            f"{n} suite step(s), {total_ms:.1f} ms host enqueue/validation — "
            "moving the step in-graph (state-as-pytree core) removes the "
            "per-call python entirely, ROADMAP #1"
        )
    if phase in ("pack", "unpack", "serialize"):
        return f"{n} span(s), {total_ms:.1f} ms {phase} work around the collective"
    if phase == "orchestrate":
        return f"{total_ms:.1f} ms suite-sync residual (member walk + eligibility)"
    if phase == "flush":
        return f"{n} flush(es), {total_ms:.1f} ms stacking/bucketing beyond the programs dispatched"
    return f"{n} span(s), {total_ms:.1f} ms"


def perf_report(
    measured_wall_s: Optional[float] = None,
    top: int = 5,
) -> Dict[str, Any]:
    """The step-latency decomposition: where the time in the current span
    ring actually went, reconciled and ranked.

    ``measured_wall_s`` (optional) is an externally measured end-to-end wall
    for the same window (e.g. ``perf_counter`` around the driven loop after
    ``clear_spans()``); the top-level reconciliation then states how much of
    REAL time the spans explain — the certification requires coverage
    within :data:`TOLERANCE` over a live suite loop. Without it, the
    reconciliation is against the top-level span wall (coverage 1.0 by
    construction — phase exactness, not coverage, is the claim). The scan
    reads THIS process's span ring; cross-rank views go through
    ``fleet_perf_report()`` (per-rank reports merged — never one scan over
    clock-skewed multi-rank rings).

    Returns a schema-stable dict: ``phases`` (every phase's exclusive
    seconds + span count), ``step`` / ``sync`` sub-blocks with their own
    walls and reconciliations (sync carries the ``wire`` evidence:
    bytes gathered, effective bytes/s, wire share), ``programs`` (the
    roofline ledger join from ``engine.program_report``), ``device_probe``
    (sampling state), and ``opportunities`` — the top-``top`` phases by
    exclusive time, each with its evidence sentence.

    Example:
        >>> from metrics_tpu_torch import perf_report
        >>> report = perf_report()
        >>> report["perf_schema"]
        1
        >>> sorted(report["phases"]) == sorted(PHASES)
        True
        >>> 0.0 <= report["sync"]["wire"]["wire_share_of_sync"] <= 1.0
        True
    """
    from metrics_tpu_torch.ops import engine as _engine

    _counters["perf_reports"] += 1
    recs = _exclusive_spans(_telemetry.spans())
    phases: Dict[str, Dict[str, Any]] = {
        p: {"total_s": 0.0, "spans": 0} for p in PHASES
    }
    top_level_s = 0.0
    step_wall_s = 0.0
    sync_wall_s = 0.0
    for rec in recs:
        if rec.get("overlapped"):
            continue  # in-flight wire: accounted in the wire evidence block
        block = phases[_phase_of(rec["site"])]
        block["total_s"] += rec["exclusive_s"]
        block["spans"] += 1
        if rec["top"]:
            top_level_s += rec["dur"]
            if rec["site"] == "suite-sync":
                sync_wall_s += rec["dur"]
            else:
                step_wall_s += rec["dur"]

    stats = _engine.engine_stats()
    step_attr = sum(phases[p]["total_s"] for p in _STEP_PHASES)
    sync_attr = sum(phases[p]["total_s"] for p in _SYNC_PHASES)
    wire_s = phases["wire"]["total_s"]

    report: Dict[str, Any] = {
        "perf_schema": 1,
        "spans_decomposed": len(recs),
        "phases": {
            p: {"total_s": round(b["total_s"], 6), "spans": b["spans"]}
            for p, b in phases.items()
        },
        "step": {
            "measured_wall_s": round(step_wall_s, 6),
            "steps": phases["enqueue"]["spans"],
            "phases": {p: round(phases[p]["total_s"], 6) for p in _STEP_PHASES},
        },
        "sync": {
            "measured_wall_s": round(sync_wall_s, 6),
            "syncs": phases["orchestrate"]["spans"],
            "phases": {p: round(phases[p]["total_s"], 6) for p in _SYNC_PHASES},
            "wire": _wire_evidence(recs, wire_s, sync_wall_s),
            "reconciliation": _reconcile(sync_attr, sync_wall_s),
        },
        "reconciliation": _reconcile(
            sum(b["total_s"] for b in phases.values()),
            top_level_s if measured_wall_s is None else float(measured_wall_s),
        ),
        "device_probe": {
            "every": _engine.device_probe_every(),
            "probes": stats.get("device_probes", 0),
        },
        "programs": _engine.program_report(analyze=True),
    }
    ranked = sorted(
        ((p, b) for p, b in phases.items() if b["total_s"] > 0),
        key=lambda kv: -kv[1]["total_s"],
    )
    total = sum(b["total_s"] for b in phases.values()) or 1.0
    report["opportunities"] = [
        {
            "phase": p,
            "total_s": round(b["total_s"], 6),
            "share": round(b["total_s"] / total, 4),
            "evidence": _opportunity(p, b, report),
        }
        for p, b in ranked[: max(1, top)]
    ]
    return report
