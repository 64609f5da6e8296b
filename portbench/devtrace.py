"""The traced window: device intervals, the benchmark's own spans and the host ops, from ``torch.profiler``.

The benchmark opens a span (``torch.profiler.record_function``) named ``portbench.<phase>`` around each
call it makes into the program: ``update``, ``sync`` (the synchronize after it), ``compute`` (to the
values on the host) and ``reset``, and ``portbench.window`` around the whole window. Device time is the
union of every kernel, copy and set on the card; what it leaves uncovered in the window is idle.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]

SPAN_PREFIX = "portbench."
HOST_READ_OPS = ("aten::item", "aten::_local_scalar_dense", "aten::nonzero")


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def covered_ns(merged: Sequence[Interval], start: int, end: int) -> int:
    """Nanoseconds of ``[start, end)`` that the disjoint sorted ``merged`` intervals cover."""
    i = max(0, bisect.bisect_right([s for s, _ in merged], start) - 1) if merged else 0
    total = 0
    while i < len(merged) and merged[i][0] < end:
        s, e = merged[i]
        total += max(0, min(e, end) - max(s, start))
        i += 1
    return total


class Trace:
    """What a per-layer reader may read: device intervals, spans by phase, host ops, and the window."""

    def __init__(self, device_ops: List[Tuple[str, int, int]], host_ops: List[Tuple[str, int]],
                 spans: Dict[str, List[Interval]], window: Interval):
        self.window = window
        self.device_ops = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in device_ops
                           if e > window[0] and s < window[1]]
        self.busy = merge([(s, e) for _, s, e in self.device_ops])
        self._starts = [s for s, _ in self.busy]
        self.host_ops = host_ops
        self.spans = {k: sorted(v) for k, v in spans.items()}

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def device_s_within(self, intervals: Sequence[Interval]) -> float:
        """Seconds of device work inside the given intervals (each counted once)."""
        return sum(covered_ns(self.busy, s, e) for s, e in intervals) / 1e9

    def steps(self) -> List[Interval]:
        """Each update with the synchronize after it: from the call to the card's finish."""
        return [(u[0], s[1]) for u, s in zip(self.spans.get("update", []), self.spans.get("sync", []))]

    def count_host_ops(self, names: Sequence[str], within: Sequence[Interval]) -> int:
        """Host ops of the given names that start inside the given intervals."""
        spans = sorted(within)
        starts = [s for s, _ in spans]
        n = 0
        for name, t in self.host_ops:
            if name in names:
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t < spans[i][1]:
                    n += 1
        return n

    def phase_at(self, t: int) -> str:
        """The benchmark span open at ``t`` ("other" between spans)."""
        for name, spans in self.spans.items():
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t < spans[i][1]:
                return name
        return "other"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device ops that took most time, and the idle time by the span that was open."""
        by_op: Dict[str, int] = defaultdict(int)
        for name, s, e in self.device_ops:
            by_op[name[:120]] += e - s
        idle: Dict[str, int] = defaultdict(int)
        edges = [self.window[0]] + [t for iv in self.busy for t in iv] + [self.window[1]]
        for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
            if gap_end > gap_start:
                idle[self.phase_at((gap_start + gap_end) // 2)] += gap_end - gap_start
        rank = lambda d: sorted(([k, v / 1e9] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_op), "idle_gaps": rank(idle)}


def from_profiler(prof) -> Optional[Trace]:
    """A :class:`Trace` from a finished ``torch.profiler.profile``; None without a ``portbench.window`` span."""
    device_ops, host_ops = [], []
    spans: Dict[str, List[Interval]] = defaultdict(list)
    window = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns(), ev.end_ns()
        if name.startswith(SPAN_PREFIX):
            if ev.device_type().name == "CPU":
                phase = name[len(SPAN_PREFIX):]
                if phase == "window":
                    window = (start, end)
                else:
                    spans[phase].append((start, end))
            continue
        if ev.device_type().name == "CUDA":
            if not ev.is_user_annotation() and not name.startswith("ProfilerStep"):
                device_ops.append((name, start, end))
        elif name in HOST_READ_OPS:
            host_ops.append((name, start))
    if window is None:
        return None
    return Trace(device_ops, host_ops, dict(spans), window)
