"""The program's own ranges in a traced window, and each device op tied to the range it was launched in.

While a ``torch.profiler`` records, ``metrics_tpu_torch`` opens a range named ``metrics_tpu_torch.<site>`` or
``metrics_tpu_torch.<site>:<detail>`` around each of its layers (``ops/telemetry.py``'s ``RANGE_SITES`` and its
timed ring sites), nested in the caller's ranges. This module keeps them apart from the benchmark's own spans
(``devtrace.Trace.spans``, which ``phase_at`` walks whole), with:

- each range's site path: the names of the ranges open around it, outermost first;
- the CUDA runtime's calls by correlation id, which a launch shares with the kernel, copy or set it launched, so
  that a device op is tied to the ranges open on the host **when it was launched**, not to those open when it
  ran (launches are asynchronous);
- the host's blocking waits on the card (``cudaStreamSynchronize`` and the like), to find reads of the card's
  values that no ``host-read`` range names.

Attach it to a trace with ``trace.program = from_profiler(prof, trace.window)``; a reader that finds no
``program`` there, or no range in it, returns None.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[int, int]
Path = Tuple[str, ...]

PROGRAM_PREFIX = "metrics_tpu_torch."
BENCH_PREFIX = "portbench."
RUNTIME_PREFIX = "cu"  # the CUDA API calls on the host: cudaLaunchKernel, cudaLaunchCooperativeKernel, cuLaunchKernel, ...
WAIT_OPS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
NO_RANGE = "(none)"


def site_of(name: str) -> str:
    """A range's site: its name without the detail (``update:AUROC`` is ``update``)."""
    return name.split(":", 1)[0]


def _within(t: int, spans: Sequence[Interval], starts: Sequence[int]) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < spans[i][1]


class ProgramTrace:
    """The program's ranges of one traced window, its device ops with their launch times, and the host's waits.

    ``ranges`` are ``(name, start_ns, end_ns)`` with the prefix taken off; ``launches`` map a correlation id to
    the launch's host time; ``device_ops`` are ``(name, start_ns, end_ns, correlation_id)`` inside ``window``;
    ``waits`` are ``(name, start_ns, end_ns)`` of the host's blocking waits.
    """

    def __init__(self, ranges: Iterable[Tuple[str, int, int]], launches: Dict[int, int],
                 device_ops: Iterable[Tuple[str, int, int, int]], waits: Iterable[Tuple[str, int, int]],
                 window: Interval):
        self.window = window
        self.launches = launches
        self.device_ops = [(n, max(s, window[0]), min(e, window[1]), c) for n, s, e, c in device_ops
                           if e > window[0] and s < window[1]]
        self.waits = sorted(waits, key=lambda w: w[1])
        # each range with the path of the ranges around it (outermost first), and the timeline of the innermost
        # range: disjoint (start, end, path) segments wherever some range is open
        self.ranges: List[Tuple[str, int, int, Path]] = []
        self.segments: List[Tuple[int, int, Path]] = []
        stack: List[Tuple[int, str]] = []
        cur = 0

        def advance(t: int) -> None:
            nonlocal cur
            if stack and t > cur:
                self.segments.append((cur, t, tuple(n for _, n in stack)))
            cur = max(cur, t)

        for name, start, end in sorted(ranges, key=lambda r: (r[1], -r[2])):
            while stack and stack[-1][0] <= start:
                advance(stack[-1][0])
                stack.pop()
            if stack:
                advance(start)
                end = min(end, stack[-1][0])  # a range that outlives its parent is cut at the parent's end
            else:
                cur = start
            self.ranges.append((name, start, end, tuple(n for _, n in stack)))
            stack.append((end, name))
        while stack:
            advance(stack[-1][0])
            stack.pop()
        self._seg_starts = [s for s, _, _ in self.segments]

    def __bool__(self) -> bool:
        return bool(self.ranges)

    def path_at(self, t: int) -> Path:
        """The names of the program's ranges open at host time ``t``, outermost first (empty outside all)."""
        i = bisect.bisect_right(self._seg_starts, t) - 1
        if i >= 0 and t < self.segments[i][1]:
            return self.segments[i][2]
        return ()

    def ranges_in(self, site: str, within: Sequence[Interval],
                  outermost: bool = False) -> List[Tuple[str, int, int]]:
        """``(name, start, end)`` of the ranges of ``site`` that start inside the intervals ``within``; with
        ``outermost``, only those with no range of the same site around them."""
        spans = sorted(within)
        starts = [s for s, _ in spans]
        return [(name, s, e) for name, s, e, parents in self.ranges
                if site_of(name) == site and _within(s, spans, starts)
                and not (outermost and any(site_of(p) == site for p in parents))]

    def device_s_launched_in(self, site: str, within: Sequence[Interval]) -> float:
        """Seconds of device ops launched inside a range of ``site`` (at any depth), from host times inside the
        intervals ``within``."""
        spans = sorted(within)
        starts = [s for s, _ in spans]
        total = 0
        for _, s, e, corr in self.device_ops:
            t = self.launches.get(corr)
            if t is not None and _within(t, spans, starts) and any(site_of(n) == site for n in self.path_at(t)):
                total += e - s
        return total / 1e9

    def device_s_by_innermost(self, within: Sequence[Interval], by_op: bool = False) -> Dict[str, float]:
        """Seconds of device ops launched inside the intervals ``within``, by the innermost range open at the
        launch (``NO_RANGE`` outside all); with ``by_op``, keyed ``(op name, innermost)``."""
        spans = sorted(within)
        starts = [s for s, _ in spans]
        out: Dict = defaultdict(float)
        for name, s, e, corr in self.device_ops:
            t = self.launches.get(corr)
            if t is None or not _within(t, spans, starts):
                continue
            path = self.path_at(t)
            inner = path[-1] if path else NO_RANGE
            out[(name, inner) if by_op else inner] += (e - s) / 1e9
        return dict(out)

    def unlaunched_device_s(self) -> Dict[str, float]:
        """Seconds of device ops whose launch the trace does not hold (they cannot be tied to a range), by name."""
        out: Dict[str, float] = defaultdict(float)
        for name, s, e, c in self.device_ops:
            if c not in self.launches:
                out[name] += (e - s) / 1e9
        return dict(out)

    def idle_by_innermost(self, busy: Sequence[Interval], within: Sequence[Interval]) -> Dict[str, float]:
        """Seconds of the window that no device op covers (``busy`` is the sorted union of the device's
        intervals), inside the intervals ``within``, split by the innermost program range open at each moment
        (``NO_RANGE`` where none is)."""
        edges = [self.window[0]] + [t for iv in busy for t in iv] + [self.window[1]]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        gap_starts = [a for a, _ in gaps]
        out: Dict[str, float] = defaultdict(float)
        for ws, we in sorted(within):
            for gs, ge, _ in _clip_segments(gaps, gap_starts, ws, we):
                covered = 0
                for ss, se, path in _clip_segments(self.segments, self._seg_starts, gs, ge):
                    out[path[-1]] += (se - ss) / 1e9
                    covered += se - ss
                if ge - gs > covered:
                    out[NO_RANGE] += (ge - gs - covered) / 1e9
        return dict(out)

    def waits_outside(self, site: str, within: Sequence[Interval]) -> Dict[str, int]:
        """The host's blocking waits inside the intervals ``within`` that no range of ``site`` encloses, counted
        by the innermost range open at the wait."""
        spans = sorted(within)
        starts = [s for s, _ in spans]
        out: Dict[str, int] = defaultdict(int)
        for _, s, _e in self.waits:
            if _within(s, spans, starts):
                path = self.path_at(s)
                if not any(site_of(n) == site for n in path):
                    out[path[-1] if path else NO_RANGE] += 1
        return dict(out)


def _clip_segments(segments: Sequence[tuple], starts: Sequence[int], start: int, end: int):
    """The parts of sorted disjoint ``segments`` (``(start, end, ...)``, their starts in ``starts``) inside
    ``[start, end)``, each with its third field (None where there is none)."""
    i = max(0, bisect.bisect_right(starts, start) - 1)
    while i < len(segments) and segments[i][0] < end:
        s, e = max(segments[i][0], start), min(segments[i][1], end)
        if e > s:
            yield s, e, (segments[i][2] if len(segments[i]) > 2 else None)
        i += 1


def from_profiler(prof, window: Interval) -> ProgramTrace:
    """The :class:`ProgramTrace` of a finished ``torch.profiler.profile`` over ``window`` (the benchmark's
    ``portbench.window`` span, as :func:`devtrace.from_profiler` finds it). Device ops are those
    ``devtrace`` counts: every kernel, copy and set on the card that is no annotation."""
    ranges, device_ops, waits = [], [], []
    launches: Dict[int, int] = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type().name == "CUDA":
            if not (ev.is_user_annotation() or name.startswith(("ProfilerStep", BENCH_PREFIX, PROGRAM_PREFIX))):
                device_ops.append((name, ev.start_ns(), ev.end_ns(), ev.correlation_id()))
        elif name.startswith(PROGRAM_PREFIX):
            ranges.append((name[len(PROGRAM_PREFIX):], ev.start_ns(), ev.end_ns()))
        elif name.startswith(RUNTIME_PREFIX):  # the runtime's ids are not the torch ops': only calls are kept
            launches[ev.correlation_id()] = ev.start_ns()
            if name in WAIT_OPS:
                waits.append((name, ev.start_ns(), ev.end_ns()))
    return ProgramTrace(ranges, launches, device_ops, waits, window)
