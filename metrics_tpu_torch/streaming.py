"""The streaming-evaluation plane: windows, decay and drift.

JAX counterpart: `metrics_tpu/streaming.py`. Every accumulator of the
library is monotone over the whole run; live monitoring asks "accuracy over
the last N batches" and "has the prediction distribution drifted". This
plane answers on top of the journal and the sync plane, with no new byte
format and no new collective:

- :class:`Windowed` (JAX `:292`): tumbling or sliding windows as a ring of
  journal records (:func:`metrics_tpu_torch.ops.journal.pack_record`, the
  sync's byte pack). A window's value re-accumulates the retained slots into
  a scratch copy by each state's reduction (so ``max``/``min``/``cat``
  states window correctly) and computes it; with a ``journal_path`` each slot
  is one atomic, generation-ringed record. In a live world a close is agreed
  across the world (:func:`metrics_tpu_torch.parallel.bucketing.agree_step`)
  and merges the stride's state with one coalesced payload collective; a
  membership change mid-close raises ``EpochFault`` with the ring and the
  live states intact.
- :class:`Decayed` (JAX `:633`): an exponential moving average by scaling
  every ``sum`` state by ``0.5 ** (1 / halflife)`` before each update,
  through one cached step program.
- :func:`drift_report` (JAX `:761`): PSI and KS between two samples over one
  shared linear binning, counted by
  :func:`metrics_tpu_torch.ops.histogram.fused_bincount`, the CUDA kernel on
  the card. ``Windowed.drift_report`` scores the newest retained slot's raw
  states against the oldest.

Counters ``window_*``/``drift_*`` (:func:`streaming_stats`) fold into
``engine_stats()``; window values and drift scores ride
``telemetry_snapshot()['streaming']`` (:func:`streaming_snapshot`). Knobs:
``METRICS_TPU_WINDOW_DEFAULT_STRIDE``, ``METRICS_TPU_WINDOW_VALUES_KEPT``,
``METRICS_TPU_DRIFT_BINS``, ``METRICS_TPU_DRIFT_EPS``.

Devices: a window's slots hold host bytes; its scratch copy and the drift
counts live on the wrapped metric's device. :func:`drift_report` counts on
the samples' device when they are CUDA tensors, else on ``device`` (None: the
card, as every entry point of the port).
"""
from __future__ import annotations

import os
from collections import deque
from copy import deepcopy
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric, resolve_device
from metrics_tpu_torch.ops import engine as _engine
from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import journal as _journal
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.ops.histogram import fused_bincount
from metrics_tpu_torch.parallel import bucketing as _bucketing
from metrics_tpu_torch.parallel import sync as _psync
from metrics_tpu_torch.utils.exceptions import EpochFault

__all__ = [
    "Decayed",
    "Windowed",
    "drift_bins",
    "drift_eps",
    "drift_report",
    "streaming_snapshot",
    "streaming_stats",
    "window_default_stride",
    "window_values_kept",
]

_counters: Dict[str, int] = {
    "window_closes": 0,
    "window_close_payload_collectives": 0,
    "window_slots_packed": 0,
    "window_slot_writes": 0,
    "window_ring_demotions": 0,
    "window_epoch_trips": 0,
    "window_decay_ticks": 0,
    # value() serves the cached window value until the next close; a decay tick
    # reuses the state layout it derived once
    "window_value_cache_hits": 0,
    "window_decay_layout_reuses": 0,
    "drift_reports": 0,
}

#: One block per Windowed name: window id, boundaries, the newest window values.
_WINDOWS: Dict[str, Dict[str, Any]] = {}

#: The newest drift scores per report name: ``{name: {"psi", "ks", "bins"}}``.
_DRIFT: Dict[str, Dict[str, float]] = {}


def streaming_stats() -> Dict[str, int]:
    """The streaming counters: window closes and the payload collectives they
    issued, ring slots packed and written, ring demotions at a restore, epoch
    trips mid-close, decay ticks and drift reports.

    Example:
        >>> from metrics_tpu_torch.streaming import streaming_stats
        >>> streaming_stats()["window_closes"] >= 0
        True
    """
    return dict(_counters)


def _reset_streaming() -> None:
    for key in _counters:
        _counters[key] = 0
    _WINDOWS.clear()
    _DRIFT.clear()


_telemetry.register_reset("streaming", _reset_streaming)


def streaming_snapshot() -> Dict[str, Any]:
    """The ``streaming`` block of ``telemetry_snapshot()``: ``windows`` (per name:
    window id, boundaries, last close latency, the newest window values),
    ``drift`` (the newest scores per report) and ``arenas`` (per arena:
    capacity, tenants and the newest per-cohort values). Its flattened keys
    are gauges (the ``streaming_`` prefix): values move both ways."""
    from metrics_tpu_torch import arena as _arena

    return {
        "windows": {
            name: dict(block, values={k: dict(v) for k, v in block["values"].items()})
            for name, block in _WINDOWS.items()
        },
        "drift": {name: dict(scores) for name, scores in _DRIFT.items()},
        "arenas": _arena.arena_snapshot(),
    }


# ------------------------------------------------------------------ env knobs
class _StreamingWarnOwner:
    """Warn-once anchor for this module's knob parse warnings."""


_STRIDE_WARN_OWNER = _StreamingWarnOwner()
_KEPT_WARN_OWNER = _StreamingWarnOwner()
_BINS_WARN_OWNER = _StreamingWarnOwner()
_EPS_WARN_OWNER = _StreamingWarnOwner()


def window_default_stride() -> int:
    """The stride of a :class:`Windowed` built without one
    (``METRICS_TPU_WINDOW_DEFAULT_STRIDE``; 0, the default: tumbling, stride == window)."""
    return max(0, _psync._env_int("METRICS_TPU_WINDOW_DEFAULT_STRIDE", 0, owner=_STRIDE_WARN_OWNER))


def window_values_kept() -> int:
    """How many window values each window keeps in the telemetry registry
    (``METRICS_TPU_WINDOW_VALUES_KEPT``, default 8, at least 1)."""
    return max(1, _psync._env_int("METRICS_TPU_WINDOW_VALUES_KEPT", 8, owner=_KEPT_WARN_OWNER))


def drift_bins() -> int:
    """The bins of :func:`drift_report`'s shared binning (``METRICS_TPU_DRIFT_BINS``, default 16, at least 2)."""
    return max(2, _psync._env_int("METRICS_TPU_DRIFT_BINS", 16, owner=_BINS_WARN_OWNER))


def drift_eps() -> float:
    """The probability floor of every bin before PSI's log ratio
    (``METRICS_TPU_DRIFT_EPS``, default 1e-6; a value not above 0 falls back)."""
    eps = _psync._env_float("METRICS_TPU_DRIFT_EPS", 1e-6, owner=_EPS_WARN_OWNER)
    return float(eps) if eps and eps > 0 else 1e-6


# ------------------------------------------------------------------- plumbing
def _safe_name(name: Any) -> str:
    """A registry name safe as a Prometheus label value and a flattened key."""
    return "".join(c if (c.isalnum() or c in "_.:-/") else "_" for c in str(name)) or "_"


def _node_list(metric: Union[Metric, MetricCollection]) -> List[Metric]:
    """The node walk the record layout depends on."""
    if isinstance(metric, MetricCollection):
        return metric._journal_nodes()
    return _bucketing.tree_nodes(metric)


def _host_array(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.cpu().numpy()
    return np.asarray(v)


def _scalar_map(value: Any) -> Dict[str, float]:
    """A computed value as label-safe scalars: ``{"value": x}`` for a scalar, one
    entry per scalar member of a collection's dict; other leaves are skipped."""
    items = value.items() if isinstance(value, dict) else [("value", value)]
    out: Dict[str, float] = {}
    for key, v in items:
        try:
            arr = _host_array(v)
        except Exception:  # noqa: BLE001 - a value that is no number does not scrape
            continue
        if arr.size == 1 and np.issubdtype(arr.dtype, np.number):
            out[_safe_name(key)] = float(arr.reshape(()))
    return out


def _flat_states(nodes: List[Metric]) -> np.ndarray:
    """Every reduced state of ``nodes``, raveled and concatenated as float64: the
    raw-state sample the drift report bins."""
    rows: List[np.ndarray] = []
    for node in nodes:
        for name in node._reduction_specs:
            value = getattr(node, name)
            for leaf in value if isinstance(value, list) else [value]:
                arr = _host_array(leaf).astype(np.float64).ravel()
                if arr.size:
                    rows.append(arr)
    return np.concatenate(rows) if rows else np.zeros((0,), dtype=np.float64)


_MERGEABLE_SPECS = ("sum", "mean", "max", "min", "cat")


def _check_mergeable(nodes: List[Metric], what: str) -> None:
    """Raise at construction when a state's reduction cannot re-accumulate across slots."""
    for node in nodes:
        for name, spec in node._reduction_specs.items():
            if spec in _MERGEABLE_SPECS:
                continue
            if callable(node._reductions.get(name)):
                continue  # a custom reduction merges through its own callable
            raise ValueError(
                f"{what} cannot merge state {type(node).__name__}.{name}: reduction "
                f"spec {spec!r} has no slot-merge rule (supported: "
                f"{', '.join(_MERGEABLE_SPECS)}, or a custom reduction callable)"
            )


def _merge_record(nodes: List[Metric], manifest: Dict[str, Any], payload: bytes) -> None:
    """Merge one decoded slot into the live states of ``nodes``, by the cross-process
    reduce's rules (``sum`` adds, ``max``/``min`` take extrema, ``cat`` appends
    rows, ``mean`` weights by update counts, a custom spec applies its callable)."""
    staged = _journal.stage_states(nodes, manifest, payload)
    local_counts = [int(n._update_count) for n in nodes]
    rec_counts = list(manifest.get("update_counts", []))
    inc_counts = [int(rec_counts[i]) if i < len(rec_counts) else 0 for i in range(len(nodes))]
    for idx, name, value in staged:
        node = nodes[idx]
        spec = node._reduction_specs.get(name)
        local = getattr(node, name)
        if spec == "cat" or isinstance(local, list) or isinstance(value, list):
            local_rows = local if isinstance(local, list) else [local]
            inc_rows = value if isinstance(value, list) else [value]
            merged: Any = list(local_rows) + list(inc_rows)
        elif spec == "sum":
            merged = local + value
        elif spec == "mean":
            c_loc, c_inc = local_counts[idx], inc_counts[idx]
            total = max(c_loc + c_inc, 1)
            merged = (c_loc * local + c_inc * value) / total
        elif spec == "max":
            merged = torch.maximum(local, value)
        elif spec == "min":
            merged = torch.minimum(local, value)
        else:
            merged = node._reductions[name](torch.stack([local, value]))
        setattr(node, name, merged)
    for i, node in enumerate(nodes):
        node._update_count = local_counts[i] + inc_counts[i]
        node._computed = None
        node._is_synced = False
        node._cache = None


# ------------------------------------------------------------------- Windowed
class Windowed:
    """A tumbling or sliding window over a metric: a ring of packed snapshots.

    ``window`` is the width in updates and ``stride`` how many updates move it
    (``window % stride == 0``; ``stride == window``, the default, tumbles).
    Every ``stride`` updates the current accumulation closes: its state is
    packed as a ring slot (written to disk when ``journal_path`` is set), the
    live accumulator resets, and the window's value re-accumulates the
    ``window // stride`` retained slots into a scratch copy. In a live world a
    close is a collective every rank enters, like ``sync()``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric, Windowed
        >>> win = Windowed(MeanMetric(device="cpu"), window=4, stride=2, name="mean")
        >>> for step in range(6):
        ...     _ = win.update(torch.tensor([float(step)]))
        >>> win.window_id  # three closes: after updates 2, 4 and 6
        3
        >>> float(win.value())  # the mean of the last 4 updates: 2, 3, 4, 5
        3.5
    """

    def __init__(
        self,
        metric: Union[Metric, MetricCollection],
        window: int,
        stride: Optional[int] = None,
        *,
        name: Optional[str] = None,
        journal_path: Optional[str] = None,
    ) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Windowed wraps a metrics_tpu_torch `Metric` or `MetricCollection`, "
                f"got {type(metric).__name__}"
            )
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be a positive update count, got {window}")
        if stride is None:
            stride = window_default_stride() or window
        stride = int(stride)
        if stride < 1 or window % stride:
            raise ValueError(f"stride must be a positive divisor of window, got stride={stride} window={window}")
        self._base = metric
        self._window = window
        self._stride = stride
        self._slots_cap = window // stride
        self._name = _safe_name(name if name is not None else type(metric).__name__)
        self._journal_path = str(journal_path) if journal_path else None
        self._ring: Deque[Tuple[int, bytes]] = deque(maxlen=self._slots_cap)
        self._closes = 0
        self._pending = 0
        self._value_cache: Optional[Tuple[int, Any]] = None
        self._nodes = _node_list(metric)
        reason = _journal.journalable(self._nodes)
        if reason is not None:
            raise ValueError(f"Windowed requires a journal-packable metric tree: {reason}")
        _check_mergeable(self._nodes, "Windowed")
        self._scratch = deepcopy(metric)
        self._scratch.reset()
        self._scratch_nodes = _node_list(self._scratch)
        # the slots hold merged state already: the scratch compute must not sync again,
        # or a live world would multiply the window's value by its size
        for node in self._scratch_nodes:
            node.sync_on_compute = False
            node._to_sync = False

    @property
    def window_id(self) -> int:
        """The newest close id (agreed across a live world); 0 before any close."""
        return self._closes

    @property
    def slots(self) -> int:
        """Retained ring slots (at most ``window // stride``)."""
        return len(self._ring)

    @property
    def base(self) -> Union[Metric, MetricCollection]:
        """The live accumulator of the current stride."""
        return self._base

    # ------------------------------------------------------------ accumulation
    def update(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, Any]]:
        """Update the live accumulator; closes the window every ``stride`` updates and
        returns that close's summary (else None)."""
        self._base.update(*args, **kwargs)
        self._pending += 1
        if self._pending >= self._stride:
            return self.close_window()
        return None

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        """Forward through the live accumulator (its batch value), counting toward the stride."""
        out = self._base(*args, **kwargs)
        self._pending += 1
        if self._pending >= self._stride:
            self.close_window()
        return out

    def reset(self) -> None:
        """Drop every retained slot and the live accumulation; close ids stay monotonic."""
        self._ring.clear()
        self._base.reset()
        self._pending = 0

    # ------------------------------------------------------------- the close
    def close_window(self, *, distributed_available: Optional[Callable] = None) -> Dict[str, Any]:
        """Close the current stride: agree the close id across a live world and
        merge the stride's state (one payload collective; none in a world of
        one), pack it as a ring slot, write it when journaling, reset the live
        accumulator. Returns ``{window, value, world, epoch, slots, bytes}``."""
        base = self._base
        base._defer_barrier()
        t0 = _telemetry.now() if _telemetry.armed else 0.0
        dist_fn = distributed_available if distributed_available is not None else _psync.distributed_available
        live = bool(dist_fn()) if callable(dist_fn) else bool(dist_fn)
        close_id = self._closes + 1
        world = 1
        epoch = _psync.world_epoch()
        if live:
            try:
                agreement = _bucketing.agree_step(
                    self, close_id, site="window-close", device=self._nodes[0].device
                )
                # a rank that missed strides jumps to the agreed id rather than reissuing a stale one
                close_id = max(close_id, agreement["agreed"])
                world = agreement["world"]
                epoch = agreement["epoch"]
                payload0 = int(_psync.collective_stats().get("sync_payload_collectives", 0))
                base.sync(distributed_available=dist_fn)
                payload_delta = int(_psync.collective_stats().get("sync_payload_collectives", 0)) - payload0
                _counters["window_close_payload_collectives"] += max(payload_delta, 0)
            except EpochFault:
                # the membership changed mid-close: ring and live accumulator untouched
                _counters["window_epoch_trips"] += 1
                raise
        for node in self._nodes:
            node._defer_barrier()
            node._canonicalize_list_states()
        record = _journal.pack_record(
            self._nodes,
            manifest_extra={
                "epoch": epoch,
                "window": close_id,
                "window_name": self._name,
                "window_updates": self._window,
                "stride": self._stride,
                "world_size": world,
            },
        )
        self._closes = close_id
        self._ring.append((close_id, record))
        _counters["window_slots_packed"] += 1
        if self._journal_path:
            slot_path = self._slot_path(close_id % self._slots_cap)
            try:
                _journal.write_record(slot_path, record)
                _counters["window_slot_writes"] += 1
            except Exception as exc:  # noqa: BLE001 - classified; a broken disk costs persistence, not the close
                _faults.note_fault(_faults.classify(exc, "journal"), site="journal-write", owner=self, error=exc)
                _faults.warn_fault(
                    self,
                    "journal",
                    f"Window ring slot write to {slot_path!r} failed "
                    f"({type(exc).__name__}: {exc}); the in-memory ring is intact and "
                    "closes continue without persistence for this slot.",
                )
        base.reset()
        self._pending = 0
        value = self.value()
        _counters["window_closes"] += 1
        dur = (_telemetry.now() - t0) if (t0 and _telemetry.armed) else 0.0
        self._record_close(close_id, value, world=world, epoch=epoch, close_s=dur, nbytes=len(record))
        if t0 and _telemetry.armed:
            _telemetry.emit(
                "window-close", self._name, "streaming", t0, dur,
                {"window": close_id, "world": world, "slots": len(self._ring), "bytes": len(record)},
            )
        return {"window": close_id, "value": value, "world": world, "epoch": epoch,
                "slots": len(self._ring), "bytes": len(record)}

    def _record_close(self, close_id: int, value: Any, *, world: int, epoch: int, close_s: float,
                      nbytes: int) -> None:
        block = _WINDOWS.setdefault(self._name, {"name": self._name, "values": {}})
        block.update(
            window=close_id,
            oldest=self._ring[0][0] if self._ring else close_id,
            slots=len(self._ring),
            stride=self._stride,
            window_updates=self._window,
            world=world,
            epoch=epoch,
            last_close_s=close_s,
            last_record_bytes=nbytes,
        )
        values: Dict[str, Dict[str, float]] = block["values"]
        values[str(close_id)] = _scalar_map(value)
        keep = window_values_kept()
        for wid in sorted(values, key=int)[:-keep]:
            del values[wid]

    # ------------------------------------------------------------- the value
    def value(self) -> Any:
        """The window's value: the oldest retained slot restored into the scratch
        copy, every younger one merged on top (:func:`_merge_record`), then
        computed; None before the first close. Cached until the next close."""
        if not self._ring:
            return None
        cached = self._value_cache
        if cached is not None and cached[0] == self._closes:
            _counters["window_value_cache_hits"] += 1
            return cached[1]
        self._scratch.reset()
        first = True
        for _, record in self._ring:
            manifest, payload = _journal.decode_record(record, origin=f"<window {self._name}>")
            if first:
                _journal.restore_nodes(self._scratch_nodes, manifest, payload)
                first = False
            else:
                _merge_record(self._scratch_nodes, manifest, payload)
        value = self._scratch.compute()
        self._value_cache = (self._closes, value)
        return value

    compute = value

    # ----------------------------------------------------------- persistence
    def _slot_path(self, slot: int) -> str:
        return f"{self._journal_path}.slot{slot}"

    def restore(self) -> Dict[str, Any]:
        """Rebuild the ring from the slot files. Each slot walks its generation ring
        newest first: a torn or checksum-failed generation counts a ``journal``
        fault and a ``window_ring_demotions`` and demotes to the previous good
        one. Returns ``{slots, window, value}``."""
        if not self._journal_path:
            raise ValueError("this Windowed was constructed without journal_path")
        recovered: List[Tuple[int, bytes]] = []
        for slot in range(self._slots_cap):
            path = self._slot_path(slot)
            for gen in range(_journal.journal_generations() + 8):
                gpath = _journal._gen_path(path, gen)
                if not os.path.exists(gpath):
                    continue
                try:
                    with open(gpath, "rb") as fh:
                        data = fh.read()
                    manifest, _ = _journal.decode_record(data, origin=repr(gpath))
                except Exception as exc:  # noqa: BLE001 - demote to the previous generation
                    _counters["window_ring_demotions"] += 1
                    _faults.note_fault(_faults.classify(exc, "journal"), site="journal-load", owner=self, error=exc)
                    _faults.warn_fault(
                        self,
                        "journal",
                        f"Window ring slot {gpath!r} failed verification "
                        f"({type(exc).__name__}: {exc}); demoting to the previous good "
                        "generation of this slot.",
                    )
                    continue
                recovered.append((int(manifest.get("window", 0)), data))
                break
        recovered.sort(key=lambda r: r[0])
        self._ring.clear()
        self._value_cache = None
        for close_id, data in recovered[-self._slots_cap:]:
            self._ring.append((close_id, data))
        if recovered:
            self._closes = max(self._closes, recovered[-1][0])
        return {"slots": len(self._ring), "window": self._closes, "value": self.value()}

    # ------------------------------------------------------------------ drift
    def drift_report(self, reference: Any = None, *, bins: Optional[int] = None) -> Dict[str, Any]:
        """PSI/KS of the newest retained slot's raw states against the oldest one (or
        an explicit ``reference`` sample), counted on the metric's device."""
        if not self._ring:
            raise ValueError("drift_report needs at least one closed slot")
        current = self._slot_sample(-1)
        if reference is None:
            if len(self._ring) < 2:
                raise ValueError("drift_report needs >= 2 retained slots (or an explicit reference sample)")
            reference = self._slot_sample(0)
        return drift_report(current, reference, bins=bins, name=self._name,
                            device=self._nodes[0].device)

    def _slot_sample(self, pos: int) -> np.ndarray:
        _, record = self._ring[pos]
        manifest, payload = _journal.decode_record(record, origin=f"<window {self._name}>")
        self._scratch.reset()
        _journal.restore_nodes(self._scratch_nodes, manifest, payload)
        return _flat_states(self._scratch_nodes)


# -------------------------------------------------------------------- Decayed
class Decayed:
    """An exponential moving average over a metric's ``sum`` states.

    Before each update every state scales by ``0.5 ** (1 / halflife)``
    (``halflife`` in updates) through one cached step, so after ``T`` updates
    contribution ``i`` weighs ``decay ** (T - i)`` and ``compute()`` serves the
    weighted value with no extra state. Every state must reduce by ``sum``
    over a floating dtype; any other raises, naming the state.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric, Decayed
        >>> ema = Decayed(MeanMetric(device="cpu"), halflife=2.0)
        >>> for x in (0.0, 0.0, 8.0):
        ...     ema.update(torch.tensor([x]))
        >>> round(float(ema.compute()), 4)  # 8 / (1 + d + d**2), d = 0.5**(1/2)
        3.6247
    """

    def __init__(self, metric: Union[Metric, MetricCollection], halflife: float, *,
                 name: Optional[str] = None) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Decayed wraps a metrics_tpu_torch `Metric` or `MetricCollection`, "
                f"got {type(metric).__name__}"
            )
        halflife = float(halflife)
        if not halflife > 0:
            raise ValueError(f"halflife must be a positive update count, got {halflife}")
        self._base = metric
        self._name = _safe_name(name if name is not None else type(metric).__name__)
        self._decay = float(0.5 ** (1.0 / halflife))
        self._halflife = halflife
        self._nodes = _node_list(metric)
        self._tick_layout: Optional[tuple] = None
        for node in self._nodes:
            for sname, spec in node._reduction_specs.items():
                if spec != "sum":
                    raise ValueError(
                        f"Decayed requires sum-reduction states; {type(node).__name__}.{sname} reduces by {spec!r}"
                    )
                value = getattr(node, sname)
                for row in value if isinstance(value, list) else [value]:
                    if not torch.as_tensor(row).is_floating_point():
                        raise ValueError(
                            f"Decayed requires floating states; {type(node).__name__}.{sname} "
                            f"is {torch.as_tensor(row).dtype} (an integer count cannot decay exactly)"
                        )

    @property
    def base(self) -> Union[Metric, MetricCollection]:
        return self._base

    @property
    def decay(self) -> float:
        """The factor each update keeps, ``0.5 ** (1 / halflife)``."""
        return self._decay

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Decay every state one tick, then land the update on top."""
        self._decay_tick()
        self._base.update(*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        self._decay_tick()
        return self._base(*args, **kwargs)

    def compute(self) -> Any:
        return self._base.compute()

    def reset(self) -> None:
        self._base.reset()

    def _decay_tick(self) -> None:
        state: Dict[str, Any] = {}
        for i, node in enumerate(self._nodes):
            node._defer_barrier()
            for sname in node._reduction_specs:
                state[f"{i}:{sname}"] = getattr(node, sname)
        if not state:
            return
        decay = self._decay
        # the layout is fixed at construction (names and float dtypes): derive it once
        dtypes = self._tick_layout
        if dtypes is None:
            dtypes = tuple(sorted((k, str(v.dtype)) for k, v in state.items()))
            self._tick_layout = dtypes
        else:
            _counters["window_decay_layout_reuses"] += 1

        def build() -> Callable:
            def step(st: Dict[str, Any]) -> Dict[str, Any]:
                return {k: v * torch.tensor(decay, dtype=v.dtype, device=v.device) for k, v in st.items()}

            return step

        exe = _engine.acquire_keyed(("streaming-decay", decay, dtypes), build)
        new_state = exe.run(state)
        for i, node in enumerate(self._nodes):
            for sname in node._reduction_specs:
                setattr(node, sname, new_state[f"{i}:{sname}"])
            node._computed = None
            node._is_synced = False
            node._cache = None
        _counters["window_decay_ticks"] += 1


# ---------------------------------------------------------------------- drift
def _sample(x: Any) -> np.ndarray:
    # a float64 sample rounds to float32 first, as the JAX package's does (its arrays are float32)
    arr = _host_array(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr.astype(np.float64).ravel()


def drift_report(
    current: Any,
    reference: Any,
    *,
    bins: Optional[int] = None,
    eps: Optional[float] = None,
    name: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Any]:
    """PSI and KS between two samples over one shared linear binning.

    Both samples bin into ``bins`` equal-width buckets over their combined
    finite range; the counts come from
    :func:`~metrics_tpu_torch.ops.histogram.fused_bincount` (the CUDA kernel on
    the card: on the samples' device when they are CUDA tensors, else on
    ``device``, None meaning the card). Each histogram takes an ``eps``
    probability floor and two scores come back: ``psi``,
    ``sum((p - q) * ln(p / q))``, and ``ks``, ``max |CDF_p - CDF_q|``.
    ``name`` records the scores in the streaming registry.

    Example:
        >>> import numpy as np
        >>> from metrics_tpu_torch import drift_report
        >>> same = drift_report(np.arange(100.0), np.arange(100.0), device="cpu")
        >>> round(same["psi"], 6), round(same["ks"], 6)
        (0.0, 0.0)
        >>> shifted = drift_report(np.arange(100.0), np.arange(100.0) + 80.0, device="cpu")
        >>> shifted["psi"] > 0.2 and shifted["ks"] > 0.2
        True
    """
    t0 = _telemetry.now() if _telemetry.armed else 0.0
    on = next((x.device for x in (current, reference) if isinstance(x, torch.Tensor) and x.is_cuda), None)
    dev = on if on is not None else resolve_device(device)
    bins = int(bins) if bins else drift_bins()
    eps = float(eps) if eps else drift_eps()
    cur = _sample(current)
    ref = _sample(reference)
    cur = cur[np.isfinite(cur)]
    ref = ref[np.isfinite(ref)]
    if cur.size == 0 or ref.size == 0:
        raise ValueError("drift_report needs non-empty finite current and reference samples")
    lo = float(min(cur.min(), ref.min()))
    hi = float(max(cur.max(), ref.max()))
    if hi <= lo:
        hi = lo + 1.0  # constant samples: all the mass in bin 0 on both sides
    scale = bins / (hi - lo)
    cur_idx = torch.from_numpy(np.clip((cur - lo) * scale, 0, bins - 1).astype(np.int32)).to(dev)
    ref_idx = torch.from_numpy(np.clip((ref - lo) * scale, 0, bins - 1).astype(np.int32)).to(dev)
    p = fused_bincount(cur_idx, bins).cpu().numpy().astype(np.float64)
    q = fused_bincount(ref_idx, bins).cpu().numpy().astype(np.float64)
    p = (p + eps) / (p.sum() + eps * bins)
    q = (q + eps) / (q.sum() + eps * bins)
    psi = float(np.sum((p - q) * np.log(p / q)))
    ks = float(np.max(np.abs(np.cumsum(p) - np.cumsum(q))))
    out = {"psi": psi, "ks": ks, "bins": bins, "n_current": int(cur.size), "n_reference": int(ref.size),
           "lo": lo, "hi": hi}
    _counters["drift_reports"] += 1
    if name is not None:
        _DRIFT[_safe_name(name)] = {"psi": psi, "ks": ks, "bins": bins}
    if t0 and _telemetry.armed:
        _telemetry.emit(
            "drift-report", _safe_name(name) if name is not None else None, "streaming",
            t0, _telemetry.now() - t0, {"bins": bins, "psi": psi, "ks": ks},
        )
    return out
