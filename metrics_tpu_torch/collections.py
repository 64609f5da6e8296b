"""MetricCollection: one call fanned out over several metrics, with compute groups.

JAX counterpart: `metrics_tpu/collections.py` (construction `:76-92`, update
with compute groups `:998-1027`, compute `:1039-1102`, group merging
`:2062-2140`); reference `src/torchmetrics/collections.py`.

Compute groups: after the first update, metrics whose states are equal are
merged into a group, and from then on only the group's first member (its
leader) updates. The other members point at the leader's state tensors; the
references are renewed whenever the members are read, because an update
rebinds the leader's states to new tensors.

As in TorchMetrics, the collection is an ``nn.ModuleDict``, so ``.to()`` and
``state_dict()`` reach every member.

Suite sync (`metrics_tpu/collections.py` ``_partition_sync_members`` `:1144`,
``sync`` `:1362`, ``unsync`` `:1489`, ``_auto_sync_context`` `:1533`): with
more than one process, ``compute()`` syncs the whole suite in one payload
collective before its members compute, then restores their local states. A
pack or unpack failure demotes the suite's ``sync-pack`` lane and replays
the sync member by member, bit for bit; clean suite steps and syncs
re-promote it.

Deferred dispatch and chunks (`metrics_tpu/collections.py` `:294-990`): once
the compute groups are known and a signature has passed one eager call, an
``update`` enqueues into ONE suite queue for every group leader (the states of
every member are held by it), and a ``forward`` of a suite whose members all
defer enqueues into one suite queue and returns a dict of
:class:`~metrics_tpu_torch.ops.engine.LazyValue`. Any member's state read,
``compute``, ``reset``, ``sync``, ``state_dict``, a copy, ``.to()`` and the
journal flush it, in enqueue order. :meth:`MetricCollection.update_many` and
:meth:`MetricCollection.forward_many` take a leading steps axis.

Journal (`metrics_tpu/collections.py` ``save_state``/``load_state``/
``journal``/``_journal_tick`` `:1616-1700`): the whole suite is one record;
``journal(path, every_n)`` saves every ``every_n`` update or forward calls,
and a failed write demotes the suite's ``journal`` lane instead of breaking
the update. Each ``update``/``forward`` emits a ``suite-step`` span and each
sync a ``suite-sync`` span.

The sync planes beyond the core (`metrics_tpu/collections.py` ``compute``
`:1039`, ``sync_async`` `:1198`, ``sync`` `:1362`, ``sync_health`` `:1569`,
``checkpoint_barrier`` `:1702`, ``rejoin`` `:1754`): the suite degrades and
re-promotes as one (its own ``sync-degrade`` lane), dispatches its one
payload collective with :meth:`MetricCollection.sync_async`, journals every
process at one agreed step with :meth:`MetricCollection.checkpoint_barrier`,
and a restarted process re-enters the world with
:meth:`MetricCollection.rejoin`.

The functional core (`metrics_tpu/collections.py` `:2008-2059`):
:meth:`MetricCollection.as_functions`, ``init``, ``apply_update``,
``apply_compute`` and ``host_handoff`` run the whole suite as one tree of
``{member: states}`` (:mod:`metrics_tpu_torch.functional_core`), each member's
kwargs filtered as the stateful update filters them, the values named with the
collection's flatten and prefix rule. The functional update runs every
member: compute groups are the stateful shell's.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from metrics_tpu_torch.metric import (
    Metric,
    _chunk_steps,
    _deferrable_call,
    _degradable_sync_failure,
    _distributed_available,
    _enter_degraded,
    _inflight_block,
    _note_degraded_serve,
    _note_quorum_serve,
    _forward_signature,
    _stack_values,
    _stamp_last_good,
)
from metrics_tpu_torch.ops import engine as _engine
from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.parallel import bucketing as _bucketing
from metrics_tpu_torch.parallel import sync as _psync
from metrics_tpu_torch.utils import checks as _checks
from metrics_tpu_torch.utils.data import _flatten_dict, allclose
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

_UNSET_GROUP = object()


def _filtered(m: Metric, kwargs: dict) -> dict:
    return m._filter_kwargs(**kwargs) if kwargs else kwargs


def _suite_many_step(suite: "MetricCollection", members: List[Tuple[str, Metric]], steps: List[Tuple[tuple, dict]],
                     counts0: List[int], with_values: bool) -> list:
    """The step program of a suite's queues and of its ``update_many``/``forward_many``:
    per step, every group leader's update (``members`` are the leaders), or
    every member's reduce-path forward, each with the update count it saw on
    the per-call path. Takes the suite as an argument, so that the cached
    program keeps no instance alive."""
    values = []
    for j, (a, k) in enumerate(steps):
        if with_values:
            row = {}
            for (name, m), c0 in zip(members, counts0):
                object.__setattr__(m, "_update_count", c0 + j)
                row[name] = m._forward_reduce_state_update(*a, **_filtered(m, k))
            values.append(row)
        else:
            for (_, m), c0 in zip(members, counts0):
                object.__setattr__(m, "_update_count", c0 + j + 1)
                m._update_step(a, _filtered(m, k))
    return values


def _build_suite_many():
    return _suite_many_step


class MetricCollection(nn.ModuleDict):
    """Chain metrics with the same call signature into a single object.

    Args:
        metrics: a Metric, a sequence of Metrics (keyed by class name), or a
            dict name -> Metric (keys sorted alphabetically).
        prefix / postfix: strings added around output-dict keys.
        compute_groups: ``True`` to find metrics that share identical state
            after the first update (only the group leader then updates); a
            list of lists to pin groups by hand; ``False`` to disable.
        device: when given, every member is moved there; when None, each
            member stays on the device it was built for.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricCollection, Precision
        >>> collection = MetricCollection([Accuracy(num_classes=3, device="cpu"),
        ...                                Precision(num_classes=3, average="macro", device="cpu")])
        >>> collection.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> {k: round(float(v), 4) for k, v in sorted(collection.compute().items())}
        {'Accuracy': 0.75, 'Precision': 0.8333}
    """

    # the dispatch engine (see the module docstring); _fused_seen holds the suite
    # signatures that passed one eager call
    _defer_ok: bool = True
    _defer_suspended: bool = False
    _many_ok: bool = True
    _fused_seen: Optional[dict] = None

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._state_is_copy = False
        self._groups: Dict[int, List[str]] = {}

        self.add_metrics(metrics, *additional_metrics)
        if device is not None:
            self.to(device)

    # ----------------------------------------------------------- call surface
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call ``forward`` on every metric, kwargs filtered per update signature."""
        with _telemetry.timed("suite-step", self, "suite", {"api": "forward"}):
            deferred = self._defer_forward(args, kwargs)
            if deferred is not None:
                self._journal_tick()
                return deferred
            members = list(self.items(keep_base=True, copy_state=False))
            res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in members}
            self._note_forward_signature(members, args, kwargs, res)
            res = _flatten_dict(res)
            self._fault_note_clean()
            self._journal_tick()
            return {self._set_name(k): v for k, v in res.items()}

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every metric, or once the groups are known, every group's leader."""
        with _telemetry.timed("suite-step", self, "suite", {"api": "update"}):
            if self._defer_update(args, kwargs):
                self._journal_tick()
                return
            if self._groups_checked:
                for cg in self._groups.values():
                    m0 = self._modules[cg[0]]
                    m0.update(*args, **m0._filter_kwargs(**kwargs))
                    for name in cg[1:]:
                        mi = self._modules[name]
                        mi._update_count = m0._update_count
                        mi._computed = None  # the leader's update invalidates the members' caches
                if self._state_is_copy:
                    self._compute_groups_create_state_ref()
                    self._state_is_copy = False
            else:
                for _, m in self.items(keep_base=True, copy_state=False):
                    m.update(*args, **m._filter_kwargs(**kwargs))
                if self._enable_compute_groups:
                    self._merge_compute_groups()
                    self._compute_groups_create_state_ref()
                    self._groups_checked = True
            # a clean suite step: demoted suite lanes count it toward their recovery edge
            self._fault_note_clean()
            self._journal_tick()

    # ------------------------------------------------------ deferred dispatch
    def _defer_barrier(self) -> None:
        """Flush the suite's pending queue, then each member's own (a member the suite
        queue could not take defers on its own) and host buffers."""
        q = self.__dict__.get("_defer_pending")
        if q is not None:
            q.flush()
        for m in self._modules.values():
            m._defer_barrier()

    def _leaders(self) -> List[Tuple[str, Metric]]:
        return [(cg[0], self._modules[cg[0]]) for cg in self._groups.values()]

    def _open_queue(self, kind: str, signature: tuple, members: List[Tuple[str, Metric]], consumed: dict,
                    kwargs: dict, flush_fn) -> _engine.PendingQueue:
        """A suite queue holding the states of every member (a follower's read flushes it too)."""
        everyone = list(self._modules.values())
        for m in everyone:
            m._defer_barrier()  # a member's own pending calls come first
        q = _engine.PendingQueue(kind, signature, flush_fn)
        q.meta = (members, frozenset(consumed), frozenset(kwargs), [m._update_count for _, m in members])
        q.adopt(self, ())
        for m in everyone:
            q.adopt(m, m._defaults)
        return q

    def _pending_fast(self, kind: str, args: tuple, kwargs: dict, mode: str):
        """The open suite queue of ``kind`` and this call's consumed kwargs when
        the call extends it, else None (a queue of another shape is flushed): a
        new or dropped kwarg, or a switch to mode ``full``, takes the slow path."""
        q = self.__dict__.get("_defer_pending")
        if q is None:
            return None
        if q.kind == kind and frozenset(kwargs) == q.meta[2] and mode != "full":
            consumed = {k: v for k, v in kwargs.items() if k in q.meta[1]}
            if q.matches(kind, _forward_signature(args, consumed)):
                return q, consumed
        q.flush()
        return None

    def _defer_update(self, args: tuple, kwargs: dict) -> bool:
        """Enqueue one suite ``update`` for every group leader; False when it must run now."""
        if not (self._groups_checked and not self._state_is_copy and self._defer_ok and not self._defer_suspended
                and _engine.defer_enabled()):
            return False
        mode = _checks._get_validation_mode()
        fast = self._pending_fast("collection-update", args, kwargs, mode)
        if fast is not None:
            q, consumed = fast
        else:
            leaders = self._leaders()
            if mode == "full" or not leaders:
                return False
            consumed = {}
            for _, m in leaders:
                consumed.update(_filtered(m, kwargs))
            if not _deferrable_call(args, consumed):
                return False
            for _, m in leaders:
                seen = m._fused_seen_signatures
                if not (m._defer_ok and m._fusable_states() and seen is not None
                        and ("__update__", _forward_signature(args, _filtered(m, kwargs))) in seen):
                    return False  # each leader's first call of a signature runs validated
            q = self._open_queue("collection-update", _forward_signature(args, consumed), leaders, consumed, kwargs,
                                 self._flush_suite_queue)
        q.enqueue(args, consumed)
        for cg in self._groups.values():
            m0 = self._modules[cg[0]]
            m0._update_count += 1
            m0._computed = None
            for name in cg[1:]:
                mi = self._modules[name]
                mi._update_count = m0._update_count
                mi._computed = None
        if q.should_flush():
            q.flush()
        return True

    def _forward_members(self) -> Optional[List[Tuple[str, Metric]]]:
        """The members when a suite forward may enqueue, else None."""
        members = list(self.items(keep_base=True, copy_state=False))
        if (
            not members
            or any(not (m._defer_ok and m._fusable_states()) or type(m).forward is not Metric.forward
                   or m.full_state_update or m.full_state_update is None or m.dist_sync_on_step or m._is_synced
                   for _, m in members)
            or len({m._update_count for _, m in members}) != 1
            or len({id(m) for _, m in members}) != len(members)
        ):
            return None
        return members

    def _defer_forward(self, args: tuple, kwargs: dict) -> Optional[Dict[str, Any]]:
        """Enqueue one suite ``forward``; a dict of lazy handles, or None when it must run now."""
        if not (self._defer_ok and not self._defer_suspended and _engine.defer_enabled()):
            return None
        mode = _checks._get_validation_mode()
        fast = self._pending_fast("collection-forward", args, kwargs, mode)
        if fast is not None:
            q, consumed = fast
            members = q.meta[0]
        else:
            if mode == "full" or self._fused_seen is None:
                return None
            members = self._forward_members()
            if members is None:
                return None
            consumed = {}
            for _, m in members:
                consumed.update(_filtered(m, kwargs))
            signature = _forward_signature(args, consumed)
            if signature not in self._fused_seen:
                return None  # the first call of a signature runs member by member, validated
            q = self._open_queue("collection-forward", signature, members, consumed, kwargs,
                                 self._flush_suite_queue)
        handles = {}
        for name, m in members:
            h = handles[name] = _engine.LazyValue(q)
            m._update_count += 1
            m._is_synced = False
            m._should_unsync = True
            m._to_sync = m.sync_on_compute
            m._computed = None
            object.__setattr__(m, "_forward_cache", h)
        q.enqueue(args, consumed, handles)
        if q.should_flush():
            q.flush()
        return {self._set_name(name): handles[name] for name, _ in members}

    def _note_forward_signature(self, members: List[Tuple[str, Metric]], args: tuple, kwargs: dict,
                                res: Dict[str, Any]) -> None:
        """After a member-wise forward: record its suite signature when the next
        such call may enqueue (every member defers, every value one tensor)."""
        if _checks._get_validation_mode() == "full" or self._forward_members() is None:
            return
        consumed: Dict[str, Any] = {}
        for _, m in members:
            consumed.update(_filtered(m, kwargs))
        if not _deferrable_call(args, consumed):
            return
        if not all(isinstance(v, (torch.Tensor, _engine.LazyValue)) for v in res.values()):
            return
        if self._fused_seen is None:
            object.__setattr__(self, "_fused_seen", {})
        self._fused_seen[_forward_signature(args, consumed)] = None
        while len(self._fused_seen) > Metric._FUSED_SIG_CAP:
            self._fused_seen.pop(next(iter(self._fused_seen)))

    def _many_program(self, with_values: bool) -> _engine.Executable:
        """The suite's step program for chunks of calls, acquired once per suite."""
        programs = self.__dict__.get("_many_programs")
        if programs is None:
            programs = {}
            object.__setattr__(self, "_many_programs", programs)
        exe = programs.get(with_values)
        if exe is None:
            key = ("suite-many", with_values) + tuple(
                (name, _engine.config_fingerprint(m)) for name, m in self._modules.items()
            )
            exe = programs[with_values] = _engine.acquire_keyed(key, _build_suite_many)
        return exe

    def _suspend(self, members: List[Metric]) -> list:
        flags = [(o, o._defer_suspended) for o in [self, *members]]
        for o, _ in flags:
            object.__setattr__(o, "_defer_suspended", True)
        return flags

    def _flush_suite_queue(self, q: _engine.PendingQueue) -> None:
        """Run a suite queue in chunks through the suite's step program, then point
        the group members at their leaders' states again. A chunk that fails is
        undone and the rest replays eagerly; deferral stays off for the suite
        until its ``defer`` ladder lane re-promotes."""
        members, counts0 = q.meta[0], q.meta[3]
        entries, handles, with_values = q.entries, q.handles, q.kind == "collection-forward"
        targets = [m for _, m in members]
        counts_now = [m._update_count for m in targets]
        caches = [m.__dict__.get("_forward_cache") for m in targets]
        q.release()
        applied, snaps = 0, None
        flags = self._suspend(targets)
        try:
            try:
                program = self._many_program(with_values)
                for index, n in enumerate(_engine.pow2_chunks(len(entries))):
                    snaps = [m._state_snapshot() for m in targets]
                    if _faults.armed:
                        _faults.maybe_fail("flush-chunk", index=index)
                    rows = program.run(self, (members, entries[applied:applied + n], [c + applied for c in counts0],
                                              with_values))
                    for j, row in enumerate(rows):
                        for name, value in row.items():
                            handles[applied + j][name]._set_value(value)
                    applied += n
            except Exception as exc:  # noqa: BLE001 - the chunk undone, the rest replayed eagerly
                if snaps is not None:
                    for m, snap in zip(targets, snaps):
                        m._restore_state(snap)
                object.__setattr__(self, "_defer_ok", False)
                _faults.demote(
                    self,
                    "defer",
                    exc,
                    tier="chunked",
                    site="suite-flush",
                    warn=(
                        f"Deferred suite {q.kind[len('collection-'):]} flush raised {type(exc).__name__}: {exc}."
                        " Replaying the queue eagerly and disabling deferred dispatch for this collection; the"
                        " degradation ladder re-probes deferral after clean steps."
                    ),
                )
                _engine.note_deferred_flush(fallback=True)
                for j in range(applied, len(entries)):
                    try:
                        rows = _suite_many_step(self, members, entries[j:j + 1], [c + j for c in counts0], with_values)
                    except Exception:
                        for m, c in zip(targets, counts_now):  # the calls after the failing one never ran
                            object.__setattr__(m, "_update_count", c - (len(entries) - j - 1))
                        raise
                    for name, value in (rows[0] if with_values else {}).items():
                        handles[j][name]._set_value(value)
            else:
                _engine.note_deferred_flush()
                self._fault_note_clean(len(entries))
            for m, c in zip(targets, counts_now):
                object.__setattr__(m, "_update_count", c)
        finally:
            for o, flag in flags:
                object.__setattr__(o, "_defer_suspended", flag)
            for m, cache in zip(targets, caches):
                object.__setattr__(m, "_forward_cache", cache)
            if not with_values:
                self._repoint_groups()

    def _repoint_groups(self) -> None:
        """Group members share their leader's states again (after a leader-only flush or chunk)."""
        for cg in self._groups.values():
            m0 = self._modules[cg[0]]
            for name in cg[1:]:
                mi = self._modules[name]
                for state in m0._defaults:
                    object.__setattr__(mi, state, m0.__dict__.get(state))
                object.__setattr__(mi, "_update_count", m0._update_count)

    def precompile(self, *args: Any, defer_chunks: Optional[int] = None, forward: bool = True, compute: bool = True,
                   sync: bool = False, **kwargs: Any) -> Dict[str, Any]:
        """Pay every program's one-time costs for the declared batch shapes, then put
        every member's states back bit for bit: a fresh process warms up before its
        first served step instead of at it.

        ``args``/``kwargs`` mirror one :meth:`update`; their tensors give the shapes,
        dtypes and devices (a tensor on the ``meta`` device declares them without
        data, for the suite's device). Zero-filled batches of them go through the
        real paths: two updates (the first validated), then one flush at each
        power-of-two queue length up to ``defer_chunks`` (default
        :func:`~metrics_tpu_torch.ops.engine.defer_max_pending`; 0 warms the per-call
        paths only), the same for :meth:`forward` with ``forward=True``, one
        :meth:`compute` with ``compute=True`` (a failure on zero-filled states is
        ignored), and a sync context with ``sync=True`` (a collective: every rank
        calls it together). Deferral needs validation mode ``"first"`` or ``"off"``.
        With the persistent program cache on, first runs store their signatures
        and stored ones count as hits. Returns ``{steps, compiles,
        progcache_hits, progcache_stores, programs}``."""
        device = next((m.device for _, m in self.items(keep_base=True, copy_state=False)), torch.device("cpu"))

        def _zeros(leaf: Any) -> Any:
            if isinstance(leaf, torch.Tensor):
                return torch.zeros(tuple(leaf.shape), dtype=leaf.dtype,
                                   device=device if leaf.device.type == "meta" else leaf.device)
            if isinstance(leaf, (list, tuple)):
                return type(leaf)(_zeros(v) for v in leaf)
            if isinstance(leaf, dict):
                return {k: _zeros(v) for k, v in leaf.items()}
            return leaf

        ex_args, ex_kwargs = _zeros(args), _zeros(kwargs)
        members = list(self.items(keep_base=True, copy_state=False))
        owners = (self,) + tuple(m for _, m in members)
        _engine.flush_barrier(owners)
        snap = {}
        for name, m in members:
            states = {s: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
                      for s, v in m.metric_state.items()}
            snap[name] = (states, m._update_count, m._computed, m.__dict__.get("_forward_cache"))
        before = _engine.program_summary()
        stats0 = _engine.engine_stats()
        cap = int(defer_chunks) if defer_chunks is not None else _engine.defer_max_pending()
        if not _engine.defer_enabled():
            cap = 0  # every call runs at once: no queue lengths exist
        steps = 0

        def drive(call) -> None:
            nonlocal steps
            for _ in range(2):  # the first call of a signature runs validated, the second takes the fast path
                call(*ex_args, **ex_kwargs)
                steps += 1
            _engine.flush_barrier(owners)
            c = 1
            while c <= cap:  # one flush at each power-of-two queue length a live queue can split into
                for _ in range(c):
                    call(*ex_args, **ex_kwargs)
                    steps += 1
                _engine.flush_barrier(owners)
                c <<= 1

        try:
            drive(self.update)
            if forward:
                try:
                    drive(self.forward)
                except Exception:  # noqa: BLE001 - the warm-up is best effort
                    pass
            if compute:
                try:
                    self.compute()
                except Exception:  # noqa: BLE001 - zero-filled states may rightly refuse a compute
                    pass
            if sync:
                with self.sync_context():
                    pass
        finally:
            _engine.flush_barrier(owners)
            for name, m in members:
                states, count, computed, forward_cache = snap[name]
                for s, v in states.items():
                    object.__setattr__(m, s, v)
                object.__setattr__(m, "_update_count", count)
                object.__setattr__(m, "_computed", computed)
                object.__setattr__(m, "_forward_cache", forward_cache)
            self._repoint_groups()
        after = _engine.program_summary()
        stats1 = _engine.engine_stats()
        return {
            "steps": steps,
            "compiles": after["compiles"] - before["compiles"],
            "progcache_hits": int(stats1.get("progcache_hits", 0)) - int(stats0.get("progcache_hits", 0)),
            "progcache_stores": int(stats1.get("progcache_stores", 0)) - int(stats0.get("progcache_stores", 0)),
            "programs": after["count"] - before["count"],
        }

    # ---------------------------------------------------------- batched steps
    def update_many(self, *args: Any, **kwargs: Any) -> None:
        """``n`` suite updates in one call: a leading steps axis on every tensor
        argument (see :meth:`Metric.update_many`)."""
        self._run_many(False, args, kwargs)

    def forward_many(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, Any]]:
        """``forward`` of the whole suite over a chunk of steps: ``{name: per-step
        values stacked on a leading axis}``."""
        return self._run_many(True, args, kwargs)

    def _run_many(self, with_values: bool, args: tuple, kwargs: dict) -> Any:
        self._defer_barrier()  # a chunk applies after the calls already queued
        members = list(self.items(keep_base=True, copy_state=False))
        for _, m in members:
            m._defer_barrier()
        consumed: Dict[str, Any] = {}
        for _, m in members:
            consumed.update(_filtered(m, kwargs))
        steps = _chunk_steps(args, consumed)
        eligible = (
            self._many_ok
            and _checks._get_validation_mode() != "full"
            and self._forward_members() is not None
            and all(m._many_ok for _, m in members)
            and _deferrable_call(args, consumed)
        )
        if not eligible:
            return self._run_many_eager(with_values, steps)
        signature = ("__many__", with_values, _forward_signature(args, consumed))
        if self._fused_seen is None:
            object.__setattr__(self, "_fused_seen", {})
        if signature not in self._fused_seen:
            result = self._run_many_eager(with_values, steps)  # the first sight runs call by call, validated
            self._fused_seen[signature] = None
            return result
        # updates go to the group leaders; forwards to every member, as the per-call paths do
        targets = members if with_values or not self._groups_checked else self._leaders()
        counts0 = [m._update_count for _, m in targets]
        snaps = [m._state_snapshot() for _, m in targets]
        flags = self._suspend([m for _, m in members])
        try:
            rows = self._many_program(with_values).run(self, (targets, steps, counts0, with_values))
        except Exception as exc:  # noqa: BLE001 - undone, then call by call (raises if the input is bad)
            for (_, m), snap, c in zip(targets, snaps, counts0):
                m._restore_state(snap)
                object.__setattr__(m, "_update_count", c)
            for o, flag in flags:
                object.__setattr__(o, "_defer_suspended", flag)
            result = self._run_many_eager(with_values, steps)
            _faults.demote(
                self,
                "many",
                exc,
                tier="chunked",
                site="suite-many",
                warn=(
                    f"Batched-step suite program for this MetricCollection raised {type(exc).__name__}: {exc}."
                    " Falling back to per-step eager forwards for this collection's batched API; recoverable"
                    " failures re-probe after clean steps."
                ),
            )
            object.__setattr__(self, "_many_ok", False)
            return result
        finally:
            for o, flag in flags:
                object.__setattr__(o, "_defer_suspended", flag)
        n = len(steps)
        for (_, m), c in zip(targets, counts0):
            m._update_count = c + n
            m._is_synced = False
            m._should_unsync = True
            m._to_sync = m.sync_on_compute
            m._computed = None
        if with_values:
            for name, m in members:
                m._forward_cache = rows[-1][name]  # as n forward calls leave it
        elif self._groups_checked:
            self._repoint_groups()
        self._fault_note_clean(n)
        self._journal_tick(n)
        if not with_values:
            return None
        res = _flatten_dict({name: _stack_values([row[name] for row in rows]) for name, _ in members})
        return {self._set_name(k): v for k, v in res.items()}

    def _run_many_eager(self, with_values: bool, steps: List[Tuple[tuple, dict]]) -> Any:
        values = []
        flags = self._suspend(list(self._modules.values()))
        try:
            for a, k in steps:
                if with_values:
                    values.append(self.forward(*a, **k))
                else:
                    self.update(*a, **k)
        finally:
            for o, flag in flags:
                object.__setattr__(o, "_defer_suspended", flag)
        return _stack_values(values) if with_values else None

    def to_device(self, device: Any) -> "MetricCollection":
        """Move every member to ``device``: ``.to(device)``."""
        return self.to(device)

    def __getstate__(self) -> Dict[str, Any]:
        # a copy or a pickle observes every member: the suite queue flushes first
        self._defer_barrier()
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_defer_pending", "_many_programs", "_funcore_export")}

    def _compute_members(self) -> Dict[str, Any]:
        return {k: m.compute() for k, m in self.items(keep_base=True, copy_state=False)}

    def compute(self) -> Dict[str, Any]:
        self._defer_barrier()
        # compute() forces the suite's sync in flight; a fault there takes the degraded tier
        pending = self.__dict__.get("_pending_sync")
        if pending is not None:
            pending_tier = _psync.sync_degraded_tier()
            forced = False
            try:
                pending.wait()
                _psync._bump("sync_async_auto_forces")
                forced = True
            except Exception as exc:  # noqa: BLE001 - degradable sync faults only
                if pending_tier is None or not _degradable_sync_failure(exc):
                    raise
                _enter_degraded(self, exc, pending_tier)
            if forced:
                try:
                    res = self._compute_members()
                finally:
                    self.unsync()
                return {self._set_name(k): v for k, v in _flatten_dict(res).items()}
        ctx = self._auto_sync_context()
        # while the suite's sync-degrade lane is down: local values, or the survivors' merge;
        # each serve is a clean step, and the recovery edge tries the full suite sync on this call
        degraded_tier = _psync.sync_degraded_tier() if ctx is not None else None
        serve_degraded = False
        if degraded_tier is not None:
            lad = self.__dict__.get("_fault_ladders", {}).get("sync-degrade")
            if lad is not None and lad.demoted:
                if lad.note_clean():
                    lad.promote()
                else:
                    serve_degraded = True
        if serve_degraded:
            res = self._compute_degraded(degraded_tier)
        elif ctx is not None:
            try:
                # the whole suite synced up front: every member computes presynced
                with ctx:
                    res = self._compute_members()
            except Exception as exc:  # noqa: BLE001 - only degradable sync faults are served
                if degraded_tier is None or not _degradable_sync_failure(exc):
                    raise
                _enter_degraded(self, exc, degraded_tier)
                res = self._compute_degraded(degraded_tier)
        else:
            res = self._compute_members()
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def _compute_degraded(self, tier: str) -> Dict[str, Any]:
        """One degraded serve: on the ``quorum`` tier with known survivors the
        suite syncs over them (one coalesced sync of the subgroup); otherwise,
        or when that fails too, every member's local value."""
        if tier == "quorum":
            survivors = _psync.surviving_members()
            if survivors is not None:
                try:
                    with self.sync_context(process_group=survivors):
                        res = self._compute_members()
                    _note_quorum_serve(self, survivors)
                    return res
                except Exception as exc:  # noqa: BLE001 - only degradable sync faults are served
                    if not _degradable_sync_failure(exc):
                        raise
                    _enter_degraded(self, exc, tier)
        _note_degraded_serve(self)
        return self._compute_local()

    def _compute_local(self) -> Dict[str, Any]:
        """Every member's compute with its own sync off (its flag put back after)."""
        members = list(self.items(keep_base=True, copy_state=False))
        saved = [(m, m._to_sync) for _, m in members]
        try:
            for m, _ in saved:
                m._to_sync = False
            return {k: m.compute() for k, m in members}
        finally:
            for m, flag in saved:
                m._to_sync = flag

    def reset(self) -> None:
        self._defer_barrier()  # pending forward values stay what they were
        fut = self.__dict__.get("_pending_sync")
        if fut is not None:  # its rows must not land on the reset states
            fut.cancel()
            object.__setattr__(self, "_pending_sync", None)
        for _, m in self.items(keep_base=True, copy_state=False):
            m.reset()
        if self._enable_compute_groups and self._groups_checked:
            self._compute_groups_create_state_ref()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True, copy_state=False):
            m.persistent(mode)

    # ------------------------------------------------------------------- sync
    def _partition_sync_members(
        self, dist_sync_fn: Optional[Any], process_group: Optional[Any]
    ) -> Tuple[List[Tuple[str, Metric]], List[Tuple[Metric, List[Metric]]], List[Metric], Any]:
        """Split the members into those whose trees pack into the suite's one
        payload collective and those that sync on their own (a custom gather,
        states that cannot be packed, another process group, a demoted
        ``sync-pack`` lane of the suite or of the member). Returns
        ``(members, coalesced, individual, group)``; raises when a member is
        already synced."""
        self._defer_barrier()
        members = list(self.items(keep_base=True, copy_state=False))
        if any(m._is_synced for _, m in members):
            raise MetricsUserError("The Metric has already been synced.")
        suite_lad = self.__dict__.get("_fault_ladders", {}).get("sync-pack")
        suite_ok = (dist_sync_fn is None and _bucketing.coalesce_enabled()
                    and not (suite_lad is not None and suite_lad.demoted))
        coalesced: List[Tuple[Metric, List[Metric]]] = []
        individual: List[Metric] = []
        anchor_group: Any = _UNSET_GROUP
        for _, m in members:
            nodes: List[Metric] = []
            lad = m.__dict__.get("_fault_ladders", {}).get("sync-pack")
            # a member whose rows are offloaded to the host syncs through its own Metric.sync, which lifts them
            eligible = (suite_ok and m.dist_sync_fn is None and not m.compute_on_cpu
                        and not (lad is not None and lad.demoted))
            if eligible:
                nodes = _bucketing.tree_nodes(m)
                for n in nodes:
                    n._defer_barrier()
                    n._canonicalize_list_states()
                group = process_group if process_group is not None else m.process_group
                eligible = (
                    not any(n._is_synced for n in nodes)
                    and (process_group is not None or not any(n.process_group is not m.process_group for n in nodes[1:]))
                    and _bucketing.coalescible(nodes)
                )
                if eligible:
                    if anchor_group is _UNSET_GROUP:
                        anchor_group = group
                    elif group is not anchor_group:
                        eligible = False  # one collective, one group
            if eligible:
                coalesced.append((m, nodes))
            else:
                individual.append(m)
        return members, coalesced, individual, anchor_group

    def sync(
        self,
        dist_sync_fn: Optional[Any] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Any] = _distributed_available,
    ) -> None:
        """Sync every member across processes: the whole suite in one coalesced payload collective where it can.

        Members are packed member by member, not group leader by leader, so the
        layout depends only on how the suite was built, never on which compute
        groups this process's data formed: every process builds the same one.
        Members that cannot be packed sync through their own :meth:`Metric.sync`.
        A pack or unpack failure demotes the suite's ``sync-pack`` lane, warns
        once and syncs the members one by one instead, bit for bit. On any
        other failure every member's local states are restored and the error
        is counted and raised.
        """
        if not should_sync:
            return
        if not (distributed_available() if callable(distributed_available) else None):
            return
        if self.__dict__.get("_pending_sync") is not None:
            raise MetricsUserError(
                "A suite sync is already in flight (sync_async); force it with wait() or compute() before syncing again."
            )
        _psync.drain_inflight()  # other owners' syncs in flight land before this one packs
        with _telemetry.timed("suite-sync", self, "sync") as span:
            members, coalesced, individual, group = self._partition_sync_members(dist_sync_fn, process_group)
            try:
                if coalesced:
                    nodes = [n for _, tree in coalesced for n in tree]
                    snaps = [(n, n._state_snapshot()) for n in nodes]
                    try:
                        _bucketing.coalesced_sync_nodes(
                            nodes, group=None if group is _UNSET_GROUP else group, owner=self
                        )
                    except _bucketing.CoalesceError as err:
                        if not _bucketing.should_fallback(err):
                            # one process alone cannot switch protocols in a live world: raise classified
                            for n, snap in snaps:
                                n._restore_state(snap)
                            raise err.original from err
                        _bucketing.handle_coalesce_failure(
                            self,
                            snaps,
                            err,
                            warn=(
                                "Coalesced suite sync failed; falling back to member-wise syncs (bit-exact;"
                                " each member may still coalesce its own tree, per-state only if its own pack"
                                " also fails)."
                            ),
                        )
                        individual = [m for m, _ in coalesced] + individual
                    except Exception:
                        for n, snap in snaps:
                            n._restore_state(snap)
                        raise
                    else:
                        for n, snap in snaps:
                            n._cache = snap
                            n._is_synced = True
                for m in individual:
                    m.sync(dist_sync_fn, process_group, True, distributed_available)
                if not coalesced:
                    # a member-wise suite sync is a clean step toward the suite lane's recovery edge
                    lad = self.__dict__.get("_fault_ladders", {}).get("sync-pack")
                    if lad is not None and lad.demoted and lad.note_clean():
                        lad.promote()
            except Exception as exc:
                # no member may stay synced while another holds its local states
                for _, m in members:
                    if m._is_synced:
                        m.unsync()
                self._relink_groups()
                _faults.note_fault(_faults.classify(exc, "sync"), site="sync", owner=self, error=exc)
                raise
            span.attrs = {"members": len(members), "coalesced": len(coalesced), "individual": len(individual)}
        # a suite sync over the whole world is the last good one of the suite and of every member's tree
        if _psync.is_full_world_group(process_group):
            self._stamp_last_good(members, _faults.tick())

    def _stamp_last_good(self, members: List[Tuple[str, Metric]], step: int) -> None:
        _stamp_last_good([self] + [n for _, m in members for n in _bucketing.tree_nodes(m)], step)

    def sync_async(
        self,
        dist_sync_fn: Optional[Any] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Any] = _distributed_available,
    ) -> Optional[Any]:
        """Dispatch the whole suite's sync without waiting for it: the members
        the suite packs go in one payload collective in flight; the others sync
        blocking here. Returns a :class:`~metrics_tpu_torch.parallel.sync.SyncFuture`
        (force it with ``wait()``, or let :meth:`compute` force it), or None when
        there is nothing to sync. A failed force leaves every member's local
        states intact."""
        if self.__dict__.get("_pending_sync") is not None:
            raise MetricsUserError(
                "A suite sync is already in flight; force it with wait() or compute() before dispatching another."
            )
        if not should_sync or not (distributed_available() if callable(distributed_available) else None):
            return None
        members, coalesced, individual, anchor_group = self._partition_sync_members(dist_sync_fn, process_group)
        group = None if anchor_group is _UNSET_GROUP else anchor_group
        all_nodes = [n for _, nodes in coalesced for n in nodes]

        def _rollback() -> None:
            for _, m in members:
                if m._is_synced:
                    m.unsync()
            self._relink_groups()

        def _replay(err: _bucketing.CoalesceError, where: str) -> None:
            _bucketing.handle_coalesce_failure(
                self, [(n, n._state_snapshot()) for n in all_nodes], err,
                warn=f"Async coalesced suite sync failed at {where}; replaying member-wise blocking syncs (bit-exact).",
            )
            for m, _ in coalesced:
                m.sync(dist_sync_fn, process_group, True, distributed_available)

        try:
            for m in individual:  # they cannot ride the one buffer in flight
                m.sync(dist_sync_fn, process_group, True, distributed_available)
            if individual:
                _psync._bump("sync_async_fallbacks")
            try:
                disp = _bucketing.dispatch_coalesced_sync(all_nodes, group=group, owner=self) if all_nodes else None
            except _bucketing.CoalesceError as err:
                if not _bucketing.should_fallback(err):
                    raise err.original from err
                _replay(err, "dispatch")
                disp = None
        except Exception as exc:
            _rollback()
            _faults.note_fault(_faults.classify(exc, "sync"), site="sync", owner=self, error=exc)
            raise
        if disp is None:
            # whatever could sync has synced blocking: a completed future, registered so compute() unsyncs
            done_fut = _psync.SyncFuture.completed(self)
            object.__setattr__(self, "_pending_sync", done_fut)
            return done_fut

        def _force() -> None:
            object.__setattr__(self, "_pending_sync", None)
            try:
                try:
                    snaps = _bucketing.force_coalesced_sync(disp)
                except _bucketing.CoalesceError as err:
                    if not _bucketing.should_fallback(err):
                        raise err.original from err
                    _replay(err, "force")
                else:
                    for n, snap in snaps:
                        n._cache = snap
                        n._is_synced = True
            except Exception as exc:
                _rollback()
                _faults.note_fault(_faults.classify(exc, "sync"), site="sync", owner=self, error=exc)
                raise
            if _psync.is_full_world_group(process_group):
                self._stamp_last_good(members, _faults.tick())

        fut = _psync.SyncFuture(self, _force, done=disp.done, quant_tier=disp.ctx.quant_tier)
        object.__setattr__(self, "_pending_sync", fut)
        return fut

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore every member's local states; group members share the leader's states again."""
        if not should_unsync:
            return
        fut = self.__dict__.get("_pending_sync")
        if fut is not None and (fut._forced or fut._cancelled):
            object.__setattr__(self, "_pending_sync", None)  # a spent future must not block the next sync
        for _, m in self.items(keep_base=True, copy_state=False):
            if m._is_synced:
                m.unsync()
        self._relink_groups()

    def _relink_groups(self) -> None:
        if self._enable_compute_groups and self._groups_checked:
            self._compute_groups_create_state_ref()

    class _SyncContext:
        def __init__(self, collection: "MetricCollection", should_unsync: bool = True, **kwargs: Any) -> None:
            self.collection = collection
            self.kwargs = kwargs
            self.should_unsync = should_unsync

        def __enter__(self) -> "MetricCollection":
            self.collection.sync(**self.kwargs)
            return self.collection

        def __exit__(self, *exc: Any) -> None:
            self.collection.unsync(should_unsync=self.should_unsync)

    def sync_context(
        self,
        dist_sync_fn: Optional[Any] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Any] = _distributed_available,
    ) -> "MetricCollection._SyncContext":
        """Context manager: the suite's sync on enter, every member's local states back on exit."""
        return MetricCollection._SyncContext(
            self,
            should_unsync=should_unsync,
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )

    def _auto_sync_context(self) -> Optional["MetricCollection._SyncContext"]:
        """The suite sync of ``compute()``, only where it is unambiguous: more
        than one process, and every member on the default sync flags (syncing
        on compute, unsyncing after, no custom gather, not synced yet). Otherwise
        each member syncs in its own ``compute()``, as before."""
        if not _distributed_available():
            return None
        members = [m for _, m in self.items(keep_base=True, copy_state=False)]
        if not members or all(m._computed is not None for m in members):
            return None  # every member returns its cached value
        if any(m._is_synced or not m._to_sync or not m._should_unsync or m.dist_sync_fn is not None for m in members):
            return None
        return self.sync_context()

    # ----------------------------------------------------------- durability
    def sync_health(self) -> Dict[str, Any]:
        """The suite's staleness block (see :meth:`Metric.sync_health`), each
        member's, and the world's membership (``world``): ``degraded`` when the
        suite or any member serves a degraded value."""
        lad = self.__dict__.get("_fault_ladders", {}).get("sync-degrade")
        members = {k: m.sync_health() for k, m in self.items(keep_base=True, copy_state=False)}
        return {
            "degraded": bool(lad is not None and lad.demoted) or any(h["degraded"] for h in members.values()),
            "degraded_tier": _psync.sync_degraded_tier(),
            "epoch": _psync.world_epoch(),
            "last_good_sync_step": self.__dict__.get("_last_good_sync_step"),
            "degraded_since_step": self.__dict__.get("_degraded_since_step"),
            "degraded_serves": self.__dict__.get("_degraded_serves", 0),
            "quorum_serves": self.__dict__.get("_quorum_serves", 0),
            "inflight": _inflight_block(self.__dict__.get("_pending_sync")),
            "members": members,
            "world": _psync.world_health(),
        }

    def fleet_health(self) -> Dict[str, Any]:
        """The suite's fleet view: one :func:`metrics_tpu_torch.fleet_snapshot` (per-rank
        planes, aggregates, the straggler report, dead-rank placeholders; zero
        collectives in a world of one process) with this suite's :meth:`sync_health`
        under ``"suite"``. A collective in a live world: every rank calls it together."""
        from metrics_tpu_torch.ops import fleetobs as _fleetobs

        out = _fleetobs.fleet_snapshot()
        out["suite"] = self.sync_health()
        return out

    def checkpoint_barrier(self, path: str) -> Dict[str, Any]:
        """Journal every process at one agreed step: the coordinated
        :meth:`save_state`. Every process calls it. One small exchange
        (epoch-fenced, under the deadline and the retry budget) agrees the
        largest of the processes' next monotonic steps, and every record's
        manifest carries it with the epoch and the world size, so a restore
        can check that every process's record comes from one cut. Returns
        ``{path, epoch, barrier_step, world_size, bytes}``."""
        from metrics_tpu_torch.ops import journal as _journal

        t0 = _telemetry.now() if _telemetry.armed else 0.0
        nodes = self._journal_nodes()
        agreement = _bucketing.agree_step(self, _faults.tick(), site="checkpoint-barrier", device=nodes[0].device)
        agreed, world, fence = agreement["agreed"], agreement["world"], agreement["epoch"]
        nbytes = _journal.save_nodes(
            self, nodes, path,
            manifest_extra={"epoch": fence, "barrier_step": agreed, "world_size": world, "barrier": True},
        )
        if t0 and _telemetry.armed:
            _telemetry.emit("checkpoint-barrier", self, "sync", t0, _telemetry.now() - t0,
                            {"barrier_step": agreed, "epoch": fence, "world": world, "bytes": nbytes})
        return {"path": path, "epoch": fence, "barrier_step": agreed, "world_size": world, "bytes": nbytes}

    def rejoin(self, path: str, handoff: Optional[Any] = None, rank: Optional[int] = None,
               warm: bool = True) -> Dict[str, Any]:
        """Re-enter the world after a restart.

        1. Restore the newest good generation of the journal at ``path`` (as
           :meth:`load_state`).
        2. With a ``handoff`` callable (a survivor's copy of this process's
           newest barrier record), call it with the restored manifest's stamps;
           a record it returns that is strictly newer (by ``barrier_step``, else
           ``monotonic_step``) replaces the restore, all or nothing. A record
           that fails to decode is counted as a ``journal`` fault, warned once,
           and the local restore stands.
        3. Enter the next epoch (:func:`~metrics_tpu_torch.parallel.sync.rejoin_rank`):
           protocols in flight fence, and the suite's ``sync-degrade`` lane is
           re-promoted.
        4. With ``warm=True`` and the persistent program cache on,
           :func:`~metrics_tpu_torch.ops.engine.warm_programs` runs every stored
           signature of the programs this process has acquired, so the first
           compute after the rejoin pays no one-time costs. On a fresh
           process, :meth:`precompile` before ``rejoin`` acquires them.

        Returns ``{generation, epoch, handoff, restored_step, rank, warmed_programs}``.
        """
        from metrics_tpu_torch.ops import journal as _journal

        t0 = _telemetry.now() if _telemetry.armed else 0.0
        gen = self.load_state(path)
        meta = _journal.restored_meta(self)

        def _stamp(m: Dict[str, Any]) -> Optional[int]:
            step = m.get("barrier_step")
            return step if step is not None else m.get("monotonic_step")

        handoff_used = False
        if handoff is not None:
            try:
                record = handoff(dict(meta))
                if record:
                    manifest, payload = _journal.decode_record(record, origin="<rejoin-handoff>")
                    theirs, mine = _stamp(manifest), _stamp(meta)
                    if theirs is not None and (mine is None or theirs > mine):
                        _journal.restore_nodes(self._journal_nodes(), manifest, payload)
                        self._relink_groups()
                        meta = _journal.manifest_meta(manifest)
                        object.__setattr__(self, "_journal_meta", dict(meta))
                        handoff_used = True
            except Exception as exc:  # noqa: BLE001 - the local restore stands
                _faults.note_fault(_faults.classify(exc, "journal"), site="journal-load", owner=self, error=exc)
                _faults.warn_fault(
                    self, "journal",
                    f"Rejoin handoff record failed verification ({type(exc).__name__}: {exc}); "
                    "continuing with the locally-restored journal generation.",
                )
        live_rank = rank
        if live_rank is None:
            live_rank = torch.distributed.get_rank() if _psync.distributed_available() else 0
        epoch = _psync.rejoin_rank(int(live_rank))
        lad = self.__dict__.get("_fault_ladders", {}).get("sync-degrade")
        if lad is not None and lad.demoted:
            lad.promote()  # a fresh epoch: nothing stale is served
        warmed = _engine.warm_programs() if warm else 0
        out = {"generation": gen, "epoch": epoch, "handoff": handoff_used, "restored_step": _stamp(meta),
               "rank": int(live_rank), "warmed_programs": warmed}
        if t0 and _telemetry.armed:
            _telemetry.emit("rank-rejoin", self, "sync", t0, _telemetry.now() - t0, dict(out))
        return out

    # ---------------------------------------------------------------- journal
    def _fault_note_clean(self, n: int = 1) -> None:
        """A clean suite step: every demoted suite lane counts it toward its recovery edge."""
        ladders = self.__dict__.get("_fault_ladders")
        if not ladders:
            return
        for lad in ladders.values():
            if lad.demoted and lad.note_clean(n):
                lad.promote()

    def _journal_nodes(self) -> List[Metric]:
        """Every member tree's nodes, member by member in suite order: the walk
        the coalesced sync packs, so the record's layout depends only on how
        the suite was built. Pending suite calls flush first."""
        self._defer_barrier()
        return [n for _, m in self.items(keep_base=True, copy_state=False) for n in _bucketing.tree_nodes(m)]

    def save_state(self, path: str) -> int:
        """Save the whole suite as one record of the crash-consistent journal at
        ``path`` (:mod:`metrics_tpu_torch.ops.journal`); returns its bytes."""
        from metrics_tpu_torch.ops import journal as _journal

        return _journal.save_nodes(self, self._journal_nodes(), path)

    def load_state(self, path: str) -> int:
        """Restore the whole suite from the newest good generation at ``path``;
        returns the generation restored (0 the newest). All or nothing."""
        from metrics_tpu_torch.ops import journal as _journal

        gen = _journal.load_nodes(self, self._journal_nodes(), path)
        self._relink_groups()  # group members share the restored leader states again
        return gen

    def journal(self, path: Optional[str], every_n: int = 1) -> None:
        """Save the suite to ``path`` every ``every_n`` ``update``/``forward``
        calls (``path=None`` stops). A failed write never breaks the update: it
        demotes the suite's ``journal`` lane (warned once, saves skipped) until
        clean steps reach the recovery edge and saving resumes.

        Example:
            >>> import os, tempfile, torch
            >>> from metrics_tpu_torch import MeanMetric, MetricCollection
            >>> path = os.path.join(tempfile.mkdtemp(), "suite.journal")
            >>> suite = MetricCollection({"mean": MeanMetric(device="cpu")})
            >>> suite.journal(path, every_n=2)
            >>> for x in (1.0, 3.0):
            ...     suite.update(torch.tensor([x]))
            >>> fresh = MetricCollection({"mean": MeanMetric(device="cpu")})
            >>> fresh.load_state(path)
            0
            >>> fresh.compute()
            {'mean': tensor(2.)}
        """
        if path is None:
            self.__dict__.pop("_journal_cfg", None)
            return
        if int(every_n) < 1:
            raise ValueError(f"journal every_n must be >= 1, got {every_n}")
        object.__setattr__(self, "_journal_cfg", {"path": str(path), "every_n": int(every_n), "count": 0})

    def _journal_tick(self, n: int = 1) -> None:
        """One state-changing suite call: save when it crosses the ``every_n`` cadence."""
        cfg = self.__dict__.get("_journal_cfg")
        if cfg is None:
            return
        before = cfg["count"]
        cfg["count"] = before + n
        if cfg["count"] // cfg["every_n"] == before // cfg["every_n"]:
            return
        lad = self.__dict__.get("_fault_ladders", {}).get("journal")
        if lad is not None and lad.demoted:
            return  # degraded: clean steps advance the recovery edge
        try:
            self.save_state(cfg["path"])
        except Exception as exc:  # noqa: BLE001 - a failed save must not break the update
            _faults.demote(
                self,
                "journal",
                exc,
                default_domain="journal",
                tier="host",
                site="journal-write",
                count=False,  # save_nodes counted it where it was raised
                warn=(
                    "Suite auto-journaling failed; journaling is DEGRADED (snapshots "
                    "skipped) until the journal lane's recovery edge re-probes the disk. "
                    "The on-disk generation ring is intact."
                ),
            )

    # ---------------------------------------------------------- compute groups
    def _merge_compute_groups(self) -> None:
        """Merge groups whose leaders hold pairwise-identical states."""
        n_groups = len(self._groups)
        while True:
            for idx1, members1 in list(self._groups.items()):
                merged = False
                for idx2, members2 in list(self._groups.items()):
                    if idx1 == idx2 or idx1 not in self._groups or idx2 not in self._groups:
                        continue
                    if self._equal_metric_states(self._modules[members1[0]], self._modules[members2[0]]):
                        self._groups[idx1].extend(self._groups.pop(idx2))
                        merged = True
                        break
                if merged:
                    break
            if len(self._groups) == n_groups:
                break
            n_groups = len(self._groups)
        self._groups = dict(enumerate(self._groups.values()))

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """True when two metrics hold identical states (reference `:227-249`)."""
        if len(metric1._defaults) == 0 or len(metric2._defaults) == 0:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        for key in metric1._defaults:
            state1, state2 = getattr(metric1, key), getattr(metric2, key)
            if type(state1) is not type(state2):
                return False
            pairs = zip(state1, state2) if isinstance(state1, list) else [(state1, state2)]
            if isinstance(state1, list) and len(state1) != len(state2):
                return False
            for s1, s2 in pairs:
                if s1.dtype != s2.dtype or s1.device != s2.device or not allclose(s1, s2):
                    return False
        return True

    def _compute_groups_create_state_ref(self, copy: bool = False) -> None:
        """Point group members' states at the leader's (copy only list states)."""
        if not self._state_is_copy:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                for name in cg[1:]:
                    mi = self._modules[name]
                    for state in m0._defaults:
                        m0_state = getattr(m0, state)
                        # tensors are rebound, never written into, so a reference
                        # is safe; lists are appended to, so copy them when asked
                        setattr(mi, state, deepcopy(m0_state) if copy and isinstance(m0_state, list) else m0_state)
        self._state_is_copy = copy

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    def _init_compute_groups(self) -> None:
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for members in self._groups.values():
                for metric in members:
                    if metric not in self._modules:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the"
                            f" collection. Please make sure that {self._enable_compute_groups} matches"
                            f" {list(self._modules)}"
                        )
            self._groups_checked = True
        else:
            self._groups = {i: [str(k)] for i, k in enumerate(self._modules)}

    # ------------------------------------------------------------- management
    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        self._defer_barrier()  # the groups change below: a suite queue runs on the groups it was made for
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, (str, dict)):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passed extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")

        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {}

    # ------------------------------------------------------ functional export
    def as_functions(self) -> tuple:
        """Export the whole suite as ``(init, update, compute)`` pure functions over a
        ``{metric_name: state}`` dict (:mod:`metrics_tpu_torch.functional_core`),
        cached per tuple of member fingerprints."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.metric_functions(self)

    def init(self) -> Any:
        """A fresh epoch-stamped ``{metric_name: state}`` tree for the whole suite."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.init(self)

    def apply_update(self, state: Any, *args: Any, **kwargs: Any) -> Any:
        """Pure whole-suite update over one explicit state tree."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.apply_update(self, state, *args, **kwargs)

    def apply_compute(self, state: Any, *, axis_name: Optional[Any] = None) -> Any:
        """Pure whole-suite compute; with ``axis_name`` every state merges with one
        functional collective."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.apply_compute(self, state, axis_name=axis_name)

    def host_handoff(self, state: Any, *, merged: bool = True) -> "MetricCollection":
        """Land a suite state tree back into every member without a second merge."""
        from metrics_tpu_torch import functional_core as _funcore

        return _funcore.host_handoff(self, state, merged=merged)

    # --------------------------------------------------------------- dict api
    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def keys(self, keep_base: bool = False) -> Iterable[Hashable]:
        if keep_base:
            return self._modules.keys()
        return [self._set_name(k) for k in self._modules]

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        self._compute_groups_create_state_ref(copy_state)
        if keep_base:
            return self._modules.items()
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules.values()

    def __getitem__(self, key: str) -> Metric:
        self._compute_groups_create_state_ref(True)
        return self._modules[key]

    def __iter__(self):
        return iter(self.keys())

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        lines = [f"  ({k}): {v!r}" for k, v in self._modules.items()]
        repr_str = "MetricCollection(\n" + ",\n".join(lines)
        if self.prefix:
            repr_str += f",\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f",\n  postfix={self.postfix}"
        return repr_str + "\n)"


__all__ = ["MetricCollection"]
