"""State sync across processes: ``torch.distributed`` collectives on the states' own device.

JAX counterpart: `metrics_tpu/parallel/sync.py` (the group resolution
`:69-139`, the environment knobs `:142-245`, the deadline watchdog
`:255-349`, the degraded, quantized and hierarchical tiers `:353-434`, the
asynchronous lane `:445-705`, membership and epochs `:708-1016`, the
collective counters `:1025-1103`, ``gather_all_tensors`` `:1106-1208`,
``reduce`` and ``class_reduce`` `:1211-1242`); reference
`src/torchmetrics/utilities/distributed.py`.

Groups. The collectives run in the default process group, or in the group a
caller names: a ``torch.distributed.ProcessGroup`` (``Metric(process_group=)``)
or, as in JAX, a list of process indices (the ``quorum`` tier passes the
surviving ranks). A list is validated against the live world
(:func:`validate_group_live`) and, in a live world, resolved to a
``ProcessGroup`` made with ``dist.new_group(ranks, use_local_synchronization=True)``,
cached per (epoch, ranks): only its members enter it, so a dead peer cannot
hang its creation. Unlike JAX, where every process joins every exchange,
only the members of a group call a collective over it, and each member
receives every member's entry in ascending rank order. With no process group
initialised, a gather returns the caller's own entry (a world of one). NCCL
carries states on the card, Gloo states on the CPU (Gloo also takes CUDA
tensors).

Faults. Every blocking exchange runs inside a retried closure
(``METRICS_TPU_SYNC_RETRIES``, default 0 in a live world of more than one
process and 2 otherwise; ``METRICS_TPU_SYNC_BACKOFF_MS``, default 50,
doubling) that first checks the protocol's epoch fence (:func:`check_epoch`,
fault site ``epoch-fence``) and then fires the ``sync-gather`` fault site.
With ``METRICS_TPU_SYNC_DEADLINE_MS`` set, the exchange runs on a watchdog
thread and raises :class:`SyncTimeoutFault` when it outlives the deadline.
A hung collective cannot be cancelled: the watchdog abandons its thread, as
JAX's does, and the process group under it may be unusable for the next
attempt, which is why live worlds do not retry by default. The watchdog and
the asynchronous dispatcher run the caller's work on the caller's CUDA
device and stream, so a collective is ordered after the kernels that made
its buffer.

Membership. A monotonic world epoch numbers the membership configurations
this process has seen; peers are declared dead by a prober after
``METRICS_TPU_SYNC_DEAD_AFTER`` consecutive timeouts, or by
:func:`mark_peer_dead`, and come back with :func:`rejoin_rank`; each
transition bumps the epoch and fences every protocol in flight.

Unlike JAX, :func:`distributed_available` is not memoized:
``torch.distributed`` answers from process-local state, and a process may
destroy its group and make another; ``sync_dist_resolutions`` counts the
reads of a live world's size.
"""
from __future__ import annotations

import os
import queue
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.exceptions import EpochFault, SyncConfigFault, SyncFault, SyncTimeoutFault


def _live() -> bool:
    """True when a process group is initialised, so a collective really runs (a world of one included)."""
    return dist.is_available() and dist.is_initialized()


def distributed_available() -> bool:
    """True when more than one process takes part: ``Metric.sync`` is a no-op otherwise."""
    if not _live():
        return False
    _bump("sync_dist_resolutions")
    return dist.get_world_size() > 1


def world_size(group: Optional[Any] = None) -> int:
    return dist.get_world_size(group) if _live() else 1


def _is_process_group(group: Any) -> bool:
    pg_type = getattr(dist, "ProcessGroup", None)
    return pg_type is not None and isinstance(group, pg_type)


def check_group(group: Optional[Any]) -> Optional[Any]:
    """A metric's ``process_group`` is None (every process) or a ``torch.distributed.ProcessGroup``."""
    if group is None or _is_process_group(group):
        return group
    raise ValueError(
        f"`process_group` must be None or a torch.distributed.ProcessGroup (from dist.new_group), got {group!r}"
    )


def _resolve_group(group: Optional[Any], n_processes: Optional[int]) -> Optional[List[int]]:
    """Validate a list of process indices: distinct, within ``[0, n_processes)``
    (``n_processes`` None skips the range check). None means every process."""
    if group is None:
        return None
    if isinstance(group, str):
        raise ValueError(f"`process_group` got the string {group!r}; it takes a list of process indices.")
    try:
        members = sorted(int(idx) for idx in group)
    except (TypeError, ValueError) as err:
        raise ValueError(f"`process_group` must be an iterable of process indices (got {group!r}).") from err
    if not members:
        raise ValueError("`process_group` must contain at least one process index.")
    if len(set(members)) != len(members):
        raise ValueError(f"`process_group` contains duplicate indices: {group!r}")
    if members[0] < 0:
        raise ValueError(f"`process_group` indices must be non-negative, got {members}.")
    if n_processes is not None and members[-1] >= n_processes:
        raise ValueError(f"`process_group` indices {members} out of range for {n_processes} process(es).")
    return members


def effective_world_size() -> int:
    """The world groups are validated against: the live process count, or the
    membership registry's declared world when that is larger (a world degraded
    below its full size keeps its rank numbering)."""
    expected = _membership.expected_world
    return max(world_size(), expected if expected else 1)


def validate_group_live(group: Optional[Any]) -> Optional[List[int]]:
    """The members of ``group`` as ascending process indices, validated against
    the live world: None for the whole world, the group's ranks for a
    ``ProcessGroup``. An invalid list raises :class:`SyncConfigFault` (also a
    ``ValueError``), which is structural and never retried."""
    if group is None:
        return None
    if _is_process_group(group):
        return sorted(dist.get_process_group_ranks(group))
    try:
        return _resolve_group(group, effective_world_size())
    except SyncConfigFault:
        raise
    except ValueError as err:
        _faults.note_fault("sync", site="sync-config", error=err)
        raise SyncConfigFault(
            f"process_group is invalid for the live world size ({effective_world_size()} process(es)): {err}",
            site="sync-config",
        ) from err


_GROUP_CACHE: Dict[tuple, Any] = {}


def transport_group(group: Optional[Any], members: Optional[List[int]]) -> Optional[Any]:
    """The ``ProcessGroup`` a collective over ``group`` runs in (None: the
    default group). A list of ranks becomes, in a live world, a group of those
    ranks made once per (epoch, ranks), which only its members enter; this
    process must be one of them. Outside a live world the list is handed on
    as it is (the transports of a world of one ignore it)."""
    if group is None or _is_process_group(group):
        return group
    if not _live():
        return members
    if members == list(range(dist.get_world_size())):
        return None
    rank = dist.get_rank()
    if rank not in members:
        raise SyncConfigFault(
            f"process {rank} is not a member of process_group {members}: only a group's members sync over it",
            site="sync-config",
        )
    key = (_membership.epoch, tuple(members))
    pg = _GROUP_CACHE.get(key)
    if pg is None:
        pg = dist.new_group(ranks=members, use_local_synchronization=True)
        _GROUP_CACHE[key] = pg
    return pg


# ---------------------------------------------------------------- env knobs
class _EnvWarnOwner:
    """Warn-once anchor for a knob's parse warning (``faults.warn_fault`` keeps its marker here)."""


_RETRIES_WARN_OWNER = _EnvWarnOwner()
_BACKOFF_WARN_OWNER = _EnvWarnOwner()
_DEADLINE_WARN_OWNER = _EnvWarnOwner()
_MEMBERSHIP_WARN_OWNER = _EnvWarnOwner()
_QUANT_WARN_OWNER = _EnvWarnOwner()
_HIER_WARN_OWNER = _EnvWarnOwner()


def _env_parse(name: str, default: Any, parse: Callable[[str], Any], kind: str, *, owner: Any,
               fallback_desc: Optional[str] = None) -> Any:
    """Every sync knob's parser, read at sync time: unset or blank gives
    ``default``; a value that does not parse warns once, naming it, and gives ``default``."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return parse(raw)
    except (TypeError, ValueError):
        _faults.warn_fault(
            owner, "sync", f"{name}={raw!r} is not {kind}; falling back to {fallback_desc or f'the default ({default!r})'}."
        )
        return default


def _env_int(name: str, default: Any, *, owner: Any, fallback_desc: Optional[str] = None) -> Any:
    return _env_parse(name, default, int, "an integer", owner=owner, fallback_desc=fallback_desc)


def _env_float(name: str, default: Any, *, owner: Any, fallback_desc: Optional[str] = None) -> Any:
    return _env_parse(name, default, float, "a number", owner=owner, fallback_desc=fallback_desc)


def sync_retries() -> int:
    """Extra attempts after a failed exchange (``METRICS_TPU_SYNC_RETRIES``):
    default 0 in a live world of more than one process, where a retry pairs
    only if every process retries in step, and 2 otherwise. A value that does
    not parse warns once and takes the same default."""
    default = 0 if distributed_available() else 2
    return max(
        0,
        _env_int(
            "METRICS_TPU_SYNC_RETRIES",
            default,
            owner=_RETRIES_WARN_OWNER,
            fallback_desc=(
                f"the distributed-aware default ({default} — unilateral collective retries"
                " stay opt-in in a live multi-process world)"
            ),
        ),
    )


def sync_backoff_s() -> float:
    """The first retry's delay (``METRICS_TPU_SYNC_BACKOFF_MS``, default 50 ms), doubled each attempt."""
    return max(0.0, _env_float("METRICS_TPU_SYNC_BACKOFF_MS", 50.0, owner=_BACKOFF_WARN_OWNER)) / 1000.0


def sync_deadline_s() -> Optional[float]:
    """One blocking exchange's deadline (``METRICS_TPU_SYNC_DEADLINE_MS``), None
    (no watchdog, no thread) when unset, not positive or not a number (warned once)."""
    ms = _env_float(
        "METRICS_TPU_SYNC_DEADLINE_MS", None, owner=_DEADLINE_WARN_OWNER,
        fallback_desc="OFF (collectives block without a deadline)",
    )
    if ms is None:
        return None
    return ms / 1000.0 if ms > 0 else None


def sync_dead_after() -> int:
    """Consecutive timeouts at one epoch before the peer prober is asked who is
    dead (``METRICS_TPU_SYNC_DEAD_AFTER``, default 3, at least 1)."""
    return max(1, _env_int("METRICS_TPU_SYNC_DEAD_AFTER", 3, owner=_MEMBERSHIP_WARN_OWNER))


def _env_tier(name: str, tiers: tuple, owner: Any, what: str, off: str) -> Optional[str]:
    raw = os.environ.get(name)
    if not raw:
        return None
    value = raw.strip().lower()
    if value in ("0", "false", "off"):
        return None
    if value in tiers:
        return value
    known = " or ".join(repr(t) for t in tiers)
    _faults.warn_fault(owner, "sync", f"{name}={raw!r} is not a known tier ({known}); {what} stays OFF ({off}).")
    return None


def sync_degraded_tier() -> Optional[str]:
    """The degraded compute tier (``METRICS_TPU_SYNC_DEGRADED``): ``"local"``
    serves the local value after a sync fails past its retries, ``"quorum"``
    the merge over the surviving ranks while peers are declared dead (the local
    value when none are). Unset keeps raise-on-failure; another value warns once."""
    return _env_tier("METRICS_TPU_SYNC_DEGRADED", ("local", "quorum"), _DEADLINE_WARN_OWNER,
                     "degraded compute", "sync failures raise classified")


def sync_quant_tier() -> Optional[str]:
    """The quantized payload lane (``METRICS_TPU_SYNC_QUANT``): ``"bf16"`` or
    ``"int8"`` (symmetric, one float32 scale a state) for float tensor states;
    integer, bool and ``cat`` states, and any state whose wire form would not
    shrink, go exact. Unset keeps every payload exact; another value warns once."""
    return _env_tier("METRICS_TPU_SYNC_QUANT", ("bf16", "int8"), _QUANT_WARN_OWNER,
                     "the quantized payload lane", "payloads ship bit-exact")


def sync_hier_node_size() -> int:
    """Processes a node for the hierarchical payload (``METRICS_TPU_SYNC_HIER``;
    0, the default, or a value below 2 is off)."""
    n = _env_int("METRICS_TPU_SYNC_HIER", 0, owner=_HIER_WARN_OWNER)
    return int(n) if n and n >= 2 else 0


# ------------------------------------------------------------ worker threads
def _on_callers_stream(fn: Callable[[], Any]) -> Callable[[], Any]:
    """``fn`` to run on another thread with the calling thread's CUDA device and
    stream current, so its collectives follow the kernels already queued there."""
    if not torch.cuda.is_initialized():
        return fn
    device, stream = torch.cuda.current_device(), torch.cuda.current_stream()

    def run() -> Any:
        with torch.cuda.device(device), torch.cuda.stream(stream):
            return fn()

    return run


class _Worker:
    """One long-lived daemon thread with a hand-off queue: the watchdog runs
    blocking collectives on one, the asynchronous lane dispatches on another.
    A worker stuck in a hung collective is abandoned (poisoned: it exits if
    the call ever returns) and replaced on next use."""

    def __init__(self, name: str) -> None:
        self.queue: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.queue.get()
            if item is None:
                return
            fn, box, done = item
            try:
                box["value"] = fn()
            except BaseException as exc:  # noqa: BLE001 - raised again on the caller's thread
                box["error"] = exc
            done.set()

    def submit(self, fn: Callable[[], Any]):
        box: dict = {}
        done = threading.Event()
        self.queue.put((_on_callers_stream(fn), box, done))
        return box, done


_workers: Dict[str, Optional[_Worker]] = {"watchdog": None, "dispatcher": None}
_workers_lock = threading.Lock()
#: The newest closure handed to the dispatcher: waiting for it waits out everything before it.
_last_submitted_done: List[Optional[threading.Event]] = [None]


def _submit(kind: str, fn: Callable[[], Any]):
    with _workers_lock:
        worker = _workers[kind]
        if worker is None or not worker.thread.is_alive():
            worker = _workers[kind] = _Worker(f"metrics-tpu-torch-sync-{kind}")
        box, done = worker.submit(fn)
        if kind == "dispatcher":
            _last_submitted_done[0] = done
        return box, done


def _abandon(kind: str) -> None:
    with _workers_lock:
        stuck, _workers[kind] = _workers[kind], None
        if kind == "dispatcher":
            _last_submitted_done[0] = None  # its pending work is written off with it
    if stuck is not None:
        stuck.queue.put(None)


def _timed_out(kind: str, site: str, owner: Any, deadline: float) -> SyncTimeoutFault:
    """Abandon the stuck worker and fold the timeout into the membership registry."""
    _abandon(kind)
    _bump("sync_deadline_timeouts")
    # the K-th timeout at one epoch may declare peers dead and bump the epoch, after
    # which a retry of this protocol trips its fence instead of pairing with a new cohort
    note_sync_timeout(site)
    if _telemetry.armed:
        _telemetry.emit("sync-timeout", owner, "sync", attrs={"site": site, "deadline_ms": deadline * 1000.0})
    return SyncTimeoutFault(
        f"collective at site {site!r} exceeded the {deadline * 1000.0:.0f} ms watchdog deadline "
        "(METRICS_TPU_SYNC_DEADLINE_MS) — a peer rank is hung or dead; local state is intact and the "
        "sync is retryable",
        site=site,
    )


def run_with_deadline(fn: Callable[[], Any], *, site: str = "sync-gather", owner: Any = None) -> Any:
    """Run one blocking exchange under the watchdog deadline: a direct call when
    none is set; otherwise on the watchdog thread, raising
    :class:`SyncTimeoutFault` if it has not returned in time (the abandoned
    call keeps blocking its daemon thread, which is retired)."""
    deadline = sync_deadline_s()
    if deadline is None:
        return fn()
    box, done = _submit("watchdog", fn)
    if not done.wait(deadline):
        raise _timed_out("watchdog", site, owner, deadline)
    if "error" in box:
        raise box["error"]
    return box.get("value")


# ---------------------------------------------------------- the async lane
def submit_async(fn: Callable[[], Any]):
    """Hand one retried collective closure to the dispatcher thread; returns
    ``(box, done)``, waited for by :func:`wait_with_deadline` at the force.
    Dispatches run one at a time in issue order: collectives pair by order."""
    return _submit("dispatcher", fn)


def run_inflight(fn: Callable[[], Any], *, site: str = "sync-gather") -> Any:
    """The asynchronous twin of :func:`run_with_deadline`: a direct call on the
    dispatcher thread, whose deadline is measured at the force."""
    return fn()


def wait_with_deadline(done: threading.Event, *, site: str = "sync-force", owner: Any = None) -> None:
    """Wait for an in-flight collective under the watchdog deadline; on timeout
    abandon the dispatcher and raise :class:`SyncTimeoutFault`, nothing applied."""
    deadline = sync_deadline_s()
    if deadline is None:
        done.wait()
        return
    if not done.wait(deadline):
        raise _timed_out("dispatcher", site, owner, deadline)


class SyncFuture:
    """One sync dispatched by ``sync_async()``: its payload collective is in
    flight while the caller goes on updating. :meth:`wait` forces it: waits
    (under the deadline), checks the epoch fence again, unpacks and applies the
    merged states; ``compute()`` forces a pending future itself. A second
    :meth:`wait` does nothing. A failed force leaves the local states intact."""

    __slots__ = ("owner", "dispatch_epoch", "dispatch_step", "quant_tier", "site", "_force_fn", "_done", "_forced",
                 "_cancelled")

    def __init__(self, owner: Any, force_fn: Optional[Callable[[], None]], *, done: Optional[threading.Event] = None,
                 quant_tier: Optional[str] = None, site: str = "sync-force") -> None:
        self.owner = owner
        self.dispatch_epoch = world_epoch()
        self.dispatch_step = _faults.current_step()
        self.quant_tier = quant_tier
        self.site = site
        self._force_fn = force_fn
        self._done = done
        self._forced = force_fn is None  # a completed future: the sync ran blocking
        self._cancelled = False
        if not self._forced:
            _inflight.append(self)
            _bump("sync_async_dispatches")

    @classmethod
    def completed(cls, owner: Any) -> "SyncFuture":
        """A future already resolved: the sync ran blocking at dispatch."""
        return cls(owner, None)

    def done(self) -> bool:
        """Whether forcing would not block on the wire."""
        return self._forced or self._cancelled or self._done is None or self._done.is_set()

    def age_steps(self) -> int:
        """Monotonic steps since dispatch."""
        return max(0, _faults.current_step() - self.dispatch_step)

    def _clear_owner(self) -> None:
        owner = self.owner
        if owner is not None and owner.__dict__.get("_pending_sync") is self:
            object.__setattr__(owner, "_pending_sync", None)

    def _leave_registry(self) -> None:
        try:
            _inflight.remove(self)
        except ValueError:
            pass

    def cancel(self) -> None:
        """Drop the future without applying its rows (``reset()`` does this)."""
        if self._forced or self._cancelled:
            return
        self._cancelled = True
        self._leave_registry()
        self._clear_owner()

    def wait(self) -> None:
        """Force the sync. Raises the classified fault (``EpochFault``,
        ``SyncTimeoutFault``, ``SyncFault``) with the local states intact."""
        if self._forced or self._cancelled:
            self._clear_owner()
            return
        self._forced = True
        self._leave_registry()
        _bump("sync_async_forces")
        self._force_fn()
        self._clear_owner()


#: The process's in-flight futures, in dispatch order.
_inflight: List[SyncFuture] = []


def drain_inflight() -> int:
    """Force every in-flight future, in dispatch order, and wait out the
    dispatcher; returns how many were forced. Every blocking protocol calls it
    first: collectives pair by issue order, so a blocking one must not race an
    in-flight one."""
    n = 0
    while _inflight:
        _inflight[0].wait()
        n += 1
    # a cancelled future's collective may still be on the wire
    done = _last_submitted_done[0]
    if done is not None and not done.is_set():
        wait_with_deadline(done, site="sync-drain")
    return n


def inflight_stats() -> Dict[str, Any]:
    """How many syncs are in flight, the oldest one's age in steps and its dispatch epoch."""
    oldest = _inflight[0] if _inflight else None
    return {
        "count": len(_inflight),
        "oldest_age_steps": oldest.age_steps() if oldest is not None else 0,
        "oldest_dispatch_epoch": oldest.dispatch_epoch if oldest is not None else 0,
    }


# ------------------------------------------------------ membership and epochs
class _Membership:
    """The process-local membership registry: the monotonic world epoch, dead
    ranks, timeout suspicion, per-peer records and the transition log. Counter
    resets leave it; :func:`reset_membership` clears it, the epoch excepted."""

    __slots__ = ("epoch", "dead", "expected_world", "observed_world", "consecutive_timeouts", "last_good_sync_step",
                 "world_degraded", "peers", "transitions")

    def __init__(self) -> None:
        self.epoch: int = 1
        self.dead: set = set()
        self.expected_world: Optional[int] = None  # declared: widens group validation
        self.observed_world: Optional[int] = None  # learned from gathers: does not
        self.consecutive_timeouts: int = 0
        self.last_good_sync_step: Optional[int] = None
        self.world_degraded: bool = False
        self.peers: Dict[int, Dict[str, Any]] = {}
        self.transitions: "deque[Dict[str, Any]]" = deque(maxlen=64)

    @property
    def known_world(self) -> Optional[int]:
        return self.expected_world or self.observed_world


_membership = _Membership()
#: Who is dead, asked after ``sync_dead_after()`` consecutive timeouts: a timeout alone names no one.
_peer_prober: Optional[Callable[[], Iterable[int]]] = None


def set_peer_prober(prober: Optional[Callable[[], Iterable[int]]]) -> None:
    """Install (or clear, with None) the callable that names the dead ranks."""
    global _peer_prober
    _peer_prober = prober


def set_expected_world(n: Optional[int]) -> None:
    """Declare the full world's process count."""
    _membership.expected_world = None if n is None else max(1, int(n))


def world_epoch() -> int:
    """The current world epoch (from 1, bumped by every membership transition)."""
    return _membership.epoch


def bump_epoch(reason: str, rank: Optional[int] = None) -> int:
    """Advance the epoch: every protocol in flight trips its fence at its next check."""
    m = _membership
    m.epoch += 1
    m.consecutive_timeouts = 0
    _bump("sync_epoch_bumps")
    m.transitions.append({"step": _faults.current_step(), "epoch": m.epoch, "reason": reason, "rank": rank})
    if _telemetry.armed:
        _telemetry.emit("epoch-bump", None, "sync", attrs={"epoch": m.epoch, "reason": reason, "rank": rank})
    return m.epoch


def check_epoch(stamped: int, *, site: str = "sync-gather", owner: Any = None) -> None:
    """The epoch fence, right before a collective: raise :class:`EpochFault`
    when the protocol's epoch is no longer the live one (fault site ``epoch-fence``)."""
    if _faults.armed:
        _faults.maybe_fail("epoch-fence")
    if stamped == _membership.epoch:
        return
    _bump("sync_epoch_fence_trips")
    err = EpochFault(
        f"collective at site {site!r} fenced: the protocol entered at world epoch {stamped} but the membership "
        f"epoch is now {_membership.epoch} (a peer died or rejoined mid-protocol). Local state is intact — "
        "re-enter the sync at the current epoch.",
        site="epoch-fence",
    )
    _faults.note_fault("sync", site="epoch-fence", owner=owner, error=err)
    raise err


def _declare_dead(ranks: Iterable[int], reason: str) -> List[int]:
    m = _membership
    new = sorted(int(r) for r in ranks if int(r) not in m.dead)
    if not new:
        return []
    if m.expected_world is None and m.observed_world:
        m.expected_world = m.observed_world  # a transition makes the registry authoritative
    for r in new:
        m.dead.add(r)
        rec = m.peers.setdefault(r, {"timeouts": 0})
        rec["state"] = "dead"
        rec["declared_dead_epoch"] = m.epoch
        _bump("sync_peers_declared_dead")
        if _telemetry.armed:
            _telemetry.emit("peer-dead", None, "sync", attrs={"rank": r, "reason": reason})
    bump_epoch("peer-dead", rank=new[0] if len(new) == 1 else None)
    return new


def mark_peer_dead(rank: int, reason: str = "declared-dead") -> int:
    """Declare one rank dead (idempotent); returns the epoch."""
    _declare_dead([rank], reason)
    return _membership.epoch


def rejoin_rank(rank: int) -> int:
    """Re-admit a restarted rank: clear its dead mark and bump the epoch; returns the new epoch."""
    m = _membership
    r = int(rank)
    m.dead.discard(r)
    rec = m.peers.setdefault(r, {"timeouts": 0})
    rec["state"] = "live"
    rec["timeouts"] = 0
    _bump("sync_rank_rejoins")
    if _telemetry.armed:
        _telemetry.emit("peer-rejoin", None, "sync", attrs={"rank": r})
    rec["rejoined_epoch"] = bump_epoch("rejoin", rank=r)
    return m.epoch


def is_full_world_group(group: Optional[Any]) -> bool:
    """Whether ``group`` covers the whole known world: only such a sync stamps
    the last good sync and clears a degradation onset."""
    if group is None:
        return True
    try:
        members = sorted(dist.get_process_group_ranks(group)) if _is_process_group(group) else sorted(
            int(r) for r in group)
    except (TypeError, ValueError, RuntimeError):
        return False
    return members == list(range(effective_world_size()))


def surviving_members() -> Optional[List[int]]:
    """The surviving ranks, ascending, while peers are declared dead in a world
    of known size; None otherwise (the ``quorum`` tier syncs over these)."""
    m = _membership
    world = m.known_world
    if not m.dead or not world:
        return None
    alive = [r for r in range(world) if r not in m.dead]
    return alive or None


def note_sync_timeout(site: str) -> None:
    """One watchdog timeout: suspicion of every live peer; the K-th in a row
    asks the prober, which may declare peers dead (bumping the epoch)."""
    m = _membership
    m.consecutive_timeouts += 1
    if m.known_world:
        for r in range(m.known_world):
            if r not in m.dead:
                m.peers.setdefault(r, {"timeouts": 0, "state": "live"})["timeouts"] += 1
    if m.consecutive_timeouts < sync_dead_after() or _peer_prober is None:
        return
    try:
        suspects = list(_peer_prober() or ())
    except Exception:  # noqa: BLE001 - a broken prober must not hide the timeout
        return
    _declare_dead(suspects, reason=f"prober after {m.consecutive_timeouts} timeouts at {site}")


def note_sync_success(world: Optional[int] = None, members: Optional[List[int]] = None) -> None:
    """One completed protocol: clears the timeout suspicion; over the whole
    world (``members`` None) it also clears the degraded flag, stamps the last
    good sync step and learns the world size from a gather of several rows."""
    m = _membership
    m.consecutive_timeouts = 0
    if members is not None:
        return  # a subgroup's row count is not the world's
    if world is not None and world > 1:
        m.observed_world = int(world)
    m.world_degraded = False
    m.last_good_sync_step = _faults.current_step()
    for rec in m.peers.values():
        if rec.get("state", "live") == "live":
            rec["timeouts"] = 0
            rec["last_good_epoch"] = m.epoch


def last_good_sync_step() -> Optional[int]:
    """The monotonic step of the last protocol completed over the whole world; None before any."""
    return _membership.last_good_sync_step


def note_degraded_serve(kind: str = "local") -> None:
    """Count one degraded serve (``local`` or ``quorum``); the world reads
    degraded until the next full-world sync."""
    _bump("sync_quorum_serves" if kind == "quorum" else "sync_degraded_serves")
    _membership.world_degraded = True


def world_health() -> Dict[str, Any]:
    """The membership health block: epoch, dead and surviving ranks, timeout
    suspicion, per-peer records and the transition log.

    Example:
        >>> from metrics_tpu_torch.parallel.sync import world_health
        >>> h = world_health()
        >>> h["epoch"] >= 1
        True
        >>> sorted(h)[:3]
        ['consecutive_timeouts', 'dead_after', 'dead_ranks']
    """
    m = _membership
    return {
        "epoch": m.epoch,
        "expected_world": m.expected_world,
        "observed_world": m.observed_world,
        "live_world": world_size(),
        "dead_ranks": sorted(m.dead),
        "surviving_ranks": surviving_members(),
        "consecutive_timeouts": m.consecutive_timeouts,
        "dead_after": sync_dead_after(),
        "degraded": bool(m.dead) or m.world_degraded,
        "last_good_sync_step": m.last_good_sync_step,
        "peers": {r: dict(rec) for r, rec in sorted(m.peers.items())},
        "transitions": list(m.transitions),
    }


def reset_membership() -> None:
    """Clear the registry and the prober (tests, drills); the epoch stays monotonic."""
    m = _membership
    m.dead.clear()
    m.peers.clear()
    m.expected_world = None
    m.observed_world = None
    m.consecutive_timeouts = 0
    m.last_good_sync_step = None
    m.world_degraded = False
    m.transitions.clear()
    set_peer_prober(None)
    _GROUP_CACHE.clear()


# ------------------------------------------------------------ collective audit
_counters: Dict[str, int] = {
    # one slot per protocol collective: the per-state protocol pays a shape
    # exchange and a payload gather per state; the coalesced protocol one
    # payload gather per sync, plus one metadata exchange where a `cat` list
    # state is packed (or the first time a static layout is seen in a live world)
    "sync_shape_collectives": 0,
    "sync_payload_collectives": 0,
    "sync_bytes_gathered": 0,
    "sync_states_coalesced": 0,
    "sync_coalesced_payloads": 0,
    "sync_fastlane_hits": 0,
    "sync_fastlane_misses": 0,
    "sync_pack_fallbacks": 0,
    "sync_deadline_timeouts": 0,
    "sync_degraded_serves": 0,
    "sync_quorum_serves": 0,
    "sync_epoch_bumps": 0,
    "sync_epoch_fence_trips": 0,
    # collectives noted at a stale epoch: the fence raises first, so this stays 0
    "sync_stale_collectives": 0,
    "sync_dist_resolutions": 0,
    "sync_peers_declared_dead": 0,
    "sync_rank_rejoins": 0,
    "sync_async_dispatches": 0,
    "sync_async_forces": 0,
    "sync_async_auto_forces": 0,
    "sync_async_fallbacks": 0,
    "sync_async_stale_futures": 0,
    "sync_quant_payloads": 0,
    "sync_quant_exact_states": 0,
    "sync_quant_lossy_states": 0,
    "sync_quant_bytes_saved": 0,
    "sync_hier_intranode_collectives": 0,
    "sync_hier_internode_collectives": 0,
    "sync_hier_node_reduces": 0,
}


def note_collective(kind: str, nbytes: int = 0, epoch: Optional[int] = None) -> None:
    """Count one protocol collective (``kind``: "shape" | "payload") and the
    bytes it gathered; one noted at a stale ``epoch`` counts in ``sync_stale_collectives``."""
    _counters[f"sync_{kind}_collectives"] += 1
    if nbytes:
        _counters["sync_bytes_gathered"] += int(nbytes)
    if epoch is not None and epoch != _membership.epoch:
        _counters["sync_stale_collectives"] += 1


def _bump(name: str, n: int = 1) -> None:
    _counters[name] += n


def collective_stats() -> dict:
    """The collective counters, their total and the coalescing ratio (states
    packed per coalesced payload; the per-state protocol's 1.0 is the floor)."""
    out = dict(_counters)
    out["sync_collectives_issued"] = out["sync_shape_collectives"] + out["sync_payload_collectives"]
    payloads = out["sync_coalesced_payloads"]
    out["sync_coalesce_ratio"] = round(out["sync_states_coalesced"] / payloads, 3) if payloads else 0.0
    return out


def reset_collective_stats() -> None:
    for key in _counters:
        _counters[key] = 0


_telemetry.register_reset("sync", reset_collective_stats)


# ------------------------------------------------------------------- gather
def _all_gather(tensor: Tensor, group: Optional[Any] = None) -> Tensor:
    """``(world, *tensor.shape)``: every member's ``tensor`` (equal shapes), in group rank order.

    One ``all_gather`` in its list form, which every torch version has; the
    list holds views into one buffer, so the rows land in place. A failed
    collective raises :class:`SyncFault`.
    """
    try:
        out = torch.empty((dist.get_world_size(group),) + tuple(tensor.shape), dtype=tensor.dtype, device=tensor.device)
        dist.all_gather(list(out.unbind(0)), tensor.contiguous(), group=group)
    except (RuntimeError, ValueError) as err:
        raise SyncFault(f"all_gather of {tuple(tensor.shape)} {tensor.dtype} failed: {err}", site="sync-gather") from err
    return out


def _gather_once(result: Tensor, group: Optional[Any], epoch: Optional[int] = None) -> List[Tensor]:
    """The uneven-shape protocol's two collectives over ``group`` (a transport group)."""
    with _telemetry.timed("sync-gather", None, "sync") as span:
        if not _live():
            note_collective("shape", epoch=epoch)
            nbytes = result.numel() * result.element_size()
            note_collective("payload", nbytes=nbytes, epoch=epoch)
            out = [result]
        else:
            x = result.reshape(1) if result.ndim == 0 else result
            note_collective("shape", epoch=epoch)
            shapes = _all_gather(torch.tensor(x.shape, dtype=torch.int64, device=x.device), group).tolist()
            max_shape = [max(s[d] for s in shapes) for d in range(x.ndim)]
            if list(x.shape) != max_shape:
                padded = x.new_zeros(max_shape)
                padded[tuple(slice(0, d) for d in x.shape)] = x
                x = padded
            nbytes = x.numel() * x.element_size() * len(shapes)
            note_collective("payload", nbytes=nbytes, epoch=epoch)
            gathered = _all_gather(x, group)
            out = [gathered[r][tuple(slice(0, d) for d in shape)] for r, shape in enumerate(shapes)]
            if result.ndim == 0:
                out = [o.reshape(()) for o in out]
        span.attrs = {"bytes": int(nbytes), "collectives": 2, "seq": _counters["sync_payload_collectives"]}
    return out


def gather_all_tensors(result: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """All-gather a tensor from every process of ``group``; sizes may differ between processes.

    The reference's uneven-shape protocol: gather the shapes, pad to the
    largest, all-gather, trim each entry back to its own shape. Returns one
    entry per member, in ascending rank order; every member receives them
    all. Every process must have the same number of dimensions. Two
    collectives a call, each counted by :func:`collective_stats`, as a call
    with no process group initialised is too (it returns ``[result]``).

    In-flight asynchronous syncs are forced first. The group is validated
    (:class:`SyncConfigFault`, never retried); then the exchange is retried
    within the budget (``METRICS_TPU_SYNC_RETRIES``), each attempt checking
    the epoch fence, firing the ``sync-gather`` fault site and running under
    the deadline. A failure past the budget raises :class:`SyncFault`.
    """
    drain_inflight()
    members = validate_group_live(group)
    fence = world_epoch()
    transport = transport_group(group, members)

    def _attempt() -> List[Tensor]:
        check_epoch(fence, site="sync-gather")
        if _faults.armed:
            _faults.maybe_fail("sync-gather")
        return run_with_deadline(lambda: _gather_once(result, transport, fence), site="sync-gather")

    out = _faults.retry_with_backoff(_attempt, attempts=sync_retries(), base_delay_s=sync_backoff_s(), site="sync-gather")
    note_sync_success(world=len(out) if members is None else None, members=members)
    return out


def reduce(x: Tensor, reduction: str) -> Tensor:
    """Reduce a tensor: "elementwise_mean" | "sum" | "none" (reference `distributed.py:22-41`)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Per-class fraction reduce: "micro" | "macro" | "weighted" | "none".

    Parity: reference `utilities/distributed.py:44-93`, with 0/0 -> 0 for the
    per-class fractions.
    """
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        return torch.sum(num) / torch.sum(denom)
    fraction = torch.where(
        denom == 0, torch.zeros((), dtype=torch.float32, device=num.device), num / torch.where(denom == 0, 1, denom)
    )
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction!r} unknown. Choose between one of these: {valid_reduction}")


__all__ = [
    "SyncFuture",
    "bump_epoch",
    "check_epoch",
    "check_group",
    "class_reduce",
    "collective_stats",
    "distributed_available",
    "drain_inflight",
    "effective_world_size",
    "gather_all_tensors",
    "inflight_stats",
    "is_full_world_group",
    "last_good_sync_step",
    "mark_peer_dead",
    "note_collective",
    "note_degraded_serve",
    "note_sync_success",
    "note_sync_timeout",
    "reduce",
    "rejoin_rank",
    "reset_collective_stats",
    "reset_membership",
    "run_inflight",
    "run_with_deadline",
    "set_expected_world",
    "set_peer_prober",
    "submit_async",
    "surviving_members",
    "sync_backoff_s",
    "sync_dead_after",
    "sync_deadline_s",
    "sync_degraded_tier",
    "sync_hier_node_size",
    "sync_quant_tier",
    "sync_retries",
    "transport_group",
    "validate_group_live",
    "wait_with_deadline",
    "world_epoch",
    "world_health",
    "world_size",
]
