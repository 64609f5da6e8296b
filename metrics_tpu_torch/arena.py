"""Tenant arenas: N same-configuration suites as one stacked state, driven by vmapped steps.

JAX counterpart: `metrics_tpu/arena.py`. Per-user, per-cohort or per-model
suites are many independent instances with small states; a Python loop feeds
them one dispatch at a time. :class:`MetricArena` stacks the functional
states (:mod:`metrics_tpu_torch.functional_core`) of N tenants on a leading
axis and drives them with cached step programs: ``update(tenant_ids,
*batch)`` is a gather, a ``torch.func.vmap`` of the metric's own pure update,
and a scatter; ``compute()``, ``reset(mask)`` and the cohort views are one
program each over the whole stack, whatever N is. The vmapped update of a
confusion-matrix member is one launch of the batched bincount kernel
(``metrics_tpu_torch::bincount``'s vmap rule) with one row a tenant.

- **Slab-bucketed shapes.** Capacity takes only the values ``slab * 2**k``,
  and an update of a ragged tenant count runs in ``engine.pow2_chunks``
  chunks, so the program cache sees a set of shapes bounded by the buckets and
  chunk sizes, not by the tenants. Removed ids recycle through a free list.
- **Slab-granular durability.** ``save()`` writes one CRC-framed raw record a
  slab (``journal.pack_raw_record``), each with its own generation ring; a
  torn slab falls back to its previous good generation at ``restore()``,
  and its neighbours are not touched.
- **Cohort views.** ``cohort_values``, ``close_window``, ``window_values``,
  ``decay_tick`` and ``cohort_drift`` run over the stack: a segment reduce by
  each state's spec, then a vmapped compute.

Suites with list (``cat``) states cannot ride a fixed-shape stack: they take
the row lane (one pure update a tenant, list appends) and still batch
``compute`` by stacking tenants of one layout. The stacked states live on the
template's device (the card unless it was built with ``device="cpu"``); the
update's scatter writes into them in place (``index_copy_``, outside the
vmap), so no chunk copies the whole stack.

Knobs: ``METRICS_TPU_ARENA_SLAB`` (default 256) and
``METRICS_TPU_ARENA_JOURNAL_EVERY`` (auto-save every N updates when a
``journal_path`` is set; 0, the default, never).
"""
from __future__ import annotations

import os
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from metrics_tpu_torch import functional_core as _funcore
from metrics_tpu_torch.ops import engine as _engine
from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import journal as _journal
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.parallel import sync as _psync

__all__ = [
    "MetricArena",
    "arena_default_slab",
    "arena_journal_every",
    "arena_snapshot",
    "arena_stats",
    "stack_states",
    "unstack_states",
]

_counters: Dict[str, int] = {
    # tenant lifecycle
    "arena_tenants_added": 0,
    "arena_tenants_removed": 0,
    "arena_ids_recycled": 0,
    "arena_grows": 0,
    "arena_shrinks": 0,
    # the vmapped hot path
    "arena_updates": 0,
    "arena_update_chunks": 0,
    "arena_row_updates": 0,
    "arena_computes": 0,
    "arena_resets": 0,
    # cohort views
    "arena_closes": 0,
    "arena_decay_ticks": 0,
    "arena_cohort_programs": 0,
    "arena_drift_reports": 0,
    # slab durability
    "arena_slab_saves": 0,
    "arena_slab_bytes_written": 0,
    "arena_slab_restores": 0,
    "arena_slab_demotions": 0,
    "arena_slab_prunes": 0,
}

#: One JSON-safe block per arena name: capacity, tenants, newest per-cohort values.
_ARENAS: Dict[str, Dict[str, Any]] = {}


def arena_stats() -> Dict[str, int]:
    """The arena counters (folded into ``engine_stats()``): tenant lifecycle,
    vmapped update chunks, row-lane updates, computes, resets, cohort views
    and slab-journal traffic.

    Example:
        >>> from metrics_tpu_torch import arena_stats
        >>> arena_stats()["arena_updates"] >= 0
        True
    """
    return dict(_counters)


def _reset_arena() -> None:
    for key in _counters:
        _counters[key] = 0
    _ARENAS.clear()


_telemetry.register_reset("arena", _reset_arena)


def arena_snapshot() -> Dict[str, Any]:
    """The ``arenas`` block of the streaming snapshot: per arena name, capacity and
    slab facts, live tenants, the close id and the newest per-cohort values."""
    return {
        name: dict(block, cohorts={k: dict(v) for k, v in block.get("cohorts", {}).items()})
        for name, block in _ARENAS.items()
    }


# ------------------------------------------------------------------ env knobs
class _ArenaWarnOwner:
    """Warn-once anchor for this module's knob parse warnings."""


_SLAB_WARN_OWNER = _ArenaWarnOwner()
_JOURNAL_WARN_OWNER = _ArenaWarnOwner()


def arena_default_slab() -> int:
    """The slab size of an arena built without ``slab`` (``METRICS_TPU_ARENA_SLAB``,
    default 256, at least 1): tenant rows a journal record, and the capacity quantum."""
    return max(1, _psync._env_int("METRICS_TPU_ARENA_SLAB", 256, owner=_SLAB_WARN_OWNER))


def arena_journal_every() -> int:
    """Auto-save cadence in updates (``METRICS_TPU_ARENA_JOURNAL_EVERY``, default 0: off)."""
    return max(0, _psync._env_int("METRICS_TPU_ARENA_JOURNAL_EVERY", 0, owner=_JOURNAL_WARN_OWNER))


# ----------------------------------------------------------------- tree utils
def stack_states(states: Sequence[Any]) -> Any:
    """N state trees of one structure as one tree whose every leaf has a new leading axis.

    The one stacking path: the arena and the clone fan-out
    (:mod:`metrics_tpu_torch.wrappers._fanout`) both stack through here.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import stack_states
        >>> stack_states([{"s": torch.ones(2)}, {"s": torch.zeros(2)}])["s"].shape
        torch.Size([2, 2])
    """
    first = states[0]
    if _flat(first):  # the common case, a metric's {state: tensor}: no tree walk
        return {k: torch.stack([s[k] for s in states]) for k in first}
    return pytree.tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_states(stacked: Any, n: int) -> List[Any]:
    """The inverse of :func:`stack_states`: ``n`` trees, each leaf a view of row ``i`` (no copies).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import stack_states, unstack_states
        >>> rows = unstack_states(stack_states([{"s": torch.ones(2)}] * 3), 3)
        >>> len(rows), tuple(rows[0]["s"].shape)
        (3, (2,))
    """
    if _flat(stacked):
        rows = {k: v.unbind(0) for k, v in stacked.items()}
        return [{k: r[i] for k, r in rows.items()} for i in range(n)]
    leaves, spec = pytree.tree_flatten(stacked)
    rows = [leaf.unbind(0) for leaf in leaves]
    return [pytree.tree_unflatten([r[i] for r in rows], spec) for i in range(n)]


def _flat(tree: Any) -> bool:
    return type(tree) is dict and all(isinstance(v, torch.Tensor) for v in tree.values())


_SEP = "\x1f"  # joins a member's and a state's names: never in a state name


def _flatten_state(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The (at most two-level) state tree as ``{name: leaf}``, members joined by
    an unprintable separator: the slab record's layout and the programs' walk."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            for sub, leaf in value.items():
                flat[f"{key}{_SEP}{sub}"] = leaf
        else:
            flat[key] = value
    return flat


def _unflatten_state(flat: Dict[str, Any], like: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in like.items():
        if isinstance(value, dict):
            out[key] = {sub: flat[f"{key}{_SEP}{sub}"] for sub in value}
        else:
            out[key] = flat[key]
    return out


def _has_list_state(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_list_state(v) for v in tree.values())
    return isinstance(tree, list)


def _mask_broadcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def _min_identity(dtype: torch.dtype) -> Any:
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point:
        return -float("inf")
    return torch.iinfo(dtype).min


def _max_identity(dtype: torch.dtype) -> Any:
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _safe_name(name: Any) -> str:
    from metrics_tpu_torch import streaming as _streaming

    return _streaming._safe_name(name)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


_ANON_SEQ = [0]


# ------------------------------------------------------------------ the arena
class MetricArena:
    """N same-configuration metric suites as one stacked state on the template's device.

    ``template`` is a ``Metric`` or ``MetricCollection`` describing every
    tenant; its pure functions (:func:`metrics_tpu_torch.functional_core.metric_functions`)
    are what the arena vmaps. Tenants are integer ids handed out by
    :meth:`add` and recycled by :meth:`remove`; ``capacity`` rounds up to the
    slab bucket ``slab * 2**k``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric, MetricArena
        >>> arena = MetricArena(MeanMetric(device="cpu"), capacity=4, slab=4)
        >>> ids = arena.add(3)
        >>> arena.update(ids, torch.tensor([[1.0], [2.0], [3.0]]))
        >>> [round(float(v), 1) for v in arena.compute(ids)]
        [1.0, 2.0, 3.0]
    """

    def __init__(
        self,
        template: Any,
        capacity: int = 0,
        *,
        name: Optional[str] = None,
        slab: Optional[int] = None,
        cohort: Optional[str] = None,
        journal_path: Optional[str] = None,
        journal_every: Optional[int] = None,
        window_slots: int = 8,
    ) -> None:
        fns = _funcore.metric_functions(template)
        self._template = template
        self._init_fn, self._update_fn, self._compute_fn = fns
        self._key = _funcore._export_key(template)
        if name is None:
            _ANON_SEQ[0] += 1
            name = f"{type(template).__name__}_arena{_ANON_SEQ[0]}"
        self._name = _safe_name(name)
        self._slab = max(1, int(slab)) if slab else arena_default_slab()
        self._default_cohort = str(cohort) if cohort is not None else "default"
        self._journal_path = str(journal_path) if journal_path else None
        self._journal_every = max(0, int(journal_every)) if journal_every is not None else arena_journal_every()
        self._updates_since_save = 0
        self._window_slots = max(1, int(window_slots))
        self._closes = 0
        #: per-close, per-cohort merged host states, re-merged by spec at window_values()
        self._ring: Deque[Tuple[int, Dict[str, Dict[str, Any]]]] = deque(maxlen=self._window_slots)

        self._proto = self._init_fn()
        self._fused = not _has_list_state(self._proto)
        self._spec_tree = self._build_spec_tree()
        self._flat_proto = _flatten_state(self._proto)
        self._flat_specs = _flatten_state(self._spec_tree)
        self._device = self._template_device()
        # a cached step closes over its template's functions, whose tensors live on its device: a card
        # arena and a CPU one of the same configuration must not share programs
        self._key = (self._key, str(self._device))
        self._decay_validated: Dict[float, float] = {}

        self._capacity = 0
        self._stacked: Optional[Dict[str, torch.Tensor]] = None  # fused lane
        self._rows: List[Optional[Dict[str, Any]]] = []  # row lane
        self._live = np.zeros((0,), dtype=bool)
        self._counts = np.zeros((0,), dtype=np.int64)
        self._cohorts: np.ndarray = np.empty((0,), dtype=object)
        self._free: List[int] = []  # recycled ids, descending (pop() gives the lowest)
        self._watermark = 0  # the first id never issued
        self._grow_to(self._bucket_capacity(max(int(capacity), 1)))

    def _template_device(self) -> torch.device:
        leaves = [leaf for leaf in pytree.tree_leaves(self._proto) if isinstance(leaf, torch.Tensor)]
        if leaves:
            return leaves[0].device
        nodes = list(self._template.values(copy_state=False)) if _funcore._is_collection(self._template) else [self._template]
        return nodes[0].device

    # ------------------------------------------------------------- properties
    @property
    def name(self) -> str:
        return self._name

    @property
    def capacity(self) -> int:
        """Allocated tenant rows: always ``slab * 2**k``."""
        return self._capacity

    @property
    def slab_size(self) -> int:
        return self._slab

    @property
    def slabs(self) -> int:
        return self._capacity // self._slab

    @property
    def tenants(self) -> int:
        """The live tenant count."""
        return int(self._live.sum())

    @property
    def fused(self) -> bool:
        """True when every state is a fixed-shape tensor (the vmapped lane); False: the row lane."""
        return self._fused

    @property
    def window_id(self) -> int:
        return self._closes

    @property
    def device(self) -> torch.device:
        """Where the stacked states live: the template's device."""
        return self._device

    def live_ids(self) -> np.ndarray:
        """Live tenant ids, ascending."""
        return np.nonzero(self._live)[0].astype(np.int64)

    def cohort_of(self, tenant_id: int) -> str:
        self._check_live(np.asarray([tenant_id]))
        return self._cohorts[int(tenant_id)] or self._default_cohort

    # ------------------------------------------------------- capacity buckets
    def _bucket_capacity(self, n: int) -> int:
        """The least ``slab * 2**k`` that holds ``n`` tenants."""
        slabs = max(1, -(-int(n) // self._slab))
        return self._slab * (1 << (slabs - 1).bit_length())

    def _grow_to(self, new_cap: int) -> None:
        old_cap = self._capacity
        if new_cap <= old_cap:
            return
        pad = new_cap - old_cap
        if self._fused:
            fresh = {k: p.expand((pad,) + tuple(p.shape)) for k, p in self._flat_proto.items()}
            if self._stacked is None:
                self._stacked = {k: v.clone() for k, v in fresh.items()}
            else:
                self._stacked = {k: torch.cat([leaf, fresh[k]]) for k, leaf in self._stacked.items()}
        else:
            self._rows.extend([None] * pad)
        self._live = np.concatenate([self._live, np.zeros(pad, dtype=bool)])
        self._counts = np.concatenate([self._counts, np.zeros(pad, dtype=np.int64)])
        self._cohorts = np.concatenate([self._cohorts, np.full(pad, None, dtype=object)])
        self._capacity = new_cap
        if old_cap:
            _counters["arena_grows"] += 1

    def _maybe_shrink(self) -> None:
        """Release trailing slabs no live tenant occupies (ids are stable: no compaction)."""
        live = np.nonzero(self._live)[0]
        high = int(live.max()) + 1 if live.size else 1
        new_cap = self._bucket_capacity(high)
        if new_cap >= self._capacity:
            return
        if self._fused:
            self._stacked = {k: leaf[:new_cap].clone() for k, leaf in self._stacked.items()}
        else:
            del self._rows[new_cap:]
        self._live = self._live[:new_cap]
        self._counts = self._counts[:new_cap]
        self._cohorts = self._cohorts[:new_cap]
        self._free = [i for i in self._free if i < new_cap]
        self._watermark = min(self._watermark, new_cap)
        self._capacity = new_cap
        _counters["arena_shrinks"] += 1

    # -------------------------------------------------------- tenant lifecycle
    def add(self, count: int = 1, *, cohort: Optional[str] = None) -> List[int]:
        """Allocate ``count`` tenant ids (removed ids first, then fresh ones, growing
        the stack by slab buckets); ``cohort`` labels them for the cohort views."""
        count = int(count)
        if count < 1:
            raise ValueError(f"add() needs a positive tenant count, got {count}")
        ids: List[int] = []
        while self._free and len(ids) < count:
            ids.append(self._free.pop())
            _counters["arena_ids_recycled"] += 1
        fresh = count - len(ids)
        if fresh:
            needed = self._watermark + fresh
            if needed > self._capacity:
                self._grow_to(self._bucket_capacity(needed))
            ids.extend(range(self._watermark, needed))
            self._watermark = needed
        label = str(cohort) if cohort is not None else None
        idx = np.asarray(ids, dtype=np.int64)
        self._live[idx] = True
        self._counts[idx] = 0
        self._cohorts[idx] = label
        if not self._fused:
            for tid in ids:
                self._rows[tid] = self._init_fn()
        _counters["arena_tenants_added"] += len(ids)
        return ids

    def remove(self, tenant_ids: Any) -> None:
        """Retire tenants: their rows reset, their ids go back on the free list, and
        empty trailing slabs are released."""
        ids = self._as_ids(tenant_ids)
        self._check_live(ids)
        self.reset(tenant_ids=ids)
        self._live[ids] = False
        self._cohorts[ids] = None
        if not self._fused:
            for tid in ids.tolist():
                self._rows[tid] = None
        self._free = sorted(set(self._free).union(ids.tolist()), reverse=True)
        _counters["arena_tenants_removed"] += int(ids.size)
        self._maybe_shrink()

    def _as_ids(self, tenant_ids: Any) -> np.ndarray:
        if isinstance(tenant_ids, torch.Tensor):
            tenant_ids = tenant_ids.cpu().numpy()
        ids = np.asarray(tenant_ids, dtype=np.int64).ravel()
        if ids.size == 0:
            raise ValueError("empty tenant id list")
        if np.unique(ids).size != ids.size:
            raise ValueError("duplicate tenant ids in one call (scatter order would be undefined)")
        if ids.min() < 0 or ids.max() >= self._capacity:
            raise ValueError(f"tenant id out of range [0, {self._capacity}): {ids.min()}..{ids.max()}")
        return ids

    def _check_live(self, ids: np.ndarray) -> None:
        dead = ids[~self._live[ids]]
        if dead.size:
            raise ValueError(f"tenant id(s) {dead.tolist()} are not live (add() them first)")

    def _on_device(self, tree: Any) -> Any:
        """Every array leaf of a batch as a tensor on the arena's device."""
        def leaf(x: Any) -> Any:
            if isinstance(x, torch.Tensor):
                return x if x.device == self._device else x.to(self._device)
            if isinstance(x, np.ndarray):
                return torch.from_numpy(np.ascontiguousarray(x)).to(self._device)
            return x

        return pytree.tree_map(leaf, tree)

    # ------------------------------------------------------------ the hot path
    def update(self, tenant_ids: Any, *args: Any, **kwargs: Any) -> None:
        """One batch a tenant: every array leaf of ``args``/``kwargs`` has a leading axis
        of ``len(tenant_ids)``. The fused lane runs gather, ``torch.func.vmap`` of the
        update and scatter as cached step programs, a ragged tenant count in
        ``pow2_chunks``; the row lane applies the same pure update tenant by tenant."""
        ids = self._as_ids(tenant_ids)
        self._check_live(ids)
        t0 = _telemetry.now() if _telemetry.armed else 0.0
        chunks = 0
        batch = self._on_device((args, kwargs))
        if self._fused:
            all_ids = torch.from_numpy(ids).to(self._device)
            off = 0
            for size in _engine.pow2_chunks(int(ids.size)):
                sl = slice(off, off + size)
                chunk_a, chunk_k = pytree.tree_map(lambda leaf: leaf[sl], batch)
                exe = self._update_exe(size)
                self._stacked = exe.run(self._stacked, (all_ids[sl], chunk_a, chunk_k))
                chunks += 1
                off += size
            _counters["arena_update_chunks"] += chunks
        else:
            for pos, tid in enumerate(ids.tolist()):
                row_args, row_kwargs = pytree.tree_map(lambda leaf: leaf[pos], batch)
                self._rows[tid] = self._update_fn(self._rows[tid], *row_args, **row_kwargs)
            _counters["arena_row_updates"] += int(ids.size)
        self._counts[ids] += 1
        _counters["arena_updates"] += 1
        if t0 and _telemetry.armed:
            _telemetry.emit(
                "arena-update", self._name, "arena", t0, _telemetry.now() - t0,
                {"tenants": int(ids.size), "chunks": chunks, "capacity": self._capacity,
                 "lane": "fused" if self._fused else "rows"},
            )
        self._updates_since_save += 1
        if self._journal_path and self._journal_every and self._updates_since_save >= self._journal_every:
            self.save()

    def _update_exe(self, chunk: int) -> Any:
        update_fn = self._update_fn
        proto = self._proto

        def build() -> Callable:
            def one(s: Dict[str, Any], aa: tuple, kk: dict) -> Dict[str, Any]:
                return update_fn(s, *aa, **kk)

            def step(stacked: Dict[str, torch.Tensor], ids: torch.Tensor, a: tuple, k: dict) -> Dict[str, torch.Tensor]:
                sub = _unflatten_state({name: leaf.index_select(0, ids) for name, leaf in stacked.items()}, proto)
                flat_new = _flatten_state(torch.func.vmap(one)(sub, a, k))
                for name, leaf in stacked.items():  # outside the vmap: an in-place scatter of the chunk's rows
                    leaf.index_copy_(0, ids, flat_new[name].to(leaf.dtype))
                return stacked

            return step

        return _engine.acquire_keyed(("arena-update", self._key, self._capacity, chunk), build)

    def compute(self, tenant_ids: Optional[Any] = None) -> Any:
        """Per-tenant values with a leading axis aligned to ``tenant_ids`` (default:
        every live tenant ascending, as :meth:`live_ids`): one vmapped program over
        the whole stack; row-lane tenants batch by state layout."""
        ids = self.live_ids() if tenant_ids is None else self._as_ids(tenant_ids)
        if ids.size == 0:
            raise ValueError("compute() on an empty arena (no live tenants)")
        self._check_live(ids)
        _counters["arena_computes"] += 1
        if self._fused:
            values = self._compute_exe()(self._stacked)
            sel = torch.from_numpy(ids).to(self._device)
            return pytree.tree_map(lambda v: torch.as_tensor(v).index_select(0, sel), values)
        # the row lane: tenants of one layout stacked, one vmapped compute each
        groups: Dict[Any, List[int]] = {}
        for pos, tid in enumerate(ids.tolist()):
            leaves, spec = pytree.tree_flatten(self._rows[tid])
            sig = (str(spec), tuple((tuple(leaf.shape), str(leaf.dtype)) for leaf in leaves))
            groups.setdefault(sig, []).append(pos)
        per_pos: List[Any] = [None] * int(ids.size)
        compute_fn = self._compute_fn
        for sig, positions in groups.items():
            stacked = stack_states([self._rows[int(ids[p])] for p in positions])

            def build() -> Callable:
                def step(st: Any) -> Any:
                    return torch.func.vmap(lambda s: compute_fn(s, axis_name=None))(st)

                return step

            vals = _engine.acquire_keyed(("arena-compute-rows", self._key, len(positions), sig), build)(stacked)
            for i, p in enumerate(positions):
                per_pos[p] = pytree.tree_map(lambda v: v[i], vals)
        return pytree.tree_map(lambda *xs: torch.stack(xs), *per_pos)

    def _compute_exe(self) -> Any:
        compute_fn = self._compute_fn
        proto = self._proto

        def build() -> Callable:
            def step(stacked: Dict[str, torch.Tensor]) -> Any:
                return torch.func.vmap(lambda s: compute_fn(s, axis_name=None))(_unflatten_state(stacked, proto))

            return step

        return _engine.acquire_keyed(("arena-compute", self._key, self._capacity), build)

    def reset(self, mask: Optional[Any] = None, *, tenant_ids: Optional[Any] = None) -> None:
        """Reset the selected tenants to their init state through one masked program;
        the other rows pass through bit for bit. ``mask`` is a bool vector of
        ``capacity``; ``tenant_ids`` the sparse form; neither resets every live tenant."""
        if mask is not None and tenant_ids is not None:
            raise ValueError("pass mask OR tenant_ids, not both")
        if mask is not None:
            m = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask, dtype=bool).ravel()
            if m.size != self._capacity:
                raise ValueError(f"mask has {m.size} rows, arena capacity is {self._capacity}")
        else:
            m = np.zeros(self._capacity, dtype=bool)
            ids = self.live_ids() if tenant_ids is None else self._as_ids(tenant_ids)
            m[ids] = True
        if self._fused:
            self._stacked = self._reset_exe().run(self._stacked, (torch.from_numpy(m).to(self._device),))
        else:
            for tid in np.nonzero(m)[0].tolist():
                if self._rows[tid] is not None:
                    self._rows[tid] = self._init_fn()
        self._counts[m] = 0
        _counters["arena_resets"] += 1

    def _reset_exe(self) -> Any:
        flat_proto = self._flat_proto

        def build() -> Callable:
            def step(stacked: Dict[str, torch.Tensor], m: torch.Tensor) -> Dict[str, torch.Tensor]:
                return {name: torch.where(_mask_broadcast(m, leaf.ndim), flat_proto[name], leaf)
                        for name, leaf in stacked.items()}

            return step

        return _engine.acquire_keyed(("arena-reset", self._key, self._capacity), build)

    def precompile(self, *args: Any, batch: Optional[int] = None, **kwargs: Any) -> Dict[str, Any]:
        """Acquire the update programs for every ``pow2_chunks`` size of a batch of
        ``batch`` tenants (default: the leading dim of the first array of
        ``args``/``kwargs``, else one slab), and the compute and reset programs,
        without touching a tenant's state. An eager step has nothing to compile
        ahead of its first run, so this builds the cache entries only; returns
        ``{programs, compiles, progcache_hits, progcache_stores, sources}``
        under JAX's keys (the program cache, and so its counts, is not ported)."""
        builds0 = _engine.engine_stats()["builds"]

        def _report(sources: Dict[str, str], skipped: Optional[str] = None) -> Dict[str, Any]:
            built = _engine.engine_stats()["builds"] - builds0
            out = {"programs": built, "compiles": 0, "progcache_hits": 0, "progcache_stores": 0, "sources": sources}
            if skipped:
                out["skipped"] = skipped
            return out

        if not self._fused:
            return _report({}, "row lane (cat-state suites) dispatches eager per-tenant kernels")
        if batch is not None:
            n = int(batch)
        else:
            dims = [int(leaf.shape[0]) for leaf in pytree.tree_leaves((args, kwargs))
                    if hasattr(leaf, "shape") and len(tuple(leaf.shape)) >= 1]
            n = dims[0] if dims else self._slab
        sources: Dict[str, str] = {}
        for c in sorted(set(_engine.pow2_chunks(n))):
            self._update_exe(c)
            sources[f"arena-update/{c}"] = "built"
        self._compute_exe()
        self._reset_exe()
        sources["arena-compute"] = sources["arena-reset"] = "built"
        return _report(sources)

    # ------------------------------------------------------ per-tenant states
    def tenant_state(self, tenant_id: int) -> Dict[str, Any]:
        """One tenant's functional state tree (a copy of its row): the bridge back to
        ``host_handoff`` and per-instance tooling."""
        ids = self._as_ids([tenant_id])
        self._check_live(ids)
        tid = int(ids[0])
        if self._fused:
            return pytree.tree_map(lambda leaf: leaf[tid].clone(), _unflatten_state(self._stacked, self._proto))
        return pytree.tree_map(lambda leaf: leaf, self._rows[tid])

    # --------------------------------------------------------- cohort streaming
    def _build_spec_tree(self) -> Dict[str, Any]:
        if _funcore._is_collection(self._template):
            return {name: {s: str(spec) for s, spec in m._reduction_specs.items()}
                    for name, m in self._template.items(keep_base=True, copy_state=False)}
        return {s: str(spec) for s, spec in self._template._reduction_specs.items()}

    def _check_cohort_mergeable(self, what: str) -> None:
        for name, spec in self._flat_specs.items():
            if spec not in ("sum", "mean", "max", "min"):
                raise ValueError(
                    f"{what} needs cohort-mergeable states (sum/mean/max/min); "
                    f"state {name.replace(_SEP, '.')} of {self._name} reduces by {spec!r}"
                )

    def _effective_cohorts(self, ids: np.ndarray) -> np.ndarray:
        """Cohort labels of ``ids``, unlabelled rows in the default cohort."""
        raw = self._cohorts[ids]
        return np.where((raw == None) | (raw == ""), self._default_cohort, raw).astype(str)  # noqa: E711 - elementwise

    def _cohort_layout(self) -> Tuple[List[str], np.ndarray]:
        """(sorted cohort labels, segment of each row); dead rows land in the drop
        segment ``len(cohorts)``."""
        live_ids = np.nonzero(self._live)[0]
        if not live_ids.size:
            return [], np.zeros(self._capacity, dtype=np.int64)
        labels_arr, inverse = np.unique(self._effective_cohorts(live_ids), return_inverse=True)
        seg = np.full(self._capacity, len(labels_arr), dtype=np.int64)
        seg[live_ids] = inverse.astype(np.int64)
        return labels_arr.tolist(), seg

    def _cohort_exe(self, num_cohorts: int) -> Any:
        flat_specs = self._flat_specs
        compute_fn = self._compute_fn
        proto = self._proto

        def build() -> Callable:
            def step(stacked: Dict[str, torch.Tensor], seg: torch.Tensor, live: torch.Tensor, w: torch.Tensor):
                n = num_cohorts + 1  # one more: the drop segment of dead rows
                wsum = torch.zeros(n, dtype=w.dtype, device=w.device).index_add(0, seg, w)[:num_cohorts]
                merged: Dict[str, torch.Tensor] = {}
                for name, leaf in stacked.items():
                    spec = flat_specs[name]
                    lb = _mask_broadcast(live, leaf.ndim)
                    shape = (n,) + tuple(leaf.shape[1:])
                    if spec == "sum":
                        z = torch.where(lb, leaf, torch.zeros((), dtype=leaf.dtype, device=leaf.device))
                        merged[name] = torch.zeros(shape, dtype=leaf.dtype, device=leaf.device).index_add(0, seg, z)[:num_cohorts]
                    elif spec == "mean":
                        num = torch.zeros(shape, dtype=torch.float32, device=leaf.device).index_add(
                            0, seg, leaf.to(torch.float32) * _mask_broadcast(w, leaf.ndim))[:num_cohorts]
                        den = torch.clamp(_mask_broadcast(wsum, leaf.ndim), min=1.0)
                        merged[name] = (num / den).to(leaf.dtype)
                    else:
                        ident = _min_identity(leaf.dtype) if spec == "max" else _max_identity(leaf.dtype)
                        z = torch.where(lb, leaf, torch.tensor(ident, dtype=leaf.dtype, device=leaf.device))
                        base = torch.full(shape, ident, dtype=leaf.dtype, device=leaf.device)
                        merged[name] = base.index_reduce(0, seg, z, "amax" if spec == "max" else "amin")[:num_cohorts]
                values = torch.func.vmap(lambda s: compute_fn(s, axis_name=None))(_unflatten_state(merged, proto))
                return merged, values

            return step

        return _engine.acquire_keyed(("arena-cohort", self._key, self._capacity, num_cohorts), build)

    def cohort_values(self) -> Dict[str, Any]:
        """Per-cohort values, each cohort's tenants merged in one program (``sum``
        adds, ``mean`` weights by update counts, ``max``/``min`` take extrema),
        then a vmapped compute over the merged states. Refreshes the arena's
        exposition block."""
        self._check_cohort_mergeable("cohort_values()")
        if not self._fused:
            raise ValueError(f"cohort_values() needs the fused lane; arena {self._name!r} carries "
                             "cat/list states (row lane)")
        labels, seg = self._cohort_layout()
        if not labels:
            return {}
        _, values = self._cohort_step(labels, seg)
        out = self._slice_cohort_values(labels, values)
        self._publish(cohorts=out)
        return out

    def _cohort_step(self, labels: List[str], seg: np.ndarray) -> Tuple[Dict[str, Any], Any]:
        exe = self._cohort_exe(len(labels))
        w = (self._counts * self._live).astype(np.float32)
        dev = self._device
        merged, values = exe(self._stacked, torch.from_numpy(seg).to(dev), torch.from_numpy(self._live).to(dev),
                             torch.from_numpy(w).to(dev))
        _counters["arena_cohort_programs"] += 1
        return merged, values

    def _slice_cohort_values(self, labels: List[str], values: Any) -> Dict[str, Any]:
        return {label: pytree.tree_map(lambda v: torch.as_tensor(v)[i], values) for i, label in enumerate(labels)}

    def close_window(self) -> Dict[str, Any]:
        """Close one arena-wide window: merge every cohort's tenants (one program),
        push the merged per-cohort states into the window ring, reset every live
        tenant, and publish the close's per-cohort values. Returns ``{window, cohorts, slots}``."""
        from metrics_tpu_torch import streaming as _streaming

        self._check_cohort_mergeable("close_window()")
        if not self._fused:
            raise ValueError(f"close_window() needs the fused lane; arena {self._name!r} carries "
                             "cat/list states (row lane)")
        t0 = _telemetry.now() if _telemetry.armed else 0.0
        labels, seg = self._cohort_layout()
        close_id = self._closes + 1
        slot: Dict[str, Dict[str, Any]] = {}
        values: Dict[str, Any] = {}
        if labels:
            merged, vals = self._cohort_step(labels, seg)
            counts = np.zeros(len(labels), dtype=np.int64)
            np.add.at(counts, seg[self._live], self._counts[self._live])
            host = {name: _host(leaf) for name, leaf in merged.items()}
            for i, label in enumerate(labels):
                slot[label] = {"states": {name: arr[i] for name, arr in host.items()}, "count": int(counts[i])}
            values = self._slice_cohort_values(labels, vals)
            self.reset()  # every live tenant starts the next stride clean
        self._closes = close_id
        self._ring.append((close_id, slot))
        _counters["arena_closes"] += 1
        self._publish(cohorts=values,
                      values_entry=(close_id, {c: _streaming._scalar_map(v) for c, v in values.items()}))
        if t0 and _telemetry.armed:
            _telemetry.emit("arena-close", self._name, "arena", t0, _telemetry.now() - t0,
                            {"window": close_id, "cohorts": len(labels), "slots": len(self._ring)})
        return {"window": close_id, "cohorts": values, "slots": len(self._ring)}

    def window_values(self) -> Dict[str, Any]:
        """Per-cohort window values: the retained ring slots re-merged by spec and
        computed, what one fresh suite fed the retained strides would compute."""
        folded: Dict[str, Tuple[Dict[str, np.ndarray], int]] = {}
        for _, slot in self._ring:
            for label, entry in slot.items():
                if label not in folded:
                    folded[label] = ({k: np.array(v, copy=True) for k, v in entry["states"].items()}, int(entry["count"]))
                    continue
                acc, c_acc = folded[label]
                c_inc = int(entry["count"])
                for name, inc in entry["states"].items():
                    spec = self._flat_specs[name]
                    if spec == "sum":
                        acc[name] = acc[name] + inc
                    elif spec == "mean":
                        total = max(c_acc + c_inc, 1)
                        acc[name] = (c_acc * acc[name] + c_inc * inc) / total
                    elif spec == "max":
                        acc[name] = np.maximum(acc[name], inc)
                    else:
                        acc[name] = np.minimum(acc[name], inc)
                folded[label] = (acc, c_acc + c_inc)
        out: Dict[str, Any] = {}
        for label, (flat, _count) in folded.items():
            state = _unflatten_state(
                {k: torch.as_tensor(np.asarray(v, dtype=_host(self._flat_proto[k]).dtype)).to(self._device)
                 for k, v in flat.items()},
                self._proto,
            )
            out[label] = self._compute_fn(state, axis_name=None)
        return out

    def decay_tick(self, halflife: float) -> None:
        """One EMA tick over the whole arena: every state scales by ``0.5 ** (1 / halflife)``
        in one program. Every state must reduce by ``sum`` over a floating dtype."""
        halflife = float(halflife)
        if not halflife > 0:
            raise ValueError(f"halflife must be a positive update count, got {halflife}")
        decay = self._decay_validated.get(halflife)
        if decay is None:
            if not self._fused:
                raise ValueError(f"decay_tick() needs the fused lane; arena {self._name!r} carries "
                                 "cat/list states (row lane)")
            for name, spec in self._flat_specs.items():
                if spec != "sum":
                    raise ValueError(f"decay_tick() requires sum-reduction states; "
                                     f"{name.replace(_SEP, '.')} reduces by {spec!r}")
                if not self._flat_proto[name].is_floating_point():
                    raise ValueError(
                        f"decay_tick() requires floating states; {name.replace(_SEP, '.')} is "
                        f"{self._flat_proto[name].dtype} (an integer count cannot decay exactly)"
                    )
            decay = float(0.5 ** (1.0 / halflife))
            self._decay_validated[halflife] = decay

        def build() -> Callable:
            def step(stacked: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
                return {k: v * torch.tensor(decay, dtype=v.dtype, device=v.device) for k, v in stacked.items()}

            return step

        self._stacked = _engine.acquire_keyed(("arena-decay", self._key, self._capacity, decay), build).run(self._stacked)
        _counters["arena_decay_ticks"] += 1

    def cohort_drift(self, cohort: str, reference: Optional[Any] = None, *,
                     bins: Optional[int] = None) -> Dict[str, Any]:
        """PSI/KS of one cohort's stacked raw states against another cohort
        (``reference`` as a label) or an explicit sample, counted on the arena's
        device; the scores land in the streaming registry as ``<arena>/<cohort>``."""
        from metrics_tpu_torch import streaming as _streaming

        current = self._cohort_sample(str(cohort))
        if reference is None:
            raise ValueError("cohort_drift needs a reference cohort label or sample")
        ref = self._cohort_sample(str(reference)) if isinstance(reference, str) else reference
        _counters["arena_drift_reports"] += 1
        return _streaming.drift_report(current, ref, bins=bins, name=f"{self._name}/{_safe_name(cohort)}",
                                       device=self._device)

    def _cohort_sample(self, cohort: str) -> np.ndarray:
        live_ids = np.nonzero(self._live)[0]
        ids = live_ids[self._effective_cohorts(live_ids) == cohort].tolist() if live_ids.size else []
        if not ids:
            raise ValueError(f"cohort {cohort!r} has no live tenants in arena {self._name!r}")
        rows: List[np.ndarray] = []
        if self._fused:
            sel = torch.as_tensor(ids, device=self._device)
            for leaf in self._stacked.values():
                arr = _host(leaf.index_select(0, sel)).astype(np.float64).ravel()
                if arr.size:
                    rows.append(arr)
        else:
            for tid in ids:
                for leaf in pytree.tree_leaves(self._rows[tid]):
                    arr = _host(leaf).astype(np.float64).ravel()
                    if arr.size:
                        rows.append(arr)
        return np.concatenate(rows) if rows else np.zeros((0,), dtype=np.float64)

    def _publish(self, *, cohorts: Optional[Dict[str, Any]] = None,
                 values_entry: Optional[Tuple[int, Dict[str, Dict[str, float]]]] = None) -> None:
        from metrics_tpu_torch import streaming as _streaming

        block = _ARENAS.setdefault(self._name, {"name": self._name, "values": {}})
        block.update(capacity=self._capacity, tenants=self.tenants, slab=self._slab, slabs=self.slabs,
                     window=self._closes, lane="fused" if self._fused else "rows")
        if cohorts is not None:
            block["cohorts"] = {_safe_name(c): _streaming._scalar_map(v) for c, v in cohorts.items()}
        if values_entry is not None:
            close_id, per_cohort = values_entry
            block["values"][str(close_id)] = per_cohort
            keep = _streaming.window_values_kept()
            for wid in sorted(block["values"], key=int)[:-keep]:
                del block["values"][wid]

    # ------------------------------------------------------------- durability
    def _slab_path(self, path: str, k: int) -> str:
        return f"{path}.slab{k}"

    def _scan_generations(self) -> int:
        # rings widened by an earlier METRICS_TPU_JOURNAL_GENERATIONS are read too
        return _journal.journal_generations() + 8

    def _slab_on_disk(self, path: str, k: int) -> bool:
        base = self._slab_path(path, k)
        return any(os.path.exists(_journal._gen_path(base, g)) for g in range(self._scan_generations()))

    def _prune_stale_slabs(self, path: str) -> None:
        """Unlink slab files beyond the current slab count, so that no later restore
        walks onto a stale record and revives removed tenants."""
        gens = self._scan_generations()
        k = self.slabs
        while True:
            base = self._slab_path(path, k)
            stale = [_journal._gen_path(base, g) for g in range(gens) if os.path.exists(_journal._gen_path(base, g))]
            if not stale:
                return
            for gpath in stale:
                try:
                    os.remove(gpath)
                except OSError:  # pragma: no cover - a restore ignores stale slabs anyway
                    pass
            _counters["arena_slab_prunes"] += 1
            k += 1

    def save(self, path: Optional[str] = None) -> int:
        """Persist the arena as one CRC-framed record a slab, each with its own
        generation ring, then prune slab files beyond the slab count. Returns the
        bytes written."""
        path = str(path) if path else self._journal_path
        if not path:
            raise ValueError("this arena was constructed without journal_path")
        if not self._fused:
            raise ValueError(f"arena {self._name!r} carries cat/list states; the slab byte layout "
                             "needs fixed-shape array states (journal the tenants individually)")
        t0 = _telemetry.now() if _telemetry.armed else 0.0
        total = 0
        S = self._slab
        host = {name: leaf.detach().cpu() for name, leaf in self._stacked.items()}  # one copy a state
        statics = self._static_attrs()
        for k in range(self.slabs):
            sl = slice(k * S, (k + 1) * S)
            record = _journal.pack_raw_record(
                {name: arr[sl] for name, arr in host.items()},
                manifest_extra={
                    "arena": {
                        "name": self._name,
                        "slab": k,
                        "slab_size": S,
                        "capacity": self._capacity,
                        "live": [int(b) for b in self._live[sl]],
                        "counts": [int(c) for c in self._counts[sl]],
                        "cohorts": self._cohorts[sl].tolist(),
                        "static_attrs": statics,
                    },
                    "epoch": _psync.world_epoch(),
                },
            )
            _journal.write_record(self._slab_path(path, k), record)
            total += len(record)
            _counters["arena_slab_saves"] += 1
        _counters["arena_slab_bytes_written"] += total
        self._prune_stale_slabs(path)
        self._updates_since_save = 0
        if t0 and _telemetry.armed:
            _telemetry.emit("arena-journal", self._name, "arena", t0, _telemetry.now() - t0,
                            {"op": "save", "slabs": self.slabs, "bytes": total})
        return total

    def _static_attrs(self) -> Dict[str, Dict[str, Any]]:
        if _funcore._is_collection(self._template):
            return {name: _journal._static_attrs(m) for name, m in self._template.items(keep_base=True, copy_state=False)}
        return {"": _journal._static_attrs(self._template)}

    def _apply_static_attrs(self, statics: Dict[str, Dict[str, Any]]) -> None:
        if _funcore._is_collection(self._template):
            members = dict(self._template.items(keep_base=True, copy_state=False))
            for name, attrs in (statics or {}).items():
                node = members.get(name)
                if node is not None:
                    for key, value in (attrs or {}).items():
                        setattr(node, key, value)
        else:
            for key, value in (statics or {}).get("", {}).items():
                setattr(self._template, key, value)

    def _check_slab_layout(self, arrays: Dict[str, torch.Tensor]) -> None:
        """A record whose state names, shapes or dtypes differ from the template's
        demotes like any corrupt record: matching by name alone would leave
        mismatched states at their init values."""
        if set(arrays) != set(self._flat_proto):
            missing = sorted(n.replace(_SEP, ".") for n in set(self._flat_proto) - set(arrays))
            unknown = sorted(n.replace(_SEP, ".") for n in set(arrays) - set(self._flat_proto))
            raise ValueError(f"slab record layout mismatch vs the template config "
                             f"(missing states: {missing or None}, unknown states: {unknown or None})")
        for name, proto in self._flat_proto.items():
            arr = arrays[name]
            want = (self._slab,) + tuple(proto.shape)
            if tuple(arr.shape) != want or arr.dtype != proto.dtype:
                raise ValueError(f"slab record state {name.replace(_SEP, '.')} is "
                                 f"{arr.dtype}{tuple(arr.shape)}, template wants {proto.dtype}{want}")

    def _recover_slab(self, base: str, gens: int) -> Tuple[Optional[Tuple[Dict[str, Any], Dict[str, torch.Tensor]]], int]:
        """Walk one slab's generation ring newest first: the first generation that
        verifies and the demotions on the way, or None if every one is torn."""
        demotions = 0
        for g in range(gens):
            gpath = _journal._gen_path(base, g)
            if not os.path.exists(gpath):
                continue
            try:
                with open(gpath, "rb") as fh:
                    data = fh.read()
                manifest, payload = _journal.decode_record(data, origin=repr(gpath))
                arrays = _journal.unpack_raw_record(manifest, payload)
                meta = manifest.get("arena") or {}
                if int(meta.get("slab_size", self._slab)) != self._slab:
                    raise ValueError(f"slab record carries slab_size={meta.get('slab_size')}, arena uses {self._slab}")
                self._check_slab_layout(arrays)
            except Exception as exc:  # noqa: BLE001 - demote to the previous generation of this slab
                demotions += 1
                _counters["arena_slab_demotions"] += 1
                _faults.note_fault(_faults.classify(exc, "journal"), site="journal-load", owner=self, error=exc)
                _faults.warn_fault(
                    self, "journal",
                    f"Arena slab record {gpath!r} failed verification ({type(exc).__name__}: {exc}); "
                    "demoting to the previous good generation of this slab (other slabs are unaffected).",
                )
                continue
            return (meta, arrays), demotions
        return None, demotions

    def restore(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Rebuild the stack from the slab records. Each slab walks its generation
        ring newest first; a torn, checksum-failed or mismatched generation counts
        a ``journal`` fault and an ``arena_slab_demotions`` and demotes to the
        previous good one of that slab only. The newest good slab-0 record says
        the arena's extent; a slab with no good generation resets to init (its
        tenants report dead). Returns ``{slabs, demotions, tenants}``."""
        path = str(path) if path else self._journal_path
        if not path:
            raise ValueError("this arena was constructed without journal_path")
        if not self._fused:
            raise ValueError(f"arena {self._name!r} carries cat/list states; the slab byte layout "
                             "needs fixed-shape array states (restore the tenants individually)")
        t0 = _telemetry.now() if _telemetry.armed else 0.0
        gens = self._scan_generations()
        if not self._slab_on_disk(path, 0):
            raise _journal.JournalFault(f"no arena slab records found at {path!r}", site="journal-load")
        recovered: Dict[int, Tuple[Dict[str, Any], Dict[str, torch.Tensor]]] = {}
        rec0, demotions = self._recover_slab(self._slab_path(path, 0), gens)
        if rec0 is not None:
            recovered[0] = rec0
            slab_count = max(1, int(rec0[0].get("capacity", self._slab)) // self._slab)
        else:
            # slab 0 is torn in every generation: walk the slab files up to the first missing one
            slab_count = 1
            while self._slab_on_disk(path, slab_count):
                slab_count += 1
        for k in range(1, slab_count):
            if not self._slab_on_disk(path, k):
                continue  # a missing slab resets to init
            rec, dem = self._recover_slab(self._slab_path(path, k), gens)
            demotions += dem
            if rec is not None:
                recovered[k] = rec
        cap = slab_count * self._slab
        S = self._slab
        host = {name: p.detach().cpu().expand((cap,) + tuple(p.shape)).clone() for name, p in self._flat_proto.items()}
        live = np.zeros(cap, dtype=bool)
        counts = np.zeros(cap, dtype=np.int64)
        cohorts = np.full(cap, None, dtype=object)
        for k, (meta, arrays) in recovered.items():
            sl = slice(k * S, (k + 1) * S)
            for name in host:
                host[name][sl] = arrays[name]
            live[sl] = np.asarray(meta.get("live", [0] * S), dtype=bool)[:S]
            counts[sl] = np.asarray(meta.get("counts", [0] * S), dtype=np.int64)[:S]
            labels = (list(meta.get("cohorts") or []) + [None] * S)[:S]
            cohorts[sl] = np.asarray(labels, dtype=object)
            self._apply_static_attrs(meta.get("static_attrs") or {})
            _counters["arena_slab_restores"] += 1
        self._capacity = cap
        self._stacked = {name: arr.to(self._device) for name, arr in host.items()}  # one copy a state
        self._live = live
        self._counts = counts
        self._cohorts = cohorts
        self._watermark = cap
        self._free = sorted(np.nonzero(~live)[0].tolist(), reverse=True)
        if t0 and _telemetry.armed:
            _telemetry.emit("arena-journal", self._name, "arena", t0, _telemetry.now() - t0,
                            {"op": "restore", "slabs": slab_count, "demotions": demotions})
        return {"slabs": slab_count, "demotions": demotions, "tenants": self.tenants}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"MetricArena({self._name!r}, tenants={self.tenants}, capacity={self._capacity}, "
                f"slab={self._slab}, lane={'fused' if self._fused else 'rows'})")
