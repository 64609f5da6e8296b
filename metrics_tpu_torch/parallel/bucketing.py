"""Coalesced sync: a whole metric tree, or a whole suite, in one payload collective.

JAX counterpart: `metrics_tpu/parallel/bucketing.py` (``tree_nodes`` `:132`,
``coalescible`` `:152`, ``_collect`` `:237`, ``_to_bytes``/``_from_bytes``
`:276-295`, the quantized wire ``_entry_nbytes``/``_decode_static``/
``_quant_encode`` `:297-395`, the seams `:402-500`, ``agree_step`` `:420`,
``_pack`` `:503`, ``_ProtocolCtx``/``_guarded``/``_pack_phase``/
``_node_reduce``/``_payload_exchange``/``_make_attempt``/``_finish``
`:581-958`, ``coalesced_sync_nodes`` `:959`, the asynchronous
``dispatch_coalesced_sync``/``force_coalesced_sync`` `:1007-1123`,
``apply_gathered_states`` `:1148`).

The per-state protocol (:func:`metrics_tpu_torch.parallel.sync.gather_all_tensors`
for each state) costs two collectives a state. This one:

- **Packs** every state as its raw bytes (``t.reshape(-1).view(torch.uint8)``,
  exact for every dtype) into one flat ``uint8`` buffer on the states'
  device. Each entry starts at a multiple of ``ALIGN`` bytes, so its slice
  of the gathered buffer can be viewed back as any dtype. The layout is
  built on the host from shapes and dtypes alone. ``torch.cat`` makes the
  buffer a copy, so the states may change while it is in flight.
- **Exchanges** the buffer in one ``all_gather``. Tensor states have the same
  shape on every process, so their byte ranges follow from the layout: no
  shape exchange (the static lane). In a live process group the first sync
  of a layout checks once that every process packed the same static bytes;
  the layout is then cached. ``cat`` list states add one metadata
  all-gather, which carries each one's dtype and dims and each process's
  packed total; the payload is padded to the largest total. A ``cat`` state
  that is empty on some processes and not on others is carried too: its
  metadata says so.
- **Unpacks** each state's slice of the ``(world, bytes)`` buffer, views it
  back to its dtype and applies the same reduction callable as the
  per-state path, to the same contiguous stack, so the two agree bit for
  bit. Every state is set only after the whole unpack has succeeded.

The collective phase is one retried closure (:func:`_make_attempt`): it
checks the epoch fence, fires the ``sync-gather`` fault site and runs each
exchange under the deadline; a disagreement of layouts leaves it as a value,
so that it is never retried, and raises :class:`SyncConfigFault`.

Three lanes ride the packed protocol:

- **Asynchronous** (:func:`dispatch_coalesced_sync`, :func:`force_coalesced_sync`):
  the pack runs on the caller, the retried collective on the dispatcher
  thread, on the caller's CUDA stream, and the unpack at the force, which
  checks the epoch fence again first.
- **Quantized** (``METRICS_TPU_SYNC_QUANT=bf16|int8``): float tensor states
  travel as bfloat16, or as int8 with one float32 scale after the values
  (``max(|x|, 1e-30) / 127``, round half to even), byte for byte the JAX
  package's wire form; integer, bool and ``cat`` states, and any state
  whose wire form would not shrink, travel exact.
- **Hierarchical** (``METRICS_TPU_SYNC_HIER=<processes a node>``): the
  payload goes through ``_intranode_allgather`` and then only node blocks
  through ``_internode_allgather``; a layout of integer ``sum`` states is
  summed within the node first (:func:`_node_reduce`), so the inter-node
  stage carries one row a node. The seams default to a world of one; in a
  live world of several processes the lane warns once and takes the flat
  gather unless both are bound.

A tree that cannot be packed (a node overriding ``_sync_dist``, a list state
whose spec is not ``cat``, a dtype outside :data:`_DTYPES`, states on more
than one device) takes the per-state protocol; :func:`coalescible` decides.

Failures (JAX ``CoalesceError`` `:95`, ``should_fallback`` `:114`,
``handle_coalesce_failure`` `:1126`): a failure in the pack or the unpack
raises :class:`CoalesceError`, and the callers (``Metric.sync``,
``MetricCollection.sync``) demote their ``sync-pack`` ladder lane, warn once
and replay the per-state protocol, bit for bit; clean syncs re-promote the
lane after ``faults.recovery_steps()``. The ``sync-pack`` fault site fires
at the pack's entry, before any collective. In a live world of more than
one process only a failure every process meets alike may fall back
(:func:`should_fallback`); another raises classified, since one process's
per-state collectives could not pair with the others' payload collective.
Each phase emits its span (``sync-pack``, ``sync-quantize``,
``sync-metadata``, ``sync-payload-gather``, ``sync-unpack``,
``sync-dispatch``, ``sync-force``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.ops import engine as _engine
from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.utils.data import _flatten, dim_zero_cat
from metrics_tpu_torch.utils.exceptions import EpochFault, SyncConfigFault, SyncFault

ALIGN = 16  # byte alignment of every packed entry: a multiple of every dtype's size
_MAX_NDIM = 8  # dims a `cat` row may have: its metadata record has room for this many
_DTYPES = (
    torch.bool,
    torch.uint8,
    torch.int8,
    torch.int16,
    torch.int32,
    torch.int64,
    torch.float16,
    torch.bfloat16,
    torch.float32,
    torch.float64,
    torch.complex64,
    torch.complex128,
)
_DTYPE_CODE = {dt: code for code, dt in enumerate(_DTYPES)}
_DYN_RECORD = 2 + _MAX_NDIM  # [ndim (-1: empty here), dtype code, dims padded with 0]

# static layouts checked across a live process group: (group, layout key) -> True. Every
# member of a group syncs a layout at the same call, so every member caches it at the same
# call; a process that joins a group later than its peers finds a cache they do not share.
_MANIFEST_CACHE: Dict[tuple, bool] = {}
_MANIFEST_CACHE_CAP = 512
#: Carried out of the retried closure when the processes' layouts disagree: never retried.
_LAYOUT_MISMATCH = object()


class CoalesceError(Exception):
    """A failure inside the pack or the unpack of the coalesced protocol, never
    in a collective. ``original`` is the exception to classify;
    ``rank_symmetric`` marks a failure every process meets alike, the only
    kind that may fall back in a live world (:func:`should_fallback`)."""

    def __init__(self, original: BaseException, rank_symmetric: bool = False):
        super().__init__(f"{type(original).__name__}: {original}")
        self.original = original
        self.rank_symmetric = rank_symmetric


def should_fallback(err: CoalesceError) -> bool:
    """Whether a caller may demote and replay the per-state protocol for ``err``:
    always in a world of one process; in a live world of more, only for a
    failure every process meets alike."""
    return err.rank_symmetric or not _sync.distributed_available()


def handle_coalesce_failure(owner: Any, snaps: Sequence[Tuple[Any, Any]], err: CoalesceError, warn: str) -> None:
    """Restore every node's snapshot, count the fallback, classify the failure
    and demote ``owner``'s ``sync-pack`` lane, warning once per owner and domain."""
    for node, snap in snaps:
        node._restore_state(snap)
    _sync._bump("sync_pack_fallbacks")
    _faults.demote(owner, "sync-pack", err.original, default_domain="runtime", tier="eager", site="sync-pack", warn=warn)


def coalesce_enabled() -> bool:
    """The ``METRICS_TPU_SYNC_COALESCE`` gate (default on; ``0`` or ``false`` restores the
    per-state protocol). Read at each call: a sync is not on the per-step path."""
    return os.environ.get("METRICS_TPU_SYNC_COALESCE", "1").lower() not in ("0", "false")


# ------------------------------------------------------------------ tree walk
def tree_nodes(metric: Any) -> List[Any]:
    """The metric and every ``_sync_children`` descendant, pre-order: the
    order the per-state sync visits, so every process builds the same layout."""
    nodes = [metric]
    for child in metric._sync_children():
        nodes.extend(tree_nodes(child))
    return nodes


def coalescible(nodes: Sequence[Any]) -> bool:
    """Whether every state of every node can ride the packed protocol."""
    from metrics_tpu_torch.metric import Metric  # metric.py imports this module

    device = None
    for node in nodes:
        if type(node)._sync_dist is not Metric._sync_dist and node._defaults:
            return False  # the node's own gather semantics
        for name, spec in node._reduction_specs.items():
            value = getattr(node, name)
            if isinstance(value, list) and spec != "cat":
                return False  # the per-element gather walk
            for row in value if isinstance(value, list) else [value]:
                if not isinstance(row, Tensor) or row.dtype not in _DTYPE_CODE or row.ndim > _MAX_NDIM:
                    return False
                if device is None:
                    device = row.device
                elif row.device != device:
                    return False
    return True


# ------------------------------------------------------------------- layout
class _Entry:
    """One packed state: ``kind`` "static" (a tensor state: same shape on every
    process) or "dyn" (a ``cat`` list state, pre-concatenated; ``shape`` None
    when this process holds no row). ``quant`` is a static float state's
    wire encoding under the quantized lane (None: its exact bytes), and
    ``wire_nbytes`` its bytes on the wire."""

    __slots__ = ("node_idx", "name", "kind", "spec", "dtype", "shape", "quant", "wire_nbytes")

    def __init__(self, node_idx: int, name: str, kind: str, spec: Optional[str], dtype=None, shape=None):
        self.node_idx = node_idx
        self.name = name
        self.kind = kind
        self.spec = spec
        self.dtype = dtype
        self.shape = shape
        self.quant: Optional[str] = None
        self.wire_nbytes: Optional[int] = None

    def sig(self) -> tuple:
        if self.kind == "static":
            return (self.node_idx, self.name, self.kind, self.spec, str(self.dtype), self.shape, self.quant)
        return (self.node_idx, self.name, self.kind, self.spec)


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _entry_nbytes(e: _Entry) -> int:
    """A static entry's bytes on the wire: its quantized length, or its raw length."""
    return int(e.wire_nbytes) if e.quant is not None else _nbytes(e.shape, e.dtype)


def _collect(nodes: Sequence[Any]) -> Tuple[List[_Entry], List[Optional[Tensor]]]:
    """The layout entries and the values to pack, tensor states first (their
    byte ranges never move), then ``cat`` states, each as one row:
    concatenated when it holds several, at least 1-d, None when empty."""
    statics: List[_Entry] = []
    dyns: List[_Entry] = []
    static_vals: List[Optional[Tensor]] = []
    dyn_vals: List[Optional[Tensor]] = []
    for idx, node in enumerate(nodes):
        for name, spec in node._reduction_specs.items():
            value = getattr(node, name)
            if isinstance(value, list):
                row = None
                if value:
                    row = dim_zero_cat(value) if len(value) > 1 else torch.atleast_1d(value[0])
                dyns.append(_Entry(idx, name, "dyn", spec, None if row is None else row.dtype,
                                   None if row is None else tuple(row.shape)))
                dyn_vals.append(row)
            else:
                statics.append(_Entry(idx, name, "static", spec, value.dtype, tuple(value.shape)))
                static_vals.append(value)
    return statics + dyns, static_vals + dyn_vals


def _layout_key(entries: Sequence[_Entry]) -> tuple:
    return tuple(e.sig() for e in entries)


def _to_bytes(x: Tensor) -> Tensor:
    """One tensor's raw bytes, flat (a view where it is contiguous)."""
    return x.reshape(-1).view(torch.uint8)


def _from_bytes(seg: Tensor, shape: tuple, dtype: torch.dtype) -> Tensor:
    """Reverse of :func:`_to_bytes`; ``seg`` is ``(n,)``, or ``(rows, n)`` for
    ``shape`` with a leading rows dim. Its offset must be a multiple of the
    dtype's size, which the layout's alignment gives."""
    return seg.view(dtype).reshape(shape)


# ---------------------------------------------------------- quantized wire
def _quant_bytes(x: Tensor, tier: str) -> Tensor:
    """One float state's wire bytes: bfloat16 values, or int8 values then their
    float32 scale, ``max(|x|, 1e-30) / 127`` (JAX `bucketing.py:368-380`)."""
    if tier == "bf16":
        return _to_bytes(x.to(torch.bfloat16))
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return torch.cat([_to_bytes(q), _to_bytes(scale.reshape(1))])


def _decode_static(seg: Tensor, e: _Entry, world: int) -> Tensor:
    """``(world, *shape)``: a static entry's rows of the gathered buffer,
    decoded to its dtype (exact bytes; bfloat16 widened; int8 times its scale)."""
    shape = (world,) + e.shape
    if e.quant is None:
        # contiguous, as the per-state path's torch.stack is: the same reduction on the same layout
        return _from_bytes(seg, shape, e.dtype).contiguous()
    n = 1
    for d in e.shape:
        n *= int(d)
    if e.quant == "bf16":
        return _from_bytes(seg[:, : 2 * n], shape, torch.bfloat16).to(e.dtype)
    q = _from_bytes(seg[:, :n], shape, torch.int8)
    # the scale follows the values at any offset: copied out before it is viewed as float32
    scale = seg[:, n : n + 4].contiguous().view(torch.float32).reshape((world,) + (1,) * len(e.shape))
    return (q.to(torch.float32) * scale).to(e.dtype)


def _quant_encode(entries: Sequence[_Entry], values: List[Optional[Tensor]], tier: str, owner: Any) -> None:
    """Encode, in place, the values of the static float states whose wire form
    shrinks under ``tier``, marking their entries; every other state stays exact."""
    lossy: List[int] = []
    exact = orig_bytes = wire_bytes = 0
    for i, (e, v) in enumerate(zip(entries, values)):
        if v is None:
            continue
        if e.kind != "static" or not e.dtype.is_floating_point:
            exact += 1
            continue
        full = _nbytes(e.shape, e.dtype)
        n = full // e.dtype.itemsize
        wire = 2 * n if tier == "bf16" else n + 4
        if wire >= full:
            exact += 1
            continue
        e.quant, e.wire_nbytes = tier, wire
        lossy.append(i)
        orig_bytes += full
        wire_bytes += wire
    _sync._bump("sync_quant_exact_states", exact)
    if not lossy:
        return
    with _telemetry.timed("sync-quantize", owner, "sync") as span:
        for i in lossy:
            values[i] = _quant_bytes(values[i], tier)
        _sync._bump("sync_quant_payloads")
        _sync._bump("sync_quant_lossy_states", len(lossy))
        _sync._bump("sync_quant_bytes_saved", orig_bytes - wire_bytes)
        span.attrs = {"tier": tier, "states": len(lossy), "bytes_before": orig_bytes, "bytes_after": wire_bytes}


def _pack(entries: Sequence[_Entry], values: Sequence[Optional[Tensor]], device: torch.device):
    """Every value into one aligned ``uint8`` buffer.

    Returns the buffer, its metadata vector as a host list (a record per
    ``cat`` entry, then the static bytes and the packed total) and the
    static bytes. Only the buffer is built on the device.
    """
    parts: List[Tensor] = []
    off = 0
    static_total = 0
    pad = None
    for e, v in zip(entries, values):
        if e.kind == "static":
            static_total = _align(off + _entry_nbytes(e))
        if v is None:
            continue
        b = _to_bytes(v)
        parts.append(b)
        off += b.numel()
        gap = _align(off) - off
        if gap:
            if pad is None:
                pad = torch.zeros(ALIGN, dtype=torch.uint8, device=device)
            parts.append(pad[:gap])
            off += gap
    packed = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8, device=device)
    meta: List[int] = []
    for e in entries:
        if e.kind != "dyn":
            continue
        if e.shape is None:
            meta += [-1, -1] + [0] * _MAX_NDIM
        else:
            meta += [len(e.shape), _DTYPE_CODE[e.dtype]] + list(e.shape) + [0] * (_MAX_NDIM - len(e.shape))
    meta += [static_total, off]
    return packed, meta, static_total


# ---------------------------------------------------------------- transport
# Module-level hooks, so that tests can stand in an N-process world for the
# collectives; row 0 of what they return is then the caller's own.
def _host_allgather(vec: Tensor, group: Optional[Any]) -> Tensor:
    """Metadata exchange: one small int64 vector from every process, ``(world, k)``."""
    return _sync._all_gather(vec, group) if _sync._live() else vec[None]


def _payload_allgather(packed: Tensor, group: Optional[Any]) -> Tensor:
    """Payload collective: the flat byte buffer from every process, ``(world, bytes)``."""
    return _sync._all_gather(packed, group) if _sync._live() else packed[None]


def _intranode_allgather(packed: Tensor) -> Tensor:
    """The hierarchical lane's first stage: the buffer from every process of
    this node, ``(node_size, bytes)``, row 0 the caller's. The default is a
    node of one; a deployment binds it to its node's group."""
    return packed[None]


def _internode_allgather(block: Tensor) -> Tensor:
    """The second stage: one block a node, ``(n_nodes, block_bytes)``. A
    deployment binds it to a gather among node leaders whose result every
    process of a node receives; the default is the flat payload collective,
    right only in a world of one."""
    return _payload_allgather(block, None)


_default_intranode_allgather = _intranode_allgather
_default_internode_allgather = _internode_allgather


class _HierWarnOwner:
    """Warn-once anchor for the hierarchical lane's refusal of unbound seams."""


_HIER_FALLBACK_WARN_OWNER = _HierWarnOwner()


def agree_step(owner: Any, local_step: int, *, site: str, device: torch.device) -> Dict[str, int]:
    """Agree one monotonic step across the world: every process calls it, and
    the largest ``local_step`` is the agreed one. The exchange is
    epoch-fenced (inside the retried closure and again after it), runs under
    the deadline and the retry budget. Returns ``{"agreed", "world", "epoch"}``."""
    fence = _sync.world_epoch()
    vec_local = torch.tensor([int(local_step)], dtype=torch.int64, device=device)

    def _exchange():
        _sync.check_epoch(fence, site=site, owner=owner)
        return _sync.run_with_deadline(lambda: _host_allgather(vec_local, None), site=site)

    vec = _faults.retry_with_backoff(
        _exchange, attempts=_sync.sync_retries(), base_delay_s=_sync.sync_backoff_s(), owner=owner, site=site
    )
    _sync.note_collective("shape", epoch=fence)
    agreed = int(vec.max())
    world = int(vec.shape[0])
    # the cohort answered; while peers are declared dead that is not the full world healing
    _sync.note_sync_success(world=world, members=_sync.surviving_members())
    _sync.check_epoch(fence, site=site, owner=owner)
    return {"agreed": agreed, "world": world, "epoch": fence}


def _dyn_layouts(entries: Sequence[_Entry], row: List[int]) -> List[Optional[tuple]]:
    """One process's ``cat`` rows from its metadata record: ``(offset, nbytes, shape, dtype)`` or None."""
    out: List[Optional[tuple]] = []
    off = row[-2]
    pos = 0
    for e in entries:
        if e.kind != "dyn":
            continue
        ndim, code = row[pos], row[pos + 1]
        if ndim < 0:
            out.append(None)
        else:
            shape, dtype = tuple(row[pos + 2 : pos + 2 + ndim]), _DTYPES[code]
            n = _nbytes(shape, dtype)
            out.append((off, n, shape, dtype))
            off = _align(off + n)
        pos += _DYN_RECORD
    return out


# ------------------------------------------------------------------ protocol
class _ProtocolCtx:
    """What one protocol instance carries from its pack to its collectives to
    its unpack: the seam the asynchronous split rides."""

    __slots__ = ("nodes", "owner", "members", "transport", "fence", "entries", "packed", "meta", "meta_vec",
                 "static_total", "key", "has_dyn", "async_mode", "quant_tier", "node_reducible")


def _guarded(ctx: _ProtocolCtx, fn, site: str = "sync-gather"):
    """One exchange under the guard of its mode: the per-call watchdog when
    blocking, none on the dispatcher thread (the force is guarded)."""
    if ctx.async_mode:
        return _sync.run_inflight(fn, site=site)
    return _sync.run_with_deadline(fn, site=site)


def _group_key(ctx: _ProtocolCtx) -> Any:
    return tuple(ctx.members) if isinstance(ctx.transport, list) else ctx.transport


def _pack_phase(nodes: Sequence[Any], group: Optional[Any], owner: Any = None,
                async_mode: bool = False) -> Optional[_ProtocolCtx]:
    """Validate the group, stamp the epoch fence and pack (fault site
    ``sync-pack``). None when the tree holds no state. Raises
    :class:`SyncConfigFault` for an invalid group, :class:`CoalesceError`
    when the pack fails."""
    owner = owner if owner is not None else nodes[0]
    members = _sync.validate_group_live(group)
    fence = _sync.world_epoch()
    with _telemetry.timed("sync-pack", owner, "sync") as span:
        try:
            if _faults.armed:
                _faults.maybe_fail("sync-pack")
            entries, values = _collect(nodes)
            if not entries:
                return None
            device = next((v.device for v in values if v is not None), nodes[0].device)
            quant_tier = _sync.sync_quant_tier()
            if quant_tier is not None:
                _quant_encode(entries, values, quant_tier, owner)
            packed, meta, static_total = _pack(entries, values, device)
        except SyncFault:
            raise
        except Exception as exc:  # noqa: BLE001 - classified by the caller's ladder
            raise CoalesceError(exc) from exc
        span.attrs = {"states": len(entries), "bytes": int(packed.numel())}
    ctx = _ProtocolCtx()
    ctx.nodes, ctx.owner, ctx.members, ctx.fence = list(nodes), owner, members, fence
    ctx.transport = _sync.transport_group(group, members)
    ctx.entries, ctx.packed, ctx.meta, ctx.static_total = entries, packed, meta, static_total
    ctx.meta_vec = torch.tensor(meta, dtype=torch.int64, device=device)
    ctx.key = (_group_key(ctx), _layout_key(entries))
    ctx.has_dyn = any(e.kind == "dyn" for e in entries)
    ctx.async_mode, ctx.quant_tier = async_mode, quant_tier
    # the psum lane: integer `sum` states add up exactly in any order
    ctx.node_reducible = not ctx.has_dyn and all(
        e.spec == "sum" and e.quant is None and not e.dtype.is_floating_point and not e.dtype.is_complex
        and e.dtype != torch.bool
        for e in entries
    )
    return ctx


def _node_reduce(ctx: _ProtocolCtx, intra: Tensor) -> Tensor:
    """Sum one node's packed rows of integer ``sum`` states into one row of the same layout."""
    parts: List[Tensor] = []
    off = 0
    k = int(intra.shape[0])
    for e in ctx.entries:
        n = _nbytes(e.shape, e.dtype)
        rows = _from_bytes(intra[:, off : off + n], (k,) + e.shape, e.dtype)
        parts.append(_to_bytes(rows.sum(0).to(e.dtype)))
        gap = _align(off + n) - (off + n)
        if gap:
            parts.append(intra.new_zeros(gap))
        off = _align(off + n)
    return torch.cat(parts)


def _payload_exchange(ctx: _ProtocolCtx, padded: Tensor) -> Tuple[Tensor, bool]:
    """The payload collective: flat, or hierarchical over the whole world
    (``METRICS_TPU_SYNC_HIER``). Returns the gathered rows and whether they are
    node partials (the psum lane)."""
    node_size = _sync.sync_hier_node_size()
    if node_size > 1 and ctx.members is None:
        seams_unbound = (
            _intranode_allgather is _default_intranode_allgather
            or _internode_allgather is _default_internode_allgather
        )
        if seams_unbound and _sync.distributed_available():
            _faults.warn_fault(
                _HIER_FALLBACK_WARN_OWNER,
                "sync",
                f"METRICS_TPU_SYNC_HIER={node_size} is set but the hierarchical transport seams are not (both) "
                "bound (bucketing._intranode_allgather / _internode_allgather); the payload collective rides the "
                "flat gather instead of double-counting node blocks.",
            )
        else:
            intra = _guarded(ctx, lambda: _intranode_allgather(padded))
            _sync._bump("sync_hier_intranode_collectives")
            if ctx.node_reducible:
                block = _node_reduce(ctx, intra)
                _sync._bump("sync_hier_node_reduces")
            else:
                block = intra.reshape(-1)
            inter = _guarded(ctx, lambda: _internode_allgather(block))
            _sync._bump("sync_hier_internode_collectives")
            _sync.note_collective("payload", nbytes=inter.numel(), epoch=ctx.fence)
            if ctx.node_reducible:
                return inter, True
            return inter.reshape(-1, padded.numel()), False
    gathered = _guarded(ctx, lambda: _payload_allgather(padded, ctx.transport))
    _sync.note_collective("payload", nbytes=gathered.numel(), epoch=ctx.fence)
    return gathered, False


def _make_attempt(ctx: _ProtocolCtx):
    """The retried collective closure of one protocol instance. A layout
    disagreement comes out as ``(_LAYOUT_MISMATCH, static totals, False)``."""

    def _attempt():
        _sync.check_epoch(ctx.fence, site="sync-gather", owner=ctx.owner)
        if _faults.armed:
            _faults.maybe_fail("sync-gather")
        local_total = ctx.meta[-1]
        rank_dyn = None
        rows = None
        # a span only where metadata crossed the wire: ``attrs`` stays None on the fast lane's hit
        with _telemetry.timed("sync-metadata", ctx.owner, "sync") as span:
            if ctx.has_dyn:
                rows = _guarded(ctx, lambda: _host_allgather(ctx.meta_vec, ctx.transport)).tolist()
                _sync.note_collective("shape", epoch=ctx.fence)
                _sync._bump("sync_fastlane_misses")
                span.attrs = {"dims": len(ctx.meta)}
            elif ctx.key in _MANIFEST_CACHE:
                _sync._bump("sync_fastlane_hits")
            else:
                _sync._bump("sync_fastlane_misses")
                if _sync._live():  # once per layout: every process packed the same static bytes
                    rows = _guarded(ctx, lambda: _host_allgather(ctx.meta_vec, ctx.transport)).tolist()
                    _sync.note_collective("shape", epoch=ctx.fence)
                    span.attrs = {"cross_check": True}
            if ctx.async_mode and span.attrs is not None:
                span.attrs["overlapped"] = True
        max_total = local_total
        if rows is not None:
            statics = sorted({row[-2] for row in rows})
            if len(statics) != 1:
                return _LAYOUT_MISMATCH, statics, False
            if ctx.has_dyn:
                rank_dyn = [_dyn_layouts(ctx.entries, row) for row in rows]
                max_total = max(row[-1] for row in rows)
        padded = ctx.packed
        if max_total > local_total:
            padded = torch.cat([padded, padded.new_zeros(max_total - local_total)])
        with _telemetry.timed("sync-payload-gather", ctx.owner, "sync") as span:
            gathered, node_reduced = _payload_exchange(ctx, padded)
            span.attrs = {"bytes": int(gathered.numel()), "world": int(gathered.shape[0]), "epoch": ctx.fence,
                          "seq": _sync._counters["sync_payload_collectives"]}
            if ctx.async_mode:
                span.attrs["overlapped"] = True
        return gathered, rank_dyn, node_reduced

    return _attempt


def _raise_mismatch(statics: List[int]) -> None:
    raise SyncConfigFault(
        f"the packed layouts of the metric states differ across processes (static bytes {statics});"
        " every process must sync the same metrics, built the same way",
        site="sync-pack",
    )


def _finish(ctx: _ProtocolCtx, gathered: Tensor, rank_dyn: Optional[list], node_reduced: bool) -> None:
    """Unpack, reduce and apply; every ``setattr`` after the whole unpack. A
    failure before the ``setattr`` raises :class:`CoalesceError` (a ``cat``
    dtype that differs across processes raises :class:`SyncConfigFault`).
    Node partials (``node_reduced``) sum to the flat sum exactly."""
    with _telemetry.timed("sync-unpack", ctx.owner, "sync") as span:
        try:
            results = _unpack(ctx.nodes, ctx.entries, gathered, ctx.static_total, rank_dyn)
        except SyncFault:
            raise
        except Exception as exc:  # noqa: BLE001 - classified by the caller's ladder
            raise CoalesceError(exc) from exc
        for node, name, value in results:
            setattr(node, name, value)
        span.attrs = {"states": len(ctx.entries)}
    if not ctx.has_dyn:
        _MANIFEST_CACHE[ctx.key] = True
        while len(_MANIFEST_CACHE) > _MANIFEST_CACHE_CAP:
            _MANIFEST_CACHE.pop(next(iter(_MANIFEST_CACHE)))
    _sync._bump("sync_states_coalesced", len(ctx.entries))
    _sync._bump("sync_coalesced_payloads")


def _unpack(
    nodes: Sequence[Any],
    entries: Sequence[_Entry],
    gathered: Tensor,
    static_total: int,
    rank_dyn: Optional[List[List[Optional[tuple]]]],
) -> List[Tuple[Any, str, Any]]:
    world = int(gathered.shape[0])
    results: List[Tuple[Any, str, Any]] = []
    off = 0
    for e in entries:
        if e.kind != "static":
            continue
        n = _entry_nbytes(e)
        stacked = _decode_static(gathered[:, off : off + n], e, world)
        fn = nodes[e.node_idx]._reductions[e.name]
        results.append((nodes[e.node_idx], e.name, fn(stacked) if fn is not None else stacked))
        off = _align(off + n)
    for i, e in enumerate(e for e in entries if e.kind == "dyn"):
        parts = []
        dtypes = set()
        for r in range(world):
            layout = rank_dyn[r][i]
            if layout is None:
                continue
            o, n, shape, dtype = layout
            dtypes.add(dtype)
            if len(dtypes) > 1:
                raise SyncConfigFault(
                    f"`cat` state {e.name!r} has dtypes {sorted(map(str, dtypes))} on different processes",
                    site="sync-pack",
                )
            parts.append(_from_bytes(gathered[r, o : o + n], shape, dtype))
        fn = nodes[e.node_idx]._reductions[e.name]
        results.append((nodes[e.node_idx], e.name, (fn(parts) if fn is not None else parts) if parts else []))
    return results


def coalesced_sync_nodes(nodes: Sequence[Any], group: Optional[Any] = None, owner: Any = None) -> None:
    """Sync every state of ``nodes`` with one payload collective (plus one
    metadata collective where a ``cat`` list state is packed).

    Every process of ``group`` must call it with the same metrics. States are
    set only after the whole unpack succeeds, so a failure leaves every
    node's local state as it was. Raises :class:`CoalesceError` when the pack
    or the unpack fails, :class:`SyncFault` when a collective fails past its
    retries and :class:`SyncConfigFault` when the group is invalid or the
    processes' layouts differ. ``owner`` names the spans (the first node by
    default). In-flight asynchronous syncs are forced by the callers, at
    their protocol's entry, before anything is packed.
    """
    ctx = _pack_phase(nodes, group, owner)
    if ctx is None:
        return
    gathered, rank_dyn, node_reduced = _faults.retry_with_backoff(
        _make_attempt(ctx), attempts=_sync.sync_retries(), base_delay_s=_sync.sync_backoff_s(), site="sync-gather"
    )
    if gathered is _LAYOUT_MISMATCH:
        _raise_mismatch(rank_dyn)
    # node partials count nodes, not processes: they teach nothing of the world's size
    _sync.note_sync_success(world=None if node_reduced else int(gathered.shape[0]), members=ctx.members)
    _finish(ctx, gathered, rank_dyn, node_reduced)


# ----------------------------------------------------- async dispatch / force
class _Dispatched:
    """One coalesced protocol in flight: its context and the dispatcher's result slot."""

    __slots__ = ("ctx", "box", "done", "t_dispatch")

    def __init__(self, ctx: _ProtocolCtx, box: dict, done: Any, t_dispatch: float):
        self.ctx = ctx
        self.box = box
        self.done = done
        self.t_dispatch = t_dispatch


def dispatch_coalesced_sync(nodes: Sequence[Any], group: Optional[Any] = None,
                            owner: Any = None) -> Optional[_Dispatched]:
    """Pack now (a copy: the caller may go on updating), gather in flight on
    the dispatcher thread. None when the tree holds no state. Raises like the
    pack phase of :func:`coalesced_sync_nodes`."""
    t_dispatch = _telemetry.now()
    with _telemetry.timed("sync-dispatch", owner, "sync") as span:
        _engine.flush_barrier(nodes)  # on the caller's thread: pending calls land before the pack reads the states
        ctx = _pack_phase(nodes, group, owner=owner, async_mode=True)
        if ctx is None:
            return None
        attempt = _make_attempt(ctx)
        attempts, backoff = _sync.sync_retries(), _sync.sync_backoff_s()
        box, done = _sync.submit_async(
            lambda: _faults.retry_with_backoff(attempt, attempts=attempts, base_delay_s=backoff, site="sync-gather")
        )
        span.owner = ctx.owner
        span.attrs = {"states": len(ctx.entries), "bytes": int(ctx.packed.numel()), "epoch": ctx.fence,
                      "quant": ctx.quant_tier or "off"}
    return _Dispatched(ctx, box, done, t_dispatch)


def force_coalesced_sync(disp: _Dispatched) -> List[Tuple[Any, Any]]:
    """Complete one protocol in flight: wait (under the deadline), check the
    epoch fence again (a membership change in flight raises
    :class:`EpochFault`, the rows discarded), then unpack and apply. Returns
    each node's state from just before the apply (its ``unsync`` cache, which
    holds the updates made in flight). Every failure leaves the states intact."""
    ctx = disp.ctx
    with _telemetry.timed("sync-force", ctx.owner, "sync") as span:
        t_wait = _telemetry.now()
        _sync.wait_with_deadline(disp.done, site="sync-force", owner=ctx.owner)
        waited = _telemetry.now() - t_wait
        if "error" in disp.box:
            err = disp.box["error"]
            if isinstance(err, EpochFault):
                _sync._bump("sync_async_stale_futures")
            raise err
        gathered, rank_dyn, node_reduced = disp.box["value"]
        if gathered is _LAYOUT_MISMATCH:
            _raise_mismatch(rank_dyn)
        try:
            _sync.check_epoch(ctx.fence, site="sync-force", owner=ctx.owner)
        except EpochFault:
            _sync._bump("sync_async_stale_futures")
            raise
        # calls enqueued while the wire ran land before the apply writes over the states
        _engine.flush_barrier(ctx.nodes)
        snaps = [(n, n._state_snapshot()) for n in ctx.nodes]
        _sync.note_sync_success(world=None if node_reduced else int(gathered.shape[0]), members=ctx.members)
        _finish(ctx, gathered, rank_dyn, node_reduced)
        span.attrs = {"waited_s": waited, "epoch": ctx.fence, "states": len(ctx.entries),
                      "inflight_s": max(0.0, t_wait - disp.t_dispatch)}
    return snaps


# --------------------------------------------------- per-state gather apply
def apply_gathered_states(metric: Any, output_dict: Dict[str, Any]) -> None:
    """The per-state protocol's tail: reduce every state's gathered entries and set them all.

    A tensor state's entries are stacked and reduced; a list state's entries
    (one list per process) are flattened and reduced; a never-updated list
    state stays empty.
    """
    results: Dict[str, Any] = {}
    for name, reduction_fn in metric._reductions.items():
        gathered = output_dict[name]
        if isinstance(gathered, list) and len(gathered) == 0:
            results[name] = []
            continue
        if isinstance(gathered[0], Tensor):
            stacked = torch.stack(gathered)
            results[name] = reduction_fn(stacked) if reduction_fn is not None else stacked
        elif isinstance(gathered[0], list):
            flat = _flatten(gathered)
            results[name] = reduction_fn(flat) if reduction_fn is not None else flat
        else:
            results[name] = reduction_fn(gathered) if reduction_fn is not None else gathered
    for name, value in results.items():
        setattr(metric, name, value)


__all__ = [
    "ALIGN",
    "CoalesceError",
    "agree_step",
    "apply_gathered_states",
    "coalesced_sync_nodes",
    "coalescible",
    "dispatch_coalesced_sync",
    "force_coalesced_sync",
    "handle_coalesce_failure",
    "should_fallback",
    "tree_nodes",
]
