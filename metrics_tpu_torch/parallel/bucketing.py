"""Coalesced sync: a whole metric tree, or a whole suite, in one payload collective.

JAX counterpart: `metrics_tpu/parallel/bucketing.py` (``tree_nodes`` `:132`,
``coalescible`` `:152`, ``_collect`` `:237`, ``_to_bytes``/``_from_bytes``
`:276-295`, ``_pack`` `:503`, ``_pack_phase`` `:606`, the flat
``_payload_exchange`` `:702`, ``_finish`` `:852`, ``coalesced_sync_nodes``
`:959`, ``apply_gathered_states`` `:1148`), without its opt-in lanes
(asynchronous dispatch, quantized and hierarchical payloads).

The per-state protocol (:func:`metrics_tpu_torch.parallel.sync.gather_all_tensors`
for each state) costs two collectives a state. This one:

- **Packs** every state as its raw bytes (``t.reshape(-1).view(torch.uint8)``,
  exact for every dtype) into one flat ``uint8`` buffer on the states'
  device. Each entry starts at a multiple of ``ALIGN`` bytes, so its slice
  of the gathered buffer can be viewed back as any dtype. The layout is
  built on the host from shapes and dtypes alone.
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

A tree that cannot be packed (a node overriding ``_sync_dist``, a list state
whose spec is not ``cat``, a dtype outside :data:`_DTYPES`, states on more
than one device) takes the per-state protocol; :func:`coalescible` decides.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.utils.data import _flatten, dim_zero_cat
from metrics_tpu_torch.utils.exceptions import SyncConfigFault

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
    when this process holds no row)."""

    __slots__ = ("node_idx", "name", "kind", "spec", "dtype", "shape")

    def __init__(self, node_idx: int, name: str, kind: str, spec: Optional[str], dtype=None, shape=None):
        self.node_idx = node_idx
        self.name = name
        self.kind = kind
        self.spec = spec
        self.dtype = dtype
        self.shape = shape

    def sig(self) -> tuple:
        if self.kind == "static":
            return (self.node_idx, self.name, self.kind, self.spec, str(self.dtype), self.shape)
        return (self.node_idx, self.name, self.kind, self.spec)


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


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
            static_total = _align(off + _nbytes(e.shape, e.dtype))
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
# two collectives; row 0 of what they return is then the caller's own.
def _host_allgather(vec: Tensor, group: Optional[Any]) -> Tensor:
    """Metadata exchange: one small int64 vector from every process, ``(world, k)``."""
    return _sync._all_gather(vec, group) if _sync._live() else vec[None]


def _payload_allgather(packed: Tensor, group: Optional[Any]) -> Tensor:
    """Payload collective: the flat byte buffer from every process, ``(world, bytes)``."""
    return _sync._all_gather(packed, group) if _sync._live() else packed[None]


def _exchange_meta(meta: List[int], device: torch.device, group: Optional[Any]) -> List[List[int]]:
    rows = _host_allgather(torch.tensor(meta, dtype=torch.int64, device=device), group).tolist()
    _sync.note_collective("shape")
    statics = {row[-2] for row in rows}
    if len(statics) != 1:
        raise SyncConfigFault(
            f"the packed layouts of the metric states differ across processes (static bytes {sorted(statics)});"
            " every process must sync the same metrics, built the same way",
            site="sync-pack",
        )
    return rows


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
def coalesced_sync_nodes(nodes: Sequence[Any], group: Optional[Any] = None) -> None:
    """Sync every state of ``nodes`` with one payload collective (plus one
    metadata collective where a ``cat`` list state is packed).

    Every process of ``group`` must call it with the same metrics. States are
    set only after the whole unpack succeeds, so a failure leaves every
    node's local state as it was. Raises :class:`SyncFault` when a collective
    fails and :class:`SyncConfigFault` when the processes' layouts differ.
    """
    entries, values = _collect(nodes)
    if not entries:
        return
    device = next((v.device for v in values if v is not None), nodes[0].device)
    packed, meta, static_total = _pack(entries, values, device)
    local_total = meta[-1]
    dyn_entries = [e for e in entries if e.kind == "dyn"]
    rank_dyn = None
    if dyn_entries:
        rows = _exchange_meta(meta, device, group)
        rank_dyn = [_dyn_layouts(entries, row) for row in rows]
        max_total = max(row[-1] for row in rows)
    else:
        key = (group, _layout_key(entries))
        if key not in _MANIFEST_CACHE and _sync._live():
            _exchange_meta(meta, device, group)  # once per layout: every process packed the same bytes
        max_total = local_total
    if max_total > local_total:
        packed = torch.cat([packed, packed.new_zeros(max_total - local_total)])
    gathered = _payload_allgather(packed, group)
    _sync.note_collective("payload", nbytes=gathered.numel())
    _finish(nodes, entries, gathered, static_total, rank_dyn)
    if not dyn_entries:
        _MANIFEST_CACHE[key] = True
        while len(_MANIFEST_CACHE) > _MANIFEST_CACHE_CAP:
            _MANIFEST_CACHE.pop(next(iter(_MANIFEST_CACHE)))
    _sync._bump("sync_states_coalesced", len(entries))
    _sync._bump("sync_coalesced_payloads")


def _finish(
    nodes: Sequence[Any],
    entries: Sequence[_Entry],
    gathered: Tensor,
    static_total: int,
    rank_dyn: Optional[List[List[Optional[tuple]]]],
) -> None:
    """Unpack, reduce and apply; every ``setattr`` after the whole unpack."""
    world = int(gathered.shape[0])
    results: List[Tuple[Any, str, Any]] = []
    off = 0
    for e in entries:
        if e.kind != "static":
            continue
        n = _nbytes(e.shape, e.dtype)
        # contiguous, as the per-state path's torch.stack is: the same reduction on the same layout
        stacked = _from_bytes(gathered[:, off : off + n], (world,) + e.shape, e.dtype).contiguous()
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
    for node, name, value in results:
        setattr(node, name, value)


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
    "apply_gathered_states",
    "coalesced_sync_nodes",
    "coalescible",
    "tree_nodes",
]
