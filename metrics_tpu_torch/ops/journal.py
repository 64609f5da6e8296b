"""Crash-consistent state journal: one flat byte record per snapshot.

JAX counterpart: `metrics_tpu/ops/journal.py`, with the same record framing,
manifest schema, counters, fault sites and environment variable. A
``Metric``'s or ``MetricCollection``'s states go into one record through the
coalesced sync's own pack (:mod:`metrics_tpu_torch.parallel.bucketing`:
``tree_nodes``, ``_collect``, ``_pack``), so a restore is bit-exact by
construction: the bytes on disk are the bytes a sync would exchange.

Record (little-endian)::

    MAGIC "MTJL" | version u32 (1) | manifest_len u32 | payload_len u64
    | crc32(manifest) u32 | crc32(payload) u32 | manifest (JSON) | payload

The manifest holds ``nodes`` (type names), ``update_counts``, ``entries``
(``node``, ``name``, ``kind`` static/dyn/empty, ``spec``, ``dtype``,
``shape``, in payload order), ``static_attrs`` (each node's public scalar
attributes), ``extras`` (:meth:`Metric._journal_extra`) and ``align``. The
payload is the port's sync pack, each entry starting at a multiple of
``align`` (16) bytes; the JAX package packs its entries back to back. So the
two packages share the framing and the manifest schema, and each reads only
its own records.

Durability (the same contract as JAX's):

- **Atomic writes**: a record goes to ``<path>.tmp``, is fsynced and
  ``os.replace``d into place; a crash mid-write leaves the ring as it was.
- **Generation ring**: each save rotates ``<path>`` -> ``<path>.g1`` -> ...,
  ``METRICS_TPU_JOURNAL_GENERATIONS`` deep (default 3).
- **Verified, all-or-nothing loads**: magic, version, lengths and both CRCs
  are checked, and the whole record decoded against the live tree, before a
  single state is set. A bad generation counts a ``journal`` fault, warns
  once and demotes to the previous one; only when none verifies does a
  :class:`~metrics_tpu_torch.utils.exceptions.JournalFault` reach the caller.

Devices: a save makes one device-to-host copy (the packed buffer); a load
makes one host-to-device copy onto the metrics' own device, and the restored
states are views into that one buffer. A record carries no device, so a
record written from CUDA states loads into CPU metrics and the reverse.

World stamps (JAX ``world_meta``/``restored_meta`` `:480-502`): every saved
manifest carries the world epoch, the owner's last good sync step and the
monotonic step; ``MetricCollection.checkpoint_barrier`` adds the agreed
``barrier_step``, ``world_size`` and ``barrier``. A load keeps the stamps of
the record it restored for ``MetricCollection.rejoin`` (:func:`restored_meta`).

Fault sites: ``journal-write`` fires before the temporary file is written
(the ring stays byte-identical), ``journal-load`` before a stored record is
read. ``MetricCollection.journal(path, every_n)`` saves every ``every_n``
updates and turns a write failure into a demotion of its ``journal`` lane.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.parallel import bucketing as _bucketing
from metrics_tpu_torch.utils.exceptions import JournalFault

__all__ = [
    "decode_record",
    "journal_generations",
    "journal_stats",
    "journalable",
    "load_nodes",
    "pack_raw_record",
    "pack_record",
    "read_record",
    "restore_nodes",
    "restored_meta",
    "save_nodes",
    "stage_states",
    "unpack_raw_record",
    "world_meta",
    "write_record",
]

_counters: Dict[str, int] = {
    "journal_saves": 0,
    "journal_loads": 0,
    "journal_bytes_written": 0,
    "journal_load_demotions": 0,
}


def journal_stats() -> Dict[str, int]:
    """Records saved and restored, bytes written, and generations demoted at load."""
    return dict(_counters)


def _reset_journal_stats() -> None:
    for key in _counters:
        _counters[key] = 0


_telemetry.register_reset("journal", _reset_journal_stats)

_MAGIC = b"MTJL"
_VERSION = 1
_HEADER = struct.Struct("<4sIIQII")  # magic, version, manifest_len, payload_len, crc_m, crc_p
_ALIGN = _bucketing.ALIGN
_DTYPE_NAME = {dt: str(dt).replace("torch.", "") for dt in _bucketing._DTYPES}
_NAME_DTYPE = {name: dt for dt, name in _DTYPE_NAME.items()}


def journal_generations() -> int:
    """Depth of the generation ring (``METRICS_TPU_JOURNAL_GENERATIONS``, default 3, at least 1)."""
    try:
        return max(1, int(os.environ.get("METRICS_TPU_JOURNAL_GENERATIONS", "3")))
    except ValueError:
        return 3


def _gen_path(path: str, gen: int) -> str:
    return path if gen == 0 else f"{path}.g{gen}"


def journalable(nodes: Sequence[Any]) -> Optional[str]:
    """None when every state of every node fits a record, else why not: a list
    state whose spec is not ``cat`` (the pack concatenates its rows), a leaf
    that is not a tensor, a dtype the pack does not carry, or states on more
    than one device."""
    devices = set()
    for node in nodes:
        for name in node._reductions:
            spec = node._reduction_specs[name]
            value = getattr(node, name)
            if isinstance(value, list) and spec != "cat" and value:
                return (
                    f"state {type(node).__name__}.{name} is a non-'cat' list state; its row "
                    "structure would not survive the concatenating byte pack"
                )
            for row in value if isinstance(value, list) else [value]:
                if not isinstance(row, Tensor):
                    return f"state {type(node).__name__}.{name} holds a non-array leaf"
                if row.dtype not in _DTYPE_NAME:
                    return f"state {type(node).__name__}.{name} has dtype {row.dtype} which the byte packing cannot carry"
                devices.add(row.device)
    if len(devices) > 1:
        return f"the states lie on more than one device ({sorted(map(str, devices))})"
    return None


_SCALAR_TYPES = (bool, int, float, str, type(None))
_MODULE_ATTRS = ("training",)  # nn.Module's own public attribute, not a metric's


def _static_attrs(node: Any) -> Dict[str, Any]:
    """A node's public scalar attributes: the hyperparameters an update may infer
    (Accuracy's ``mode``, a curve's ``num_classes``), which ``compute()`` after a
    restore needs back. Containers are left out: JSON would not return their type."""
    state_names = set(node._reduction_specs)
    out: Dict[str, Any] = {}
    for key, value in node.__dict__.items():
        if key.startswith("_") or key in state_names or key in _MODULE_ATTRS:
            continue
        if isinstance(value, _SCALAR_TYPES):
            out[key] = value
    return out


def _host_bytes(buf: Tensor) -> bytes:
    """A uint8 buffer's bytes on the host: one device-to-host copy for a CUDA buffer."""
    return buf.cpu().numpy().tobytes()


def _device_buffer(payload: bytes, device: torch.device) -> Tensor:
    """``payload`` as one uint8 tensor on ``device``: an aligned host copy, then
    one host-to-device copy for a CUDA device."""
    host = torch.empty(len(payload), dtype=torch.uint8)
    if payload:
        host.numpy()[:] = np.frombuffer(payload, np.uint8)
    return host if device.type == "cpu" else host.to(device)


# ------------------------------------------------------------------- encoding
def pack_record(nodes: Sequence[Any], manifest_extra: Optional[Dict[str, Any]] = None) -> bytes:
    """Every state of ``nodes`` as one CRC-framed record. The caller has
    canonicalized the nodes' list states (:func:`save_nodes` does).
    ``manifest_extra`` adds JSON keys to the manifest; it never replaces the
    structural ones."""
    reason = journalable(nodes)
    if reason is not None:
        raise JournalFault(f"cannot journal this state tree: {reason}", site="journal-write")
    entries, values = _bucketing._collect(nodes)
    device = next((v.device for v in values if v is not None), torch.device("cpu"))
    packed, _, _ = _bucketing._pack(entries, values, device)
    payload = _host_bytes(packed)

    rows: List[Dict[str, Any]] = []
    empties: List[Dict[str, Any]] = []
    for e, value in zip(entries, values):
        row: Dict[str, Any] = {"node": e.node_idx, "name": e.name, "kind": e.kind, "spec": e.spec}
        if value is None:
            row["kind"] = "empty"
            empties.append(row)
            continue
        row["dtype"] = _DTYPE_NAME[value.dtype]
        row["shape"] = [int(d) for d in value.shape]
        rows.append(row)
    manifest = {
        "version": _VERSION,
        "nodes": [type(n).__name__ for n in nodes],
        "update_counts": [int(n._update_count) for n in nodes],
        "entries": rows + empties,  # payload order; empties carry no bytes
        "static_attrs": [_static_attrs(n) for n in nodes],
        "extras": [n._journal_extra() for n in nodes],
        "align": _ALIGN,
    }
    if manifest_extra:
        for key, value in manifest_extra.items():
            manifest.setdefault(key, value)
    return _frame_record(manifest, payload)


def _frame_record(manifest: Dict[str, Any], payload: bytes) -> bytes:
    mbytes = json.dumps(manifest, separators=(",", ":")).encode("utf-8")
    header = _HEADER.pack(_MAGIC, _VERSION, len(mbytes), len(payload), zlib.crc32(mbytes), zlib.crc32(payload))
    return header + mbytes + payload


def pack_raw_record(arrays: Dict[str, Any], manifest_extra: Optional[Dict[str, Any]] = None) -> bytes:
    """A flat ``{name: tensor or array}`` dict as one CRC-framed record, for a
    caller whose durable unit is a plain layout rather than a metric tree.
    Entries are ``kind="raw"``; each starts at a multiple of 16 bytes."""
    entries: List[Dict[str, Any]] = []
    chunks: List[bytes] = []
    off = 0
    for name in arrays:
        t = torch.as_tensor(arrays[name])
        if t.dtype not in _DTYPE_NAME:
            raise JournalFault(f"raw entry {name!r} has dtype {t.dtype} which the byte packing cannot carry",
                               site="journal-write")
        data = _host_bytes(_bucketing._to_bytes(t.contiguous()))
        entries.append({"node": 0, "name": str(name), "kind": "raw", "dtype": _DTYPE_NAME[t.dtype],
                        "shape": [int(d) for d in t.shape]})
        chunks.append(data)
        off += len(data)
        gap = _bucketing._align(off) - off
        chunks.append(b"\0" * gap)
        off += gap
    manifest: Dict[str, Any] = {"version": _VERSION, "raw": True, "entries": entries, "align": _ALIGN}
    if manifest_extra:
        for key, value in manifest_extra.items():
            manifest.setdefault(key, value)
    return _frame_record(manifest, b"".join(chunks))


def _segments(entries: Sequence[Dict[str, Any]], nbytes: int, bad) -> List[Tuple[int, int]]:
    """The ``(offset, length)`` of every entry that carries bytes, in payload order."""
    out = []
    off = 0
    for e in entries:
        if e.get("kind") == "empty":
            out.append((off, 0))
            continue
        dtype = _NAME_DTYPE.get(e.get("dtype"))
        if dtype is None:
            raise bad(f"entry {e.get('name')!r} has an unknown dtype {e.get('dtype')!r}")
        n = _bucketing._nbytes(tuple(e["shape"]), dtype)
        if off + n > nbytes:
            raise bad(f"entry {e['name']!r} overruns the payload")
        out.append((off, n))
        off = _bucketing._align(off + n)
    if off != nbytes:
        raise bad(f"record carries {nbytes - off} unclaimed payload bytes")
    return out


def unpack_raw_record(manifest: Dict[str, Any], payload: bytes) -> Dict[str, Tensor]:
    """A :func:`pack_raw_record` payload back as ``{name: tensor}`` on the CPU;
    raises :class:`JournalFault` on any layout mismatch."""

    def _bad(why: str) -> JournalFault:
        return JournalFault(f"raw journal record is corrupt: {why}", site="journal-load")

    if not manifest.get("raw"):
        raise _bad("manifest is not a raw record (missing the 'raw' stamp)")
    for e in manifest["entries"]:
        if e.get("kind") != "raw":
            raise _bad(f"entry {e.get('name')!r} has kind {e.get('kind')!r}, expected 'raw'")
    segments = _segments(manifest["entries"], len(payload), _bad)
    buf = _device_buffer(payload, torch.device("cpu"))
    return {
        e["name"]: _bucketing._from_bytes(buf[off : off + n], tuple(e["shape"]), _NAME_DTYPE[e["dtype"]])
        for e, (off, n) in zip(manifest["entries"], segments)
    }


def decode_record(data: bytes, origin: str = "<bytes>") -> Tuple[Dict[str, Any], bytes]:
    """Verify one record and split it into ``(manifest, payload)``; raises
    :class:`JournalFault` on truncation, a foreign magic, another version or a
    checksum mismatch. Manifest keys it does not know are kept; a manifest
    without an ``entries`` table is corrupt."""

    def _bad(why: str) -> JournalFault:
        return JournalFault(f"journal record {origin} is corrupt: {why}", site="journal-load")

    if len(data) < _HEADER.size:
        raise _bad(f"truncated header ({len(data)} bytes)")
    magic, version, mlen, plen, crc_m, crc_p = _HEADER.unpack_from(data)
    if magic != _MAGIC:
        raise _bad(f"bad magic {magic!r}")
    if version != _VERSION:
        raise _bad(f"unsupported version {version}")
    if len(data) != _HEADER.size + mlen + plen:
        raise _bad(f"torn record ({len(data)} bytes, header promises {_HEADER.size + mlen + plen})")
    mbytes = data[_HEADER.size : _HEADER.size + mlen]
    payload = data[_HEADER.size + mlen :]
    if zlib.crc32(mbytes) != crc_m:
        raise _bad("manifest checksum mismatch")
    if zlib.crc32(payload) != crc_p:
        raise _bad("payload checksum mismatch")
    try:
        manifest = json.loads(mbytes.decode("utf-8"))
    except ValueError as err:  # pragma: no cover - the CRC makes this near-impossible
        raise _bad(f"manifest does not parse: {err}") from err
    if not isinstance(manifest, dict) or not isinstance(manifest.get("entries"), list):
        raise _bad("manifest has no entries table")
    return manifest, payload


def stage_states(nodes: Sequence[Any], manifest: Dict[str, Any], payload: bytes) -> List[Tuple[int, str, Any]]:
    """Check one record against the live ``nodes`` and decode it without
    setting anything: ``(node index, state name, value)`` rows (``cat`` states
    as one-row lists, empty ones as ``[]``). Raises :class:`JournalFault` on
    any mismatch, every node untouched."""

    def _bad(why: str) -> JournalFault:
        return JournalFault(f"journal record does not match this state tree: {why}", site="journal-load")

    # the whole tree must match, node for node: a partial restore is corruption
    live_types = [type(n).__name__ for n in nodes]
    rec_types = manifest.get("nodes")
    if rec_types is not None and list(rec_types) != live_types:
        raise _bad(
            f"record holds {len(rec_types)} node(s) {rec_types}, live tree is "
            f"{len(live_types)} node(s) {live_types} (construction mismatch)"
        )
    if manifest.get("align", _ALIGN) != _ALIGN:
        raise _bad(f"payload aligned to {manifest.get('align')} bytes, not {_ALIGN}")
    entries = manifest["entries"]
    for e in entries:
        idx, name = e["node"], e["name"]
        if not (0 <= idx < len(nodes)):
            raise _bad(f"entry {name!r} addresses node {idx} of {len(nodes)}")
        node = nodes[idx]
        if name not in node._defaults:
            raise _bad(f"{type(node).__name__} has no state {name!r}")
        current = getattr(node, name)
        if e["kind"] == "static" and (isinstance(current, list) or _DTYPE_NAME.get(current.dtype) != e["dtype"]):
            live = "a list" if isinstance(current, list) else current.dtype
            raise _bad(f"{type(node).__name__}.{name} is {live} live but {e['dtype']} in the record (construction mismatch)")
    segments = _segments(entries, len(payload), _bad)
    buffers: Dict[torch.device, Tensor] = {}  # one copy of the payload on each device the nodes use
    staged: List[Tuple[int, str, Any]] = []
    for e, (off, n) in zip(entries, segments):
        idx, name, kind = e["node"], e["name"], e["kind"]
        if kind == "empty":
            staged.append((idx, name, []))
            continue
        device = nodes[idx].device
        if device not in buffers:
            buffers[device] = _device_buffer(payload, device)
        value = _bucketing._from_bytes(buffers[device][off : off + n], tuple(e["shape"]), _NAME_DTYPE[e["dtype"]])
        staged.append((idx, name, [value] if kind == "dyn" else value))
    return staged


def restore_nodes(nodes: Sequence[Any], manifest: Dict[str, Any], payload: bytes) -> None:
    """Apply a decoded record to ``nodes``, all or nothing: states, update
    counts, public scalar attributes and extras, set only after the whole
    record decoded (:func:`stage_states`)."""
    staged = stage_states(nodes, manifest, payload)
    counts = manifest.get("update_counts", [])
    statics = manifest.get("static_attrs", [])
    extras = manifest.get("extras", [])
    for idx, name, value in staged:
        setattr(nodes[idx], name, value)
    for i, node in enumerate(nodes):
        if i < len(statics) and statics[i]:
            for key, value in statics[i].items():
                setattr(node, key, value)
        if i < len(extras) and extras[i]:
            node._journal_restore_extra(extras[i])
        if i < len(counts):
            node._update_count = int(counts[i])
        node._computed = None
        node._is_synced = False
        node._cache = None


# ------------------------------------------------------------------- disk I/O
def write_record(path: str, data: bytes, generations: Optional[int] = None) -> None:
    """Write one record atomically and rotate the generation ring. The
    ``journal-write`` fault site fires before a byte is written."""
    if _faults.armed:
        _faults.maybe_fail("journal-write")
    cap = generations if generations is not None else journal_generations()
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    for gen in range(cap - 1, 0, -1):
        src = _gen_path(path, gen - 1)
        if os.path.exists(src):
            os.replace(src, _gen_path(path, gen))
    os.replace(tmp, path)


def read_record(path: str) -> Tuple[Dict[str, Any], bytes]:
    """Read and verify one generation file; I/O errors and corruption raise
    :class:`JournalFault`. The ``journal-load`` fault site fires first."""
    if _faults.armed:
        _faults.maybe_fail("journal-load")
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as err:
        raise JournalFault(
            f"journal record {path!r} is unreadable: {type(err).__name__}: {err}", site="journal-load"
        ) from err
    return decode_record(data, origin=repr(path))


# ---------------------------------------------------------------- owner-level
#: The manifest stamps a rejoin reads back.
_META_KEYS = ("epoch", "last_good_sync_step", "monotonic_step", "barrier_step", "world_size", "barrier")


def world_meta(owner: Any) -> Dict[str, Any]:
    """The membership stamps of one save: the world epoch, the owner's last
    good sync step and the monotonic step."""
    from metrics_tpu_torch.parallel import sync as _sync

    return {
        "epoch": _sync.world_epoch(),
        "last_good_sync_step": owner.__dict__.get("_last_good_sync_step"),
        "monotonic_step": _faults.current_step(),
    }


def manifest_meta(manifest: Dict[str, Any]) -> Dict[str, Any]:
    """The membership stamps a manifest carries."""
    return {k: manifest[k] for k in _META_KEYS if k in manifest}


def restored_meta(owner: Any) -> Dict[str, Any]:
    """The membership stamps of the record ``owner`` last restored (empty before any load)."""
    return dict(owner.__dict__.get("_journal_meta") or {})


def save_nodes(owner: Any, nodes: Sequence[Any], path: str, manifest_extra: Optional[Dict[str, Any]] = None) -> int:
    """Save ``nodes`` to ``path``, rotating the ring; returns the record's bytes.
    The manifest carries :func:`world_meta`'s stamps, and ``manifest_extra``,
    which wins where they overlap. A failure is counted and raised as
    :class:`JournalFault`, the ring intact."""
    t0 = _telemetry.now() if _telemetry.armed else 0.0
    try:
        for n in nodes:
            n._defer_barrier()
            n._canonicalize_list_states()
        extra = world_meta(owner)
        if manifest_extra:
            extra.update(manifest_extra)
        data = pack_record(nodes, manifest_extra=extra)
        write_record(path, data)
    except Exception as exc:  # noqa: BLE001 - classified and raised
        _faults.note_fault(_faults.classify(exc, "journal"), site="journal-write", owner=owner, error=exc)
        if isinstance(exc, JournalFault):
            raise
        raise JournalFault(f"journal save to {path!r} failed: {type(exc).__name__}: {exc}", site="journal-write") from exc
    _counters["journal_saves"] += 1
    _counters["journal_bytes_written"] += len(data)
    if t0 and _telemetry.armed:
        _telemetry.emit(
            "journal-save", owner, "journal", t0, _telemetry.now() - t0, {"bytes": len(data), "nodes": len(nodes)}
        )
    return len(data)


def load_nodes(owner: Any, nodes: Sequence[Any], path: str) -> int:
    """Restore ``nodes`` from the newest generation at ``path`` that verifies and
    fits; returns its index (0 the newest). Each bad generation counts a
    ``journal`` fault, warns once and demotes to the previous one; raises
    :class:`JournalFault` only when none restores."""
    last: Optional[BaseException] = None
    t0 = _telemetry.now() if _telemetry.armed else 0.0
    for n in nodes:
        n._defer_barrier()  # queued calls run first: a later flush must not write over the restored states
    # a few generations past the configured depth: the depth may have been lowered between runs
    for gen in range(journal_generations() + 8):
        gpath = _gen_path(path, gen)
        if not os.path.exists(gpath):
            continue
        try:
            manifest, payload = read_record(gpath)
            restore_nodes(nodes, manifest, payload)
            object.__setattr__(owner, "_journal_meta", manifest_meta(manifest))
        except Exception as exc:  # noqa: BLE001 - demote to the previous generation
            last = exc
            _counters["journal_load_demotions"] += 1
            _faults.note_fault(_faults.classify(exc, "journal"), site="journal-load", owner=owner, error=exc)
            if _telemetry.armed:
                _telemetry.emit("journal-demote", owner, "journal", attrs={"generation": gen, "error": type(exc).__name__})
            _faults.warn_fault(
                owner,
                "journal",
                f"Journal generation {gpath!r} failed verification "
                f"({type(exc).__name__}: {exc}); demoting to the previous good generation.",
            )
            continue
        _counters["journal_loads"] += 1
        if t0 and _telemetry.armed:
            _telemetry.emit(
                "journal-load", owner, "journal", t0, _telemetry.now() - t0,
                {"generation": gen, "bytes": len(payload), "nodes": len(nodes)},
            )
        return gen
    if last is not None:
        if isinstance(last, JournalFault):
            raise last
        raise JournalFault(
            f"every journal generation at {path!r} failed verification; last error: {type(last).__name__}: {last}",
            site="journal-load",
        ) from last
    raise JournalFault(f"no journal record found at {path!r}", site="journal-load")
