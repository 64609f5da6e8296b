"""Persistent cross-process program cache: the signatures a warm boot runs ahead of traffic.

JAX counterpart: `metrics_tpu/ops/progcache.py`, with its knobs, its entry
header (``:76``: magic, version, two lengths, two CRCs), its counters, its
fault sites and its ladder lane. What it persists is decided anew, because the
port has no XLA programs to export.

**What a fresh process pays before its first served step, and what is kept.**
An eager step program is Python that launches kernels; nothing of it can be
serialised and reloaded, and nothing of it needs to be. What a fresh process
pays on the first run of a shape is the card's one-time work: CUDA's lazy
loading of each kernel module at its first launch, the cuBLAS and cuSOLVER
handles and workspaces, the caching allocator's first blocks of each size,
and the nvcc build of ``csrc/`` (already content-hashed under
``build/metrics_tpu_torch/``, so a checkout builds once). All of it is paid
by running the program once at that shape. So an entry records, per
``(kind, config-fingerprint digest, signature digest)``, the **abstract
signature** one program ran: the shapes, dtypes and devices of its
arguments, which modules of its state owner they named, and their Python
values (:func:`metrics_tpu_torch.ops.engine.encode_call`). It never holds
pickled code or data. :func:`metrics_tpu_torch.ops.engine.warm_programs`
drives each stored signature through its cached program once, on
zero-filled inputs and a throwaway copy of the state, and
``MetricCollection.precompile`` drives the real call paths; a signature the
store holds counts a hit when a program runs it first, its wall landing in
``cache_load_time_s`` instead of ``compile_time_s``.

An entry is stamped with the store version, ``torch.__version__``,
``torch.version.cuda``, the card's name and the build hash of ``csrc/``; an
entry of another stamp, a truncated or corrupt one, or one keyed otherwise
raises a classified :class:`JournalFault` (site ``progcache-load``), demotes
the ``progcache`` ladder lane, warns once and is treated as a miss: the
program runs as it would have, with identical results.

Everything is off by default (``METRICS_TPU_PROGCACHE=1`` opts in;
``METRICS_TPU_PROGCACHE_DIR`` and ``METRICS_TPU_PROGCACHE_MAX_MB`` place and
size the store; a value that does not parse warns once and keeps the
default). With the knob off no directory is created and no index is scanned.
The store is LRU-capped by mtime (a load touches its entry), oldest first,
each eviction counted (``progcache_evictions``) and warned.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import struct
import time
import zlib
from typing import Any, Dict, FrozenSet, Optional, Set, Tuple

import torch

from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.exceptions import JournalFault

__all__ = [
    "cache_dir",
    "configure",
    "decode_entry",
    "enabled",
    "load_program",
    "max_cap_mb",
    "progcache_stats",
    "stamp",
    "store_program",
    "stored_sigs",
]

# ------------------------------------------------------------- entry framing
# JAX's framing: a fixed header, CRC32 over the JSON manifest and over the payload, atomic writes.
_MAGIC = b"MTPC"
_VERSION = 1
_HEADER = struct.Struct("<4sIIQII")  # magic, version, manifest_len, payload_len, crc_m, crc_p
_SUFFIX = ".mpc"
_KIND_SAFE = re.compile(r"[^A-Za-z0-9_.]")

# ------------------------------------------------------------------ counters
_counters: Dict[str, int] = {
    "progcache_hits": 0,
    "progcache_misses": 0,
    "progcache_stores": 0,
    "progcache_demotions": 0,
    "progcache_evictions": 0,
    "progcache_bytes_stored": 0,
}


def progcache_stats() -> Dict[str, int]:
    """The counters, merged into ``engine.engine_stats()``: ``progcache_hits`` (stored
    signatures loaded for a first run or a warm-up), ``progcache_misses`` (first runs
    the store had nothing for), ``progcache_stores`` / ``progcache_bytes_stored``
    (entries written), ``progcache_demotions`` (corrupt, stale or mismatched entries,
    failed stores, stored signatures a program could not run) and
    ``progcache_evictions`` (size-cap removals)."""
    return dict(_counters)


def _zero_counters() -> None:
    for key in _counters:
        _counters[key] = 0


_telemetry.register_reset("progcache", _zero_counters)


class _ProgCacheOwner:
    """Ladder and warn-once anchor of the store (one lane a process: the store is process-wide)."""


_OWNER = _ProgCacheOwner()
_ENABLE_WARN_OWNER = _ProgCacheOwner()
_CAP_WARN_OWNER = _ProgCacheOwner()
_EVICT_WARN_OWNER = _ProgCacheOwner()

# ------------------------------------------------------------------- knobs
_override: Dict[str, Any] = {}
_TRUE_TOKENS = ("1", "true", "on", "yes")
_FALSE_TOKENS = ("0", "false", "off", "no")


def _parse_bool(raw: str) -> bool:
    token = raw.strip().lower()
    if token in _TRUE_TOKENS:
        return True
    if token in _FALSE_TOKENS:
        return False
    raise ValueError(raw)


def enabled() -> bool:
    """Whether the store is on (``METRICS_TPU_PROGCACHE``, default off), read at each consult."""
    if "enabled" in _override:
        return bool(_override["enabled"])
    raw = os.environ.get("METRICS_TPU_PROGCACHE")
    if raw is None or not raw.strip():
        return False
    from metrics_tpu_torch.parallel import sync as _psync

    return bool(_psync._env_parse("METRICS_TPU_PROGCACHE", False, _parse_bool, "a boolean (0/1/on/off)",
                                  owner=_ENABLE_WARN_OWNER))


def cache_dir() -> str:
    """The store's directory (``METRICS_TPU_PROGCACHE_DIR``, default under the user's cache
    directory). Nothing is created before the first store."""
    if "dir" in _override:
        return str(_override["dir"])
    raw = os.environ.get("METRICS_TPU_PROGCACHE_DIR", "")
    if raw.strip():
        return raw.strip()
    return os.path.join(os.path.expanduser("~"), ".cache", "metrics_tpu_torch", "progcache")


def max_cap_mb() -> int:
    """The store's size cap in MB (``METRICS_TPU_PROGCACHE_MAX_MB``, default 512; 0 or
    less: no cap), enforced oldest first after every store."""
    if "max_mb" in _override:
        return int(_override["max_mb"])
    from metrics_tpu_torch.parallel import sync as _psync

    return int(_psync._env_int("METRICS_TPU_PROGCACHE_MAX_MB", 512, owner=_CAP_WARN_OWNER))


def configure(*, enabled: Optional[bool] = None, cache_dir: Optional[str] = None,  # noqa: A002 - the knob's name
              max_mb: Optional[int] = None, reset: bool = False) -> None:
    """Set the knobs at run time (tests, boot scripts). ``reset=True`` first clears every
    override, the ladder lane and the directory index, so a store pointed elsewhere starts clean."""
    global _index
    if reset:
        _override.clear()
        _OWNER.__dict__.pop("_fault_ladders", None)
    if enabled is not None:
        _override["enabled"] = bool(enabled)
    if cache_dir is not None:
        _override["dir"] = str(cache_dir)
    if max_mb is not None:
        _override["max_mb"] = int(max_mb)
    _index = None
    _sizes.clear()


# ------------------------------------------------------------------ stamps
_stamp_cache: Dict[str, Any] = {}


def _build_hash() -> str:
    """A digest of the names of the libraries ``csrc/`` builds into (each named by its source's hash)."""
    from metrics_tpu_torch.ops import _native

    names = sorted(_native.library_path(p.name).name for p in _native.CSRC_DIR.glob("*.cu"))
    return hashlib.sha1("|".join(names).encode()).hexdigest()[:16]


def stamp() -> Dict[str, Any]:
    """What an entry must have been written under to be read: the store version, torch's
    and CUDA's versions, the card's name (``"cpu"`` without one) and the build hash of ``csrc/``."""
    if not _stamp_cache:
        _stamp_cache.update(
            store_version=_VERSION,
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            device=torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
            build=_build_hash(),
        )
    return dict(_stamp_cache)


# ------------------------------------------------------------ ladder lane
def _lane_armed() -> bool:
    """The store's ``progcache`` ladder lane: demoted by a failed load or store,
    re-promoted after the recovery policy's count of clean consults."""
    lad = _faults.ladder(_OWNER, "progcache")
    if not lad.demoted:
        return True
    if lad.note_clean():
        lad.promote()
        return True
    return False


# ------------------------------------------------------------- entry codec
def _frame_entry(manifest: Dict[str, Any], payload: bytes) -> bytes:
    mbytes = json.dumps(manifest, sort_keys=True).encode()
    header = _HEADER.pack(_MAGIC, _VERSION, len(mbytes), len(payload), zlib.crc32(mbytes), zlib.crc32(payload))
    return header + mbytes + payload


def decode_entry(data: bytes, origin: str = "<bytes>") -> Tuple[Dict[str, Any], bytes]:
    """Check and split one framed entry. A truncation, a bad magic, another store
    version or a CRC mismatch raises :class:`JournalFault` (site ``progcache-load``)."""
    if len(data) < _HEADER.size:
        raise JournalFault(f"progcache entry {origin} truncated: {len(data)} bytes < {_HEADER.size}-byte header",
                           site="progcache-load")
    magic, version, mlen, plen, crc_m, crc_p = _HEADER.unpack_from(data)
    if magic != _MAGIC:
        raise JournalFault(f"progcache entry {origin} has bad magic {magic!r}", site="progcache-load")
    if version != _VERSION:
        raise JournalFault(f"progcache entry {origin} has store version {version}, this build reads {_VERSION}",
                           site="progcache-load")
    end = _HEADER.size + mlen + plen
    if len(data) < end:
        raise JournalFault(f"progcache entry {origin} truncated: {len(data)} bytes < {end} framed",
                           site="progcache-load")
    mbytes = data[_HEADER.size:_HEADER.size + mlen]
    payload = bytes(data[_HEADER.size + mlen:end])
    if zlib.crc32(mbytes) != crc_m:
        raise JournalFault(f"progcache entry {origin} manifest CRC mismatch", site="progcache-load")
    if zlib.crc32(payload) != crc_p:
        raise JournalFault(f"progcache entry {origin} payload CRC mismatch", site="progcache-load")
    return json.loads(mbytes.decode()), payload


def _validate_manifest(manifest: Dict[str, Any], kind: str, key_digest: str, sig: str, origin: str) -> None:
    for name, want in stamp().items():
        if manifest.get(name) != want:
            raise JournalFault(f"progcache entry {origin} was written under {name} {manifest.get(name)!r}, this "
                               f"process runs {want!r}", site="progcache-load")
    if (manifest.get("kind"), manifest.get("key"), manifest.get("sig")) != (kind, key_digest, sig):
        raise JournalFault(f"progcache entry {origin} is keyed ({manifest.get('kind')}, {manifest.get('key')}, "
                           f"{manifest.get('sig')}), expected ({kind}, {key_digest}, {sig})", site="progcache-load")


# ---------------------------------------------------------------- the index
_index: Optional[Dict[Tuple[str, str], Set[str]]] = None
_sizes: Dict[str, int] = {}


def _fname_kind(kind: str) -> str:
    return _KIND_SAFE.sub("_", kind)


def _entry_name(kind: str, key_digest: str, sig: str) -> str:
    return f"{_fname_kind(kind)}-{key_digest}-{sig}{_SUFFIX}"


def _ensure_index() -> Dict[Tuple[str, str], Set[str]]:
    global _index
    if _index is not None:
        return _index
    _index = {}
    root = cache_dir()
    try:
        names = os.listdir(root)
    except OSError:
        return _index
    for name in names:
        if not name.endswith(_SUFFIX):
            continue
        parts = name[:-len(_SUFFIX)].rsplit("-", 2)
        if len(parts) != 3:
            continue
        _index.setdefault((parts[0], parts[1]), set()).add(parts[2])
        try:
            _sizes[name] = os.path.getsize(os.path.join(root, name))
        except OSError:
            pass
    return _index


def _drop_indexed(name: str) -> None:
    _sizes.pop(name, None)
    parts = name[:-len(_SUFFIX)].rsplit("-", 2)
    if len(parts) == 3 and _index is not None:
        sigs = _index.get((parts[0], parts[1]))
        if sigs is not None:
            sigs.discard(parts[2])


def stored_sigs(kind: str, key_digest: str) -> FrozenSet[str]:
    """The signature digests the store holds for one program; empty, with no disk read, while off."""
    if not enabled():
        return frozenset()
    return frozenset(_ensure_index().get((_fname_kind(kind), key_digest), ()))


def note_miss() -> None:
    """Count one first run the store had no entry for."""
    _counters["progcache_misses"] += 1


def note_unrunnable(kind: str, key_digest: str, sig: str, err: BaseException) -> None:
    """A stored signature its program could not run (a configuration that changed its
    meaning): counted as a demotion, warned once; the program runs on as it would have."""
    _counters["progcache_demotions"] += 1
    _faults.demote(
        _OWNER, "progcache", err, default_domain="runtime", site="progcache-load",
        warn=(f"progcache signature {kind}:{key_digest}:{sig} did not run ({type(err).__name__}: {err}); "
              "demoting the persistent tier — results are unaffected."),
    )


# ----------------------------------------------------------- store / load
def _write_entry(kind: str, key_digest: str, sig: str, payload: bytes) -> int:
    """Frame and atomically write one entry, then sweep the size cap; the framed bytes. Raises on IO failure."""
    if _faults.armed:
        _faults.maybe_fail("progcache-store")
    manifest = {"kind": kind, "key": key_digest, "sig": sig, "created": time.time(), **stamp()}
    data = _frame_entry(manifest, payload)
    root = cache_dir()
    os.makedirs(root, exist_ok=True)
    name = _entry_name(kind, key_digest, sig)
    path = os.path.join(root, name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _ensure_index().setdefault((_fname_kind(kind), key_digest), set()).add(sig)
    _sizes[name] = len(data)
    _evict_over_cap(root, keep=name)
    return len(data)


def _evict_over_cap(root: str, keep: Optional[str] = None) -> None:
    cap_mb = max_cap_mb()
    if cap_mb <= 0:
        return
    cap = cap_mb * 1024 * 1024
    try:
        names = [n for n in os.listdir(root) if n.endswith(_SUFFIX)]
    except OSError:
        return
    entries = []
    total = 0
    for n in names:
        try:
            st = os.stat(os.path.join(root, n))
        except OSError:
            continue
        entries.append((st.st_mtime, n, st.st_size))
        total += st.st_size
    if total <= cap:
        return
    entries.sort()  # oldest mtime first: loads touch their entry, so this is LRU
    dropped = []
    for _mtime, n, size in entries:
        if total <= cap:
            break
        if n == keep:
            continue
        try:
            os.remove(os.path.join(root, n))
        except OSError:
            continue
        total -= size
        dropped.append(n)
        _counters["progcache_evictions"] += 1
        _drop_indexed(n)
    if dropped:
        if _telemetry.armed:
            _telemetry.emit("progcache-store", "evict", "progcache", attrs={"evicted": dropped[:16], "count": len(dropped)})
        _faults.warn_fault(
            _EVICT_WARN_OWNER, "journal",
            f"progcache size cap ({cap_mb} MB) evicted {len(dropped)} entry(ies) oldest-first: {', '.join(dropped[:4])}"
            + ("…" if len(dropped) > 4 else "") + " — raise METRICS_TPU_PROGCACHE_MAX_MB to keep warm boots warm.",
        )


def store_program(kind: str, key_digest: str, sig: str, encoded: Dict[str, Any]) -> Optional[str]:
    """Persist one program's abstract signature ``encoded`` under ``sig``. Returns
    ``sig``, or None where the store is off or demoted, or the write failed (which
    demotes the lane and warns once). Never raises into the dispatch path."""
    if not enabled() or not _lane_armed():
        return None
    t0 = time.perf_counter()
    try:
        nbytes = _write_entry(kind, key_digest, sig, json.dumps(encoded, sort_keys=True).encode())
    except Exception as err:  # noqa: BLE001 - disk trouble: demote the lane
        _counters["progcache_demotions"] += 1
        _faults.demote(
            _OWNER, "progcache", err, default_domain="journal", site="progcache-store",
            warn=(f"progcache store failed for {kind}:{key_digest}:{sig} ({type(err).__name__}: {err}); demoting the "
                  "persistent tier — programs run as before until the lane recovers."),
        )
        return None
    _counters["progcache_stores"] += 1
    _counters["progcache_bytes_stored"] += nbytes
    if _telemetry.armed:
        _telemetry.emit("progcache-store", kind, "progcache", t0, time.perf_counter() - t0,
                        {"key": key_digest, "sig": sig, "bytes": nbytes})
    return sig


def load_program(kind: str, key_digest: str, sig: str) -> Optional[Dict[str, Any]]:
    """Read, check and decode one stored signature; the encoded signature, or None
    after counting and classifying a demotion (a corrupt, truncated, stale or
    mismatched entry: the caller runs the program as it would have)."""
    if not enabled() or not _lane_armed():
        return None
    t0 = time.perf_counter()
    name = _entry_name(kind, key_digest, sig)
    path = os.path.join(cache_dir(), name)
    try:
        if _faults.armed:
            _faults.maybe_fail("progcache-load")
        with open(path, "rb") as fh:
            data = fh.read()
        manifest, payload = decode_entry(data, origin=name)
        _validate_manifest(manifest, kind, key_digest, sig, origin=name)
        encoded = json.loads(payload.decode())
        if not isinstance(encoded, dict) or not {"state", "args", "kwargs"} <= set(encoded):
            raise JournalFault(f"progcache entry {name} holds no call signature", site="progcache-load")
        try:
            os.utime(path)  # LRU recency for the size-cap sweep
        except OSError:
            pass
    except Exception as err:  # noqa: BLE001 - every load defect demotes
        _counters["progcache_demotions"] += 1
        _drop_indexed(name)
        _faults.demote(
            _OWNER, "progcache", err, default_domain="journal", site="progcache-load",
            warn=f"progcache entry {name} failed to load ({type(err).__name__}: {err}); running the program as "
                 "before — results are unaffected.",
        )
        return None
    _counters["progcache_hits"] += 1
    if _telemetry.armed:
        _telemetry.emit("progcache-load", kind, "progcache", t0, time.perf_counter() - t0,
                        {"key": key_digest, "sig": sig})
    return encoded
