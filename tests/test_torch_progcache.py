"""The port's persistent program cache (``metrics_tpu_torch/ops/progcache.py``), the collection's
``precompile`` and ``rejoin(warm=True)``.

The store keeps JAX's contract: off by default with no directory made and no
index scanned; JAX's entry header (magic, version, two lengths, two CRCs);
corrupt, truncated and mismatched entries raise a classified ``JournalFault``,
demote the ``progcache`` lane, warn once and change no result; LRU eviction by
mtime, touched on load, counted. What an entry holds is the abstract
signature a program ran: a second process that precompiles the same suite
finds every signature the first stored (two real processes), and
``warm_programs`` runs the stored ones this process has not run. ``precompile``
puts every member's states back bit for bit.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from metrics_tpu_torch.ops import engine, faults, progcache
from metrics_tpu_torch.utils import checks
from metrics_tpu_torch.utils.exceptions import JournalFault
from tests.helpers.torch_sync import headline_suite, suite_batches
import metrics_tpu_torch as tmt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("METRICS_TPU_PROGCACHE", "METRICS_TPU_PROGCACHE_DIR", "METRICS_TPU_PROGCACHE_MAX_MB"):
        monkeypatch.delenv(knob, raising=False)
    mode = checks._get_validation_mode()
    checks.set_validation_mode("first")
    progcache.configure(reset=True)
    engine.reset_engine()
    engine.reset_stats(reset_warnings=True)
    yield
    checks.set_validation_mode(mode)
    progcache.configure(reset=True)
    engine.reset_engine()
    engine.reset_stats(reset_warnings=True)


def _batch():
    preds, target = suite_batches(6, 1)[0]
    return torch.from_numpy(preds), torch.from_numpy(target)


def _states(suite):
    return {f"{name}.{k}": (v.clone() if isinstance(v, torch.Tensor) else [t.clone() for t in v])
            for name, m in suite.items(keep_base=True, copy_state=False) for k, v in m.metric_state.items()}


def _equal(a, b):
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else all(map(torch.equal, a[k], b[k])) for k in a)


def test_off_by_default_makes_no_directory_and_scans_nothing(monkeypatch, tmp_path):
    store = tmp_path / "store"
    monkeypatch.setenv("METRICS_TPU_PROGCACHE_DIR", str(store))
    monkeypatch.setattr(progcache, "_ensure_index", lambda: pytest.fail("an index scan while the store is off"))
    suite = headline_suite(tmt)
    for _ in range(4):
        suite.update(*_batch())
    suite.precompile(*_batch(), defer_chunks=4)
    assert engine.warm_programs() == 0 and not store.exists() and progcache.enabled() is False
    assert all(v == 0 for v in progcache.progcache_stats().values())
    assert progcache.stored_sigs("suite-many", "x") == frozenset()


def test_a_garbage_knob_warns_once_and_stays_off(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_PROGCACHE", "sometimes")
    with pytest.warns(UserWarning, match="METRICS_TPU_PROGCACHE"):
        assert progcache.enabled() is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert progcache.enabled() is False


def test_the_entry_header_is_the_reference_layout():
    assert progcache._HEADER.format == "<4sIIQII" and progcache._MAGIC == b"MTPC" and progcache._VERSION == 1
    manifest, payload = {"kind": "k"}, b'{"state": "none"}'
    data = progcache._frame_entry(manifest, payload)
    assert progcache.decode_entry(data) == (manifest, payload)
    for bad, match in ((data[:10], "truncated"), (data[:-3], "truncated"), (b"XXXX" + data[4:], "bad magic"),
                       (data[:-1] + bytes([data[-1] ^ 1]), "payload CRC")):
        with pytest.raises(JournalFault, match=match):
            progcache.decode_entry(bad)


def test_precompile_stores_and_restores_states_bit_for_bit(tmp_path):
    progcache.configure(enabled=True, cache_dir=str(tmp_path))
    suite = headline_suite(tmt)
    for _ in range(3):
        suite.update(*_batch())
    before = _states(suite)
    counts = {n: m._update_count for n, m in suite.items(keep_base=True, copy_state=False)}
    report = suite.precompile(*_batch(), defer_chunks=4)
    assert _equal(_states(suite), before)
    assert {n: m._update_count for n, m in suite.items(keep_base=True, copy_state=False)} == counts
    assert report["steps"] > 4 and report["compiles"] >= 3 and report["progcache_stores"] == report["compiles"]
    stats = progcache.progcache_stats()
    assert stats["progcache_stores"] == stats["progcache_misses"] and stats["progcache_bytes_stored"] > 0
    names = [n for n in os.listdir(tmp_path) if n.endswith(".mpc")]
    assert len(names) == stats["progcache_stores"]
    manifest, payload = progcache.decode_entry(open(tmp_path / names[0], "rb").read())
    assert {"torch_version", "cuda_version", "device", "build", "store_version"} <= set(manifest)
    assert set(json.loads(payload)) == {"state", "args", "kwargs"}  # a signature, never code
    # the suite goes on as a suite that was never precompiled
    twin = headline_suite(tmt)
    for _ in range(3):
        twin.update(*_batch())
    suite.update(*_batch())
    twin.update(*_batch())
    assert _equal(_states(suite), _states(twin))


def _second_process(tmp_path):
    """What a fresh process sees: no program, the store's index read anew."""
    engine.reset_engine()
    engine.reset_stats(reset_warnings=True)
    progcache.configure(enabled=True, cache_dir=str(tmp_path), reset=True)


def test_a_second_process_finds_every_stored_signature(tmp_path):
    progcache.configure(enabled=True, cache_dir=str(tmp_path))
    headline_suite(tmt).precompile(*_batch(), defer_chunks=4)
    stored = progcache.progcache_stats()["progcache_stores"]
    _second_process(tmp_path)
    report = headline_suite(tmt).precompile(*_batch(), defer_chunks=4)
    assert report["progcache_hits"] == stored and report["compiles"] == 0 and report["progcache_stores"] == 0
    row = next(r for r in engine.program_report(analyze=False) if r["kind"] == "suite-many")
    assert row["cache_source"] == "progcache" and row["cache_load_time_s"] > 0 and row["compile_time_s"] == 0


def test_warm_programs_runs_the_stored_signatures_not_yet_run(tmp_path):
    progcache.configure(enabled=True, cache_dir=str(tmp_path))
    headline_suite(tmt).precompile(*_batch(), defer_chunks=8)
    _second_process(tmp_path)
    suite = headline_suite(tmt)
    suite.precompile(*_batch(), defer_chunks=1, forward=False)
    before = _states(suite)
    warmed = engine.warm_programs()
    assert warmed >= 2 and engine.warm_programs() == 0  # 2, 4 and 8 entries a chunk; then nothing is left
    assert _equal(_states(suite), before)
    exe = next(e for e in engine._PROGRAM_CACHE.values() if e.kind == "suite-many")
    assert exe.compiled_signatures() >= warmed


def test_rejoin_warm_returns_the_warmed_programs(tmp_path):
    progcache.configure(enabled=True, cache_dir=str(tmp_path / "store"))
    first = headline_suite(tmt)
    first.precompile(*_batch(), defer_chunks=8)
    for _ in range(3):
        first.update(*_batch())
    first.save_state(str(tmp_path / "journal"))
    _second_process(tmp_path / "store")
    fresh = headline_suite(tmt)
    fresh.precompile(*_batch(), defer_chunks=1, forward=False)
    out = fresh.rejoin(str(tmp_path / "journal"), warm=True)
    assert out["warmed_programs"] >= 2 and out["generation"] == 0
    assert _equal(_states(fresh), _states(first))
    again = headline_suite(tmt)
    again.precompile(*_batch(), defer_chunks=1, forward=False)
    assert again.rejoin(str(tmp_path / "journal"), warm=False)["warmed_programs"] == 0


@pytest.mark.parametrize("defect", ["corrupt", "truncated", "mismatched"])
def test_a_bad_entry_demotes_warns_once_and_changes_nothing(tmp_path, defect):
    progcache.configure(enabled=True, cache_dir=str(tmp_path))
    headline_suite(tmt).precompile(*_batch(), defer_chunks=2)
    for name in (n for n in os.listdir(tmp_path) if n.endswith(".mpc")):
        path = tmp_path / name
        data = bytearray(path.read_bytes())
        if defect == "corrupt":
            data[-2] ^= 0xFF
        elif defect == "truncated":
            data = data[: len(data) // 2]
        else:
            manifest, payload = progcache.decode_entry(bytes(data))
            manifest["torch_version"] = "0.0"
            data = progcache._frame_entry(manifest, payload)
        path.write_bytes(bytes(data))
    _second_process(tmp_path)
    suite, twin = headline_suite(tmt), headline_suite(tmt)
    with pytest.warns(UserWarning, match="failed to load") as caught:
        for _ in range(6):
            suite.update(*_batch())
        suite.compute()
    assert sum("failed to load" in str(w.message) for w in caught) == 1  # warned once
    stats = progcache.progcache_stats()
    assert stats["progcache_demotions"] >= 1 and stats["progcache_hits"] == 0
    assert faults.fault_stats()["fault_journal"] >= 1
    for _ in range(6):
        twin.update(*_batch())
    assert _equal(_states(suite), _states(twin))


def _padded_entry(n_bytes):
    return json.dumps({"state": "none", "args": {"l": []}, "kwargs": {"d": []}, "pad": "x" * n_bytes}).encode()


def test_lru_eviction_by_mtime_touched_on_load(tmp_path):
    progcache.configure(enabled=True, cache_dir=str(tmp_path), max_mb=1)
    kb = 1024
    progcache._write_entry("k", "key", "a", _padded_entry(500 * kb))
    progcache._write_entry("k", "key", "b", _padded_entry(300 * kb))
    os.utime(tmp_path / "k-key-a.mpc", (1000, 1000))
    os.utime(tmp_path / "k-key-b.mpc", (2000, 2000))
    assert progcache.load_program("k", "key", "a") is not None  # the load touches a: b is now the oldest
    with pytest.warns(UserWarning, match="evicted 1"):
        progcache._write_entry("k", "key", "c", _padded_entry(300 * kb))
    assert sorted(os.listdir(tmp_path)) == ["k-key-a.mpc", "k-key-c.mpc"]
    assert progcache.progcache_stats()["progcache_evictions"] == 1
    assert progcache.stored_sigs("k", "key") == frozenset({"a", "c"})


@pytest.mark.parametrize("site", ["progcache-store", "progcache-load"])
def test_the_fault_sites_demote_the_lane(tmp_path, site):
    progcache.configure(enabled=True, cache_dir=str(tmp_path))
    if site == "progcache-load":
        headline_suite(tmt).precompile(*_batch(), defer_chunks=2)
        _second_process(tmp_path)
    with faults.inject_faults(site, count=1) as plan, pytest.warns(UserWarning):
        headline_suite(tmt).precompile(*_batch(), defer_chunks=2)
    assert plan.fired == 1 and progcache.progcache_stats()["progcache_demotions"] == 1
    assert faults.ladder(progcache._OWNER, "progcache").demoted


CHILD = """
import json, os, sys, time, torch
import metrics_tpu_torch as tmt
from metrics_tpu_torch.ops import engine
from metrics_tpu_torch.utils import checks
from tests.helpers.torch_sync import headline_suite, suite_batches
checks.set_validation_mode("first")
preds, target = map(torch.from_numpy, suite_batches(6, 1)[0])
report = headline_suite(tmt).precompile(preds, target, defer_chunks=4)
assert "jax" not in sys.modules
print(json.dumps({**report, **{k: v for k, v in engine.engine_stats().items() if k.startswith("progcache_")}}))
"""


def test_two_real_processes_share_the_store(tmp_path):
    env = dict(os.environ, METRICS_TPU_PROGCACHE="1", METRICS_TPU_PROGCACHE_DIR=str(tmp_path), PYTHONPATH=ROOT)
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["progcache_stores"] > 0 and cold["progcache_hits"] == 0
    assert warm["progcache_hits"] == cold["progcache_stores"] and warm["progcache_stores"] == 0
    assert warm["compiles"] == 0 and np.isclose(warm["steps"], cold["steps"])
