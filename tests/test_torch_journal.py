"""The port's state journal (``metrics_tpu_torch/ops/journal.py``) against the JAX package's.

The headline suite after the same batches gives the JAX manifest: ``nodes``,
``update_counts``, entry names, kinds, specs and shapes, ``static_attrs``,
the world stamps of a saved record, and each dtype
where the two packages' live state dtypes agree; the records share the JAX
framing (``MTJL``, version 1, header ``<4sIIQII``). Then the JAX package's
own journal scenarios (``tests/ops/test_journal.py``) as cases of
parametrised tests: bit-exact round trips of every family, crash and replay,
torn and flipped records demoting to the previous generation, a smaller
suite's record never partially restoring, the bounded ring, the write fault
leaving the ring byte-identical, the ``every_n`` hook and its degrade and
recovery; and the port's own: a restored BootStrapper drawing what the
uninterrupted one draws, the tracker's packed history equal to JAX's values,
and raw records. Values compare bit for bit (``torch.equal``).
"""
import os
import struct

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu.ops import journal as jjournal
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import faults, journal, telemetry
from metrics_tpu_torch.utils.exceptions import JournalFault
from tests.helpers.torch_sync import headline_suite, suite_batches


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX
    package's journal pack reaches; this test's copy of it lets the reference run."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    yield


RNG = np.random.RandomState(7)


def _equal(got, want) -> None:
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), (got, want)


def _batch(n=16):
    return torch.from_numpy(RNG.rand(n).astype(np.float32)), torch.from_numpy(RNG.randint(0, 2, n))


FAMILIES = {
    "accuracy": (lambda: tmt.Accuracy(device="cpu"), _batch),
    "mean": (lambda: tmt.MeanMetric(device="cpu"), lambda: (_batch()[0],)),
    "auroc": (lambda: tmt.AUROC(pos_label=1, device="cpu"), _batch),
    "cat": (lambda: tmt.CatMetric(device="cpu"), lambda: (_batch()[0],)),
    "bootstrap": (
        lambda: tmt.BootStrapper(tmt.MeanSquaredError(device="cpu"), num_bootstraps=3,
                                 sampling_strategy="multinomial"),
        lambda: (_batch()[0], _batch()[0]),
    ),
    "suite": (lambda: headline_suite(tmt), lambda: tuple(map(torch.from_numpy, suite_batches(5, 1)[0]))),
}


# ---------------------------------------------------------- reference parity
def test_headline_manifest_equals_the_reference():
    mine, ref = headline_suite(tmt), headline_suite(jmt)
    for preds, target in suite_batches(3, 3):
        mine.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    m_man, _ = journal.decode_record(journal.pack_record(mine._journal_nodes()))
    r_man, _ = jjournal.decode_record(jjournal.pack_record(ref._journal_nodes()))
    assert m_man["version"] == r_man["version"] == 1
    assert m_man["nodes"] == r_man["nodes"]
    assert m_man["update_counts"] == r_man["update_counts"]
    assert m_man["extras"] == r_man["extras"]
    strip = lambda e: {k: e[k] for k in ("node", "name", "kind", "spec", "shape")}  # noqa: E731
    assert [strip(e) for e in m_man["entries"]] == [strip(e) for e in r_man["entries"]]
    m_nodes, r_nodes = mine._journal_nodes(), ref._journal_nodes()
    agreeing = 0
    for me, re in zip(m_man["entries"], r_man["entries"]):
        live_m = getattr(m_nodes[me["node"]], me["name"])
        live_r = getattr(r_nodes[re["node"]], re["name"])
        if str(live_m.dtype).replace("torch.", "") == str(live_r.dtype):
            agreeing += 1
            assert me["dtype"] == re["dtype"]
    assert agreeing == len(m_man["entries"])
    assert m_man["static_attrs"] == r_man["static_attrs"]


def test_saved_manifest_carries_the_reference_world_stamps(tmp_path):
    """A save stamps the world epoch, the owner's last good sync and the monotonic step, as JAX's does;
    a load keeps them for ``rejoin``."""
    mine, ref = headline_suite(tmt), headline_suite(jmt)
    for preds, target in suite_batches(4, 2):
        mine.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    m_path, r_path = str(tmp_path / "port.journal"), str(tmp_path / "jax.journal")
    mine.save_state(m_path)
    ref.save_state(r_path)
    m_man, _ = journal.read_record(m_path)
    r_man, _ = jjournal.read_record(r_path)
    stamps = ("epoch", "last_good_sync_step", "monotonic_step")
    assert set(stamps) <= set(m_man) and set(stamps) <= set(r_man)
    assert m_man["last_good_sync_step"] is None is r_man["last_good_sync_step"]
    fresh = headline_suite(tmt)
    fresh.load_state(m_path)
    assert journal.restored_meta(fresh) == {k: m_man[k] for k in stamps}


def test_record_framing_is_the_reference_framing():
    m = tmt.SumMetric(device="cpu")
    m.update(torch.tensor([1.0, 2.0]))
    record = journal.pack_record([m])
    assert journal._HEADER.format == jjournal._HEADER.format == "<4sIIQII"
    magic, version, mlen, plen, _, _ = journal._HEADER.unpack_from(record)
    assert (magic, version) == (jjournal._MAGIC, jjournal._VERSION) == (b"MTJL", 1)
    manifest, payload = jjournal.decode_record(record)  # the reference's verifier accepts the frame
    assert manifest["align"] == 16 and len(payload) == plen and len(record) == journal._HEADER.size + mlen + plen


# ------------------------------------------------------------- round trips
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_save_load_bit_exact(family, tmp_path):
    make, data = FAMILIES[family]
    path = str(tmp_path / f"{family}.journal")
    live = make()
    for _ in range(3):
        live.update(*data())
    nbytes = live.save_state(path)
    assert nbytes > 0 and os.path.getsize(path) == nbytes
    fresh = make()
    assert fresh.load_state(path) == 0
    _equal(fresh.compute(), live.compute())
    if isinstance(live, Metric):
        assert fresh.update_count == live.update_count


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_save_crash_load_replay_equals_uninterrupted(family, tmp_path):
    make, data = FAMILIES[family]
    batches = [data() for _ in range(5)]
    path = str(tmp_path / "crash.journal")
    oracle, crashed = make(), make()
    if family == "bootstrap":
        oracle.generator.manual_seed(11)
        crashed.generator.manual_seed(11)
    for b in batches:
        oracle.update(*b)
    for b in batches[:3]:
        crashed.update(*b)
    crashed.save_state(path)
    del crashed
    restored = make()
    restored.load_state(path)
    for b in batches[3:]:
        restored.update(*b)
    _equal(restored.compute(), oracle.compute())


def test_unknown_extra_manifest_keys_round_trip():
    m = tmt.MeanMetric(device="cpu")
    m.update(torch.tensor([2.0, 4.0]))
    extra = {"epoch": 7, "barrier_step": 41, "from_the_future": {"list": [1, 2]}}
    record = journal.pack_record([m], manifest_extra=extra)
    manifest, payload = journal.decode_record(record)
    for key, value in extra.items():
        assert manifest[key] == value
    shadowing = journal.pack_record([m], manifest_extra={"entries": [], "epoch": 1})
    assert journal.decode_record(shadowing)[0]["entries"]
    fresh = tmt.MeanMetric(device="cpu")
    journal.restore_nodes([fresh], manifest, payload)
    _equal(fresh.compute(), m.compute())
    torn = bytearray(record)
    torn[journal._HEADER.size + 2] ^= 0xFF
    with pytest.raises(JournalFault, match="checksum"):
        journal.decode_record(bytes(torn))
    with pytest.raises(JournalFault, match="version"):
        journal.decode_record(record[:4] + struct.pack("<I", 99) + record[8:])
    with pytest.raises(JournalFault, match="magic"):
        journal.decode_record(b"XXXX" + record[4:])


def test_compute_group_collection_round_trip(tmp_path):
    path = str(tmp_path / "groups.journal")
    live = headline_suite(tmt)
    for preds, target in suite_batches(4, 3):
        live.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert any(len(g) > 1 for g in live.compute_groups.values())
    live.save_state(path)
    fresh = headline_suite(tmt)
    preds, target = suite_batches(9, 1)[0]
    fresh.update(torch.from_numpy(preds), torch.from_numpy(target))  # groups formed, other data
    fresh.load_state(path)
    _equal(fresh.compute(), live.compute())
    more = suite_batches(5, 1)[0]
    for s in (fresh, live):
        s.update(*map(torch.from_numpy, more))
    _equal(fresh.compute(), live.compute())


class _SpecNoneList(Metric):
    full_state_update = True

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("rows", [], dist_reduce_fx=None)

    def update(self, x):
        self.rows.append(x)

    def compute(self):
        return self.rows[0]


@pytest.mark.parametrize("case", ["non_cat_list", "not_a_tensor"])
def test_unjournalable_trees_decline_classified(case, tmp_path):
    if case == "non_cat_list":
        m = _SpecNoneList()
        m.update(torch.tensor([1.0]))
        match = "non-'cat' list state"
    else:
        m = tmt.SumMetric(device="cpu")
        m.value = 3.0
        match = "non-array leaf"
    assert journal.journalable([m]) is not None
    with pytest.raises(JournalFault, match=match):
        m.save_state(str(tmp_path / "x.journal"))


# --------------------------------------------------------------- corruption
def _two_generations(tmp_path):
    path = str(tmp_path / "m.journal")
    x1, x2 = torch.tensor([1.0, 3.0]), torch.tensor([100.0])
    m = tmt.MeanMetric(device="cpu")
    m.update(x1)
    m.save_state(path)  # generation 1 after the next save
    m.update(x2)
    m.save_state(path)  # generation 0
    oracle = tmt.MeanMetric(device="cpu")
    oracle.update(x1)
    return path, oracle


def _flip(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))


def _truncate(path):
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])


def _garbage(path):
    open(path, "wb").write(b"garbage")


@pytest.mark.parametrize("corrupt", ["flipped_byte", "truncated", "load_fault"])
def test_bad_newest_generation_demotes_to_the_previous(corrupt, tmp_path):
    path, oracle = _two_generations(tmp_path)
    if corrupt == "flipped_byte":
        _flip(path)
    elif corrupt == "truncated":
        _truncate(path)
    before = telemetry.snapshot()
    fresh = tmt.MeanMetric(device="cpu")
    with faults.inject_faults("journal-load") if corrupt == "load_fault" else _nothing():
        with pytest.warns(UserWarning, match="demoting to the previous good generation"):
            assert fresh.load_state(path) == 1
    after = telemetry.snapshot()
    assert after["fault_journal"] - before["fault_journal"] == 1
    assert after["journal_load_demotions"] - before["journal_load_demotions"] == 1
    assert after["journal_loads"] - before["journal_loads"] == 1
    _equal(fresh.compute(), oracle.compute())


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("case", ["every_generation_corrupt", "missing_path", "smaller_suite", "layout_mismatch"])
def test_failed_loads_raise_classified_and_leave_the_state(case, tmp_path):
    if case == "every_generation_corrupt":
        path, _ = _two_generations(tmp_path)
        for p in (path, path + ".g1"):
            _garbage(p)
        live = tmt.MeanMetric(device="cpu")
        live.update(torch.tensor([7.0]))
    elif case == "missing_path":
        path = str(tmp_path / "never-written.journal")
        live = tmt.MeanMetric(device="cpu")
    elif case == "smaller_suite":
        path = str(tmp_path / "small.journal")
        small = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu")})
        small.update(torch.tensor([2.0]))
        small.save_state(path)
        live = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "sum": tmt.SumMetric(device="cpu")})
        live.update(torch.tensor([7.0]))
    else:
        path = str(tmp_path / "mean.journal")
        m = tmt.MeanMetric(device="cpu")
        m.update(torch.tensor([2.0]))
        m.save_state(path)
        live = tmt.Accuracy(device="cpu")
        live.update(*_batch())
    members = live._journal_nodes() if isinstance(live, tmt.MetricCollection) else [live]
    before = [{k: v for k, v in n.metric_state.items()} for n in members]
    counts = [n.update_count for n in members]
    if case == "missing_path":
        with pytest.raises(JournalFault, match="no journal record"):
            live.load_state(path)
    else:
        with pytest.warns(UserWarning, match="demoting"):
            with pytest.raises(JournalFault):
                live.load_state(path)
    for n, state, count in zip(members, before, counts):
        assert n.update_count == count
        for k, v in n.metric_state.items():
            assert v is state[k]  # untouched: the very same tensors


# ------------------------------------------------------- ring and atomicity
def test_generation_ring_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("METRICS_TPU_JOURNAL_GENERATIONS", "3")
    path = str(tmp_path / "m.journal")
    m = tmt.MeanMetric(device="cpu")
    for i in range(6):
        m.update(torch.tensor([float(i)]))
        m.save_state(path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.journal", "m.journal.g1", "m.journal.g2"]
    for gen, n_updates in ((0, 6), (1, 5), (2, 4)):
        fresh = tmt.MeanMetric(device="cpu")
        manifest, payload = journal.read_record(journal._gen_path(path, gen))
        journal.restore_nodes([fresh], manifest, payload)
        assert fresh.update_count == n_updates


def test_injected_write_fault_leaves_ring_byte_identical(tmp_path):
    path = str(tmp_path / "m.journal")
    m = tmt.MeanMetric(device="cpu")
    m.update(torch.tensor([1.0]))
    m.save_state(path)
    ring_before = open(path, "rb").read()
    m.update(torch.tensor([2.0]))
    with faults.inject_faults("journal-write") as plan:
        with pytest.raises(JournalFault):
            m.save_state(path)
    assert plan.fired == 1
    assert open(path, "rb").read() == ring_before
    assert not os.path.exists(path + ".g1") and not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("api", ["update", "forward"])
def test_collection_journal_hook_every_n(api, tmp_path):
    path = str(tmp_path / "suite.journal")
    make = lambda: tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "sum": tmt.SumMetric(device="cpu")})  # noqa: E731
    coll = make()
    coll.journal(path, every_n=3)
    step = coll.update if api == "update" else coll
    x = torch.tensor([1.0, 2.0])
    for _ in range(2):
        step(x)
    assert not os.path.exists(path)
    step(x)
    assert os.path.exists(path)
    oracle3 = coll.compute()
    for _ in range(3):
        step(x)
    fresh = make()
    fresh.load_state(path)
    _equal(fresh.compute(), coll.compute())
    prev = make()
    manifest, payload = journal.read_record(path + ".g1")
    journal.restore_nodes(prev._journal_nodes(), manifest, payload)
    _equal(prev.compute(), oracle3)
    coll.journal(None)
    step(x)
    assert not os.path.exists(path + ".g2")
    with pytest.raises(ValueError, match="every_n"):
        coll.journal(path, every_n=0)


def test_journal_hook_write_fault_degrades_without_breaking_updates(tmp_path):
    faults.set_recovery_policy(steps=2)
    try:
        path = str(tmp_path / "suite.journal")
        coll = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu")})
        coll.journal(path, every_n=1)
        x = torch.tensor([4.0])
        coll.update(x)
        before = telemetry.snapshot()
        with faults.inject_faults("journal-write", count=1) as plan:
            with pytest.warns(UserWarning, match="journaling failed"):
                coll.update(x)  # must not raise
        assert plan.fired == 1
        after = telemetry.snapshot()
        assert after["fault_journal"] - before["fault_journal"] == 1  # counted once, where it was raised
        lad = coll.__dict__["_fault_ladders"]["journal"]
        assert lad.demoted
        for _ in range(2):
            coll.update(x)
            coll.compute()
        assert not lad.demoted
        coll.update(x)  # journaling resumed
        fresh = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu")})
        fresh.load_state(path)
        _equal(fresh.compute(), coll.compute())
    finally:
        faults.set_recovery_policy(steps=8)


def test_journal_counters_and_spans(tmp_path):
    telemetry.set_telemetry(True)
    path = str(tmp_path / "m.journal")
    before = journal.journal_stats()
    m = tmt.SumMetric(device="cpu")
    m.update(torch.tensor([1.0]))
    n = m.save_state(path)
    tmt.SumMetric(device="cpu").load_state(path)
    after = journal.journal_stats()
    assert after["journal_saves"] - before["journal_saves"] == 1
    assert after["journal_loads"] - before["journal_loads"] == 1
    assert after["journal_bytes_written"] - before["journal_bytes_written"] == n
    sites = [r["site"] for r in telemetry.spans()[-2:]]
    assert sites == ["journal-save", "journal-load"]


# ------------------------------------------------------------ port extras
def test_restored_bootstrapper_draws_what_the_uninterrupted_one_draws(tmp_path):
    path = str(tmp_path / "boot.journal")
    batches = [_batch(24) for _ in range(8)]
    for strategy in ("poisson", "multinomial"):
        make = lambda: tmt.BootStrapper(tmt.MeanSquaredError(device="cpu"), num_bootstraps=5,  # noqa: E731
                                        sampling_strategy=strategy, raw=True)
        oracle, first = make(), make()
        oracle.generator.manual_seed(5)
        first.generator.manual_seed(5)
        for b in batches:
            oracle.update(*b)
        for b in batches[:3]:
            first.update(*b)
        first.save_state(path)
        restored = make()  # a generator seeded at random
        restored.load_state(path)
        for b in batches[3:]:
            restored.update(*b)
        _equal(restored.compute(), oracle.compute())


def test_bootstrapper_record_on_another_device_type_keeps_its_draws(tmp_path):
    m = tmt.BootStrapper(tmt.MeanMetric(device="cpu"), num_bootstraps=2)
    m.update(torch.tensor([1.0, 2.0]))
    extra = m._journal_extra()
    extra["generator_device"] = "cuda"
    state = m.generator.get_state()
    with pytest.warns(UserWarning, match="continue from its own generator"):
        m._journal_restore_extra(extra)
    assert torch.equal(m.generator.get_state(), state)


def _tracker_batches():
    rng = np.random.RandomState(17)
    def batch():
        p = rng.rand(12, 3).astype(np.float32)
        return p / p.sum(1, keepdims=True), rng.randint(0, 3, 12)

    return [[batch() for _ in range(2)] for _ in range(4)]


@pytest.mark.parametrize("tracked", ["metric", "collection"])
def test_tracker_packed_history_equals_the_reference(tracked, monkeypatch):
    """The packed history against JAX's (Accuracy bit for bit; AUROC's float32
    areas within atol 1e-6, summed in another order) and against the port's own
    copy-per-step history bit for bit."""

    def make(pkg):
        dev = {"device": "cpu"} if pkg is tmt else {}
        if tracked == "metric":
            return pkg.MetricTracker(pkg.Accuracy(num_classes=3, average="macro", **dev), maximize=True)
        return pkg.MetricTracker(pkg.MetricCollection({"acc": pkg.Accuracy(num_classes=3, **dev),
                                                        "auroc": pkg.AUROC(num_classes=3, **dev)}),
                                 maximize=[True, True])

    def run(tracker, to_tensor):
        for epoch in _tracker_batches():
            tracker.increment()
            for preds, target in epoch:
                tracker.update(to_tensor(preds), to_tensor(target))
        return tracker

    mine, ref = run(make(tmt), torch.from_numpy), run(make(jmt), jnp.asarray)
    with monkeypatch.context() as mp:
        mp.setattr(journal, "journalable", lambda nodes: "copies")
        copies = run(make(tmt), torch.from_numpy)
    assert mine._packed_mode and ref._packed_mode and copies._packed_mode is False
    assert sum(isinstance(e, bytes) for e in mine._history) == 3
    got, want, copied = mine.compute_all(), ref.compute_all(), copies.compute_all()
    if tracked == "metric":
        got, want, copied = {"acc": got}, {"acc": want}, {"acc": copied}
    for k in want:
        assert torch.equal(got[k], copied[k])
        if k == "acc":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
    assert mine.best_metric(return_step=True) == copies.best_metric(return_step=True)
    mine.reset_all()
    assert all(e == mine._pristine for e in mine._history[:-1])


def test_tracker_falls_back_to_copies_for_an_unjournalable_tree():
    tracker = tmt.MetricTracker(_SpecNoneList(), maximize=True)
    tracker.increment()
    tracker.update(torch.tensor([1.0]))
    tracker.increment()
    tracker.update(torch.tensor([2.0]))
    assert tracker._packed_mode is False and not any(isinstance(e, bytes) for e in tracker._history)
    _equal(tracker.compute_all(), torch.tensor([1.0, 2.0]))


def test_raw_record_round_trip():
    arrays = {"a": torch.arange(5, dtype=torch.int16), "b": torch.rand(3, 2, dtype=torch.float64),
              "c": torch.tensor([True, False, True]), "d": np.arange(7, dtype=np.int64),
              "e": torch.randn(4).to(torch.bfloat16)}
    manifest, payload = journal.decode_record(journal.pack_raw_record(arrays, {"slab": 3}))
    assert manifest["slab"] == 3 and manifest["raw"]
    out = journal.unpack_raw_record(manifest, payload)
    for name, value in arrays.items():
        _equal(out[name], torch.as_tensor(value))
    with pytest.raises(JournalFault, match="raw"):
        journal.unpack_raw_record({"entries": []}, b"")
    bad = dict(manifest, entries=manifest["entries"][:-1])
    with pytest.raises(JournalFault, match="unclaimed"):
        journal.unpack_raw_record(bad, payload)
