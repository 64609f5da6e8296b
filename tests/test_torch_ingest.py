"""The port's ingestion gateway (``metrics_tpu_torch/ingest.py``) against the JAX package's.

The same payloads, made from a seed, are offered to both packages' gateways
over an arena, a Mapping of suites and a bare metric: every outcome (staged,
coalesced under the degraded tier, shed, quarantined), the occurrence split of
duplicate tenant ids, priority eviction, schema pinning, NaN storms, the
settlement identity ``offered == admitted + coalesced + shed + quarantined``
after a drain, the two fault sites ``ingest-admit`` and ``ingest-shed``, and
the knobs. Settlements and counters are compared exactly, arena values within
atol 1e-6 and rtol 1e-5.
"""
import warnings

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jmt
import metrics_tpu_torch as tmt
from metrics_tpu import ingest as jingest
from metrics_tpu.arena import MetricArena as JArena
from metrics_tpu.ops import engine as jengine
from metrics_tpu.ops import faults as jfaults
from metrics_tpu_torch import ingest
from metrics_tpu_torch.ops import engine, faults

ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX engine calls; this file's
    copy of it lets the reference run. Counters start at zero; shed and quarantine warnings are the
    point of several tests and are silenced."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    engine.reset_stats()
    jengine.reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def arenas(tenants=6):
    mine = tmt.MetricArena(tmt.MeanMetric(device="cpu"), capacity=tenants, slab=4, name="gw_t")
    ref = JArena(jmt.MeanMetric(), capacity=tenants, slab=4, name="gw_j")
    assert mine.add(tenants) == ref.add(tenants)
    return mine, ref


def outcome(out):
    return {k: out[k] for k in ("outcome", "rows")}


def offer_both(gws, *cols, **kw):
    mine = gws[0].offer(*cols, **kw)
    ref = gws[1].offer(*cols, **kw)
    assert outcome(mine) == outcome(ref)
    return mine["outcome"]


def settled(stats):
    return stats["ingest_admitted_rows"] + stats["ingest_coalesced_rows"] + stats["ingest_shed_rows"] + \
        stats["ingest_quarantined_rows"]


def assert_same_books():
    stats, jstats = ingest.ingest_stats(), jingest.ingest_stats()
    assert stats == jstats
    return stats


def arena_values(mine, ref):
    np.testing.assert_allclose(mine.compute().numpy(), np.asarray(ref.compute()), atol=ATOL, rtol=RTOL)


def test_arena_payloads_stage_flush_and_split_duplicates():
    mine, ref = arenas()
    gws = (tmt.IngestGateway(mine, auto_flush=False, name="a"), jmt.IngestGateway(ref, auto_flush=False, name="a"))
    rng = np.random.RandomState(0)
    ids = np.asarray([0, 1, 1, 5, 1, 0])  # tenant 1 three times: three occurrence ranks
    x = rng.rand(6, 2).astype(np.float32)
    assert offer_both(gws, x, tenant_ids=ids) == "staged"
    assert offer_both(gws, rng.rand(2, 2).astype(np.float32), tenant_ids=[2, 3]) == "staged"
    out, jout = gws[0].flush(), gws[1].flush()
    assert out == jout == {"dispatches": 4, "rows": 8}
    arena_values(mine, ref)
    stats = assert_same_books()
    assert stats["ingest_offered_rows"] == settled(stats) == 8
    assert gws[0].state() == gws[1].state()


def test_every_outcome_and_the_identity(monkeypatch):
    mine, ref = arenas()
    gws = (tmt.IngestGateway(mine, auto_flush=False, max_rows=8, quarantine_cap=2, name="b"),
           jmt.IngestGateway(ref, auto_flush=False, max_rows=8, quarantine_cap=2, name="b"))
    rng = np.random.RandomState(1)

    def rows(n):
        return rng.rand(n, 1).astype(np.float32)

    assert offer_both(gws, rows(3), tenant_ids=[0, 1, 2]) == "staged"
    assert offer_both(gws, rows(3), tenant_ids=[0, 1, 2], priority=2) == "staged"
    # over the watermark: the priority-0 payload is evicted for a priority-1 arrival
    assert offer_both(gws, rows(4), tenant_ids=[2, 3, 4, 5], priority=1) == "staged"
    assert offer_both(gws, rows(4), tenant_ids=[2, 3, 4, 5]) == "shed"
    # poison: a schema mismatch, a NaN storm, a ragged payload, an arena payload without ids
    assert offer_both(gws, rows(2).astype(np.float64), tenant_ids=[0, 1]) == "quarantined"
    assert offer_both(gws, np.full((2, 1), np.nan, np.float32), tenant_ids=[0, 1]) == "quarantined"
    assert offer_both(gws, rows(2), np.zeros(3), tenant_ids=[0, 1]) == "quarantined"
    assert offer_both(gws, rows(2)) == "quarantined"
    assert len(gws[0].quarantined()) == len(gws[1].quarantined()) == 2
    # the degraded tier: a new SLO violation demotes the lane, and same-schema arena offers coalesce
    seen = [0]
    monkeypatch.setattr(ingest._telemetry, "slo_violations", lambda: {"total": seen[0]})
    monkeypatch.setattr(jingest._telemetry, "slo_violations", lambda: {"total": seen[0]})
    seen[0] = 1
    assert offer_both(gws, rows(1), tenant_ids=[5], priority=2) == "coalesced"
    assert gws[0].degraded and gws[1].degraded
    assert gws[0].flush() == gws[1].flush()
    arena_values(mine, ref)
    for gw in gws:
        gw.offer(rows(1), tenant_ids=[1])
        gw.close()
    assert offer_both(gws, rows(1), tenant_ids=[1]) == "shed"  # closed
    stats = assert_same_books()
    assert stats["ingest_offered_rows"] == settled(stats)
    for key in ("ingest_admitted_rows", "ingest_coalesced_rows", "ingest_shed_rows", "ingest_quarantined_rows"):
        assert stats[key] > 0, key
    assert stats["ingest_quarantine_evictions"] == 2


def test_mapping_and_metric_targets():
    suites = {"m": tmt.MeanMetric(device="cpu"), "s": tmt.SumMetric(device="cpu")}
    jsuites = {"m": jmt.MeanMetric(), "s": jmt.SumMetric()}
    gws = (tmt.IngestGateway(suites, flush_rows=4, name="c"), jmt.IngestGateway(jsuites, flush_rows=4, name="c"))
    rng = np.random.RandomState(2)
    for route in ("m", "s", "m", "s", "m"):
        assert offer_both(gws, rng.rand(3).astype(np.float32), route=route) in ("staged",)
    assert offer_both(gws, rng.rand(3).astype(np.float32), route="x") == "quarantined"
    assert offer_both(gws, np.ones(2, np.float32), route="m", tenant_ids=[0, 1]) == "quarantined"
    gws[0].flush()
    gws[1].flush()
    for k in suites:
        np.testing.assert_allclose(float(suites[k].compute()), float(jsuites[k].compute()), rtol=RTOL)
    single = (tmt.SumMetric(device="cpu"), jmt.SumMetric())
    sgws = (tmt.IngestGateway(single[0], name="d"), jmt.IngestGateway(single[1], name="d"))
    assert offer_both(sgws, np.arange(4, dtype=np.float32)) == "staged"
    sgws[0].close()
    sgws[1].close()
    assert_same_books()
    with pytest.raises(TypeError):
        tmt.IngestGateway(object())


@pytest.mark.parametrize("site", ["ingest-admit", "ingest-shed"])
def test_the_fault_sites_settle_and_never_raise(site):
    mine, ref = arenas()
    gws = (tmt.IngestGateway(mine, auto_flush=False, name="e"), jmt.IngestGateway(ref, auto_flush=False, name="e"))
    x = np.ones((2, 1), np.float32)
    for gw, f in zip(gws, (faults, jfaults)):
        with f.inject_faults(site, count=1) as plan:
            gw.offer(x, tenant_ids=[0, 1])
            gw.flush()
        assert plan.fired == 1
    stats = assert_same_books()
    assert stats["ingest_quarantined_rows"] == 2 and stats["ingest_offered_rows"] == settled(stats)
    if site == "ingest-shed":
        assert stats["ingest_apply_faults"] == 1
    assert faults.fault_stats()["fault_ingest"] == jfaults.fault_stats()["fault_ingest"] == 1
    assert {"ingest-admit", "ingest-shed"} <= set(faults.INSTRUMENTED_SITES)


def test_ingest_state_and_snapshot_keys():
    mine, _ = arenas()
    gw = tmt.IngestGateway(mine, auto_flush=False, name="f")
    gw.offer(np.ones((2, 1), np.float32), tenant_ids=[0, 1])
    state = tmt.ingest_state()
    assert state["gateways"]["f"]["staging_rows"] == 2 and state["staging_rows"] >= 2
    assert set(state) == set(jmt.ingest_state())
    assert set(gw.state()) == {"staging_rows", "staging_bytes", "peak_bytes", "staged_payloads", "degraded",
                               "quarantine_depth", "pinned_schemas"}
    snap = tmt.telemetry_snapshot()
    assert snap["ingest_state"]["gateways"]["f"]["staged_payloads"] == 1
    gw.close()


KNOBS = [
    ("METRICS_TPU_INGEST_MAX_ROWS", "_knob_max_rows", ("10", "0", "junk")),
    ("METRICS_TPU_INGEST_MAX_BYTES", "_knob_max_bytes", ("4096", "junk")),
    ("METRICS_TPU_INGEST_FLUSH_ROWS", "_knob_flush_rows", ("7", "junk")),
    ("METRICS_TPU_INGEST_DEGRADED_FACTOR", "_knob_degraded_factor", ("0.25", "5", "0", "junk")),
    ("METRICS_TPU_INGEST_QUARANTINE_CAP", "_knob_quarantine_cap", ("3", "junk")),
    ("METRICS_TPU_INGEST_POISON_NANFRAC", "_knob_poison_nanfrac", ("0.1", "2", "junk")),
]


@pytest.mark.parametrize("env,fn,values", KNOBS, ids=[k[0] for k in KNOBS])
def test_knobs_read_as_the_reference(env, fn, values, monkeypatch):
    for value in values:
        monkeypatch.setenv(env, value)
        assert getattr(ingest, fn)() == getattr(jingest, fn)(), value


def test_tensor_columns_route_to_the_arena_device():
    mine, ref = arenas()
    gw = tmt.IngestGateway(mine, auto_flush=False, name="g")
    jgw = jmt.IngestGateway(ref, auto_flush=False, name="g")
    x = np.random.RandomState(3).rand(4, 2).astype(np.float32)
    for _ in range(2):  # two segments: concatenated at the flush
        gw.offer(torch.from_numpy(x), tenant_ids=torch.tensor([0, 2, 2, 3]))
        jgw.offer(jnp.asarray(x), tenant_ids=np.asarray([0, 2, 2, 3]))
    assert gw.flush() == jgw.flush()
    arena_values(mine, ref)


def test_an_slo_violation_demotes_and_clean_flushes_promote(monkeypatch):
    from metrics_tpu_torch.ops import telemetry

    mine, _ = arenas(8)
    gw = tmt.IngestGateway(mine, name="slo", auto_flush=False, max_rows=64)
    rng = np.random.RandomState(8)
    x = lambda: rng.rand(8, 2).astype(np.float32)  # noqa: E731
    tids = np.arange(8)
    assert gw.offer(x(), tenant_ids=tids)["outcome"] == "staged" and not gw.degraded
    faults.set_recovery_policy(steps=2)
    try:
        monkeypatch.setitem(telemetry._slo_violations, "engine-flush",
                            telemetry._slo_violations.get("engine-flush", 0) + 1)
        assert gw.offer(x(), tenant_ids=tids)["outcome"] == "coalesced"  # demoted in this very offer
        assert gw.degraded and gw.offer(x(), tenant_ids=tids)["outcome"] == "coalesced"
        gw.flush()
        assert gw.degraded  # one clean flush of the two the recovery edge needs
        gw.offer(x(), tenant_ids=tids)
        gw.flush()
        assert not gw.degraded
    finally:
        faults.set_recovery_policy(steps=8)
    stats = ingest.ingest_stats()
    assert stats["ingest_degraded_offers"] >= 2 and stats["ingest_offered_rows"] == settled(stats)


def test_a_collection_target_equals_direct_updates():
    rng = np.random.RandomState(9)
    suite = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "sum": tmt.SumMetric(device="cpu")})
    direct = tmt.MetricCollection({"mean": tmt.MeanMetric(device="cpu"), "sum": tmt.SumMetric(device="cpu")})
    gw = tmt.IngestGateway(suite, flush_rows=16, name="col")
    for _ in range(5):
        x = rng.rand(6).astype(np.float32)
        gw.offer(x)
        direct.update(torch.from_numpy(x))
    assert gw.flush()["rows"] == 12  # the auto-flush took the first 18 rows
    gw.close()
    got, want = suite.compute(), direct.compute()
    assert all(torch.equal(got[k], want[k]) for k in want)
    stats = ingest.ingest_stats()
    assert stats["ingest_shed_rows"] == 0 and stats["ingest_admitted_rows"] == 30 and stats["ingest_flushes"] == 2
