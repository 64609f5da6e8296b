"""The port's failure domains (``metrics_tpu_torch/ops/faults.py``) against the JAX package's.

The same exceptions classify to the same domains; the same demote, clean and
promote sequence leaves equal ``Ladder`` states, thresholds and histories;
the same ``METRICS_TPU_FAULTS`` string fires the same classified exceptions
at the same sites and indices; the failure logs hold equal entries apart
from their step stamps. Then the JAX package's own ladder and fault-counter
scenarios (``tests/bases/test_fault_injection.py`` ``TestLadderStateMachine``
and ``TestTelemetry``) as cases of parametrised tests, and the warn-once,
reset and retry contracts. Everything here is exact: states, counts and
strings compare with ``==``.
"""
import builtins

import jax
import jax._src.core
import pytest

from metrics_tpu.ops import faults as jfaults
from metrics_tpu.utils import exceptions as jexc
from metrics_tpu_torch.ops import faults, telemetry
from metrics_tpu_torch.utils import exceptions as texc


@pytest.fixture(autouse=True)
def _reference_runs(monkeypatch):
    """jax 0.9 no longer exports ``jax.core.trace_state_clean``, which the JAX
    package's engine calls; this test's copy of it lets the reference run."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    for pkg in (faults, jfaults):
        pkg.set_recovery_policy(steps=3, max_exponent=6)
    yield
    for pkg in (faults, jfaults):
        pkg.set_recovery_policy(steps=8, max_exponent=6)


# ----------------------------------------------------------------- classify
CLASSIFY_CASES = [
    ("RuntimeFault", "x", "runtime"),
    ("TraceFault", "x", "trace"),
    ("CompileFault", "x", "runtime"),
    ("DonationFault", "x", "runtime"),
    ("HostOffloadFault", "x", "runtime"),
    ("SyncFault", "x", "runtime"),
    ("SyncConfigFault", "x", "runtime"),
    ("SyncTimeoutFault", "x", "runtime"),
    ("EpochFault", "x", "runtime"),
    ("IngestFault", "x", "runtime"),
    ("JournalFault", "x", "runtime"),
    ("ValueError", "boom", "runtime"),
    ("ValueError", "boom", "journal"),
    ("RuntimeError", "XLA compilation failure", "runtime"),
    ("RuntimeError", "RESOURCE_EXHAUSTED: out of memory", "runtime"),
    ("RuntimeError", "CUDA out of memory. Tried to allocate 2.00 GiB", "sync"),
    ("RuntimeError", "buffer has been deleted or donated", "runtime"),
    ("RuntimeError", "abstract value passed", "runtime"),
    ("TimeoutError", "peer hung", "runtime"),
    ("OSError", "disk full", "journal"),
    ("OSError", "disk full", "host"),
    ("OSError", "disk full", "runtime"),
    ("FileNotFoundError", "gone", "sync"),
    ("KeyError", "k", "no-such-domain"),
]


def _make(pkg_exc, name, msg):
    return (getattr(pkg_exc, name, None) or getattr(builtins, name))(msg)


@pytest.mark.parametrize("name, msg, default", CLASSIFY_CASES)
def test_classify_gives_the_reference_domain(name, msg, default):
    want = jfaults.classify(_make(jexc, name, msg), default)
    got = faults.classify(_make(texc, name, msg), default)
    assert got == want


def test_taxonomy_matches_the_reference():
    assert texc.FAULT_DOMAINS == jexc.FAULT_DOMAINS
    for name in jexc.__all__:
        if name in ("FAULT_DOMAINS", "MetricsUserError"):
            continue
        mine, ref = getattr(texc, name), getattr(jexc, name)
        assert (mine.domain, mine.recoverable) == (ref.domain, ref.recoverable), name
        assert [b.__name__ for b in mine.__mro__] == [b.__name__ for b in ref.__mro__], name
    assert faults.FAULT_SITES == jfaults.FAULT_SITES and len(faults.FAULT_SITES) == 15
    assert faults.TIERS == jfaults.TIERS
    for site in faults.FAULT_SITES:
        assert faults._site_exc(site, None).__name__ == jfaults._site_exc(site, None).__name__


# ------------------------------------------------------------------- ladder
def _ladder_state(lad):
    return (lad.lane, lad.tier, lad.domain, lad.failures, lad.clean, lad.threshold, list(lad.history),
            lad.demoted, lad.recoverable)


LADDER_SEQUENCES = {
    "demote_clean_promote": [("demote", "runtime", "eager")] + [("clean",)] * 3 + [("promote",),
                             ("demote", "runtime", "eager"), ("clean",)],
    "backoff_doubles_to_its_cap": [("demote", "compile", "chunked"), ("promote",)] * 9 + [("clean",)] * 5,
    "trace_never_recovers": [("demote", "trace", "eager")] + [("clean",)] * 40,
    "unknown_tier_lands_on_eager": [("demote", "sync", "nowhere"), ("clean",), ("clean",)],
    "history_is_bounded": [("demote", "donation", "host"), ("promote",)] * 20,
}


@pytest.mark.parametrize("sequence", sorted(LADDER_SEQUENCES))
def test_ladder_sequence_matches_the_reference(sequence):
    mine, ref = faults.Ladder("sync-pack"), jfaults.Ladder("sync-pack")
    assert _ladder_state(mine) == _ladder_state(ref)
    for step in LADDER_SEQUENCES[sequence]:
        if step[0] == "demote":
            mine.demote(step[1], to=step[2])
            ref.demote(step[1], to=step[2])
        elif step[0] == "clean":
            assert mine.note_clean() == ref.note_clean()
        else:
            mine.promote()
            ref.promote()
        assert _ladder_state(mine) == _ladder_state(ref)


def test_recovery_steps_zero_matches_the_reference():
    for pkg in (faults, jfaults):
        pkg.set_recovery_policy(steps=0)
    mine, ref = faults.Ladder("update"), jfaults.Ladder("update")
    mine.demote("runtime")
    ref.demote("runtime")
    assert _ladder_state(mine) == _ladder_state(ref)
    assert not mine.recoverable and not mine.note_clean()


class _Owner:
    pass


def test_demote_counts_warns_once_and_logs_like_the_reference():
    logs = {}
    for pkg, exc_mod in ((faults, texc), (jfaults, jexc)):
        pkg.clear_fault_state()
        owner = _Owner()
        with pytest.warns(UserWarning, match="fell over"):
            assert pkg.demote(owner, "journal", exc_mod.JournalFault("disk"), site="journal-write",
                              warn="the journal fell over") == "journal"
        pkg.demote(owner, "journal", OSError("again"), default_domain="journal", warn="the journal fell over")
        pkg.demote(owner, "sync-pack", RuntimeError("x"), count=False)
        stats = pkg.fault_stats()
        log = stats.pop("failure_log")
        logs[pkg.__name__] = ([{k: v for k, v in e.items() if k != "step"} for e in log],
                              [e["step"] - log[0]["step"] for e in log], stats,
                              {lane: _ladder_state(lad) for lane, lad in owner._fault_ladders.items()})
    assert logs["metrics_tpu_torch.ops.faults"] == logs["metrics_tpu.ops.faults"]


# ---------------------------------------------------------------- injection
ENV_PLANS = [
    "sync-pack:2,journal-write:1:sync, ,bad",
    "flush-chunk-2:1,flush-chunk:2,probe",
    "journal-load:3:ingest,sync-gather::runtime,epoch-fence:x",
]
CALLS = [("sync-pack", None), ("journal-write", None), ("sync-pack", None), ("sync-pack", None),
         ("flush-chunk", 1), ("flush-chunk", 2), ("flush-chunk", 2), ("flush-chunk", 3), ("probe", None),
         ("journal-load", None), ("journal-load", None), ("sync-gather", None), ("epoch-fence", None),
         ("bad", None), ("journal-load", None), ("journal-load", None)]


def _fire(pkg, monkeypatch, spec):
    monkeypatch.setenv("METRICS_TPU_FAULTS", spec)
    saved = {site: list(stack) for site, stack in pkg._plans.items()}
    pkg._plans.clear()
    try:
        pkg._env_plans()
        out = [pkg.armed]
        for site, index in CALLS:
            try:
                pkg.maybe_fail(site, index=index)
                out.append(None)
            except Exception as exc:  # noqa: BLE001 - the classified injection is the value
                out.append((type(exc).__name__, exc.site, exc.domain, str(exc)))
        return out
    finally:
        pkg._plans.clear()
        pkg._plans.update(saved)
        pkg._rearm()


@pytest.mark.parametrize("spec", ENV_PLANS)
def test_env_plans_fire_like_the_reference(spec, monkeypatch):
    assert _fire(faults, monkeypatch, spec) == _fire(jfaults, monkeypatch, spec)


def test_env_hook_parses_plans(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_FAULTS", "sync-pack:2,sync-gather:1:sync, ,bad")
    before = {site: list(stack) for site, stack in faults._plans.items()}
    try:
        faults._env_plans()
        assert faults.armed
        assert any(p.remaining == 2 for p in faults._plans["sync-pack"])
        assert any(p.exc_type is texc.SyncFault for p in faults._plans["sync-gather"])
    finally:
        faults._plans.clear()
        faults._plans.update(before)
        faults._rearm()


@pytest.mark.parametrize("case", ["indexed_site", "exhausted_plan", "nested_plans", "domain_override"])
def test_injection_contract(case):
    if case == "indexed_site":
        with faults.inject_faults("flush-chunk-2") as plan:
            with pytest.raises(texc.RuntimeFault) as ei:
                faults.maybe_fail("flush-chunk", index=2)
        assert plan.fired == 1 and ei.value.site == "flush-chunk-2" and ei.value.domain == "runtime"
        with faults.inject_faults("flush-chunk-3"):
            faults.maybe_fail("flush-chunk", index=1)  # another index does not fire
    elif case == "exhausted_plan":
        with faults.inject_faults("sync-pack", count=1) as plan:
            with pytest.raises(texc.RuntimeFault):
                faults.maybe_fail("sync-pack")
            faults.maybe_fail("sync-pack")  # budget spent: no-op
        assert plan.fired == 1
        assert not faults.armed
    elif case == "nested_plans":
        with faults.inject_faults("journal-write") as outer:
            with faults.inject_faults("journal-write", count=2) as inner:
                for _ in range(3):
                    with pytest.raises(texc.JournalFault):
                        faults.maybe_fail("journal-write")
                faults.maybe_fail("journal-write")
            assert faults.armed
        assert (outer.fired, inner.fired) == (1, 2) and not faults.armed
    else:
        with faults.inject_faults("journal-load", domain="sync", message="custom") as plan:
            with pytest.raises(texc.SyncFault, match="custom"):
                faults.maybe_fail("journal-load")
        assert plan.fired == 1


# ------------------------------------------------------------------ counters
@pytest.mark.parametrize("case", ["fault_surface", "failure_log_bounded", "unknown_domain_counts_runtime"])
def test_fault_counters(case):
    faults.clear_fault_state()
    if case == "fault_surface":
        stats = faults.fault_stats()
        for domain in texc.FAULT_DOMAINS:
            assert isinstance(stats[f"fault_{domain}"], int)
        for key in ("fault_demotions", "fault_promotions", "fault_injected"):
            assert isinstance(stats[key], int)
        assert isinstance(stats["failure_log"], list)
        assert set(stats) == set(jfaults.fault_stats())
    elif case == "failure_log_bounded":
        for i in range(200):
            faults.note_fault("runtime", site=f"s{i}")
        log = faults.fault_stats()["failure_log"]
        assert len(log) == 64
        assert log[-1]["site"] == "s199"  # newest last, oldest evicted
        steps = [e["step"] for e in log]
        assert steps == sorted(steps) and len(set(steps)) == 64
    else:
        faults.note_fault("no-such-domain", site="x")
        assert faults.fault_stats()["fault_runtime"] == 1


def test_monotonic_step_survives_resets_and_stamps_spans():
    step = faults.tick()
    assert faults.current_step() == step
    telemetry.reset_all(reset_warnings=True)
    assert faults.current_step() == step
    was = telemetry.armed
    telemetry.set_telemetry(True)
    try:
        faults.note_fault("sync", site="sync")
        assert telemetry.spans()[-1]["site"] == "fault"
        assert telemetry.spans()[-1]["step"] == faults.current_step() == step + 1
    finally:
        telemetry.set_telemetry(was)


def test_warn_fault_once_per_owner_and_domain_until_reset():
    owner = _Owner()
    with pytest.warns(UserWarning, match="first"):
        assert faults.warn_fault(owner, "sync", "first")
    assert not faults.warn_fault(owner, "sync", "again")
    with pytest.warns(UserWarning, match="other domain"):
        assert faults.warn_fault(owner, "journal", "other domain")
    telemetry.reset_all()  # a counter reset keeps the markers
    assert not faults.warn_fault(owner, "sync", "again")
    telemetry.reset_all(reset_warnings=True)
    with pytest.warns(UserWarning, match="re-armed"):
        assert faults.warn_fault(owner, "sync", "re-armed")


def test_retry_with_backoff_like_the_reference():
    for pkg, exc_mod in ((faults, texc), (jfaults, jexc)):
        pkg.clear_fault_state()
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient")
            return "ok"

        assert pkg.retry_with_backoff(flaky, attempts=2, base_delay_s=0.0) == "ok"
        assert pkg.fault_stats()["fault_sync"] == 2
        with pytest.raises(exc_mod.SyncFault, match="after 2 attempt"):
            pkg.retry_with_backoff(lambda: 1 / 0, attempts=1, base_delay_s=0.0)
        with pytest.raises(exc_mod.EpochFault):
            pkg.retry_with_backoff(lambda: (_ for _ in ()).throw(exc_mod.EpochFault("stale")), attempts=5,
                                   base_delay_s=0.0)


def test_instrumented_sites_are_reference_sites_and_fire():
    """Every site the port instruments is one of JAX's, and a plan armed there fires on the port's path."""
    import torch

    import metrics_tpu_torch as tmt
    from metrics_tpu_torch.parallel import sync as psync

    assert set(faults.INSTRUMENTED_SITES) <= set(jfaults.FAULT_SITES)
    assert {"epoch-fence", "host-offload"} <= set(faults.INSTRUMENTED_SITES)

    def sync_once():
        m = tmt.SumMetric(device="cpu")
        m.update(torch.tensor([1.0]))
        m.sync(distributed_available=lambda: True)

    def offload_once():
        tmt.CatMetric(compute_on_cpu=True, device="cpu").update(torch.tensor([1.0]))

    def journal_once(tmp):
        m = tmt.SumMetric(device="cpu")
        m.update(torch.tensor([1.0]))
        path = tmp + "/j"
        m.save_state(path)
        m.load_state(path)

    def flush_once():
        from metrics_tpu_torch.ops import engine
        from metrics_tpu_torch.utils import checks

        mode = checks._get_validation_mode()
        checks.set_validation_mode("first")
        try:
            engine.reset_engine()  # a cache miss, where "compile" fires
            m = tmt.SumMetric(device="cpu")
            for _ in range(3):
                m.update(torch.tensor([1.0]))
            m.compute()
        finally:
            checks.set_validation_mode(mode)

    import tempfile
    import warnings

    def ingest_once():
        gw = tmt.IngestGateway(tmt.SumMetric(device="cpu"), auto_flush=False)
        gw.offer(torch.ones(2))
        gw.flush()
        gw.close()

    paths = {"sync-gather": sync_once, "sync-pack": sync_once, "epoch-fence": sync_once,
             "host-offload": offload_once, "compile": flush_once, "flush-chunk": flush_once,
             "ingest-admit": ingest_once, "ingest-shed": ingest_once}
    with tempfile.TemporaryDirectory() as tmp:
        paths.update({"journal-write": lambda: journal_once(tmp), "journal-load": lambda: journal_once(tmp)})
        for site in faults.INSTRUMENTED_SITES:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with faults.inject_faults(site, count=1) as plan:
                    try:
                        paths[site]()
                    except Exception:  # noqa: BLE001 - a site that raises through is fine: it fired
                        pass
            assert plan.fired == 1, site
    psync.reset_membership()
