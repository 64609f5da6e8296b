"""Failure domains: classification, degradation ladders, fault injection.

JAX counterpart: `metrics_tpu/ops/faults.py`, with the same names, sites,
counter keys, environment variables and defaults. Every fallback routes
through this module:

- **Classification** (:func:`classify`): maps an exception onto a domain of
  :data:`metrics_tpu_torch.utils.exceptions.FAULT_DOMAINS`. A
  :class:`FaultError` carries its own; other exceptions are read by type and
  message (a ``TimeoutError`` is ``sync``, an ``OSError`` storage or host
  I/O, "out of memory" or "compil..." ``compile``, "donat..."/"deleted"
  ``donation``), else the catching site's default.
- **Degradation ladder** (:class:`Ladder`, :func:`ladder`, :func:`demote`):
  one state machine per owner and lane over the tiers ``fused -> chunked ->
  eager -> host``. A demotion in a recoverable domain earns a recovery
  edge: after :func:`recovery_steps` clean steps
  (``METRICS_TPU_FAULT_RECOVERY_STEPS``, default 8, doubled per repeated
  failure up to ``2**6`` times) the owner re-arms the demoted path. Trace
  demotions never recover.
- **Fault injection** (:func:`inject_faults`, ``METRICS_TPU_FAULTS``): named
  sites fire classified exceptions on demand. When no plan is armed a site
  costs one module-attribute read (:data:`armed`).
- **Counters**: per-domain counts, demotions, promotions and injections, a
  bounded ``failure_log`` (:func:`fault_stats`), and :func:`warn_fault`,
  which warns once per owner and domain.
"""
from __future__ import annotations

import os
import time
import weakref
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.exceptions import (
    FAULT_DOMAINS,
    CompileFault,
    DonationFault,
    EpochFault,
    FaultError,
    HostOffloadFault,
    IngestFault,
    JournalFault,
    RuntimeFault,
    SyncFault,
    TraceFault,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "FAULT_SITES",
    "INSTRUMENTED_SITES",
    "Ladder",
    "TIERS",
    "armed",
    "classify",
    "clear_fault_state",
    "current_step",
    "demote",
    "domain_recoverable",
    "fault_stats",
    "inject_faults",
    "ladder",
    "maybe_fail",
    "note_fault",
    "recovery_steps",
    "reset_warn_dedupe",
    "retry_with_backoff",
    "set_recovery_policy",
    "tick",
    "warn_fault",
]

#: Degradation tiers, best first.
TIERS = ("fused", "chunked", "eager", "host")

#: The named injection sites, as in the JAX package. The port instruments
#: ``sync-pack`` (the entry of the coalesced sync's pack phase, before any
#: collective), ``sync-gather`` (before a gather's collectives),
#: ``epoch-fence`` (the epoch check before each collective),
#: ``host-offload`` (before ``compute_on_cpu`` moves rows to the host),
#: ``journal-write`` (before a record's temporary file is written),
#: ``journal-load`` (before a stored record is read), ``ingest-admit`` (each
#: gateway offer) and ``ingest-shed`` (each staged payload a gateway flushes),
#: all in :data:`INSTRUMENTED_SITES`, the sites a default configuration reaches.
#: ``progcache-load`` and ``progcache-store`` (before an entry is read or
#: written) and ``autotune-sweep`` (before each candidate's check) fire in
#: planes that are off by default (``METRICS_TPU_PROGCACHE``,
#: ``METRICS_TPU_AUTOTUNE``).
FAULT_SITES = (
    "probe",
    "compile",
    "flush-chunk",
    "donation",
    "sync-gather",
    "sync-pack",
    "epoch-fence",
    "host-offload",
    "journal-write",
    "journal-load",
    "progcache-load",
    "progcache-store",
    "ingest-admit",
    "ingest-shed",
    "autotune-sweep",
)

#: ``probe`` is not among them: the JAX package fires it where it traces a
#: program abstractly before licensing it (``jax.eval_shape``), and an eager
#: step has nothing to trace. ``donation`` neither: no eager op consumes its
#: input (``engine.donation_supported()`` is False). ``flush-chunk`` fires
#: before each chunk of a flush, also as ``flush-chunk-<k>`` for chunk k.
INSTRUMENTED_SITES = ("compile", "flush-chunk", "sync-gather", "sync-pack", "epoch-fence", "host-offload",
                      "journal-write", "journal-load", "ingest-admit", "ingest-shed")

_SITE_DEFAULT_EXC = {
    "probe": TraceFault,
    "compile": CompileFault,
    "flush-chunk": RuntimeFault,
    "donation": DonationFault,
    "sync-gather": SyncFault,
    # runtime: recoverable, so the sync-pack ladder earns its recovery edge
    "sync-pack": RuntimeFault,
    "epoch-fence": EpochFault,
    "host-offload": HostOffloadFault,
    "journal-write": JournalFault,
    "journal-load": JournalFault,
    "progcache-load": JournalFault,
    "progcache-store": JournalFault,
    "ingest-admit": IngestFault,
    "ingest-shed": IngestFault,
    "autotune-sweep": RuntimeFault,
}

_DOMAIN_EXC = {
    "trace": TraceFault,
    "compile": CompileFault,
    "runtime": RuntimeFault,
    "donation": DonationFault,
    "host": HostOffloadFault,
    "sync": SyncFault,
    "journal": JournalFault,
    "ingest": IngestFault,
}


# ------------------------------------------------------------- classification
def classify(exc: BaseException, default: str = "runtime") -> str:
    """The failure domain of ``exc``: its own for a :class:`FaultError`, else
    read from its type and message, else ``default`` (the catching site knows
    which stage it was running)."""
    if isinstance(exc, FaultError):
        return exc.domain
    if isinstance(exc, TimeoutError):
        return "sync"
    if isinstance(exc, OSError):
        return default if default in ("journal", "host", "sync") else "journal"
    text = f"{type(exc).__name__}: {exc}".lower()
    if "donat" in text or "deleted" in text or "buffer has been deleted" in text:
        return "donation"
    if "compil" in text or "resource_exhausted" in text or "out of memory" in text:
        return "compile"
    if "tracer" in text or "abstract" in text:
        return "trace"
    return default if default in FAULT_DOMAINS else "runtime"


def domain_recoverable(domain: str) -> bool:
    """Whether a ladder may try again after a failure in ``domain``: all but ``trace``."""
    return domain != "trace"


# ------------------------------------------------------------------ counters
_FAILURE_LOG_CAP = 64

_counters: Dict[str, int] = {f"fault_{d}": 0 for d in FAULT_DOMAINS}
_counters.update({"fault_demotions": 0, "fault_promotions": 0, "fault_injected": 0})
_failure_log: "deque[Dict[str, Any]]" = deque(maxlen=_FAILURE_LOG_CAP)

# The monotonic event index the failure log and the span ring share: every
# recorded fault and every completed sync advances it. Never reset.
_monotonic_step: int = 0


def tick() -> int:
    """Advance and return the monotonic fault/sync event index."""
    global _monotonic_step
    _monotonic_step += 1
    return _monotonic_step


def current_step() -> int:
    """The current monotonic event index (the last value :func:`tick` returned)."""
    return _monotonic_step


# spans are stamped with this index: one ordering axis for the ring and the log
_telemetry._step_provider = current_step


def note_fault(
    domain: str,
    *,
    site: Optional[str] = None,
    owner: Any = None,
    error: Optional[BaseException] = None,
) -> None:
    """Count one fault in its domain and append it to the failure log, stamped with a new step."""
    key = f"fault_{domain}"
    if key not in _counters:
        key = "fault_runtime"
    _counters[key] += 1
    _failure_log.append(
        {
            "step": tick(),
            "domain": domain,
            "site": site,
            "owner": type(owner).__name__ if owner is not None else None,
            "error": f"{type(error).__name__}: {error}" if error is not None else None,
        }
    )
    if _telemetry.armed:
        _telemetry.emit(
            "fault",
            owner,
            domain,
            attrs={"site": site, "error": type(error).__name__ if error is not None else None},
        )


def fault_stats() -> Dict[str, Any]:
    """Per-domain fault counts, demotions, promotions, injections and the ``failure_log`` (newest last)."""
    out: Dict[str, Any] = dict(_counters)
    out["failure_log"] = list(_failure_log)
    return out


def clear_fault_state() -> None:
    """Zero the counters and drop the failure log. Ladders and warn-once
    markers live on their owners and are left as they are."""
    for key in _counters:
        _counters[key] = 0
    _failure_log.clear()


_telemetry.register_reset("faults", clear_fault_state)


# --------------------------------------------------------- warning hygiene
# Owners that carry a warn-once marker, held weakly: the markers live on the
# owners and die with them, and reset_warn_dedupe can still reach them.
_warned_owners: "weakref.WeakSet" = weakref.WeakSet()


def reset_warn_dedupe() -> None:
    """Clear every live owner's :func:`warn_fault` markers, so that the next
    fault in any domain warns again (``telemetry.reset_all(reset_warnings=True)``)."""
    for owner in list(_warned_owners):
        warned = getattr(owner, "_fault_warned", None)
        if warned is not None:
            warned.clear()


_telemetry.register_warning_reset("faults", reset_warn_dedupe)


def warn_fault(owner: Any, domain: str, message: str) -> bool:
    """Warn ``message`` once per ``owner`` and ``domain``; later faults of that
    domain on that owner only count. The marker lives on the owner. Returns
    True when the warning was emitted."""
    warned = owner.__dict__.get("_fault_warned") if owner is not None else None
    if warned is None:
        warned = set()
        if owner is not None:
            object.__setattr__(owner, "_fault_warned", warned)
    if owner is not None:
        try:
            _warned_owners.add(owner)
        except TypeError:  # not weakly referenceable: the marker still dedupes
            pass
    if domain in warned:
        return False
    warned.add(domain)
    rank_zero_warn(
        message
        + f" [fault domain: {domain}; further {domain}-domain warnings for this owner are "
        "suppressed — see telemetry_snapshot()['failure_log']]"
    )
    return True


# ----------------------------------------------------------- recovery policy
_recovery_steps: Optional[int] = None
_recovery_max_exponent: int = 6


def recovery_steps() -> int:
    """Clean steps at a degraded tier before the first retry of the demoted path
    (``METRICS_TPU_FAULT_RECOVERY_STEPS``, default 8; ``0`` disables recovery).
    Doubles with each repeated failure of a lane, up to ``base * 2**6``."""
    global _recovery_steps
    if _recovery_steps is None:
        try:
            _recovery_steps = max(0, int(os.environ.get("METRICS_TPU_FAULT_RECOVERY_STEPS", "8")))
        except ValueError:
            _recovery_steps = 8
    return _recovery_steps


def set_recovery_policy(steps: Optional[int] = None, *, max_exponent: Optional[int] = None) -> None:
    """Set the recovery policy at run time (None leaves a knob as it is; takes precedence over the environment)."""
    global _recovery_steps, _recovery_max_exponent
    if steps is not None:
        _recovery_steps = max(0, int(steps))
    if max_exponent is not None:
        _recovery_max_exponent = max(0, int(max_exponent))


# ----------------------------------------------------------------- the ladder
class Ladder:
    """The degradation state of one owner's lane (``sync-pack``, ``journal``, ...).

    - ``demote(domain, to=...)``: a classified failure moves the lane down and
      records its domain; each repeated failure doubles the retry threshold.
    - ``note_clean()``: one clean step at the degraded tier; True when the
      recovery edge fires and the owner should re-arm the demoted path.
    - ``promote()``: the owner re-armed the path; the lane is back at its best tier.
    """

    __slots__ = ("lane", "tier", "domain", "failures", "clean", "threshold", "history")

    def __init__(self, lane: str):
        self.lane = lane
        self.tier = TIERS[0]
        self.domain: Optional[str] = None
        self.failures = 0
        self.clean = 0
        self.threshold = 0
        self.history: List[str] = []

    @property
    def demoted(self) -> bool:
        return self.tier != TIERS[0]

    @property
    def recoverable(self) -> bool:
        return self.demoted and self.domain is not None and domain_recoverable(self.domain) and recovery_steps() > 0

    def demote(self, domain: str, to: str = "eager") -> None:
        self.domain = domain
        self.tier = to if to in TIERS else "eager"
        self.failures += 1
        self.clean = 0
        base = recovery_steps()
        exponent = min(self.failures - 1, _recovery_max_exponent)
        self.threshold = base * (2**exponent) if base else 0
        self.history.append(f"demote:{domain}:{self.tier}")
        if len(self.history) > 32:
            del self.history[:-32]
        _counters["fault_demotions"] += 1
        if _telemetry.armed:
            _telemetry.emit(
                "ladder-demote", None, self.lane, attrs={"domain": domain, "tier": self.tier, "failures": self.failures}
            )

    def note_clean(self, n: int = 1) -> bool:
        if not self.recoverable:
            return False
        self.clean += n
        return self.clean >= self.threshold

    def promote(self) -> None:
        self.tier = TIERS[0]
        self.clean = 0
        self.history.append("promote")
        if len(self.history) > 32:
            del self.history[:-32]
        _counters["fault_promotions"] += 1
        if _telemetry.armed:
            _telemetry.emit("ladder-promote", None, self.lane, attrs={"failures": self.failures})


def ladder(owner: Any, lane: str) -> Ladder:
    """The owner's ladder for ``lane``, made at first use and kept in the owner's ``__dict__``."""
    ladders = owner.__dict__.get("_fault_ladders")
    if ladders is None:
        ladders = {}
        object.__setattr__(owner, "_fault_ladders", ladders)
    lad = ladders.get(lane)
    if lad is None:
        lad = Ladder(lane)
        ladders[lane] = lad
    return lad


def demote(
    owner: Any,
    lane: str,
    exc: BaseException,
    *,
    default_domain: str = "runtime",
    tier: str = "eager",
    site: Optional[str] = None,
    warn: Optional[str] = None,
    count: bool = True,
) -> str:
    """Classify ``exc``, count it (unless ``count=False``: it was counted where
    it was raised), demote the owner's ``lane`` and, given ``warn``, warn once
    per owner and domain. Returns the domain."""
    domain = classify(exc, default_domain)
    if count:
        note_fault(domain, site=site, owner=owner, error=exc)
    ladder(owner, lane).demote(domain, to=tier)
    if warn:
        warn_fault(owner, domain, warn)
    return domain


# ----------------------------------------------------------- fault injection
class _Plan:
    """One armed injection: fire ``count`` classified exceptions at ``site``."""

    __slots__ = ("site", "remaining", "exc_type", "message", "fired")

    def __init__(self, site: str, count: int, exc_type: type, message: Optional[str]):
        self.site = site
        self.remaining = count
        self.exc_type = exc_type
        self.message = message
        self.fired = 0


_plans: Dict[str, List[_Plan]] = {}

#: Hot-path guard: call sites check ``faults.armed`` before :func:`maybe_fail`.
armed: bool = False


def _rearm() -> None:
    global armed
    armed = bool(_plans)


def _site_exc(site: str, domain: Optional[str]) -> type:
    if domain is not None:
        return _DOMAIN_EXC.get(domain, RuntimeFault)
    family = site.rsplit("-", 1)[0] if site.startswith("flush-chunk") else site
    return _SITE_DEFAULT_EXC.get(family, _SITE_DEFAULT_EXC.get(site, RuntimeFault))


@contextmanager
def inject_faults(
    site: str,
    count: int = 1,
    *,
    domain: Optional[str] = None,
    message: Optional[str] = None,
) -> Iterator[_Plan]:
    """Fire ``count`` classified failures at ``site`` (one of :data:`FAULT_SITES`;
    ``flush-chunk-2`` fires only at index 2). ``domain`` overrides the site's
    exception class; the plan's ``fired`` counts what fired. Plans nest, and
    plans on one site fire in the order they were installed::

        with inject_faults("sync-pack") as plan:
            metric.compute()            # the coalesced sync fails and falls back
        assert plan.fired == 1
    """
    plan = _Plan(site, count, _site_exc(site, domain), message)
    _plans.setdefault(site, []).append(plan)
    _rearm()
    try:
        yield plan
    finally:
        stack = _plans.get(site)
        if stack is not None:
            try:
                stack.remove(plan)
            except ValueError:
                pass
            if not stack:
                _plans.pop(site, None)
        _rearm()


def _env_plans() -> None:
    """``METRICS_TPU_FAULTS="site[:count[:domain]],..."`` arms plans at import
    (e.g. ``sync-pack:1,sync-gather:2:sync``)."""
    spec = os.environ.get("METRICS_TPU_FAULTS", "")
    if not spec:
        return
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        site = fields[0]
        try:
            count = int(fields[1]) if len(fields) > 1 and fields[1] else 1
        except ValueError:
            count = 1
        domain = fields[2] if len(fields) > 2 and fields[2] else None
        _plans.setdefault(site, []).append(_Plan(site, count, _site_exc(site, domain), None))
    _rearm()


_env_plans()


def maybe_fail(site: str, index: Optional[int] = None) -> None:
    """Fire the next armed plan for ``site`` (or ``site-<index>``), if any."""
    if not _plans:
        return
    names = (site,) if index is None else (f"{site}-{index}", site)
    for name in names:
        stack = _plans.get(name)
        if not stack:
            continue
        for plan in stack:
            if plan.remaining > 0:
                plan.remaining -= 1
                plan.fired += 1
                _counters["fault_injected"] += 1
                raise plan.exc_type(
                    plan.message or f"injected {plan.exc_type.__name__} at site {name!r}",
                    site=name,
                )


# ------------------------------------------------------------- retry helpers
def retry_with_backoff(fn, *, attempts: int, base_delay_s: float, owner: Any = None, site: str = "sync-gather"):
    """Run ``fn()`` with up to ``attempts`` retries, the delay doubling from
    ``base_delay_s``; every failure counts in its domain. Raises the last
    failure, classified, when the budget is spent. An :class:`EpochFault`
    is never retried."""
    delay = base_delay_s
    last: Optional[BaseException] = None
    for attempt in range(attempts + 1):
        try:
            return fn()
        except EpochFault:
            raise
        except Exception as exc:  # noqa: BLE001 - classified and raised below
            last = exc
            note_fault(classify(exc, "sync"), site=site, owner=owner, error=exc)
            if attempt == attempts:
                break
            time.sleep(delay)
            delay *= 2
    if isinstance(last, FaultError):
        raise last
    raise SyncFault(
        f"distributed gather failed after {attempts + 1} attempt(s): {type(last).__name__}: {last}",
        site=site,
    ) from last
