"""Device kernels and the planes beside them: the CUDA bincount (``histogram``),
the loader that builds the sources under ``csrc/`` (``_native``), the binned
curve counts, the segment reductions, the dispatch engine (``engine``), and
the fault, telemetry and state journal planes (``faults``, ``telemetry``,
``journal``), performance attribution (``perf``), the fleet plane
(``fleetobs``), the persistent program cache (``progcache``) and the kernel
autotuner (``autotune``).

The names of ``metrics_tpu/ops/__init__.py`` that the port has, resolved at
first access: ``utils/data.py`` imports ``ops.histogram`` while the modules
behind the other names import ``utils/data.py``.
"""
import importlib

from metrics_tpu_torch.ops.histogram import fused_bincount

_LAZY = {
    "Executable": "engine",
    "acquire": "engine",
    "acquire_keyed": "engine",
    "config_fingerprint": "engine",
    "donation_supported": "engine",
    "engine_stats": "engine",
    "reset_engine": "engine",
    "reset_stats": "engine",
    "program_report": "engine",
    "program_summary": "engine",
    "binned_curve_counts": "binned",
    "export_fleet_trace": "fleetobs",
    "fleet_perf_report": "fleetobs",
    "fleet_prometheus_text": "fleetobs",
    "fleet_snapshot": "fleetobs",
    "straggler_report": "fleetobs",
    "perf_report": "perf",
    "FAULT_SITES": "faults",
    "fault_stats": "faults",
    "inject_faults": "faults",
    "reset_warn_dedupe": "faults",
    "set_recovery_policy": "faults",
    "journal_generations": "journal",
    "journal_stats": "journal",
    "journalable": "journal",
    "segment_count": "segments",
    "segment_cumsum": "segments",
    "segment_max": "segments",
    "segment_ranks": "segments",
    "segment_starts": "segments",
    "segment_sum": "segments",
    "SPAN_SITES": "telemetry",
    "export_trace": "telemetry",
    "prometheus_text": "telemetry",
    "set_telemetry": "telemetry",
    "telemetry_snapshot": "telemetry",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


__all__ = ["fused_bincount", *sorted(_LAZY)]
