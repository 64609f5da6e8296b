"""The program's ranges beside the benchmark's trace: kept apart from its spans, each device op tied to the range
open at its launch, the new readers' arithmetic and their silence without ranges, and every existing reading the
same with the ranges as without them, on synthetic kineto-like events and on a traced CPU run of a small cell."""
import json
from pathlib import Path

import pytest
from conftest import SMALL

import devtrace
import harness
import progtrace
import work

BENCH = Path(__file__).resolve().parents[1]
NEW = ["validate_host_ms", "validate_host_ms.ctr", "update_host_reads", "update_host_reads.ctr", "canon_device_ms",
       "counts_device_ms", "compute_sort_device_ms.ctr", "compute_ties_device_ms.ctr"]
P = progtrace.PROGRAM_PREFIX


class Event:
    """What ``from_profiler`` reads of a kineto event."""

    def __init__(self, name, start, end, device="CPU", corr=0, annotation=False):
        self._name, self._start, self._end, self._corr, self._annotation = name, start, end, corr, annotation
        self._device = type("DeviceType", (), {"name": device})()

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


class Profile:
    """A finished profile's face: ``prof.profiler.kineto_results.events()``."""

    def __init__(self, events):
        results = type("Results", (), {"events": lambda _self: list(events)})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def readers():
    entries = json.loads((BENCH.parent / "BENCHMARK.json").read_text())["per_layer"]
    return {m["name"]: harness.load_module(BENCH / "layers" / f"{m['name']}.py") for m in entries}


def new_reader(name):
    return harness.load_module(BENCH / "layers" / f"{name}.py")


# one update (0-100) and its synchronize (100-120), one compute (200-300); the window is 0-400
BENCH_EVENTS = [
    Event("portbench.window", 0, 400, annotation=True), Event("portbench.update", 0, 100, annotation=True),
    Event("portbench.sync", 100, 120, annotation=True), Event("portbench.compute", 200, 300, annotation=True),
    Event("aten::item", 250, 251), Event("aten::_local_scalar_dense", 250, 251),
    Event("cudaLaunchKernel", 20, 22, corr=1), Event("cudaLaunchKernel", 50, 52, corr=2),
    Event("cudaLaunchKernel", 210, 212, corr=3), Event("cudaLaunchKernel", 260, 262, corr=4),
    Event("one_hot_kernel", 60, 70, device="CUDA", corr=1), Event("bincount_kernel", 70, 110, device="CUDA", corr=2),
    Event("radix_sort", 215, 240, device="CUDA", corr=3), Event("nonzero_kernel", 265, 270, device="CUDA", corr=4),
]
PROGRAM_EVENTS = [
    Event(P + "suite-step", 5, 95, annotation=True), Event(P + "update:JaccardIndex", 6, 94, annotation=True),
    Event(P + "validate", 7, 18, annotation=True), Event(P + "host-read:value-stats", 8, 17, annotation=True),
    Event(P + "canonicalize", 19, 40, annotation=True), Event(P + "counts", 45, 60, annotation=True),
    Event(P + "compute:AUROC", 205, 295, annotation=True), Event(P + "curve-sort", 208, 230, annotation=True),
    Event(P + "curve-ties", 250, 280, annotation=True), Event(P + "host-read:curve-thresholds", 255, 275, annotation=True),
    # the card's side of the annotations, which no reading may count as device work
    Event(P + "canonicalize", 60, 70, device="CUDA", annotation=True),
]


def test_program_ranges_stay_out_of_the_spans_and_every_existing_reading_is_unchanged():
    bare = devtrace.from_profiler(Profile(BENCH_EVENTS))
    full = devtrace.from_profiler(Profile(BENCH_EVENTS + PROGRAM_EVENTS))
    for attr in ("window", "device_ops", "busy", "host_ops", "spans"):
        assert getattr(full, attr) == getattr(bare, attr), attr
    assert full.breakdown() == bare.breakdown() and full.steps() == bare.steps()
    full.program = progtrace.from_profiler(Profile(BENCH_EVENTS + PROGRAM_EVENTS), full.window)
    window = {"host_update_s": [1e-7], "update_bytes": [64], "compute_bytes": 64, "peaks": work.DEFAULT_PEAKS}
    for name, module in readers().items():
        assert module.read(full, window) == module.read(bare, window), name
    assert set(full.spans) == {"update", "sync", "compute"}
    assert {name for name, *_ in full.program.ranges} == {e.name()[len(P):] for e in PROGRAM_EVENTS}


def test_a_device_op_belongs_to_the_range_open_at_its_launch_not_while_it_ran():
    trace = devtrace.from_profiler(Profile(BENCH_EVENTS + PROGRAM_EVENTS))
    program = trace.program = progtrace.from_profiler(Profile(BENCH_EVENTS + PROGRAM_EVENTS), trace.window)
    updates, computes = trace.spans["update"], trace.spans["compute"]
    # the one-hot kernel runs at 60-70, after `canonicalize` (19-40) closed, but was launched inside it at 20; the
    # bincount launched inside `counts` at 50 runs at 70-110, after the update span
    assert program.path_at(20) == ("suite-step", "update:JaccardIndex", "canonicalize")
    assert program.device_s_launched_in("canonicalize", updates) == pytest.approx(10e-9)
    assert program.device_s_launched_in("counts", updates) == pytest.approx(40e-9)
    assert program.device_s_launched_in("update", updates) == pytest.approx(50e-9)
    assert program.device_s_by_innermost(computes) == {"curve-sort": pytest.approx(25e-9),
                                                      "host-read:curve-thresholds": pytest.approx(5e-9)}
    assert new_reader("canon_device_ms").read(trace, {}) == pytest.approx(10e-6)
    assert new_reader("counts_device_ms").read(trace, {}) == pytest.approx(40e-6)
    assert new_reader("compute_sort_device_ms.ctr").read(trace, {}) == pytest.approx(25e-6)
    assert new_reader("compute_ties_device_ms.ctr").read(trace, {}) == pytest.approx(5e-6)  # the read nests in ties
    assert new_reader("validate_host_ms").read(trace, {}) == pytest.approx(11e-6)
    assert new_reader("update_host_reads").read(trace, {}) == 1.0
    # the update's idle time, 0-60 (the card is busy from 60), by the innermost range open at each moment
    idle = program.idle_by_innermost(trace.busy, updates)
    assert idle == {progtrace.NO_RANGE: pytest.approx(5e-9), "suite-step": pytest.approx(1e-9),
                    "update:JaccardIndex": pytest.approx(7e-9), "validate": pytest.approx(2e-9),
                    "host-read:value-stats": pytest.approx(9e-9), "canonicalize": pytest.approx(21e-9),
                    "counts": pytest.approx(15e-9)}


def test_nested_ranges_give_paths_and_outermost_only_counts_once():
    program = progtrace.ProgramTrace([("validate", 0, 50), ("validate", 10, 20), ("host-read:x", 12, 15),
                                      ("canonicalize", 60, 80), ("canonicalize", 70, 90)], {}, [], [], (0, 100))
    assert program.path_at(13) == ("validate", "validate", "host-read:x")
    assert program.path_at(55) == ()
    assert [r[1:3] for r in program.ranges_in("validate", [(0, 100)], outermost=True)] == [(0, 50)]
    assert len(program.ranges_in("validate", [(0, 100)])) == 2
    # a range that outlives its parent is cut at the parent's end
    assert program.path_at(85) == ()


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_is_silent_without_program_ranges(name):
    module = new_reader(name)
    bare = devtrace.from_profiler(Profile(BENCH_EVENTS))
    assert module.read(None, {}) is None
    assert module.read(bare, {}) is None  # no `program` attached, as a checkout without this reader's wiring
    bare.program = progtrace.from_profiler(Profile(BENCH_EVENTS), bare.window)
    assert not bare.program and module.read(bare, {}) is None


def test_a_traced_cpu_run_keeps_the_ranges_apart_and_every_existing_reading_the_same(spec, monkeypatch):
    pairs = []
    original = devtrace.from_profiler

    def keep(prof):
        events = list(prof.profiler.kineto_results.events())
        bare = Profile([e for e in events if not e.name().startswith(P)])
        trace = original(prof)
        trace.program = progtrace.from_profiler(prof, trace.window)
        pairs.append((trace, original(bare)))
        return trace

    monkeypatch.setattr(devtrace, "from_profiler", keep)
    result = harness.run_cell(spec, "seg19.labels-b8", 2**31 + 11, 1.0, True, "cpu",
                              data_overrides=SMALL["cityscapes-seg19"])
    assert result["correct"]
    ((full, bare),) = pairs
    for attr in ("window", "device_ops", "busy", "host_ops", "spans"):
        assert getattr(full, attr) == getattr(bare, attr), attr
    assert full.breakdown() == bare.breakdown()
    window = {"host_update_s": [1e-3] * len(full.spans["update"]), "update_bytes": [1 << 20] * len(full.spans["update"]),
              "compute_bytes": 1 << 20, "peaks": work.DEFAULT_PEAKS}
    for name, module in readers().items():
        assert module.read(full, window) == module.read(bare, window), name
    names = {n for n, *_ in full.program.ranges}
    assert {"suite-step", "update:JaccardIndex", "update:Dice", "validate", "host-read:value-stats", "canonicalize",
            "counts", "stat-scores"} <= names
    assert not any(k.startswith("metrics_tpu_torch") for k in full.spans)
    assert new_reader("validate_host_ms").read(full, {}) > 0
    assert new_reader("update_host_reads").read(full, {}) == 2.0  # the value read of each member's validation
    assert new_reader("canon_device_ms").read(full, {}) == 0.0  # a CPU run launches nothing on a card
