"""Run one cell traced, as ``run.py --trace 1`` does, and attribute its window to the program's own ranges.

    python3 portbench/attribute.py --workload <name> --seed <n> --seconds <s> [--out <dir>]

Prints ``run.py``'s result line, then one JSON object (also written to ``<out>/<workload>-<seed>.json``, by
default under ``build/attribute/``): the per-layer metrics that read the program's ranges
(``layers/<metric>.py`` for the names in :data:`READERS`), and, inside the benchmark's update and compute
spans, the idle time and the device time by the innermost program range, the device ops by name and range,
the program's host reads by site, and the host's waits on the card that no ``host-read`` range encloses.
``checks`` holds what must hold for those numbers to mean anything: no program range among the device ops
``devtrace`` counts, and the share of device time whose launch was found.
"""
import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
for _path in (str(REPO), str(HERE)):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import devtrace  # noqa: E402
import progtrace  # noqa: E402

READERS = ("validate_host_ms", "validate_host_ms.ctr", "update_host_reads", "update_host_reads.ctr",
           "canon_device_ms", "counts_device_ms", "compute_sort_device_ms.ctr", "compute_ties_device_ms.ctr")
TOP_OPS = 12


def _rank(d: dict, top: int = 0) -> list:
    items = sorted(([k if isinstance(k, str) else list(k), v] for k, v in d.items()), key=lambda kv: -kv[1])
    return items[:top] if top else items


def _per(counter: Counter, n: int) -> dict:
    return {k: v / n for k, v in sorted(counter.items())} if n else {}


def attribute(trace) -> dict:
    """The window's attribution to the program's ranges (``trace.program``), inside the benchmark's spans."""
    program = trace.program
    updates, computes = trace.spans.get("update", []), trace.spans.get("compute", [])
    out = {"ranges": len(program.ranges), "updates": len(updates), "computes": len(computes)}
    for phase, spans in (("update", updates), ("compute", computes)):
        if not spans:
            continue
        idle = program.idle_by_innermost(trace.busy, spans)
        idle_s = sum(idle.values())
        below_step = sum(v for k, v in idle.items() if k not in (progtrace.NO_RANGE, "suite-step"))
        out[phase] = {
            "idle_s": idle_s,
            "idle_below_suite_step": below_step / idle_s if idle_s else None,
            "idle_by_innermost_s": _rank(idle),
            "device_by_innermost_s": _rank(program.device_s_by_innermost(spans)),
            "device_ops_by_innermost_s": _rank(program.device_s_by_innermost(spans, by_op=True), TOP_OPS),
            "host_reads_per_call": _per(Counter(n for n, _, _ in program.ranges_in("host-read", spans)), len(spans)),
            "waits_outside_host_read_per_call": {k: v / len(spans) for k, v in
                                                 sorted(program.waits_outside("host-read", spans).items())},
        }
    device_s = sum(e - s for _, s, e, _ in program.device_ops) / 1e9
    unlaunched = program.unlaunched_device_s()
    out["checks"] = {
        "program_names_in_device_ops": sum(1 for n, _, _ in trace.device_ops if n.startswith(progtrace.PROGRAM_PREFIX)),
        "device_s": device_s,
        "launch_found_share": 1.0 - sum(unlaunched.values()) / device_s if device_s else None,
        "unlaunched_s": _rank(unlaunched, TOP_OPS),
        "devtrace_device_ops": len(trace.device_ops), "program_device_ops": len(program.device_ops),
    }
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out", default=str(REPO / "build" / "attribute"))
    args = parser.parse_args(argv)

    kept = []
    from_profiler = devtrace.from_profiler

    def keep(prof):
        trace = from_profiler(prof)
        if trace is not None:
            trace.program = progtrace.from_profiler(prof, trace.window)
            kept.append(trace)
        return trace

    devtrace.from_profiler = keep
    import harness
    import run

    rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                   "--trace", "1"])
    wall_s = time.time() - T0_WALL
    if rc != 0 or not kept:
        return rc or 1
    trace = kept[0]
    layers = Path(HERE / "layers")
    doc = {"workload": args.workload, "seed": args.seed, "wall_s": wall_s,
           "metrics": {name: harness.load_module(layers / f"{name}.py").read(trace, {}) for name in READERS},
           **attribute(trace)}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}-{args.seed}.json").write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
