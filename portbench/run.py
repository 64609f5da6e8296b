"""Run one cell of the benchmark of ``metrics_tpu_torch`` once, on the card, and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, then ``setup``: the set-up's phases in seconds and the
kernel libraries this run built, which only a checkout's first run does; and last ``check``: each number
compared beside its limit). The same numbers are the last lines of standard error. Without a CUDA device, or with fewer than
the cell asks for, the run exits with code 2 and prints no result.
"""
import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# a one-chip run's process, and every thread it starts, on two fixed cores: unpinned, the host-paced CTR
# loop's rows/s spread 22% over runs on one machine, pinned to two cores 6% (PERF.md, section 2)
HOST_CPUS = {2, 3}


def pin_host_cpus(spec: dict, workload: str) -> None:
    """Pin this process to ``HOST_CPUS`` before torch starts its threads, for a cell of one chip (a cell of
    several spawns a process a rank, which would share the two cores) and where the machine has them."""
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == workload), None)
    if chips == 1 and HOST_CPUS <= os.sched_getaffinity(0):
        os.sched_setaffinity(0, HOST_CPUS)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the program's defaults: no METRICS_TPU_* knob from the caller's environment; no JAX through a library
    for key in [k for k in os.environ if k.startswith("METRICS_TPU_")]:
        del os.environ[key]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (str(REPO), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    pin_host_cpus(spec, args.workload)
    import harness

    try:
        result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0_WALL)
    except harness.RunError as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    result["setup"]["cpus"] = sorted(os.sched_getaffinity(0))
    print("setup " + json.dumps(result["setup"]), file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
