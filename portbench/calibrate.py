"""Readings from which the limits of a cell's comparison are set, on the card, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 13 --seconds 3 [--control-only]

For each seed: a short run of the program (the cell's own set-up, window and check, as ``run.py`` makes
it) and the control: the plain reference computed in the precision below the configuration's, judged by
the same comparison over a whole epoch and the open epoch of the program's run. One JSON line a seed, on
standard output: the program's numbers and the control's. The lower reading of a number is the largest
the program gives over the seeds; the upper reading the smallest the control gives.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
for path in (str(REPO), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control-only", action="store_true")
    args = parser.parse_args(argv)

    import torch

    import generate
    import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device; the readings are taken on the card only", file=sys.stderr)
        return 2
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        row = {"workload": args.workload, "seed": seed}
        if not args.control_only:
            result = harness.run_cell(spec, args.workload, seed, args.seconds, False, "cuda")
            row["program"] = {k: v["value"] for k, v in result["check"].items()}
            row["correct"] = result["correct"]
            row["metrics"] = {k: v["value"] for k, v in result["metrics"].items()}
        t = time.perf_counter()
        cell = harness.Cell(spec, args.workload)
        inputs = generate.make_inputs(cell.data, cell.traffic, seed, "cuda")
        epoch = generate.epoch_steps(cell.data, cell.traffic, inputs)
        # the open epoch of a run: about half an epoch's steps
        row["control"] = harness.control_numbers(cell, epoch, epoch[: len(epoch) // 2])
        row["control_s"] = time.perf_counter() - t
        del inputs, epoch, cell
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
