"""Run chosen phases of a checkout's ``chip_smoke.py`` alone on the card and print their seconds.

Usage (from the repository root, on a machine with a CUDA device)::

    python3 tools/torch_smoke_phases.py [--root DIR] PHASE [PHASE ...]

``PHASE`` is ``curves`` (phase 9), ``sync`` (phase 10) or ``planes`` (phase
26). ``--root`` is the root of the checkout whose ``chip_smoke.py`` and
``metrics_tpu_torch`` run (default: this one), so that two trees are timed on
one card in one call, in turns: run it once with the parent's root and once
with this tree's. The kernels are built first, as ``chip_smoke.py`` builds
them. The last line is one JSON object: the root, each phase's seconds, and
the card's name and power limit.
"""
import argparse
import json
import sys
import time
from pathlib import Path

PHASES = {"curves": "curves_path", "sync": "sync_path", "planes": "planes_ledger_autotune"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("phases", nargs="+", choices=sorted(PHASES))
    args = parser.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_smoke_phases: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as c
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import _native, histogram
    from metrics_tpu_torch.utils import checks

    if not Path(mt.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"metrics_tpu_torch was imported from {mt.__file__}, not from {root}")
    card = c.card_line()
    c.build_kernels(_native, histogram)
    seconds = {}
    for phase in args.phases:
        fn = getattr(c, PHASES[phase])
        t0 = time.perf_counter()
        if phase == "sync":
            fn(mt, histogram, card)
        else:
            fn(mt, checks, histogram, card)
        seconds[phase] = time.perf_counter() - t0
    print(json.dumps({"root": root, "seconds": seconds, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
