"""The inputs of a cell: a configuration's ``data`` and a traffic mix's parameters in, seeded tensors out.

The generator of a configuration is found by the name of its data's kind: ``generators/<kind>.py``, with

- ``make_inputs(data, traffic, seed, device)``: the distinct inputs, a list of ``(preds, target)`` tensors,
  made on the device from one ``torch.Generator`` (``seeded_generator``) in a few large calls, so that the
  same seed gives the same inputs;
- ``epoch_steps(data, traffic, inputs)``: one epoch as the loop feeds it, a list of ``(preds, target)``
  views, the last one partial where the epoch's size is not a multiple of the batch.

A traffic mix is a data file (``traffic/<mix>.json``) that the generator of its configuration's kind reads;
a configuration of a new kind brings its generator as a new file.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import torch

Step = Tuple[torch.Tensor, torch.Tensor]
GENERATORS = Path(__file__).resolve().parent / "generators"
_loaded: Dict[str, object] = {}


def seeded_generator(seed: int, device) -> torch.Generator:
    """The run's one generator on ``device``; any whole seed, also one over 32 bits."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed) % 2**63)


def generator_of(kind: str):
    """The module ``generators/<kind>.py``."""
    if kind not in _loaded:
        path = GENERATORS / f"{kind}.py"
        if not path.is_file():
            raise ValueError(f"no generator for data kind {kind!r} ({path} is missing)")
        spec = importlib.util.spec_from_file_location(f"portbench_generators_{kind}".replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[kind] = module
    return _loaded[kind]


def make_inputs(data: Dict, traffic: Dict, seed: int, device) -> List[Step]:
    """The distinct inputs of a cell, from the generator of its data's kind."""
    return generator_of(data["kind"]).make_inputs(data, traffic, seed, device)


def epoch_steps(data: Dict, traffic: Dict, inputs: List[Step]) -> List[Step]:
    """One epoch as the loop feeds it, from the generator of its data's kind."""
    return generator_of(data["kind"]).epoch_steps(data, traffic, inputs)


def step_samples(step: Step) -> int:
    """Samples a step consumes: the length of its target's first axis (images, rows)."""
    return int(step[1].shape[0])
