"""Checks of supplied weights for the model-backed metrics, and their carry into the port's networks.

JAX counterpart: `metrics_tpu/models/manifest.py` (``validate_params`` `:39`).
The published numbers of FID/KID/IS/LPIPS mean something only with the
reference checkpoints (torch-fidelity's InceptionV3, the ``lpips`` package
nets). They arrive as the ``.npz`` files that
``tools/convert_{inception,lpips}_weights.py`` write (flat ``"a/b/c"``
keys, Flax layout), or as the JAX package's variables tree; a file with a
key missing or a shape wrong would give plausible numbers that mean nothing.
So every supplied tree is checked against the manifest, the exact key set and
shapes the network expects, and the error names the missing, extra and
mis-shaped keys and the converter command.

The manifest is read off the port's own module: each network maps its
``state_dict`` keys to the Flax keys and layouts
(``flax_layout()``: ``{port key: (flax key, axis permutation from the port's
layout to Flax's)}``), so it cannot drift from the architecture.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

Layout = Dict[str, Tuple[str, Optional[Tuple[int, ...]]]]


def flatten_params(params: Any) -> Dict[str, np.ndarray]:
    """A variables tree (nested mappings) or a flat ``"a/b/c"`` mapping, as flat numpy arrays."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any) -> None:
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(path, value)
            else:
                flat[path] = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)

    if not isinstance(params, Mapping):
        raise TypeError(f"Expected the weights as a mapping of arrays, got {type(params).__name__}")
    walk("", params)
    return flat


def expected_manifest(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Flat ``flax key -> shape`` manifest of ``model`` (built on the ``meta`` device: no memory)."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out = {}
    for port_key, (flax_key, perm) in model.flax_layout().items():
        shape = shapes[port_key]
        out[flax_key] = tuple(shape[i] for i in perm) if perm is not None else shape
    return out


def validate_params(params: Any, model: nn.Module, converter_hint: str) -> Dict[str, np.ndarray]:
    """Raise with an actionable message when ``params`` does not match ``model``'s manifest
    (missing keys, unexpected keys, shape mismatches); return the flat arrays otherwise."""
    want = expected_manifest(model)
    flat = flatten_params(params)
    got = {k: tuple(v.shape) for k, v in flat.items()}

    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if not (missing or extra or wrong):
        return flat

    def _fmt(keys, detail=None):
        shown = keys[:5]
        lines = [f"  - {k}" + (f": expected {want[k]}, got {got[k]}" if detail else "") for k in shown]
        if len(keys) > len(shown):
            lines.append(f"  ... and {len(keys) - len(shown)} more")
        return "\n".join(lines)

    sections = []
    if missing:
        sections.append(f"missing {len(missing)} parameter(s):\n{_fmt(missing)}")
    if extra:
        sections.append(f"unexpected {len(extra)} parameter(s):\n{_fmt(extra)}")
    if wrong:
        sections.append(f"shape mismatch on {len(wrong)} parameter(s):\n{_fmt(wrong, detail=True)}")
    raise ValueError(
        f"Supplied parameters do not match the {type(model).__name__} manifest:\n"
        + "\n".join(sections)
        + f"\nConvert the reference checkpoint with `{converter_hint}` and pass the resulting"
        " .npz via `npz_path` (or its loaded pytree via `params`)."
    )


def state_from_flax(params: Any, model: nn.Module, converter_hint: str) -> Dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` (CPU tensors) from Flax-layout weights, checked against its manifest.

    Each array is moved from Flax's layout (NHWC convolutions: HWIO kernels;
    ``Dense`` kernels (in, out)) to the port's (OIHW; (out, in)). An entry of
    the port with no Flax counterpart (BatchNorm's ``num_batches_tracked``)
    is zero.
    """
    flat = validate_params(params, model, converter_hint)
    layout = model.flax_layout()
    state = {}
    for key, like in model.state_dict().items():
        if key not in layout:
            state[key] = torch.zeros(like.shape, dtype=like.dtype)
            continue
        flax_key, perm = layout[key]
        value = flat[flax_key]
        if perm is not None:
            value = np.transpose(value, np.argsort(perm))
        state[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    return state


def meta_module(cls: type, *args: Any, **kwargs: Any) -> nn.Module:
    """``cls(*args, **kwargs)`` on the ``meta`` device: shapes only, no memory, no initialisation."""
    with torch.device("meta"):
        return cls(*args, **kwargs)


__all__ = ["expected_manifest", "flatten_params", "meta_module", "state_from_flax", "validate_params"]
