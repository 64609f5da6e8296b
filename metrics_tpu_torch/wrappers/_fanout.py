"""One program over identically configured clones (JAX counterpart: `metrics_tpu/wrappers/_fanout.py`).

``BootStrapper`` (resampled clones) and ``MultioutputWrapper`` (one clone a
column) run their whole clone fleet as ONE program after an eager, validated
first call of each input signature: stack the clone states
(:func:`metrics_tpu_torch.arena.stack_states`), run the base metric's pure
update over them with ``torch.func.vmap``, unstack. The bincount under a
vmapped update is one batched launch (``metrics_tpu_torch::bincount``'s vmap
rule). This module holds what the wrappers share: the config-drift guard,
the program's build and refresh, keyed on the wrapper's and every clone's
``_fused_version`` and served by the dispatch engine
(``engine.acquire(wrapper, "fanout:...")``), the run with its demotion, and
the write-back of the clone states.

A program's first run after a build is its probe, as JAX's abstract trace
is: a failure there declines silently (trace domain, for good). A later
failure demotes the wrapper's ``fanout`` ladder lane with JAX's warning, and
the clones go on eagerly until the lane's recovery edge re-arms the path.
Nothing is donated in the port, so a failed program leaves every clone's
states as they were.

The weighted-row helpers (:func:`row_deltas`, :func:`weighted_delta_add`,
:func:`weighted_state_apply`) serve the paths whose draws or masks change
the batch's length (Poisson resampling, ``remove_nans``): for a base whose
states all merge by sum, the update of a resampled or filtered batch is the
count-weighted sum of the per-row state deltas. Integer weights times integer
deltas contract exactly: in float64, exact while every partial sum stays below
2**53, then rounded back to the state's dtype (no CUDA matmul takes int32).
Float states contract in their own dtype with TF32 off; their sums run in
another order than the eager update's, within ``WEIGHTED_RTOL``. The deltas
are ``(rows, *state)``: they are made and contracted in row blocks of at most
``DELTA_BLOCK_BYTES``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Sequence

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from metrics_tpu_torch.metric import Metric, _propagate_static_attrs
from metrics_tpu_torch.ops import engine as _engine
from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.utils.prints import rank_zero_warn

#: The most bytes of per-row deltas made and contracted at once (as Manhattan's row blocks).
DELTA_BLOCK_BYTES = 256 << 20
#: The float states' weighted sums against the eager update's (another order of float32 adds).
WEIGHTED_RTOL = 1e-5


def clone_config(m: Metric) -> Dict[str, str]:
    """A comparable snapshot of a clone's hyperparameters (public attributes that
    are not states, by repr: a false inequality only costs the fast path)."""
    skip = ("update", "compute", "compute_on_cpu", "training")
    return {
        k: repr(v)
        for k, v in sorted(m.__dict__.items())
        if not k.startswith("_") and k not in m._defaults and k not in skip
    }


def _disable(wrapper: Metric, ok_attr: str, program_attr: str) -> None:
    object.__setattr__(wrapper, ok_attr, False)
    object.__setattr__(wrapper, program_attr, None)


def run_fanout(
    wrapper: Metric,
    clones: Sequence[Metric],
    build_program: Callable[[Callable], Callable],
    call_args: tuple,
    call_kwargs: dict,
    *,
    label: str,
    program_attr: str,
    versions_attr: str,
    ok_attr: str,
) -> bool:
    """Build or refresh the clone program and run it; True when it ran.

    ``build_program(upd)`` takes the base metric's pure update and returns
    ``program(states, *call_args, **call_kwargs) -> list of state dicts``. The
    engine caches it under the wrapper's fingerprint (which recurses into the
    clones), so identically configured wrappers share one program. On False
    the caller runs the per-clone eager path; the clones' states are untouched.
    """
    lane = f"fanout:{ok_attr}:{program_attr}"
    versions = (wrapper._fused_version,) + tuple(m._fused_version for m in clones)
    if versions != getattr(wrapper, versions_attr):
        cfg0 = clone_config(clones[0])
        if any(clone_config(m) != cfg0 for m in clones[1:]):
            rank_zero_warn(
                f"{label} clones are no longer identically configured; the one-program fan-out is disabled "
                "for this instance and updates run the per-clone eager path."
            )
            # structural (a user-driven divergence): trace domain, never re-probed
            _faults.ladder(wrapper, lane).demote("trace")
            _disable(wrapper, ok_attr, program_attr)
            return False
    rebuilt = False
    try:
        states = [m.metric_state for m in clones]
        if getattr(wrapper, program_attr) is None or getattr(wrapper, versions_attr) != versions:
            clone0 = clones[0]

            def build() -> Callable:
                _, upd, _ = clone0.as_functions()
                program = build_program(upd)
                return lambda states, *a, **k: program(states, *a, **k)

            object.__setattr__(wrapper, program_attr, _engine.acquire(wrapper, f"fanout:{program_attr}", build))
            object.__setattr__(wrapper, versions_attr, versions)
            rebuilt = True
        new_states = getattr(wrapper, program_attr).run(states, call_args, call_kwargs)
    except Exception as exc:  # noqa: BLE001 - nothing consumed: the eager path runs on intact states
        if rebuilt:
            # the first run is the probe: a configuration the program cannot run
            # is supported, not an anomaly (silent, trace domain, for good)
            _faults.note_fault("trace", site="fanout", owner=wrapper, error=exc)
            _faults.ladder(wrapper, lane).demote("trace")
        else:
            _faults.demote(
                wrapper,
                lane,
                exc,
                site="fanout",
                warn=(
                    f"Fused fan-out program for `{type(clones[0]).__name__}` raised {type(exc).__name__}: {exc}. "
                    "Falling back to the per-clone eager path for this instance; recoverable failures re-probe "
                    "after clean steps."
                ),
            )
        _disable(wrapper, ok_attr, program_attr)
        return False
    for m, st in zip(clones, new_states):
        d = m.__dict__
        d.update(st)  # state leaves: no version logic
        d["_update_count"] += 1
        d["_computed"] = None
    if rebuilt:
        # update-inferred static attributes (shape-derived, so one value for
        # every clone) flow from clone 0, whose eager first call set them
        for m in clones[1:]:
            _propagate_static_attrs(clones[0], m)
    return True


def fanout_gate(wrapper: Metric, clones: List[Metric], args: tuple, kwargs: dict, ok_attr: str) -> bool:
    """The shared preconditions: a healthy path, a base whose states may fuse,
    a validation mode other than ``full`` and plain tensors in the call (the
    validated eager path defines what inputs are accepted)."""
    from metrics_tpu_torch.utils.checks import _get_validation_mode, _is_concrete

    leaves = pytree.tree_leaves((args, kwargs))
    return (
        getattr(wrapper, ok_attr)
        and clones[0]._fusable_states()
        and _get_validation_mode() != "full"
        and all(isinstance(leaf, Tensor) for leaf in leaves)
        and _is_concrete(*leaves)
    )


def sum_linear_base(m: Metric) -> bool:
    """Every state reduces by "sum": an update is additive across batches, which the
    weighted-row programs extend to additivity across rows (certified on the first
    fused steps of each instance)."""
    return bool(m._defaults) and all(spec == "sum" for spec in m._reduction_specs.values())


def _delta_rows(init_state: Dict[str, Any], rows: int) -> int:
    """Rows of deltas a block holds: at most ``DELTA_BLOCK_BYTES`` of deltas at
    the widest state's float64 contraction (8 bytes an element)."""
    widest = max((v.numel() for v in init_state.values()), default=1)
    return max(1, min(rows, DELTA_BLOCK_BYTES // max(1, 8 * widest)))


def row_deltas(upd: Callable, init_state: Dict[str, Any], a: tuple, k: dict) -> Dict[str, Tensor]:
    """Each row's state contribution ``upd(init, row) - init``, ``(rows, *state)``,
    one vmapped update over the batch's rows, shared by every clone."""

    def one_row(row):
        ra, rk = pytree.tree_map(lambda x: x.unsqueeze(0), row)
        new = upd(init_state, *ra, **rk)
        return {name: new[name] - init_state[name] for name in init_state}

    return torch.func.vmap(one_row)((a, k))


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _integral(t: Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def weighted_delta_add(old: Tensor, contrib_fn: Callable, *, weights: Tensor, delta: Tensor) -> Tensor:
    """``old + contrib_fn(weights, delta)`` with JAX's dtype rules.

    Integer (and bool) states take integer weights times integer deltas
    exactly: the contraction runs in float64 and is rounded back; weights that
    are floats (0/1 masks) are rounded too. Float states contract in their own
    dtype with TF32 off."""
    if _integral(old):
        contrib = torch.round(contrib_fn(weights.to(torch.float64), delta.to(torch.float64)))
        return old + contrib.to(old.dtype)
    with _no_tf32():
        contrib = contrib_fn(weights.to(old.dtype), delta.to(old.dtype))
    return (old + contrib).to(old.dtype)


def _contract(w: Tensor, d: Tensor) -> Tensor:
    """``sum_i w[..., i] * d[i, ...]``: one matmul over the flattened state."""
    return (w @ d.reshape(d.shape[0], -1)).reshape(w.shape[:-1] + d.shape[1:])


def weighted_state_apply(stacked_states: Dict[str, Tensor], deltas: Dict[str, Tensor], weights: Tensor) -> Dict[str, Tensor]:
    """``new_c = old_c + sum_i weights[c, i] * delta_i`` for every clone ``c``: the
    resample or filter itself, one contraction a state."""
    return {
        name: weighted_delta_add(old, _contract, weights=weights, delta=deltas[name])
        for name, old in stacked_states.items()
    }


def weighted_rows_apply(
    stacked_states: Dict[str, Tensor], upd: Callable, init_state: Dict[str, Any], weights: Tensor, a: tuple, k: dict
) -> Dict[str, Tensor]:
    """:func:`weighted_state_apply` over :func:`row_deltas` made block by block, so
    that no more than ``DELTA_BLOCK_BYTES`` of deltas exist at once. Integer states
    are exact whatever the blocks; float states add the blocks' sums in order."""
    rows = weights.shape[-1]
    block = _delta_rows(init_state, rows)
    out = stacked_states
    for start in range(0, rows, block):
        stop = min(rows, start + block)
        part = pytree.tree_map(lambda x: x[start:stop], (a, k))
        deltas = row_deltas(upd, init_state, *part)
        out = weighted_state_apply(out, deltas, weights[..., start:stop])
    return out


def states_allclose(states_a: Sequence[Dict[str, Any]], states_b: Sequence[Dict[str, Any]], rtol: float = 1e-3,
                    atol: float = 1e-4) -> bool:
    """Two clone-state lists compared on the host (one read; used on the first
    fused steps of an instance to certify the weighted-row path)."""
    for sa, sb in zip(states_a, states_b):
        for name in sa:
            va, vb = sa[name].to(torch.float64), sb[name].to(torch.float64)
            if va.shape != vb.shape or not torch.allclose(va, vb.to(va.device), rtol=rtol, atol=atol, equal_nan=False):
                return False
    return True


__all__ = [
    "DELTA_BLOCK_BYTES",
    "WEIGHTED_RTOL",
    "clone_config",
    "fanout_gate",
    "row_deltas",
    "run_fanout",
    "states_allclose",
    "sum_linear_base",
    "weighted_delta_add",
    "weighted_rows_apply",
    "weighted_state_apply",
]
