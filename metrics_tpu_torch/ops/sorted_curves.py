"""Exact AUROC and average precision from one sort, with static shapes.

JAX counterpart: `metrics_tpu/ops/sorted_curves.py` (the reference
formulations: ``_tie_run_ids`` `:39`, ``midranks`` `:45`,
``_auroc_from_rank_sum`` `:59`, ``_auroc_midranks`` `:68`, the binary
entry points `:115`, `:131`, ``_ap_from_descending`` `:150`, the
multi-class entry points `:189`, `:215`).

The curves have one point per distinct score, but the areas under them are
scalars, so they are computed with fixed shapes and no host read: sort, find
the tie runs with segment reductions, and integrate in closed form.

- AUROC by the midrank (Mann-Whitney U) identity: with tied scores sharing
  their average rank, ``AUC = (sum of the positives' ranks - P(P+1)/2) /
  (P * N_neg)``, which is the trapezoidal area of the tie-collapsed ROC curve.
- AP as ``sum_i y_i * P_end(i) / P``, where ``P_end(i)`` is the precision at
  the end of i's tie run, so that a tie run counts once, at its precision.

The JAX package maps each class's binary kernel over the classes with
``jax.vmap``. Here the ``(N, C)`` scores are laid out as ``(C, N)`` rows and
sorted in one batched sort; each row's tie runs are offset by ``c * N``, so
one scatter reduction covers every class. Sums of 0/1 labels are float32, as
in the JAX package: exact up to 2**24 scores. The rank sum at that size adds
2**24 float32 terms in an order that differs between devices, so areas agree
within a tolerance, not bit for bit.

The JAX package's autotuned formulations are autotuner variants here as there
(``sorted_curves.py:82-246``; :mod:`metrics_tpu_torch.ops.autotune`), each
declaring :data:`_SORT_TOL`: ``single_sort`` derives ranks, tie runs and the
U statistic in sorted order (no scatter back: the sum does not depend on the
order), and ``packed_sort`` sorts :func:`_sortable_score_keys` packed with
each score's position into one int64 key (the key in the high bits), so that
one sort of values carries the labels along and tie runs come from integer
equality of the keys; AP's ``packed_sort`` sorts the complemented keys. A
multi-class call consults the autotuner with one class's row, as JAX's vmap
of the binary kernel does, and runs the variant on every row.
"""
from __future__ import annotations

import torch
from torch import Tensor

from metrics_tpu_torch.ops import autotune as _autotune
from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.compute import high_precision


@_telemetry.ranged("curve-ties")
def _tie_run_ids(sorted_vals: Tensor) -> Tensor:
    """0-based tie-run index of each element of a vector (or of each row of a
    matrix) already sorted along its last dim; equal neighbours share a run."""
    boundary = torch.ones_like(sorted_vals, dtype=torch.bool)
    boundary[..., 1:] = sorted_vals[..., 1:] != sorted_vals[..., :-1]
    return torch.cumsum(boundary, dim=-1) - 1


@_telemetry.ranged("curve-ties")
def _segment(values: Tensor, run_id: Tensor, reduce: str) -> Tensor:
    """Segment reduction of each row of ``values`` (C, N) over its tie runs, as
    ``jax.ops.segment_{sum,min,max}(..., num_segments=N)`` per row: one scatter
    over ``C * N`` segments, row ``c``'s runs offset by ``c * N``. Returns (C, N)."""
    c, n = values.shape
    ids = (run_id + n * torch.arange(c, device=run_id.device)[:, None]).reshape(-1)
    # out of place: under torch.func.vmap the zeros are unbatched and the values batched
    out = torch.zeros(c * n, dtype=values.dtype, device=values.device)
    if reduce == "sum":
        out = out.index_add(0, ids, values.reshape(-1))
    else:
        out = out.scatter_reduce(0, ids, values.reshape(-1), reduce=reduce, include_self=False)
    return out.reshape(c, n)


def _midranks_rows(x: Tensor) -> Tensor:
    """Average 1-based ascending ranks of each row of ``x`` (C, N), ties sharing their midrank."""
    n = x.shape[-1]
    with _telemetry.trace_range("curve-sort"):
        order = torch.argsort(x, dim=-1, stable=True)
        sorted_x = torch.gather(x, -1, order)
    run_id = _tie_run_ids(sorted_x)
    del sorted_x  # freed where the unnamed gather was
    with _telemetry.trace_range("curve-ties"):
        pos = torch.arange(n, dtype=torch.float32, device=x.device).expand_as(x)
        run_count = _segment(torch.ones_like(pos), run_id, "sum")
        run_first = _segment(pos, run_id, "amin")
        # the 1-based midrank of a run that starts at f (0-based) with c members: f + (c + 1) / 2
        mid_sorted = torch.gather(run_first, -1, run_id) + (torch.gather(run_count, -1, run_id) + 1.0) * 0.5
        return torch.zeros_like(mid_sorted).scatter(-1, order, mid_sorted)


def midranks(x: Tensor) -> Tensor:
    """Average 1-based ranks of ``x`` (ascending), ties sharing their midrank.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.sorted_curves import midranks
        >>> midranks(torch.tensor([3.0, 1.0, 3.0, 2.0, 3.0]))
        tensor([4., 1., 4., 2., 4.])
    """
    return _midranks_rows(x.reshape(1, -1).to(torch.float32))[0]


@_telemetry.ranged("curve-area")
def _auroc_from_rank_sum(rank_sum_pos: Tensor, n_pos: Tensor, n: int) -> Tensor:
    """AUROC from the midrank sum over the positives (the Mann-Whitney U identity)."""
    n_neg = n - n_pos
    u = rank_sum_pos - n_pos * (n_pos + 1.0) * 0.5
    denom = n_pos * n_neg
    return torch.where(denom > 0, u / torch.clamp(denom, min=1.0), torch.nan)


def _auroc_rows(preds: Tensor, y: Tensor) -> Tensor:
    """The reference formulation for each row of (C, N): midranks scattered
    back to input order, then the rank sum over the positives."""
    ranks = _midranks_rows(preds)
    return _auroc_from_rank_sum(torch.sum(ranks * y, dim=-1), torch.sum(y, dim=-1), preds.shape[-1])


def _auroc_midranks(preds: Tensor, y: Tensor) -> Tensor:
    """The reference formulation for one vector of scores."""
    return _auroc_rows(preds.reshape(1, -1), y.reshape(1, -1))[0]


@_telemetry.ranged("curve-ties")
def _sorted_midranks(run_id: Tensor) -> Tensor:
    """1-based midrank of each sorted position of each row, from its tie-run ids (no scatter)."""
    pos = torch.arange(run_id.shape[-1], dtype=torch.float32, device=run_id.device).expand(run_id.shape)
    run_count = _segment(torch.ones_like(pos), run_id, "sum")
    run_first = _segment(pos, run_id, "amin")
    return torch.gather(run_first, -1, run_id) + (torch.gather(run_count, -1, run_id) + 1.0) * 0.5


def _auroc_single_sort_rows(preds: Tensor, y: Tensor) -> Tensor:
    """``single_sort`` for each row: ranks, tie runs and the rank sum in sorted order."""
    with _telemetry.trace_range("curve-sort"):
        order = torch.argsort(preds, dim=-1, stable=True)
        sy = torch.gather(y, -1, order)
        sorted_preds = torch.gather(preds, -1, order)
    mid = _sorted_midranks(_tie_run_ids(sorted_preds))
    del sorted_preds  # freed where the unnamed gather was
    return _auroc_from_rank_sum(torch.sum(mid * sy, dim=-1), torch.sum(sy, dim=-1), preds.shape[-1])


def _sortable_score_keys(preds: Tensor) -> Tensor:
    """A monotone image of float32 scores in ``[0, 2**32)`` (int64 here, JAX's uint32):
    ascending keys are ascending scores, and equal keys are tied scores (``-0.0``
    folds to ``+0.0`` first, so the zero run stays one run). A NaN sorts by its sign
    bit, not last: the sweep disqualifies the packed variants on NaN scores."""
    p = torch.where(preds == 0.0, torch.zeros_like(preds), preds).contiguous()
    ub = p.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where((ub >> 31) == 1, ~ub & 0xFFFFFFFF, ub | (1 << 31))


@_telemetry.ranged("curve-sort")
def _packed_sort(keys: Tensor, y: Tensor):
    """Sort each row's keys with its labels in one sort of int64 values (key << 31 | position):
    the sorted keys and the labels in their order. Rows hold fewer than 2**31 scores."""
    n = keys.shape[-1]
    packed = (keys << 31) | torch.arange(n, device=keys.device, dtype=torch.int64)
    values = torch.sort(packed, dim=-1).values
    return values >> 31, torch.gather(y, -1, values & ((1 << 31) - 1))


def _auroc_packed_sort_rows(preds: Tensor, y: Tensor) -> Tensor:
    """``packed_sort`` for each row: one sort of packed keys carries the labels."""
    sorted_keys, sy = _packed_sort(_sortable_score_keys(preds), y)
    mid = _sorted_midranks(_tie_run_ids(sorted_keys))
    return _auroc_from_rank_sum(torch.sum(mid * sy, dim=-1), torch.sum(sy, dim=-1), preds.shape[-1])


def _auroc_single_sort(preds: Tensor, y: Tensor) -> Tensor:
    return _auroc_single_sort_rows(preds.reshape(1, -1), y.reshape(1, -1))[0]


def _auroc_packed_sort(preds: Tensor, y: Tensor) -> Tensor:
    return _auroc_packed_sort_rows(preds.reshape(1, -1), y.reshape(1, -1))[0]


_AUROC_ROWS = {"single_sort": _auroc_single_sort_rows, "packed_sort": _auroc_packed_sort_rows}


def _auroc_variant_rows(preds: Tensor, y: Tensor) -> Tensor:
    """The AUROC of each row (C, N) by the variant the autotuner serves one row with."""
    return _AUROC_ROWS.get(_autotune.dispatch("auroc_sort", (preds[0], y[0])), _auroc_rows)(preds, y)


@high_precision
def binary_auroc_sorted(preds: Tensor, target: Tensor) -> Tensor:
    """Exact binary AUROC by midranks; NaN when a class is empty.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.sorted_curves import binary_auroc_sorted
        >>> binary_auroc_sorted(torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34]), torch.tensor([0, 0, 1, 1, 1]))
        tensor(0.5000)
    """
    preds = torch.as_tensor(preds).reshape(-1).to(torch.float32)
    y = torch.as_tensor(target, device=preds.device).reshape(-1).to(torch.float32)
    if preds.shape[0] == 0:  # no data: undefined, like an empty class
        return torch.tensor(torch.nan, dtype=torch.float32, device=preds.device)
    return _auroc_variant_rows(preds.reshape(1, -1), y.reshape(1, -1))[0]


@_telemetry.ranged("curve-area")
def _ap_from_descending(ys: Tensor, run_id: Tensor, n: int) -> Tensor:
    """AP of each row from its labels sorted by descending score and its tie-run ids.

    Precisions at the ends of the runs do not depend on the order within a run.
    """
    cum_tp = torch.cumsum(ys, dim=-1)
    cnt = torch.arange(1, n + 1, dtype=torch.float32, device=ys.device).expand_as(ys)
    run_tp_end = _segment(cum_tp, run_id, "amax")
    run_cnt_end = _segment(cnt, run_id, "amax")
    prec_end = torch.gather(run_tp_end, -1, run_id) / torch.gather(run_cnt_end, -1, run_id)
    n_pos = cum_tp[..., -1]
    ap = torch.sum(ys * prec_end, dim=-1) / torch.clamp(n_pos, min=1.0)
    return torch.where(n_pos > 0, ap, torch.nan)


def _ap_rows(preds: Tensor, y: Tensor) -> Tensor:
    """The reference formulation for each row of (C, N): a descending argsort and two gathers."""
    with _telemetry.trace_range("curve-sort"):
        order = torch.argsort(-preds, dim=-1, stable=True)
        ys = torch.gather(y, -1, order)
        sorted_preds = torch.gather(preds, -1, order)
    run_id = _tie_run_ids(sorted_preds)
    del sorted_preds  # freed where the unnamed gather was
    return _ap_from_descending(ys, run_id, preds.shape[-1])


def _ap_packed_sort_rows(preds: Tensor, y: Tensor) -> Tensor:
    """``packed_sort`` for each row: the complemented keys sort descending in one sort
    carrying the labels (run-end precisions do not depend on the order within a run)."""
    sorted_keys, ys = _packed_sort(~_sortable_score_keys(preds) & 0xFFFFFFFF, y)
    return _ap_from_descending(ys, _tie_run_ids(sorted_keys), preds.shape[-1])


def _ap_argsort(preds: Tensor, y: Tensor) -> Tensor:
    return _ap_rows(preds.reshape(1, -1), y.reshape(1, -1))[0]


def _ap_packed_sort(preds: Tensor, y: Tensor) -> Tensor:
    return _ap_packed_sort_rows(preds.reshape(1, -1), y.reshape(1, -1))[0]


def _ap_variant_rows(preds: Tensor, y: Tensor) -> Tensor:
    """The AP of each row (C, N) by the variant the autotuner serves one row with."""
    if _autotune.dispatch("ap_sort", (preds[0], y[0])) == "packed_sort":
        return _ap_packed_sort_rows(preds, y)
    return _ap_rows(preds, y)


@high_precision
def binary_average_precision_sorted(preds: Tensor, target: Tensor) -> Tensor:
    """Exact binary AP (step interpolation, tie runs collapsed); NaN without positives.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.sorted_curves import binary_average_precision_sorted
        >>> binary_average_precision_sorted(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        tensor(0.8333)
    """
    preds = torch.as_tensor(preds).reshape(-1).to(torch.float32)
    y = torch.as_tensor(target, device=preds.device).reshape(-1).to(torch.float32)
    if preds.shape[0] == 0:  # no data: undefined, like an input without positives
        return torch.tensor(torch.nan, dtype=torch.float32, device=preds.device)
    return _ap_variant_rows(preds.reshape(1, -1), y.reshape(1, -1))[0]


def _one_vs_rest(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """The (N, C) float32 one-hot of an integer target, or a 2-D target as float32."""
    if target.ndim == preds.ndim:
        return target.to(torch.float32)
    return torch.nn.functional.one_hot(target.long(), num_classes).to(torch.float32)


def _class_rows(preds: Tensor, onehot: Tensor):
    """(N, C) scores and labels as contiguous (C, N) float32 rows, one per class."""
    return preds.to(torch.float32).T.contiguous(), onehot.T.contiguous()


@high_precision
def multiclass_auroc_sorted(preds: Tensor, target: Tensor, num_classes: int, average: str = "macro") -> Tensor:
    """One-vs-rest exact AUROC per class, averaged by ``macro``, ``weighted`` or ``none``.

    A class without positives or negatives scores 0.0 and stays in the macro
    mean, as in the eager curve path, where its flat ROC integrates to 0. In
    the weighted average an unobserved class has support 0 and drops out.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.sorted_curves import multiclass_auroc_sorted
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.3, 0.5], [0.6, 0.3, 0.1]])
        >>> multiclass_auroc_sorted(preds, torch.tensor([0, 1, 2, 1]), 3, "none")
        tensor([1.0000, 0.8750, 1.0000])
    """
    onehot = _one_vs_rest(preds, target, num_classes)
    if preds.shape[0] == 0:
        scores = torch.full((num_classes,), torch.nan, dtype=torch.float32, device=preds.device)
    else:
        scores = _auroc_variant_rows(*_class_rows(preds, onehot))
    scores = torch.nan_to_num(scores, nan=0.0)
    if average in ("none", None):
        return scores
    if average == "macro":
        return torch.mean(scores)
    if average == "weighted":
        support = onehot.sum(dim=0)
        return torch.sum(scores * support) / torch.clamp(support.sum(), min=1.0)
    raise ValueError(f"Unsupported average {average!r} for the sorted AUROC")


@high_precision
def multiclass_average_precision_sorted(
    preds: Tensor, target: Tensor, num_classes: int, average: str = "macro"
) -> Tensor:
    """One-vs-rest exact AP per class, averaged by ``micro``, ``macro``, ``weighted`` or ``none``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.ops.sorted_curves import multiclass_average_precision_sorted
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.3, 0.5], [0.6, 0.3, 0.1]])
        >>> multiclass_average_precision_sorted(preds, torch.tensor([0, 1, 2, 1]), 3, "none")
        tensor([1.0000, 0.8333, 1.0000])
    """
    onehot = _one_vs_rest(preds, target, num_classes)
    if average == "micro":
        return binary_average_precision_sorted(preds.reshape(-1), onehot.reshape(-1))
    if preds.shape[0] == 0:
        scores = torch.full((num_classes,), torch.nan, dtype=torch.float32, device=preds.device)
    else:
        scores = _ap_variant_rows(*_class_rows(preds, onehot))
    if average in ("none", None):
        return scores
    valid = ~torch.isnan(scores)
    safe = torch.where(valid, scores, 0.0)
    if average == "macro":
        return torch.sum(safe) / torch.clamp(valid.sum(), min=1)
    if average == "weighted":
        support = onehot.sum(dim=0)
        w = support / torch.clamp(support.sum(), min=1.0)
        return torch.sum(torch.where(valid, scores * w, 0.0))
    raise ValueError(f"Unsupported average {average!r} for the sorted AP")


# The autotuner's variants, consulted only while METRICS_TPU_AUTOTUNE is armed. They reduce the same
# terms in another order: a small float-summation tolerance. Each takes float32 (n,) scores and labels.
_SORT_TOL = 1e-4
_autotune.register_variant("auroc_sort", "midranks", _auroc_midranks, reference=True)
_autotune.register_variant("auroc_sort", "single_sort", _auroc_single_sort, tolerance=_SORT_TOL)
_autotune.register_variant("auroc_sort", "packed_sort", _auroc_packed_sort, tolerance=_SORT_TOL)
_autotune.register_variant("ap_sort", "argsort", _ap_argsort, reference=True)
_autotune.register_variant("ap_sort", "packed_sort", _ap_packed_sort, tolerance=_SORT_TOL)


__all__ = [
    "midranks",
    "binary_auroc_sorted",
    "binary_average_precision_sorted",
    "multiclass_auroc_sorted",
    "multiclass_average_precision_sorted",
]
