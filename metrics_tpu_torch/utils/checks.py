"""Classification input validation and canonicalisation.

JAX counterpart: `metrics_tpu/utils/checks.py` (validation modes `:69-240`,
``_input_format_classification`` and its helpers `:240-523`); reference
`src/torchmetrics/utilities/checks.py:68-454`.

Inputs are classified into one of four :class:`DataType` cases and converted
to canonical binary int32 tensors of shape ``(N, C)`` (or ``(N, C, X)`` for
multi-dim multi-class) by thresholding, one-hot or top-k selection
(:func:`_input_format_classification`). Multi-class inputs whose consumer
needs no more than each position's class have a second canonical form: after
the same validation (:func:`_validated_classification`), the class id of each
side (:func:`_class_id_form`, the arg-max of the one-hot), so that the counts
come from one pair histogram and no one-hot is built. The consumer chooses the
form. ``canon_stats()`` counts the updates of each form.

Shape and dtype checks always run. Checks that read data values (label
ranges, probability bounds) cost one device-to-host copy on the card, so they
follow the validation mode, read from ``METRICS_TPU_VALIDATION`` as in the JAX
package: ``"full"`` (the default) checks every update, ``"first"`` checks the
first update of each input signature per metric instance, ``"off"`` never.

Under a transform no value is read at all (:func:`_is_concrete`, JAX
counterpart `checks.py:32`): inside ``torch.func.vmap``, on fake tensors and
while a CUDA graph is being captured, the value checks skip without taking
the signature, as a traced update skips them in the JAX package, so a later
eager update of the same shapes is still checked.
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor
from torch._subclasses.fake_tensor import FakeTensor

from metrics_tpu_torch.ops import telemetry as _telemetry
from metrics_tpu_torch.utils.data import select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType

_MODES = ("full", "first", "off")
_BENIGN_STATS = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)  # t_min, t_max, p_min, p_max
_validation_mode: Optional[str] = None  # resolved lazily from the environment
# "first"-mode memory of input signatures already checked, for calls made
# outside any metric; bounded FIFO, so an evicted signature is checked again
_seen_check_keys: dict = {}
_SEEN_KEYS_CAP = 4096
# Metric's wrapped update points this at the metric whose update is running,
# so "first"-mode memory is kept per metric instance
_check_owner = None
_cache_generation = 0  # bumped by set_validation_mode to invalidate per-instance memory
# canonicalizations by form: class ids, or a one-hot (or top-k) mask of the classes
_forms: Dict[str, int] = {"perf_canon_class_ids": 0, "perf_canon_onehot": 0}
# float32 holds every integer up to 2**24 exactly: a range read tells whether labels lie in [0, C) only below it
_EXACT_F32 = 2**24


def canon_stats() -> Dict[str, int]:
    """Canonicalizations since the last reset, by form: ``perf_canon_class_ids`` (the
    class ids of :func:`_class_id_form`) and ``perf_canon_onehot`` (a one-hot
    or top-k mask of the classes).

    Example:
        >>> from metrics_tpu_torch.utils.checks import canon_stats
        >>> sorted(canon_stats())
        ['perf_canon_class_ids', 'perf_canon_onehot']
    """
    return dict(_forms)


def _reset_forms() -> None:
    for key in _forms:
        _forms[key] = 0


_telemetry.register_reset("canonical-forms", _reset_forms)


def _is_concrete(*tensors) -> bool:
    """Whether the values of ``tensors`` may be read on the host: False for a
    tensor wrapped by a ``torch.func`` transform, for a ``FakeTensor`` and,
    for a CUDA tensor, while the current stream is capturing a CUDA graph."""
    on_card = False
    for t in tensors:
        if not isinstance(t, Tensor):
            continue
        if torch._C._functorch.is_functorch_wrapped_tensor(t) or isinstance(t, FakeTensor):
            return False
        on_card = on_card or t.is_cuda
    return not (on_card and torch.cuda.is_current_stream_capturing())


def set_validation_mode(mode: str) -> None:
    """Choose when value-dependent input checks run: ``"full"`` (every update),
    ``"first"`` (first update per input signature and metric) or ``"off"``."""
    if mode not in _MODES:
        raise ValueError(f"validation mode must be 'full', 'first' or 'off', got {mode!r}")
    global _validation_mode, _cache_generation
    _validation_mode = mode
    _seen_check_keys.clear()
    _cache_generation += 1


def _get_validation_mode() -> str:
    global _validation_mode
    if _validation_mode is None:
        mode = os.environ.get("METRICS_TPU_VALIDATION", "full")
        _validation_mode = mode if mode in _MODES else "full"
    return _validation_mode


def _should_value_check(preds: Tensor, target: Tensor, key_extra: tuple = ()) -> bool:
    mode = _get_validation_mode()
    if mode == "off":
        return False
    if not _is_concrete(preds, target):
        # no value under a transform is read; the signature is not taken, so a
        # later eager update of the same shapes is still checked
        return False
    if mode == "full":
        return True
    key = (tuple(preds.shape), str(preds.dtype), tuple(target.shape), str(target.dtype), str(preds.device), key_extra)
    owner = _check_owner
    if owner is not None:
        cache = owner.__dict__.get("_value_check_seen")
        if cache is None or owner.__dict__.get("_value_check_gen") != _cache_generation:
            cache = {}
            owner.__dict__["_value_check_seen"] = cache
            owner.__dict__["_value_check_gen"] = _cache_generation
    else:
        cache = _seen_check_keys
    if key in cache:
        return False
    cache[key] = None
    while len(cache) > _SEEN_KEYS_CAP:
        cache.pop(next(iter(cache)))
    return True


class _ValueStats:
    """Lazily fetched ``(t_min, t_max, p_min, p_max)`` shared across check stages.

    The four reductions go to the host as one copy. When the validation mode
    skips this signature, benign values that pass every check are returned
    without touching the device.
    """

    __slots__ = ("_preds", "_target", "_vals")

    def __init__(self, preds: Tensor, target: Tensor, force: bool = False, key_extra: tuple = ()) -> None:
        self._preds, self._target = preds, target
        self._vals = None if (force or _should_value_check(preds, target, key_extra)) else _BENIGN_STATS

    @property
    def is_real(self) -> bool:
        """True when the stats reflect actual data (not the benign skip values)."""
        return self._vals is not _BENIGN_STATS

    def _fetch(self) -> np.ndarray:
        if self._vals is None:
            self._vals = self._read()
        return self._vals

    @_telemetry.ranged("host-read", "value-stats")
    def _read(self) -> np.ndarray:
        t, p = self._target, self._preds
        if t.numel() == 0 or p.numel() == 0:
            # torch raises RuntimeError on the min of no values; jnp raises ValueError
            raise ValueError("zero-size array to reduction operation min which has no identity")
        if _is_concrete(t, p):
            stats = torch.stack([t.min().float(), t.max().float(), p.min().float(), p.max().float()])
            return stats.cpu().numpy()
        # a pair half under a transform: each concrete side is read on its
        # own, the other reports the benign values (JAX `checks.py:205-217`)
        vals = _BENIGN_STATS.copy()
        if _is_concrete(t):
            vals[:2] = torch.stack([t.min().float(), t.max().float()]).cpu().numpy()
        if _is_concrete(p):
            vals[2:] = torch.stack([p.min().float(), p.max().float()]).cpu().numpy()
        return vals

    def known(self) -> Optional[np.ndarray]:
        """The four values where both sides were read from the data, else None. Reads nothing."""
        if self._vals is None or self._vals is _BENIGN_STATS or not _is_concrete(self._preds, self._target):
            return None
        return self._vals

    @property
    def target_min(self) -> float:
        return float(self._fetch()[0])

    @property
    def target_max(self) -> float:
        return float(self._fetch()[1])

    @property
    def preds_min(self) -> float:
        return float(self._fetch()[2])

    @property
    def preds_max(self) -> float:
        return float(self._fetch()[3])


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, got {preds.shape} and {target.shape}"
        )


def _check_broadcastable(a: Tuple[int, ...], b: Tuple[int, ...]) -> None:
    """Raise as ``jnp`` does when arrays of shapes ``a`` and ``b`` cannot broadcast.

    ``jnp`` raises ValueError when the ranks differ and TypeError when they
    are equal; torch raises RuntimeError in both cases.
    """
    for x, y in zip(reversed(a), reversed(b)):
        if x != y and x != 1 and y != 1:
            if len(a) == len(b):
                raise TypeError(f"add got incompatible shapes for broadcasting: {tuple(a)}, {tuple(b)}.")
            raise ValueError(f"Incompatible shapes for broadcasting: shapes={[tuple(a), tuple(b)]}")


def _check_for_empty(preds: Tensor, target: Tensor) -> bool:
    return preds.numel() == 0 and target.numel() == 0


def _squeeze_excess_dims(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Drop all size-1 dims except the leading N dim (reference ``_input_squeeze``)."""
    if preds.shape[:1] == (1,):
        preds = preds.squeeze()[None]
        target = target.squeeze()[None]
    else:
        if 1 in preds.shape:
            preds = preds.squeeze()
        if 1 in target.shape:
            target = target.squeeze()
    return preds, target


def _basic_validation(preds, target, threshold, multiclass, ignore_index, stats=None) -> None:
    if _check_for_empty(preds, target):
        return
    if target.is_floating_point():
        raise ValueError("The `target` has to be an integer tensor.")
    preds_float = preds.is_floating_point()
    if preds.shape[0] != target.shape[0]:
        raise ValueError("The `preds` and `target` should have the same first dimension.")
    stats = stats or _ValueStats(preds, target)
    if ignore_index is None and stats.target_min < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if ignore_index is not None and ignore_index >= 0 and stats.target_min < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if not preds_float and stats.preds_min < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if multiclass is False and stats.target_max > 1:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")
    if multiclass is False and not preds_float and stats.preds_max > 1:
        raise ValueError("If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")


def _case_and_implied_classes(preds: Tensor, target: Tensor, stats=None) -> Tuple[DataType, int]:
    """Resolve the input case from shapes and dtypes (reference `:68-121`)."""
    preds_float = preds.is_floating_point()
    if stats is None:
        stats = _ValueStats(preds, target)
    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                f"The `preds` and `target` should have the same shape, got {preds.shape} and {target.shape}."
            )
        if preds_float and target.numel() > 0 and stats.target_max > 1:
            raise ValueError(
                "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
            )
        if preds.ndim == 1 and preds_float:
            case = DataType.BINARY
        elif preds.ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif preds.ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS
        implied_classes = int(np.prod(preds.shape[1:])) if preds.numel() > 0 else 0
    elif preds.ndim == target.ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        implied_classes = preds.shape[1] if preds.numel() > 0 else 0
        case = DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    return case, implied_classes


def _validate_num_classes(case, preds, target, num_classes, multiclass, implied_classes, stats=None) -> None:
    if case == DataType.BINARY:
        if num_classes > 2:
            raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
        if num_classes == 2 and not multiclass:
            raise ValueError(
                "Your data is binary and `num_classes=2`, but `multiclass` is not True."
                " Set it to True if you want to transform binary data to multi-class format."
            )
        if num_classes == 1 and multiclass:
            raise ValueError("You have binary data and have set `multiclass=True`, but `num_classes` is 1.")
    elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        if num_classes == 1 and multiclass is not False:
            raise ValueError(
                "You have set `num_classes=1`, but predictions are integers."
                " If you want to convert (multi-dimensional) multi-class data with 2 classes"
                " to binary/multi-label, set `multiclass=False`."
            )
        if num_classes > 1:
            if multiclass is False and implied_classes != num_classes:
                raise ValueError(
                    "You have set `multiclass=False`, but the implied number of classes"
                    " (from shape of inputs) does not match `num_classes`."
                )
            if target.numel() > 0 and num_classes <= (stats or _ValueStats(preds, target)).target_max:
                raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
            if preds.shape != target.shape and num_classes != implied_classes:
                raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")
    elif case == DataType.MULTILABEL:
        if multiclass and num_classes != 2:
            raise ValueError("Your have set `multiclass=True`, but `num_classes` is not equal to 2.")
        if not multiclass and num_classes != implied_classes:
            raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")


def _validate_top_k(top_k, case, implied_classes, multiclass, preds_float) -> None:
    if case == DataType.BINARY:
        raise ValueError("You can not use `top_k` parameter with binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("The `top_k` has to be an integer larger than 0.")
    if not preds_float:
        raise ValueError("You have set `top_k`, but you do not have probability predictions.")
    if multiclass is False:
        raise ValueError("If you set `multiclass=False`, you can not set `top_k`.")
    if case == DataType.MULTILABEL and multiclass:
        raise ValueError(
            "If you want to transform multi-label data to 2 class multi-dimensional"
            " multi-class data using `multiclass=True`, you can not use `top_k`."
        )
    if top_k >= implied_classes:
        raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


@_telemetry.ranged("validate")
def _check_classification_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
    stats: Optional[_ValueStats] = None,
) -> DataType:
    """Full input validation; returns the resolved :class:`DataType` case."""
    if stats is None:
        stats = _ValueStats(preds, target, key_extra=(threshold, num_classes, multiclass, top_k, ignore_index))
    _basic_validation(preds, target, threshold, multiclass, ignore_index, stats)
    case, implied_classes = _case_and_implied_classes(preds, target, stats)

    if preds.shape != target.shape:
        if multiclass is False and implied_classes != 2:
            raise ValueError(
                "You have set `multiclass=False`, but have more than 2 classes in your data,"
                " based on the C dimension of `preds`."
            )
        if target.numel() > 0 and stats.target_max >= implied_classes:
            raise ValueError(
                "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
            )

    if num_classes:
        _validate_num_classes(case, preds, target, num_classes, multiclass, implied_classes, stats)

    if top_k is not None:
        _validate_top_k(top_k, case, implied_classes, multiclass, preds.is_floating_point())

    return case


def _classification_case(preds, target, threshold: float = 0.5) -> DataType:
    """Resolve the input's :class:`DataType` case with the full validation of
    :func:`_input_format_classification`, but format nothing.

    The curve metrics buffer raw rows: they need the case at ``update`` time
    to check that it stays the same, and leave the layout transform to the
    moment the rows are observed (JAX counterpart `checks.py:427`).
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    preds, target = _squeeze_excess_dims(preds, target)
    return _check_classification_inputs(
        preds, target, threshold=threshold, num_classes=None, multiclass=None, top_k=None
    )


def _validated_classification(
    preds, target, threshold: float, top_k: Optional[int], num_classes: Optional[int],
    multiclass: Optional[bool], ignore_index: Optional[int],
) -> Tuple[Tensor, Tensor, DataType, _ValueStats]:
    """The inputs as tensors, their excess dims squeezed, checked: ``(preds, target, case, stats)``."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    preds, target = _squeeze_excess_dims(preds, target)
    if preds.dtype == torch.float16:
        preds = preds.to(torch.float32)

    stats = _ValueStats(preds, target, key_extra=(threshold, num_classes, multiclass, top_k, ignore_index))
    case = _check_classification_inputs(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
        stats=stats,
    )
    return preds, target, case, stats


def _input_format_classification(
    preds,
    target,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Canonicalise ``(preds, target)`` to int32 binary tensors ``(N, C)`` / ``(N, C, X)``.

    Same contract as reference ``_input_format_classification``
    (`utilities/checks.py:313-454`): binary -> ``(N, 1)`` thresholded;
    multi-class -> one-hot/top-k ``(N, C)``; multi-label -> thresholded
    ``(N, C)`` (extra dims flattened); multi-dim multi-class -> ``(N, C, X)``.
    The ``multiclass`` flag force-converts between views.
    """
    preds, target, case, stats = _validated_classification(
        preds, target, threshold, top_k, num_classes, multiclass, ignore_index
    )
    return _canonical_form(preds, target, case, threshold, top_k, num_classes, multiclass, stats)


class ClassIds(NamedTuple):
    """Both sides of a multi-class input as the class ids of its one-hot form.

    ``preds`` and ``target`` are int64, ``(N,)`` where the one-hot form is
    ``(N, C)`` and ``(N, X)`` where it is ``(N, C, X)``: the one-hot's arg-max
    along C. ``num_classes`` is the one-hot's width C. A label outside
    ``[0, C)``, whose one-hot column is all zero, takes the id the caller
    chose (``outside``).
    """

    preds: Tensor
    target: Tensor
    num_classes: int


def _takes_class_ids(
    preds: Tensor, target: Tensor, case: DataType, top_k: Optional[int] = None, multiclass: Optional[bool] = None
) -> bool:
    """Whether validated inputs have a class-id form (:func:`_class_id_form`) that stands for their one-hot:
    a multi-class or multi-dim multi-class batch that is not empty, ``top_k`` None or 1, ``multiclass`` not
    False. Reads nothing."""
    return (
        case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS)
        and top_k in (None, 1)
        and multiclass is not False
        and not _check_for_empty(preds, target)
    )


def _class_count(
    preds: Tensor, target: Tensor, num_classes: Optional[int], stats: _ValueStats
) -> Tuple[int, _ValueStats]:
    """The one-hot width C of multi-class inputs: the scores' channels, else ``num_classes`` or one above the
    largest label (read on the host), at least 2; and the stats that hold the values read."""
    if preds.is_floating_point():
        return preds.shape[1], stats
    if num_classes is None:
        if not _is_concrete(preds, target):
            raise ValueError(
                "`num_classes` must be given explicitly for label inputs under a transform"
                " (vmap, a CUDA graph capture): the class count defines the output shape."
            )
        # inference, not validation: needs the real values
        stats = stats if stats.is_real else _ValueStats(preds, target, force=True)
        num_classes = int(max(stats.preds_max, stats.target_max) + 1)
    return max(2, num_classes), stats


@_telemetry.ranged("canonicalize")
def _class_id_form(
    preds: Tensor,
    target: Tensor,
    n_cls: int,
    stats: _ValueStats,
    outside: int,
) -> ClassIds:
    """The class ids of validated inputs that :func:`_takes_class_ids`, of ``n_cls`` classes (:func:`_class_count`).

    Float scores give their arg-max (``select_topk(preds, 1)``'s index, so ties and NaN
    resolve alike); labels stay as they are. A side is mapped into ``[0, C)`` and
    ``outside`` only where the range read of the validation does not already show it
    there, so a validated update adds no pass over the labels.
    """
    _forms["perf_canon_class_ids"] += 1
    n = target.shape[0]
    scores = preds.is_floating_point()
    if scores:
        preds = preds.argmax(dim=1)
    vals = stats.known() if n_cls <= _EXACT_F32 else None

    def into_classes(x: Tensor, shown: bool) -> Tensor:
        x = x.to(torch.int64)
        return x if shown else torch.where((x >= 0) & (x < n_cls), x, outside)

    preds = into_classes(preds, scores or (vals is not None and vals[2] >= 0 and vals[3] < n_cls))
    target = into_classes(target, vals is not None and vals[0] >= 0 and vals[1] < n_cls)
    # the one-hot form's layout: (N, C, X), its last dim squeezed where X is 1
    preds, target = preds.reshape(n, -1), target.reshape(n, -1)
    if preds.shape[1] == 1:
        preds, target = preds[:, 0], target[:, 0]
    return ClassIds(preds, target, n_cls)


@_telemetry.ranged("canonicalize")
def _canonical_form(
    preds: Tensor,
    target: Tensor,
    case: DataType,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    multiclass: Optional[bool],
    stats: _ValueStats,
) -> Tuple[Tensor, Tensor, DataType]:
    """:func:`_input_format_classification`'s layout transform of validated inputs of case ``case``."""
    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32) if preds.is_floating_point() else preds
        num_classes = num_classes if not multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        _forms["perf_canon_onehot"] += 1
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        _forms["perf_canon_onehot"] += 1
        if preds.is_floating_point():
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            num_classes, _ = _class_count(preds, target, num_classes, stats)
            preds = to_onehot(preds, num_classes)
        target = to_onehot(target, max(2, int(num_classes) if num_classes else 2))

        if multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if not _check_for_empty(preds, target):
        if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass:
            target = target.reshape(target.shape[0], target.shape[1], -1)
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
        else:
            target = target.reshape(target.shape[0], -1)
            preds = preds.reshape(preds.shape[0], -1)

    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    return preds.to(torch.int32), target.to(torch.int32), case


def _is_integer_dtype(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _check_retrieval_dtypes(indexes: Tensor, preds: Tensor, target: Tensor) -> None:
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if not _is_integer_dtype(indexes.dtype):
        raise ValueError("`indexes` must be a tensor of long integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if target.is_complex():
        raise ValueError("`target` must be a tensor of booleans, integers or floats")


def _check_retrieval_metadata(
    indexes,
    preds,
    target,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Check a retrieval triple and return it as it came (JAX counterpart `checks.py:527`).

    The retrieval metrics buffer raw rows and flatten, cast and drop ignored
    rows only when the rows are observed, so this formats nothing. Shapes and
    dtypes are always checked. The checks of values (binary targets; a batch
    that ``ignore_index`` leaves empty) read the device once, and follow the
    validation mode.
    """
    indexes, preds, target = (torch.as_tensor(v) for v in (indexes, preds, target))
    _check_retrieval_dtypes(indexes, preds, target)
    if preds.numel() == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty")
    needs_range = not allow_non_binary_target
    if (needs_range or ignore_index is not None) and _should_value_check(
        preds, target, key_extra=("retrieval", ignore_index)
    ):
        t = target.reshape(-1).to(torch.float32)
        valid = torch.ones_like(t, dtype=torch.bool) if ignore_index is None else target.reshape(-1) != ignore_index
        inf = torch.tensor(float("inf"), device=t.device)
        stats = torch.stack(
            [valid.any().to(torch.float32), torch.where(valid, t, inf).min(), torch.where(valid, t, -inf).max()]
        ).tolist()
        if not stats[0]:
            raise ValueError("`indexes`, `preds` and `target` must be non-empty")
        if needs_range and (stats[2] > 1 or stats[1] < 0):
            raise ValueError("`target` must contain binary values")
    return indexes, preds, target


def _check_retrieval_inputs(
    indexes,
    preds,
    target,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Check and flatten a retrieval triple (JAX counterpart `checks.py:603`).

    Returns 1-D rows: float32 scores, float32 or int32 targets by their
    family, int32 indexes (int64 kept), rows whose target is
    ``ignore_index`` dropped. The binary-target check reads the device once
    and follows the validation mode.
    """
    indexes, preds, target = (torch.as_tensor(v) for v in (indexes, preds, target))
    _check_retrieval_dtypes(indexes, preds, target)
    target_is_float = target.is_floating_point()
    indexes = indexes.reshape(-1)
    preds = preds.reshape(-1).to(torch.float32)
    target = target.reshape(-1)
    if ignore_index is not None:
        valid = target != ignore_index
        indexes, preds, target = indexes[valid], preds[valid], target[valid]
    if preds.numel() == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty")
    if not allow_non_binary_target and _should_value_check(preds, target, key_extra=("retrieval", ignore_index)):
        tmin, tmax = torch.stack([target.min().to(torch.float32), target.max().to(torch.float32)]).tolist()
        if tmax > 1 or tmin < 0:
            raise ValueError("`target` must contain binary values")
    target = target.to(torch.float32) if target_is_float else target.to(torch.int32)
    return (indexes if indexes.dtype == torch.int64 else indexes.to(torch.int32)), preds, target


def _input_squeeze(preds, target) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    return _squeeze_excess_dims(preds, torch.as_tensor(target, device=preds.device))


__all__ = [
    "_check_broadcastable",
    "_check_classification_inputs",
    "_check_retrieval_inputs",
    "_check_retrieval_metadata",
    "_check_same_shape",
    "_classification_case",
    "_input_format_classification",
    "_input_squeeze",
    "canon_stats",
    "set_validation_mode",
]
