"""MetricTracker: the history of a metric, or of a collection, over steps.

JAX counterpart: `metrics_tpu/wrappers/tracker.py:34` (``increment`` `:85`,
``best_metric`` `:152`, the packed history `:210-260`); reference
`wrappers/tracker.py:26-213`. When the tree fits a journal record
(:func:`metrics_tpu_torch.ops.journal.journalable`), each finished step is
kept as one packed record (bytes on the host: one device-to-host copy a
step) and the live metric is reset for the next step; reading a step
restores its record into one scratch copy, bit for bit. A tree the journal
declines keeps a deep copy of the metric a step, as before.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import journal as _journal
from metrics_tpu_torch.parallel import bucketing as _bucketing
from metrics_tpu_torch.utils.exceptions import JournalFault
from metrics_tpu_torch.utils.prints import rank_zero_warn


class MetricTracker:
    """A copy of a metric (or collection) for each step; the newest is the one that accumulates.

    ``best_metric`` returns the best value over the steps and, with
    ``return_step``, its step (JAX's contract: the reference's ``best_metric``
    returns the argmax index as the value).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricTracker
        >>> tracker = MetricTracker(Accuracy(device="cpu"), maximize=True)
        >>> target = torch.tensor([1, 1, 1, 0])
        >>> for preds in (torch.tensor([0, 1, 1, 0]), torch.tensor([1, 1, 1, 0])):
        ...     tracker.increment()
        ...     tracker.update(preds, target)
        >>> tracker.compute_all()
        tensor([0.7500, 1.0000])
        >>> tracker.best_metric(return_step=True)
        (1.0, 1)
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a metrics_tpu_torch"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        if isinstance(metric, Metric) and not isinstance(maximize, bool):
            raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
        self.maximize = maximize
        # finished steps as packed journal records when the tree fits one, else
        # live copies; the last entry is always the live, accumulating metric
        self._history: List[Union[Metric, MetricCollection, bytes]] = []
        self._increment_called = False
        self._packed_mode: Optional[bool] = None  # decided at the first increment
        self._pristine: Optional[bytes] = None  # the packed default state, for reset_all
        self._scratch: Optional[Union[Metric, MetricCollection]] = None

    @property
    def n_steps(self) -> int:
        """The number of steps, one per ``increment()``."""
        return len(self._history)

    def increment(self) -> None:
        """Start a new step: the finished one is packed into a record (or kept as
        a copy when the journal declines the tree) and the live metric is reset."""
        self._increment_called = True
        if not self._history:
            live = deepcopy(self._base_metric)
            live.reset()
            self._history.append(live)
            self._packed_mode = _journal.journalable(self._node_list(live)) is None
            if self._packed_mode:
                self._pristine = self._pack(live)
            return
        if self._packed_mode:
            live = self._history[-1]
            try:
                record = self._pack(live)
            except JournalFault:
                # a state grew into something the pack declines: back to copies
                self._materialize()
            else:
                self._history[-1] = record
                self._history.append(live)
                live.reset()
                return
        step = deepcopy(self._base_metric)
        step.reset()
        self._history.append(step)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._history[-1](*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._history[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._history[-1].compute()

    def compute_all(self) -> Union[Tensor, Dict[str, Tensor]]:
        """Every step's value, stacked along a new first dim (a dict of them for a collection)."""
        self._check_for_increment("compute_all")
        res = [self._step_metric(i).compute() for i in range(len(self._history))]
        if isinstance(self._base_metric, MetricCollection):
            return {k: torch.stack([r[k] for r in res], dim=0) for k in res[0].keys()}
        return torch.stack(res, dim=0)

    def reset(self) -> None:
        """Reset the current step's metric."""
        if self._history:
            self._history[-1].reset()

    def reset_all(self) -> None:
        for i, entry in enumerate(self._history):
            if isinstance(entry, bytes):
                self._history[i] = self._pristine
            else:
                entry.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[
        None,
        float,
        Tuple[float, int],
        Tuple[None, None],
        Dict[str, Optional[float]],
        Tuple[Dict[str, Optional[float]], Dict[str, Optional[int]]],
    ]:
        """The best value over the steps (and its step): two host reads a value."""
        if isinstance(self._base_metric, Metric):
            try:
                values = self.compute_all()
                fn = torch.argmax if self.maximize else torch.argmin
                idx = int(fn(values))
                if return_step:
                    return float(values[idx]), idx
                return float(values[idx])
            except (ValueError, TypeError, RuntimeError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric: {error}"
                    "this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.",
                    UserWarning,
                )
                if return_step:
                    return None, None
                return None
        res = self.compute_all()
        maximize = self.maximize if isinstance(self.maximize, list) else len(res) * [self.maximize]
        value: Dict[str, Optional[float]] = {}
        idx: Dict[str, Optional[int]] = {}
        for i, (k, v) in enumerate(res.items()):
            try:
                fn = torch.argmax if maximize[i] else torch.argmin
                out = int(fn(v))
                value[k], idx[k] = float(v[out]), out
            except (ValueError, TypeError, RuntimeError) as error:
                rank_zero_warn(
                    f"Encountered the following error when trying to get the best metric for metric {k}:"
                    f"{error} this is probably due to the 'best' not being defined for this metric."
                    "Returning `None` instead.",
                    UserWarning,
                )
                value[k], idx[k] = None, None
        if return_step:
            return value, idx
        return value

    # ------------------------------------------------------- packed history
    @staticmethod
    def _node_list(metric: Union[Metric, MetricCollection]) -> List[Metric]:
        if isinstance(metric, MetricCollection):
            return metric._journal_nodes()
        return _bucketing.tree_nodes(metric)

    def _pack(self, metric: Union[Metric, MetricCollection]) -> bytes:
        nodes = self._node_list(metric)
        for node in nodes:
            node._defer_barrier()
            node._canonicalize_list_states()
        return _journal.pack_record(nodes)

    def _step_metric(self, i: int) -> Union[Metric, MetricCollection]:
        """Step ``i`` as a metric: the entry itself when live, else its record
        restored into one shared scratch copy (valid until the next call)."""
        entry = self._history[i]
        if not isinstance(entry, bytes):
            return entry
        if self._scratch is None:
            self._scratch = deepcopy(self._base_metric)
        self._scratch.reset()
        manifest, payload = _journal.decode_record(entry, origin=f"<tracker step {i}>")
        _journal.restore_nodes(self._node_list(self._scratch), manifest, payload)
        if isinstance(self._scratch, MetricCollection):
            self._scratch._relink_groups()
        return self._scratch

    def _materialize(self) -> None:
        """From records back to copies: each record restored into its own copy."""
        for i, entry in enumerate(self._history):
            if not isinstance(entry, bytes):
                continue
            clone = deepcopy(self._base_metric)
            clone.reset()
            manifest, payload = _journal.decode_record(entry, origin=f"<tracker step {i}>")
            _journal.restore_nodes(self._node_list(clone), manifest, payload)
            self._history[i] = clone
        self._packed_mode = False

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")


__all__ = ["MetricTracker"]
