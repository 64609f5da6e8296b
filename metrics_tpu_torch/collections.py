"""MetricCollection: one call fanned out over several metrics, with compute groups.

JAX counterpart: `metrics_tpu/collections.py` (construction `:76-92`, update
with compute groups `:998-1027`, compute `:1039-1102`, group merging
`:2062-2140`); reference `src/torchmetrics/collections.py`.

Compute groups: after the first update, metrics whose states are equal are
merged into a group, and from then on only the group's first member (its
leader) updates. The other members point at the leader's state tensors; the
references are renewed whenever the members are read, because an update
rebinds the leader's states to new tensors.

As in TorchMetrics, the collection is an ``nn.ModuleDict``, so ``.to()`` and
``state_dict()`` reach every member.

Suite sync (`metrics_tpu/collections.py` ``_partition_sync_members`` `:1144`,
``sync`` `:1362`, ``unsync`` `:1489`, ``_auto_sync_context`` `:1533`): with
more than one process, ``compute()`` syncs the whole suite in one payload
collective before its members compute, then restores their local states.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel import bucketing as _bucketing
from metrics_tpu_torch.parallel.sync import distributed_available as _distributed_available
from metrics_tpu_torch.utils.data import _flatten_dict, allclose
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

_UNSET_GROUP = object()


class MetricCollection(nn.ModuleDict):
    """Chain metrics with the same call signature into a single object.

    Args:
        metrics: a Metric, a sequence of Metrics (keyed by class name), or a
            dict name -> Metric (keys sorted alphabetically).
        prefix / postfix: strings added around output-dict keys.
        compute_groups: ``True`` to find metrics that share identical state
            after the first update (only the group leader then updates); a
            list of lists to pin groups by hand; ``False`` to disable.
        device: when given, every member is moved there; when None, each
            member stays on the device it was built for.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricCollection, Precision
        >>> collection = MetricCollection([Accuracy(num_classes=3, device="cpu"),
        ...                                Precision(num_classes=3, average="macro", device="cpu")])
        >>> collection.update(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))
        >>> {k: round(float(v), 4) for k, v in sorted(collection.compute().items())}
        {'Accuracy': 0.75, 'Precision': 0.8333}
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._state_is_copy = False
        self._groups: Dict[int, List[str]] = {}

        self.add_metrics(metrics, *additional_metrics)
        if device is not None:
            self.to(device)

    # ----------------------------------------------------------- call surface
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call ``forward`` on every metric, kwargs filtered per update signature."""
        res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items(keep_base=True, copy_state=False)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every metric, or once the groups are known, every group's leader."""
        if self._groups_checked:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                m0.update(*args, **m0._filter_kwargs(**kwargs))
                for name in cg[1:]:
                    mi = self._modules[name]
                    mi._update_count = m0._update_count
                    mi._computed = None  # the leader's update invalidates the members' caches
            if self._state_is_copy:
                self._compute_groups_create_state_ref()
                self._state_is_copy = False
        else:
            for _, m in self.items(keep_base=True, copy_state=False):
                m.update(*args, **m._filter_kwargs(**kwargs))
            if self._enable_compute_groups:
                self._merge_compute_groups()
                self._compute_groups_create_state_ref()
                self._groups_checked = True

    def compute(self) -> Dict[str, Any]:
        ctx = self._auto_sync_context()
        if ctx is not None:
            # the whole suite synced up front: every member computes presynced
            with ctx:
                res = {k: m.compute() for k, m in self.items(keep_base=True, copy_state=False)}
        else:
            res = {k: m.compute() for k, m in self.items(keep_base=True, copy_state=False)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    def reset(self) -> None:
        for _, m in self.items(keep_base=True, copy_state=False):
            m.reset()
        if self._enable_compute_groups and self._groups_checked:
            self._compute_groups_create_state_ref()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True, copy_state=False):
            m.persistent(mode)

    # ------------------------------------------------------------------- sync
    def _partition_sync_members(
        self, dist_sync_fn: Optional[Any], process_group: Optional[Any]
    ) -> Tuple[List[Tuple[str, Metric]], List[Tuple[Metric, List[Metric]]], List[Metric], Any]:
        """Split the members into those whose trees pack into the suite's one
        payload collective and those that sync on their own (a custom gather,
        states that cannot be packed, another process group). Returns
        ``(members, coalesced, individual, group)``; raises when a member is
        already synced."""
        members = list(self.items(keep_base=True, copy_state=False))
        if any(m._is_synced for _, m in members):
            raise MetricsUserError("The Metric has already been synced.")
        coalesced: List[Tuple[Metric, List[Metric]]] = []
        individual: List[Metric] = []
        anchor_group: Any = _UNSET_GROUP
        for _, m in members:
            nodes: List[Metric] = []
            eligible = dist_sync_fn is None and m.dist_sync_fn is None
            if eligible:
                nodes = _bucketing.tree_nodes(m)
                for n in nodes:
                    n._canonicalize_list_states()
                group = process_group if process_group is not None else m.process_group
                eligible = (
                    not any(n._is_synced for n in nodes)
                    and (process_group is not None or not any(n.process_group is not m.process_group for n in nodes[1:]))
                    and _bucketing.coalescible(nodes)
                )
                if eligible:
                    if anchor_group is _UNSET_GROUP:
                        anchor_group = group
                    elif group is not anchor_group:
                        eligible = False  # one collective, one group
            if eligible:
                coalesced.append((m, nodes))
            else:
                individual.append(m)
        return members, coalesced, individual, anchor_group

    def sync(
        self,
        dist_sync_fn: Optional[Any] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Any] = _distributed_available,
    ) -> None:
        """Sync every member across processes: the whole suite in one coalesced payload collective where it can.

        Members are packed member by member, not group leader by leader, so the
        layout depends only on how the suite was built, never on which compute
        groups this process's data formed: every process builds the same one.
        Members that cannot be packed sync through their own :meth:`Metric.sync`.
        On any failure every member's local states are restored and the error
        is raised.
        """
        if not should_sync:
            return
        if not (distributed_available() if callable(distributed_available) else None):
            return
        members, coalesced, individual, group = self._partition_sync_members(dist_sync_fn, process_group)
        try:
            if coalesced:
                nodes = [n for _, tree in coalesced for n in tree]
                snaps = [(n, n._state_snapshot()) for n in nodes]
                try:
                    _bucketing.coalesced_sync_nodes(nodes, group=None if group is _UNSET_GROUP else group)
                except Exception:
                    for n, snap in snaps:
                        n._restore_state(snap)
                    raise
                for n, snap in snaps:
                    n._cache = snap
                    n._is_synced = True
            for m in individual:
                m.sync(dist_sync_fn, process_group, True, distributed_available)
        except Exception:
            # no member may stay synced while another holds its local states
            for _, m in members:
                if m._is_synced:
                    m.unsync()
            self._relink_groups()
            raise

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore every member's local states; group members share the leader's states again."""
        if not should_unsync:
            return
        for _, m in self.items(keep_base=True, copy_state=False):
            if m._is_synced:
                m.unsync()
        self._relink_groups()

    def _relink_groups(self) -> None:
        if self._enable_compute_groups and self._groups_checked:
            self._compute_groups_create_state_ref()

    class _SyncContext:
        def __init__(self, collection: "MetricCollection", should_unsync: bool = True, **kwargs: Any) -> None:
            self.collection = collection
            self.kwargs = kwargs
            self.should_unsync = should_unsync

        def __enter__(self) -> "MetricCollection":
            self.collection.sync(**self.kwargs)
            return self.collection

        def __exit__(self, *exc: Any) -> None:
            self.collection.unsync(should_unsync=self.should_unsync)

    def sync_context(
        self,
        dist_sync_fn: Optional[Any] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Any] = _distributed_available,
    ) -> "MetricCollection._SyncContext":
        """Context manager: the suite's sync on enter, every member's local states back on exit."""
        return MetricCollection._SyncContext(
            self,
            should_unsync=should_unsync,
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )

    def _auto_sync_context(self) -> Optional["MetricCollection._SyncContext"]:
        """The suite sync of ``compute()``, only where it is unambiguous: more
        than one process, and every member on the default sync flags (syncing
        on compute, unsyncing after, no custom gather, not synced yet). Otherwise
        each member syncs in its own ``compute()``, as before."""
        if not _distributed_available():
            return None
        members = [m for _, m in self.items(keep_base=True, copy_state=False)]
        if not members or all(m._computed is not None for m in members):
            return None  # every member returns its cached value
        if any(m._is_synced or not m._to_sync or not m._should_unsync or m.dist_sync_fn is not None for m in members):
            return None
        return self.sync_context()

    # ---------------------------------------------------------- compute groups
    def _merge_compute_groups(self) -> None:
        """Merge groups whose leaders hold pairwise-identical states."""
        n_groups = len(self._groups)
        while True:
            for idx1, members1 in list(self._groups.items()):
                merged = False
                for idx2, members2 in list(self._groups.items()):
                    if idx1 == idx2 or idx1 not in self._groups or idx2 not in self._groups:
                        continue
                    if self._equal_metric_states(self._modules[members1[0]], self._modules[members2[0]]):
                        self._groups[idx1].extend(self._groups.pop(idx2))
                        merged = True
                        break
                if merged:
                    break
            if len(self._groups) == n_groups:
                break
            n_groups = len(self._groups)
        self._groups = dict(enumerate(self._groups.values()))

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """True when two metrics hold identical states (reference `:227-249`)."""
        if len(metric1._defaults) == 0 or len(metric2._defaults) == 0:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        for key in metric1._defaults:
            state1, state2 = getattr(metric1, key), getattr(metric2, key)
            if type(state1) is not type(state2):
                return False
            pairs = zip(state1, state2) if isinstance(state1, list) else [(state1, state2)]
            if isinstance(state1, list) and len(state1) != len(state2):
                return False
            for s1, s2 in pairs:
                if s1.dtype != s2.dtype or s1.device != s2.device or not allclose(s1, s2):
                    return False
        return True

    def _compute_groups_create_state_ref(self, copy: bool = False) -> None:
        """Point group members' states at the leader's (copy only list states)."""
        if not self._state_is_copy:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                for name in cg[1:]:
                    mi = self._modules[name]
                    for state in m0._defaults:
                        m0_state = getattr(m0, state)
                        # tensors are rebound, never written into, so a reference
                        # is safe; lists are appended to, so copy them when asked
                        setattr(mi, state, deepcopy(m0_state) if copy and isinstance(m0_state, list) else m0_state)
        self._state_is_copy = copy

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    def _init_compute_groups(self) -> None:
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for members in self._groups.values():
                for metric in members:
                    if metric not in self._modules:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the"
                            f" collection. Please make sure that {self._enable_compute_groups} matches"
                            f" {list(self._modules)}"
                        )
            self._groups_checked = True
        else:
            self._groups = {i: [str(k)] for i, k in enumerate(self._modules)}

    # ------------------------------------------------------------- management
    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, (str, dict)):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passed extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")

        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {}

    # --------------------------------------------------------------- dict api
    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def keys(self, keep_base: bool = False) -> Iterable[Hashable]:
        if keep_base:
            return self._modules.keys()
        return [self._set_name(k) for k in self._modules]

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        self._compute_groups_create_state_ref(copy_state)
        if keep_base:
            return self._modules.items()
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        self._compute_groups_create_state_ref(copy_state)
        return self._modules.values()

    def __getitem__(self, key: str) -> Metric:
        self._compute_groups_create_state_ref(True)
        return self._modules[key]

    def __iter__(self):
        return iter(self.keys())

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        lines = [f"  ({k}): {v!r}" for k, v in self._modules.items()]
        repr_str = "MetricCollection(\n" + ",\n".join(lines)
        if self.prefix:
            repr_str += f",\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f",\n  postfix={self.postfix}"
        return repr_str + "\n)"


__all__ = ["MetricCollection"]
