"""Worlds of several processes for the port's sync tests, without JAX.

- :class:`TorchFakeGather`: the port's twin of ``testers._FakeGather``, an
  injectable ``dist_sync_fn`` that replays ``Metric._sync_dist``'s walk (one
  call per tensor leaf, ``group=`` passed) over every rank's metric.
- :func:`install_world`: stands an N-process world in for the coalesced
  protocol's two collectives (``bucketing._host_allgather`` and
  ``_payload_allgather``); the other ranks' trees are packed by the same
  layout and pack code the syncing rank uses (:func:`pack_tree`).
- :class:`ElasticWorld`: the same, with one rank dead until the membership
  registry declares it (the port's twin of JAX's ``_ElasticWorld``).
- :func:`run_world`: a real ``torch.distributed`` world of processes
  (spawned, Gloo, rendezvous through a file), each running a module-level
  function, with a wall-clock limit after which every process is killed.

This module imports no JAX, so spawned processes can import it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

import metrics_tpu_torch as tmt
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel import bucketing
from metrics_tpu_torch.utils.data import dim_zero_cat


class TorchFakeGather:
    """Injectable ``dist_sync_fn`` emulating an N-rank all-gather in one process.

    Like ``testers._FakeGather``, ``None``-spec list states need the same
    length on every rank, and a ``cat`` state must be empty on all ranks or
    on none (the per-state protocol's own limits).
    """

    def __init__(self, rank_metrics: Sequence[Metric]) -> None:
        self.rank_metrics = rank_metrics
        # every rank's own sync canonicalises its buffered rows; here only one
        # rank syncs, so the others are canonicalised for it
        for m in rank_metrics:
            for node in bucketing.tree_nodes(m):
                node._canonicalize_list_states()
        self._schedule = self._build_schedule(rank_metrics[0])
        self._call_idx = 0

    @staticmethod
    def _resolve(m: Metric, path: tuple) -> Metric:
        for child_idx in path:
            m = m._sync_children()[child_idx]
        return m

    def _build_schedule(self, m: Metric, path: tuple = ()):
        schedule = []
        rank_subs = [self._resolve(rm, path) for rm in self.rank_metrics]
        for name, spec in m._reduction_specs.items():
            value = getattr(m, name)
            if isinstance(value, list):
                if spec == "cat":
                    empties = {len(getattr(rm, name)) == 0 for rm in rank_subs}
                    assert len(empties) == 1, f"cat state {name!r} is empty on some ranks only"
                    if value:
                        schedule.append((path, name, None))
                else:
                    lengths = {len(getattr(rm, name)) for rm in rank_subs}
                    assert len(lengths) == 1, f"list state {name!r} has lengths {lengths} across ranks"
                    schedule.extend((path, name, j) for j in range(len(value)))
            else:
                schedule.append((path, name, None))
        for i, child in enumerate(m._sync_children()):
            schedule.extend(self._build_schedule(child, path + (i,)))
        return schedule

    def __call__(self, tensor: torch.Tensor, group: Any = None) -> List[torch.Tensor]:
        path, name, elem = self._schedule[self._call_idx]
        self._call_idx += 1
        out = []
        for m in self.rank_metrics:
            value = getattr(self._resolve(m, path), name)
            if elem is not None:
                out.append(value[elem])
            elif isinstance(value, list):
                out.append(dim_zero_cat(value))
            else:
                out.append(value)
        return out


def tree_of(obj: Any) -> List[Metric]:
    """The nodes a sync packs for a metric, or for a collection (member by member, every group relinked)."""
    if isinstance(obj, tmt.MetricCollection):
        return [n for _, m in obj.items(keep_base=True, copy_state=False) for n in bucketing.tree_nodes(m)]
    return bucketing.tree_nodes(obj)


def pack_tree(obj: Any):
    """``(packed, meta)`` of a metric's or collection's tree, as its own sync packs it (the quantized
    lane's encoding included, when ``METRICS_TPU_SYNC_QUANT`` is set)."""
    from metrics_tpu_torch.parallel import sync as psync

    nodes = tree_of(obj)
    for node in nodes:  # as each rank's own sync does before it packs
        node._canonicalize_list_states()
    entries, values = bucketing._collect(nodes)
    tier = psync.sync_quant_tier()
    if tier is not None:
        bucketing._quant_encode(entries, values, tier, nodes[0])
    device = next((v.device for v in values if v is not None), nodes[0].device)
    packed, meta, _ = bucketing._pack(entries, values, device)
    return packed, torch.tensor(meta, dtype=torch.int64, device=device)


def _padded_rows(x: torch.Tensor, packs: list) -> torch.Tensor:
    rows = [x]
    for packed, _ in packs:
        assert packed.numel() <= x.numel()
        rows.append(torch.cat([packed, packed.new_zeros(x.numel() - packed.numel())]))
    return torch.stack(rows)


def install_world(monkeypatch, others: Sequence[Any]) -> None:
    """Make the coalesced protocol's collectives return the caller's row, then one row per metric
    (or collection) of ``others``, each packed when the collective runs."""

    def host(vec, group):
        return torch.stack([vec] + [meta for _, meta in map(pack_tree, others)])

    def payload(x, group):
        return _padded_rows(x, [pack_tree(obj) for obj in others])

    monkeypatch.setattr(bucketing, "_host_allgather", host)
    monkeypatch.setattr(bucketing, "_payload_allgather", payload)


class ElasticWorld:
    """A world of ranks 0..n-1 with one killed rank, stood in for the coalesced protocol's collectives
    (rank 0 is the caller). While the killed rank is not declared dead, a full-world collective hangs
    for ``hang_s`` and then raises (the dead peer never shows up); once the membership registry
    declares it dead, the collectives are the survivors' group, their rows in ascending rank order;
    after :meth:`revive` (the restarted process is back) the full world answers again."""

    def __init__(self, monkeypatch, others: Sequence[Any], hang_s: float = 1.0) -> None:
        from metrics_tpu_torch.parallel import sync as psync

        self.others, self.killed, self.hang_s, self.psync = list(others), True, hang_s, psync
        monkeypatch.setattr(bucketing, "_host_allgather", self._host)
        monkeypatch.setattr(bucketing, "_payload_allgather", self._payload)

    def revive(self) -> None:
        self.killed = False

    def _rows(self):
        if not self.killed:
            return self.others
        alive = self.psync.surviving_members()
        if alive is None:
            time.sleep(self.hang_s)
            raise RuntimeError("abandoned hung collective (dead peer)")
        return [self.others[r - 1] for r in alive if r != 0]

    def _host(self, vec, group):
        return torch.stack([vec] + [meta for _, meta in map(pack_tree, self._rows())])

    def _payload(self, x, group):
        return _padded_rows(x, [pack_tree(obj) for obj in self._rows()])


# ------------------------------------------------------------ real processes
def _entry(fn: Callable, rank: int, world: int, init_method: str, out_dir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, *args), os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, *args: Any, timeout: float = 60.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined by a Gloo group.

    Returns each rank's result. Kills every process still running after
    ``timeout`` seconds and raises ``TimeoutError``; raises
    ``RuntimeError`` with the traceback when a rank fails.
    """
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [
            ctx.Process(target=_entry, args=(fn, rank, world, init_method, tmp, args), daemon=True)
            for rank in range(world)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
        for p in procs:
            p.join(10)
        if hung:
            raise TimeoutError(f"{len(hung)} of {world} ranks still ran after {timeout} s and were killed")
        errors = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
        codes = [p.exitcode for p in procs]
        if errors or any(codes):
            raise RuntimeError(f"exit codes {codes}:\n" + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"{rank}.pt")) for rank in range(world)]


# ------------------------------------------------- the data of the sync tests
C = 6
B = 40


def suite_batches(seed: int, steps: int, num_classes: int = C, batch: int = B):
    """Softmax preds and int64 targets as numpy arrays, made from ``seed``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        logits = rng.randn(batch, num_classes).astype(np.float32)
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        out.append(((probs / probs.sum(axis=1, keepdims=True)).astype(np.float32), rng.randint(0, num_classes, batch)))
    return out


def cat_rows(seed: int, rank: int):
    """Uneven per-rank loss rows for ``CatMetric``: rank r gets 3 + 2r rows of 5 + r values."""
    rng = np.random.RandomState(1000 + seed + rank)
    return [rng.rand(5 + rank).astype(np.float32) for _ in range(3 + 2 * rank)]


def headline_suite(pkg: Any, num_classes: int = C, **kwargs: Any):
    dev = {"device": "cpu"} if pkg is tmt else {}
    return pkg.MetricCollection(
        {
            "acc": pkg.Accuracy(num_classes=num_classes, average="macro", **dev),
            "f1": pkg.F1Score(num_classes=num_classes, average="macro", **dev),
            "confmat": pkg.ConfusionMatrix(num_classes=num_classes, **dev),
            "precision": pkg.Precision(num_classes=num_classes, average="macro", **dev),
        },
        **kwargs,
    )


def curve_rows(seed: int, rank: int):
    """Binary score rows for the curve suite: rank r gets 2 + r rows, of shape (n,) and (m, 1) in turn."""
    rng = np.random.RandomState(2000 + seed + rank)
    rows = []
    for i in range(2 + rank):
        n = 30 + 7 * i + 5 * rank
        preds, target = np.round(rng.rand(n), 2).astype(np.float32), rng.randint(0, 2, n)
        rows.append((preds, target) if i % 2 == 0 else (preds[:, None], target[:, None]))
    return rows


def curve_suite(pkg: Any, **kwargs: Any):
    """AUROC and AveragePrecision, binary: one compute group of buffered rows after the first update."""
    dev = {"device": "cpu"} if pkg is tmt else {}
    return pkg.MetricCollection(
        {"auroc": pkg.AUROC(pos_label=1, **dev), "ap": pkg.AveragePrecision(pos_label=1, **dev)}, **kwargs
    )


def regression_rows(seed: int, rank: int):
    """Positive targets with exact zeros and positive preds, 1-D: rank r gets 2 rows of 40 + 9r values."""
    rng = np.random.RandomState(3000 + seed + rank)
    rows = []
    for _ in range(2):
        n = 40 + 9 * rank
        target = np.where(rng.rand(n) < 0.3, 0.0, rng.rand(n) * 4).astype(np.float32)
        rows.append(((target + rng.rand(n) + 0.05).astype(np.float32), target))
    return rows


def regression_suite(pkg: Any, **kwargs: Any):
    """Pearson's stacked moments (``None``), Spearman's ``cat`` rows, and summed states."""
    dev = {"device": "cpu"} if pkg is tmt else {}
    return pkg.MetricCollection(
        {
            "mse": pkg.MeanSquaredError(**dev),
            "pearson": pkg.PearsonCorrCoef(**dev),
            "spearman": pkg.SpearmanCorrCoef(**dev),
            "r2": pkg.R2Score(**dev),
            "tweedie": pkg.TweedieDevianceScore(power=1.5, **dev),
        },
        **kwargs,
    )


def retrieval_rows(seed: int, rank: int):
    """Two batches of (preds, target, int64 indexes) a rank; the ranks share some query ids."""
    rng = np.random.RandomState(4000 + seed + rank)
    rows = []
    for _ in range(2):
        sizes = rng.randint(1, 12, 5)
        indexes = np.repeat(rng.choice(12, 5, replace=False) + 10**10, sizes).astype(np.int64)
        preds = np.round(rng.rand(indexes.size), 1).astype(np.float32)
        rows.append((preds, (rng.rand(indexes.size) < 0.3).astype(np.int64), indexes))
    return rows


def retrieval_suite(pkg: Any, **kwargs: Any):
    """Retrieval metrics of the same buffered rows (``None`` list states): one compute group."""
    dev = {"device": "cpu"} if pkg is tmt else {}
    return pkg.MetricCollection(
        {
            "map": pkg.RetrievalMAP(**dev),
            "mrr": pkg.RetrievalMRR(**dev),
            "ndcg": pkg.RetrievalNormalizedDCG(k=5, **dev),
            "recall": pkg.RetrievalRecall(k=3, **dev),
        },
        **kwargs,
    )


def gloo_world_worker(rank: int, world: int, seed: int) -> dict:
    """One rank of the real-process test: the headline suite, a ``CatMetric``,
    the curve suite (binary rows of two ranks), the regression suite and the
    retrieval suite fed this rank's batches,
    ``compute()`` (which syncs), the collective
    counts of two explicit suite syncs, ``gather_all_tensors`` on uneven
    shapes and ``sync_pytree`` with every spec."""
    from metrics_tpu_torch.parallel import collective_stats, gather_all_tensors, reset_collective_stats, sync_pytree

    suite = headline_suite(tmt)
    for preds, target in suite_batches(seed + rank, 3):
        suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    cat = tmt.CatMetric(device="cpu")
    for row in cat_rows(seed, rank):
        cat.update(torch.from_numpy(row))
    reset_collective_stats()
    values = suite.compute()
    cat_value = cat.compute()
    compute_stats = collective_stats()
    counts = []
    for _ in range(2):
        reset_collective_stats()
        suite.sync()
        counts.append({k: v for k, v in collective_stats().items()
                       if k in ("sync_shape_collectives", "sync_payload_collectives")})
        suite.unsync()
    curves = curve_suite(tmt)
    for preds, target in curve_rows(seed, rank):
        curves.update(torch.from_numpy(preds), torch.from_numpy(target))
    curve_values = curves.compute()
    regression = regression_suite(tmt)
    for preds, target in regression_rows(seed, rank):
        regression.update(torch.from_numpy(preds), torch.from_numpy(target))
    retrieval = retrieval_suite(tmt)
    for preds, target, indexes in retrieval_rows(seed, rank):
        retrieval.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    reset_collective_stats()
    regression_values = regression.compute()
    retrieval_values = retrieval.compute()
    new_suite_stats = collective_stats()
    x = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
    specs = {"s": "sum", "m": "mean", "mx": "max", "mn": "min", "c": "cat", "n": None, "f": lambda t: t.sum(0) * 10}
    return {
        "values": values,
        "cat": cat_value,
        "curves": curve_values,
        "regression": regression_values,
        "retrieval": retrieval_values,
        "new_suite_stats": new_suite_stats,
        "compute_stats": compute_stats,
        "sync_counts": counts,
        "local_tp": suite["acc"].tp.clone(),
        "gathered": {
            "uneven": gather_all_tensors(torch.arange(rank + 2, dtype=torch.int32)),
            "uneven_2d": gather_all_tensors(torch.full((rank + 1, 3 - rank), rank, dtype=torch.int64)),
            "scalar": gather_all_tensors(torch.tensor(rank + 0.5)),
            "bool": gather_all_tensors(torch.tensor([True, rank == 1])),
        },
        "pytree": sync_pytree({"s": x, "m": x, "mx": x, "mn": x, "c": x, "n": x, "f": x, "rows": [x[:1], x[1:]]},
                              {**specs, "rows": "cat"}),
    }


__all__ = [
    "ElasticWorld",
    "TorchFakeGather",
    "curve_rows",
    "curve_suite",
    "install_world",
    "pack_tree",
    "regression_rows",
    "regression_suite",
    "retrieval_rows",
    "retrieval_suite",
    "run_world",
    "tree_of",
]


# ------------------------------------------------- the functional core's merge
def _sum_rows(stacked):
    """The probe's custom reduction: the sum of every process's row."""
    return stacked.sum(dim=0)


class SpecProbe(Metric):
    """One state of every reduction spec, for the functional core's merge: sum, mean, max and min
    over 3 floats, a stacked (spec None) pair, a custom sum and a ``cat`` list of rows."""

    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)
        for name, spec in (("s_sum", "sum"), ("s_mean", "mean"), ("s_max", "max"), ("s_min", "min")):
            self.add_state(name, torch.zeros(3), spec)
        self.add_state("stacked", torch.zeros(2), None)
        self.add_state("custom", torch.zeros(3), _sum_rows)
        self.add_state("rows", [], "cat")

    def update(self, x: torch.Tensor) -> None:
        self.s_sum = self.s_sum + x
        self.s_mean = self.s_mean + x / 4
        self.s_max = torch.maximum(self.s_max, x)
        self.s_min = torch.minimum(self.s_min, x)
        self.stacked = self.stacked + x[:2]
        self.custom = self.custom + 2 * x
        self.rows.append(x)

    def compute(self) -> dict:
        out = {k: getattr(self, k) for k in ("s_sum", "s_mean", "s_max", "s_min", "stacked", "custom")}
        out["rows"] = dim_zero_cat(self.rows)
        return out

    def _merge_stacked(self, stacked: dict) -> dict:
        """The stacked pair is a running sum: its stacked contributions add."""
        return {k: v.sum(dim=0) for k, v in stacked.items()}


class RowProbe(Metric):
    """States of the reductions other than sum/max/min over a batch of ``(rows, 3)``: a running sum of
    batch means (``mean``), a per-position sum with the rows grouped by their index mod 4 (spec None,
    ``(4, 3)``, which a spec splits on its rows), and a custom sum of doubled rows, beside a plain sum.
    Under a data-parallel batch of equal row counts, each a multiple of 4, the update of the global
    batch is what each state's reduction makes of the ranks' contributions."""

    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)
        self.add_state("avg", torch.zeros(3), "mean")
        self.add_state("per_slot", torch.zeros(4, 3), None)
        self.add_state("folded", torch.zeros(3), _sum_rows)
        self.add_state("total", torch.zeros(3), "sum")

    def update(self, x: torch.Tensor) -> None:
        self.avg = self.avg + x.mean(dim=0)
        self.per_slot = self.per_slot + x.reshape(-1, 4, 3).sum(dim=0)
        self.folded = self.folded + 2 * x.sum(dim=0)
        self.total = self.total + x.sum(dim=0)

    def compute(self) -> dict:
        return {k: getattr(self, k) for k in ("avg", "per_slot", "folded", "total")}

    def _merge_stacked(self, stacked: dict) -> dict:
        return {k: v.sum(dim=0) for k, v in stacked.items()}


def probe_rows(seed: int, rank: int, steps: int = 3) -> list:
    rng = np.random.RandomState(seed + 10 * rank)
    return [rng.randn(3).astype(np.float32) for _ in range(steps)]


def funcore_world_worker(rank: int, world: int, seed: int) -> dict:
    """One rank of the functional core's real-process test: the headline suite and the spec probe
    updated through ``apply_update`` on this rank's inputs, then ``apply_compute(axis_name=...)`` over
    the world's group, a one-dimensional ``DeviceMesh`` and a ``(mesh, dim)`` pair, with the functional
    collectives and the host sync plane's collectives counted; ``merge_pytree`` and ``sync_pytree`` of
    every member's states over the same group."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.parallel import collective_stats, sync_pytree
    from metrics_tpu_torch.parallel.collectives import merge_pytree

    suite = headline_suite(tmt)
    state = suite.init()
    for preds, target in suite_batches(seed + rank, 2):
        state = suite.apply_update(state, torch.from_numpy(preds), torch.from_numpy(target))
    probe = SpecProbe()
    pstate = probe.init()
    for row in probe_rows(seed, rank):
        pstate = probe.apply_update(pstate, torch.from_numpy(row))
    counted = [0]
    real = {name: getattr(funcol, name) for name in ("all_reduce", "all_gather_single", "all_gather_tensor")
            if hasattr(funcol, name)}
    for name, fn in real.items():
        def call(*args, _fn=fn, **kwargs):
            counted[0] += 1
            return _fn(*args, **kwargs)

        setattr(funcol, name, call)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("dp",))
    host_before = collective_stats()["sync_collectives_issued"]
    try:
        values = suite.apply_compute(state, axis_name=dist.group.WORLD)
        suite_collectives = counted[0]
        probe_values = probe.apply_compute(pstate, axis_name=dist.group.WORLD)
        probe_collectives = counted[0] - suite_collectives
        mesh_values = suite.apply_compute(state, axis_name=mesh)
        mesh_dim_values = probe.apply_compute(pstate, axis_name=(mesh, "dp"))
        merged = {name: merge_pytree(state.states[name], m._reduction_specs, dist.group.WORLD)
                  for name, m in suite._modules.items()}
        custom = {k: fn for k, fn in probe._reductions.items() if probe._reduction_specs[k] == "custom"}
        merged["probe"] = merge_pytree(pstate.states, probe._reduction_specs, dist.group.WORLD, custom)
    finally:
        for name, fn in real.items():
            setattr(funcol, name, fn)
    host_collectives = collective_stats()["sync_collectives_issued"] - host_before
    synced = {name: sync_pytree(state.states[name], m._reduction_specs) for name, m in suite._modules.items()}
    synced["probe"] = sync_pytree(pstate.states, probe._reduction_specs, None, custom)
    return {"values": values, "probe_values": probe_values, "mesh_values": mesh_values,
            "mesh_dim_values": mesh_dim_values, "merged": merged, "synced": synced,
            "suite_collectives": suite_collectives, "probe_collectives": probe_collectives,
            "host_collectives": host_collectives, "local": state.states, "probe_local": pstate.states}


SHARDING_CASES = {
    "binned": (lambda: tmt.BinnedPrecisionRecallCurve(num_classes=8, thresholds=5, device="cpu"),
               ("TPs", "FPs", "FNs"), ("c", None), 8),
    "f1": (lambda: tmt.F1Score(num_classes=8, average="macro", device="cpu"), ("tp", "fp", "tn", "fn"), ("c",), 8),
    "confmat": (lambda: tmt.ConfusionMatrix(num_classes=1000, device="cpu"), ("confmat",), ("c", None), 1000),
}


def sharding_batches(seed: int, c: int, steps: int = 2, rows: int = 64):
    """``steps`` batches of softmax preds ``(rows, c)`` and int64 targets, as numpy arrays made from ``seed``."""
    rng = np.random.RandomState(seed)
    logits = rng.rand(steps, rows, c).astype(np.float32)
    return logits / logits.sum(-1, keepdims=True), rng.randint(0, c, (steps, rows))


def _sharded_run(metric, states, twin, feeds):
    """``feeds``: ``(sharded args, twin args)`` per step. The states after the updates, and the twin's."""
    for args, twin_args in feeds:
        states = metric.apply_update(states, *args)
        twin = metric.apply_update(twin, *twin_args)
    return states, twin


def _sharding_report(metric, states, twin, names, inputs):
    tree, twin_tree = states.states, twin.states
    return {
        "placements": {k: [(type(p).__name__, getattr(p, "dim", None)) for p in tree[k].placements] for k in names},
        "local_shapes": {k: tuple(tree[k].to_local().shape) for k in names},
        "value": metric.apply_compute(states),
        "plain_value": metric.apply_compute(twin),
        "states_equal": all(torch.equal(tree[k].full_tensor(), twin_tree[k]) for k in names),
        "inputs": inputs,
    }


def sharding_world_worker(rank: int, world: int, seed: int) -> dict:
    """One rank of the sharded-state test (``world`` = 4): states placed by ``shard_states`` and updated
    through ``apply_update``, with each state's placements and local shape after the updates, its value,
    and an unsharded twin's:

    - ``replicated``: a one-dim ``DeviceMesh`` ``("c",)``; every rank feeds the same batches as
      ``Replicate()`` DTensors, so the twin runs those batches;
    - ``dp``: the same mesh; each rank feeds its own batches (seed ``seed + 1 + rank``) as plain tensors,
      so the twin runs every rank's rows, concatenated in rank order;
    - ``dp_c`` (binned only): a ``(2, 2)`` mesh ``("dp", "c")``, the state split over ``c`` and the batch
      over ``dp`` (``[Shard(0), Replicate()]``), as JAX's ``test_dp_times_c``.

    Then the helpers' errors, the update of states of other reductions (replicated under a replicated
    batch; then under a data-parallel batch of each rank's own rows: ``PearsonCorrCoef`` placed by
    ``infer_state_pspecs``, ``RowProbe`` with its ``(4, 3)`` None state split on its rows over ``c``, and
    ``SpecProbe``), and the inferred specs of a mixed state tree."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from metrics_tpu_torch.parallel.sharding import (
        PartitionSpec as P,
        infer_state_pspecs,
        shard_states,
        state_shardings,
    )

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("c",))
    grid = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("dp", "c"))

    def dt(x, on, placements):
        return DTensor.from_local(torch.from_numpy(x), on, placements, run_check=False)

    out: dict = {}
    for name, (make, names, spec, c) in SHARDING_CASES.items():
        metric = make()
        specs = {n: P(*spec) for n in names}
        preds, target = sharding_batches(seed, c)
        feeds = [((dt(preds[s], mesh, [Replicate()]), dt(target[s], mesh, [Replicate()])),
                  (torch.from_numpy(preds[s]), torch.from_numpy(target[s]))) for s in range(2)]
        states, twin = _sharded_run(metric, shard_states(metric.init(), mesh, specs), metric.init(), feeds)
        out[(name, "replicated")] = _sharding_report(metric, states, twin, names,
                                                     (torch.from_numpy(preds), torch.from_numpy(target)))
        every = [sharding_batches(seed + 1 + r, c) for r in range(world)]
        preds, target = (np.concatenate([b[i] for b in every], axis=1) for i in (0, 1))
        feeds = [((torch.from_numpy(every[rank][0][s]), torch.from_numpy(every[rank][1][s])),
                  (torch.from_numpy(preds[s]), torch.from_numpy(target[s]))) for s in range(2)]
        states, twin = _sharded_run(metric, shard_states(metric.init(), mesh, specs), metric.init(), feeds)
        out[(name, "dp")] = _sharding_report(metric, states, twin, names,
                                             (torch.from_numpy(preds), torch.from_numpy(target)))
    make, names, spec, c = SHARDING_CASES["binned"]
    metric, row = make(), grid.get_local_rank("dp")
    every = [sharding_batches(seed + 10 + r, c) for r in range(2)]
    preds, target = (np.concatenate([b[i] for b in every], axis=1) for i in (0, 1))
    placements = [Shard(0), Replicate()]
    feeds = [((dt(every[row][0][s], grid, placements), dt(every[row][1][s], grid, placements)),
              (torch.from_numpy(preds[s]), torch.from_numpy(target[s]))) for s in range(2)]
    states, twin = _sharded_run(metric, shard_states(metric.init(), grid, {n: P(*spec) for n in names}),
                                metric.init(), feeds)
    out[("binned", "dp_c")] = _sharding_report(metric, states, twin, names,
                                               (torch.from_numpy(preds), torch.from_numpy(target)))

    errors = {}
    auroc = tmt.AUROC(device="cpu")
    probe = SpecProbe()
    x = np.arange(3, dtype=np.float32) + rank  # a different row on each rank: a plain batch is this rank's own
    pearson = tmt.PearsonCorrCoef(device="cpu")
    pearson_specs = {k: v for k, v in infer_state_pspecs(pearson.init().states, mesh,
                                                         pearson._reduction_specs).items() if v is not None}
    xs, ys = sharding_batches(seed + 20, 1, rows=32)
    xs, ys = xs[..., 0] * ys, xs[..., 0]  # correlated float columns
    for key, call in {
        "list": lambda: state_shardings(auroc.init(), mesh, {"preds": P("c")}),
        "unknown": lambda: state_shardings(tmt.BinnedPrecisionRecallCurve(num_classes=8, thresholds=5, device="cpu")
                                           .init(), mesh, {"tps": P("c", None)}),
        "mean_spec": lambda: probe.apply_update(shard_states(probe.init(), mesh, {}), torch.from_numpy(x)),
        "mixed_batch": lambda: tmt.ConfusionMatrix(num_classes=4, device="cpu").apply_update(
            shard_states(tmt.ConfusionMatrix(num_classes=4, device="cpu").init(), mesh, {"confmat": P("c", None)}),
            dt(np.arange(4), mesh, [Replicate()]), torch.arange(4)),
        "pearson_dp": lambda: pearson.apply_update(shard_states(pearson.init(), mesh, pearson_specs),
                                                   torch.from_numpy(xs[0]), torch.from_numpy(ys[0])),
    }.items():
        try:
            call()
            errors[key] = None
        except ValueError as err:
            errors[key] = str(err)
    out["errors"] = errors

    # states of other reductions, replicated, under a batch replicated on every process: updated whole
    replicated = {}
    state, twin = shard_states(probe.init(), mesh, {}), probe.init()
    for step in range(2):
        row_x = np.arange(3, dtype=np.float32) * (step + 1) - 1
        state = probe.apply_update(state, dt(row_x, mesh, [Replicate()]))
        twin = probe.apply_update(twin, torch.from_numpy(row_x))
    replicated["probe"] = all(torch.equal(state.states[k].full_tensor(), twin.states[k])
                              for k in twin.states if not isinstance(twin.states[k], list))
    state, twin = shard_states(pearson.init(), mesh, pearson_specs), pearson.init()
    for step in range(2):
        state = pearson.apply_update(state, dt(xs[step], mesh, [Replicate()]), dt(ys[step], mesh, [Replicate()]))
        twin = pearson.apply_update(twin, torch.from_numpy(xs[step]), torch.from_numpy(ys[step]))
    replicated["pearson"] = (pearson.apply_compute(state), pearson.apply_compute(twin))
    replicated["pearson_inputs"] = (torch.from_numpy(xs), torch.from_numpy(ys))
    out["replicated_other"] = replicated

    # states of other reductions under a data-parallel batch: each rank feeds its own rows (plain tensors)
    dp = {}
    every = [sharding_batches(seed + 30 + r, 1, rows=32) for r in range(world)]
    every = [(a[..., 0] * b, a[..., 0]) for a, b in every]  # correlated float columns, (2, 32) a rank
    state = shard_states(pearson.init(), mesh, pearson_specs)
    for step in range(2):
        state = pearson.apply_update(state, *(torch.from_numpy(a[step]) for a in every[rank]))
    dp["pearson"] = pearson.apply_compute(state)
    dp["pearson_placements"] = {k: [type(p).__name__ for p in v.placements] for k, v in state.states.items()}
    dp["pearson_inputs"] = tuple(torch.from_numpy(np.concatenate([e[i] for e in every], axis=1)) for i in (0, 1))
    row_probe = RowProbe()
    rows = [np.random.RandomState(seed + 40 + r).randn(2, 8, 3).astype(np.float32) for r in range(world)]
    state = shard_states(row_probe.init(), mesh, {"per_slot": P("c")})
    for step in range(2):
        state = row_probe.apply_update(state, torch.from_numpy(rows[rank][step]))
    dp["rows"] = row_probe.apply_compute(state)
    dp["rows_local"] = state.states["per_slot"].to_local()
    dp["rows_placements"] = [type(p).__name__ for p in state.states["per_slot"].placements]
    dp["rows_inputs"] = torch.from_numpy(np.concatenate(rows, axis=1))
    state = shard_states(probe.init(), mesh, {})
    dp["probe"] = probe.apply_compute(probe.apply_update(state, torch.from_numpy(x)))
    out["dp_other"] = dp

    mixed = {"rows": torch.zeros(8, 3), "empty": torch.zeros(0), "odd": torch.zeros(5, 4), "total": torch.zeros(()),
             "pairs": torch.zeros(3, 2), "buffered": [torch.zeros(2)]}
    specs = {"rows": "cat", "empty": "cat", "odd": None, "total": "sum", "pairs": "max", "buffered": "cat"}
    out["inferred"] = {k: None if v is None else tuple(v) for k, v in infer_state_pspecs(mixed, mesh, specs).items()}
    return out


def coalesce_gate_worker(rank: int, world: int, seed: int) -> dict:
    """One rank of the ``METRICS_TPU_SYNC_COALESCE`` test: ``MetricCollection([Accuracy(5),
    ConfusionMatrix(5)])`` synced (blocking, then asynchronously) under ``=1`` and ``=0`` on this rank's
    inputs, with the collective counters of each sync and the synced states."""
    from metrics_tpu_torch.parallel import collective_stats, reset_collective_stats

    out: dict = {}
    rng = np.random.RandomState(seed + rank)
    logits = rng.rand(2, 20, 5).astype(np.float32)
    preds, target = logits / logits.sum(-1, keepdims=True), rng.randint(0, 5, (2, 20))
    for env in ("1", "0"):
        os.environ["METRICS_TPU_SYNC_COALESCE"] = env
        for lane in ("sync", "sync_async"):
            suite = tmt.MetricCollection([tmt.Accuracy(num_classes=5, device="cpu"),
                                          tmt.ConfusionMatrix(num_classes=5, device="cpu")])
            for step in range(2):
                suite.update(torch.from_numpy(preds[step]), torch.from_numpy(target[step]))
            reset_collective_stats()
            if lane == "sync":
                suite.sync()
            else:
                fut = suite.sync_async()
                if fut is not None:
                    fut.wait()
            stats = collective_stats()
            out[(env, lane)] = {
                "counts": {k: stats[k] for k in ("sync_shape_collectives", "sync_payload_collectives",
                                                 "sync_coalesced_payloads", "sync_states_coalesced")},
                "states": {f"{name}.{s}": getattr(m, s).clone() for name, m in suite.items(keep_base=True)
                           for s in m._defaults},
            }
    os.environ.pop("METRICS_TPU_SYNC_COALESCE", None)
    return out
