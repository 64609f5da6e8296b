"""Worlds of several processes for the port's sync tests, without JAX.

- :class:`TorchFakeGather`: the port's twin of ``testers._FakeGather``, an
  injectable ``dist_sync_fn`` that replays ``Metric._sync_dist``'s walk (one
  call per tensor leaf, ``group=`` passed) over every rank's metric.
- :func:`install_world`: stands an N-process world in for the coalesced
  protocol's two collectives (``bucketing._host_allgather`` and
  ``_payload_allgather``); the other ranks' trees are packed by the same
  layout and pack code the syncing rank uses.
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


def install_world(monkeypatch, others: Sequence[Any]) -> None:
    """Make the coalesced protocol's collectives return the caller's row, then one row per metric
    (or collection) of ``others``, each packed when the collective runs."""

    def packs():
        out = []
        for obj in others:
            nodes = tree_of(obj)
            for node in nodes:  # as each rank's own sync does before it packs
                node._canonicalize_list_states()
            entries, values = bucketing._collect(nodes)
            device = next((v.device for v in values if v is not None), nodes[0].device)
            packed, meta, _ = bucketing._pack(entries, values, device)
            out.append((packed, torch.tensor(meta, dtype=torch.int64, device=device)))
        return out

    def host(vec, group):
        return torch.stack([vec] + [meta for _, meta in packs()])

    def payload(x, group):
        rows = [x]
        for packed, _ in packs():
            assert packed.numel() <= x.numel()
            rows.append(torch.cat([packed, packed.new_zeros(x.numel() - packed.numel())]))
        return torch.stack(rows)

    monkeypatch.setattr(bucketing, "_host_allgather", host)
    monkeypatch.setattr(bucketing, "_payload_allgather", payload)


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
        counts.append({k: v for k, v in collective_stats().items() if k.endswith("_collectives")})
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
    "TorchFakeGather",
    "curve_rows",
    "curve_suite",
    "install_world",
    "regression_rows",
    "regression_suite",
    "retrieval_rows",
    "retrieval_suite",
    "run_world",
    "tree_of",
]
