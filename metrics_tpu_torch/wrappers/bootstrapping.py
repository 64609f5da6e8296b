"""BootStrapper: bootstrap estimates of any metric from resampled clones.

JAX counterpart: `metrics_tpu/wrappers/bootstrapping.py` (``_bootstrap_sampler``
`:28`, ``BootStrapper`` `:45`, the eager ``update`` `:185` and
``_eager_resampled_update`` `:247`, ``compute`` `:461`); reference
`wrappers/bootstrapping.py:26-155`.

The draws come from a ``torch.Generator`` on the metric's device, for every
clone in one call (:func:`_draw_matrix`): a multinomial draw is a
``(num_bootstraps, N)`` index matrix, and a Poisson draw a
``(num_bootstraps, N)`` count matrix. The eager path realises them as each
clone's indices (for Poisson, the row sums read on the host once per update
size one ``repeat_interleave``) and updates clone by clone, each on its
resampled batch in one update (JAX's power-of-two chunks of a Poisson draw
bound XLA's compile cache and are not ported).

The one-program fan-out (`bootstrapping.py:287` ``_try_fused_poisson``,
`:394` ``_try_fused_multinomial``; :mod:`metrics_tpu_torch.wrappers._fanout`):
after the first, eager and validated call of an input signature, in a
validation mode other than ``full``, every clone updates in one program that
takes the same matrix, so the generator's stream is the same on either path.
Multinomial: ``torch.func.vmap`` over the clones of (gather the drawn rows,
update). Poisson, for a base whose states all merge by sum: the per-row state
deltas of the batch (one vmapped update) contracted against the count
matrix, with no host read of the row sums; its first ``_POISSON_CERT_STEPS``
fused steps, and the first of every new signature, are certified against
the eager path on state copies fed the same draws, and a disagreement keeps
the eager result and turns the path off for the instance.

A journal record (``save_state``) carries the generator's state
(``_journal_extra``), so a restored BootStrapper draws what the saved one
would have drawn next. The state of a CUDA generator does not fit a CPU
generator: a record loaded onto another device type keeps the new
instance's own draws, and says so once.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor, nn

from metrics_tpu_torch.arena import stack_states, unstack_states
from metrics_tpu_torch.metric import Metric, _forward_signature
from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.utils.data import apply_to_collection
from metrics_tpu_torch.utils.prints import rank_zero_warn
from metrics_tpu_torch.wrappers._fanout import (
    fanout_gate,
    run_fanout,
    states_allclose,
    sum_linear_base,
    weighted_rows_apply,
)


def _draw_matrix(size: int, num_bootstraps: int, sampling_strategy: str, generator: torch.Generator) -> Tensor:
    """One update's draws for every clone, ``(num_bootstraps, size)`` int64 on the
    generator's device: Poisson(1) counts of each row, or ``size`` row indices
    drawn with replacement. Both paths draw through here."""
    device = generator.device
    if sampling_strategy == "poisson":
        return torch.poisson(torch.ones(num_bootstraps, size, device=device), generator=generator).to(torch.int64)
    if sampling_strategy == "multinomial":
        return torch.randint(0, size, (num_bootstraps, size), generator=generator, device=device)
    raise ValueError("Unknown sampling strategy")


def _matrix_indices(draws: Tensor, sampling_strategy: str) -> List[Tensor]:
    """Each clone's resampling indices realising a draw matrix (a Poisson count
    matrix takes one host read of the clones' lengths)."""
    if sampling_strategy == "multinomial":
        return list(draws.unbind(0))
    num_bootstraps, size = draws.shape
    lengths = draws.sum(dim=1).tolist()
    rows = torch.arange(size, device=draws.device).repeat(num_bootstraps)
    flat = torch.repeat_interleave(rows, draws.reshape(-1), output_size=sum(lengths))
    return list(torch.split(flat, lengths))


def _bootstrap_sampler(
    size: int, num_bootstraps: int, sampling_strategy: str, generator: torch.Generator
) -> List[Tensor]:
    """Each clone's resampling indices into a batch of ``size`` rows, on the generator's device.

    ``"poisson"``: every row appears Poisson(1) times (one host read of the
    clones' lengths); ``"multinomial"``: ``size`` rows drawn with replacement.
    """
    return _matrix_indices(_draw_matrix(size, num_bootstraps, sampling_strategy, generator), sampling_strategy)


class BootStrapper(Metric):
    """Keeps ``num_bootstraps`` clones of a base metric, each updated on a resampled batch.

    ``compute()`` returns the mean, the standard deviation (``correction=1``),
    the quantiles (linear interpolation) and the raw values of the clones'
    results, as asked. Integer results are taken as float32 for the statistics.
    The draws come from ``generator`` (a ``torch.Generator`` on the metric's
    device, seeded at random; seed it with ``manual_seed`` for repeatable draws).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BootStrapper, MeanMetric
        >>> bootstrap = BootStrapper(MeanMetric(device="cpu"), num_bootstraps=4)
        >>> bootstrap.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> sorted(bootstrap.compute().keys())
        ['mean', 'std']
    """

    full_state_update: Optional[bool] = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float], Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = nn.ModuleList([deepcopy(base_metric) for _ in range(num_bootstraps)])
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling} but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self.generator = torch.Generator(device=self.device)
        self.generator.seed()

    # the one-program fan-out: built lazily, dropped on pickle and copy
    _boot_program = None
    _boot_versions = None  # the (wrapper, clones) _fused_version tuple the program was built for
    _boot_ok = True
    _record_boot_signature_after = None
    # the Poisson weighted-row path is certified against the eager path on its
    # first fused steps, and on the first step of every new signature
    _POISSON_CERT_STEPS = 3
    _poisson_cert_done = 0
    _poisson_cert_sigs = None

    def __getstate__(self) -> Dict[str, Any]:
        state = super().__getstate__()
        state.pop("_boot_program", None)
        return state

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch for every clone and update each on its own rows: one
        program for every clone once the signature has passed an eager call."""
        args_sizes = apply_to_collection(args, Tensor, len)
        kwargs_sizes = apply_to_collection(kwargs, Tensor, len)
        if len(args_sizes) > 0:
            size = args_sizes[0]
        elif len(kwargs_sizes) > 0:
            size = next(iter(kwargs_sizes.values()))
        else:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        object.__setattr__(self, "_record_boot_signature_after", None)
        fused = self._try_fused_multinomial if self.sampling_strategy == "multinomial" else self._try_fused_poisson
        handled, predrawn = fused(size, args, kwargs)
        if handled:
            return
        if predrawn is None:
            draws = _bootstrap_sampler(size, self.num_bootstraps, self.sampling_strategy, self.generator)
        else:
            # a fused attempt that failed after drawing: its draws, so the stream is
            # what a never-fused run consumes
            draws = _matrix_indices(predrawn, self.sampling_strategy)
        for metric, sample_idx in zip(self.metrics, draws):
            self._eager_resampled_update(metric, sample_idx, args, kwargs)
        sig = self._record_boot_signature_after
        if sig is not None:
            # the eager pass validated this signature: the fused path may take it
            object.__setattr__(self, "_record_boot_signature_after", None)
            self._record_fused_signature(sig)

    @staticmethod
    def _eager_resampled_update(metric: Metric, sample_idx: Tensor, args: tuple, kwargs: dict) -> None:
        """Feed one clone its resampled batch on the eager path."""
        if sample_idx.numel() == 0:
            # an empty Poisson draw still counts as the clone's update, as in JAX
            metric._update_count += 1
            return
        metric.update(
            *apply_to_collection(args, Tensor, torch.index_select, 0, sample_idx),
            **apply_to_collection(kwargs, Tensor, torch.index_select, 0, sample_idx),
        )

    def _boot_signature(self, size: int, args: tuple, kwargs: dict) -> Optional[tuple]:
        """The signature the fused path may take (None: not yet, it runs eagerly first)."""
        if self._fused_seen_signatures is None:
            object.__setattr__(self, "_fused_seen_signatures", {})
        signature = ("__boot__", size, _forward_signature(args, kwargs))
        if signature not in self._fused_seen_signatures:
            object.__setattr__(self, "_record_boot_signature_after", signature)
            return None
        return signature

    def _run_boot_fanout(self, build: Callable, draws: Tensor, args: tuple, kwargs: dict) -> bool:
        return run_fanout(
            self, list(self.metrics), build, (draws,) + args, kwargs, label="BootStrapper",
            program_attr="_boot_program", versions_attr="_boot_versions", ok_attr="_boot_ok",
        )

    def _try_fused_multinomial(self, size: int, args: tuple, kwargs: dict) -> Tuple[bool, Optional[Tensor]]:
        """Every clone's (gather its drawn rows, update) as ONE program: ``torch.func.vmap``
        over the clones' stacked states and the ``(num_bootstraps, N)`` index matrix.

        Returns ``(handled, predrawn)``: ``predrawn`` is the draw matrix of a
        fused attempt that failed after drawing, for the eager path to use."""
        if not fanout_gate(self, list(self.metrics), args, kwargs, "_boot_ok"):
            return False, None
        if self._boot_signature(size, args, kwargs) is None:
            return False, None
        draws = _draw_matrix(size, self.num_bootstraps, "multinomial", self.generator)

        def build(upd: Callable) -> Callable:
            def program(states, idx, *a, **k):
                def one(state, rows):
                    ra = apply_to_collection(a, Tensor, torch.index_select, 0, rows)
                    rk = apply_to_collection(k, Tensor, torch.index_select, 0, rows)
                    return upd(state, *ra, **rk)

                return unstack_states(torch.func.vmap(one)(stack_states(states), idx), len(states))

            return program

        if not self._run_boot_fanout(build, draws, args, kwargs):
            return False, draws
        return True, None

    def _try_fused_poisson(self, size: int, args: tuple, kwargs: dict) -> Tuple[bool, Optional[Tensor]]:
        """Poisson resampling as ONE program: the counts are row weights.

        Each row appears Poisson(1) times in each clone's batch; for a base
        whose states all merge by sum, the resampled update is the
        count-weighted sum of the per-row state deltas ``upd(init, row) -
        init`` (one vmapped update of the batch, shared by every clone),
        contracted against the ``(num_bootstraps, N)`` count matrix in row
        blocks: no host read, no resampled batch of its own length. The first
        fused steps are certified (see the module docstring)."""
        if not fanout_gate(self, list(self.metrics), args, kwargs, "_boot_ok") or not sum_linear_base(self.metrics[0]):
            return False, None
        # every tensor must carry the batch axis for the row vmap
        leaves = [v for v in list(args) + list(kwargs.values())]
        if not all(v.ndim >= 1 and v.shape[0] == size for v in leaves):
            return False, None
        signature = self._boot_signature(size, args, kwargs)
        if signature is None:
            return False, None
        counts = _draw_matrix(size, self.num_bootstraps, "poisson", self.generator)
        certify = self._poisson_cert_done < self._POISSON_CERT_STEPS or signature not in (self._poisson_cert_sigs or ())
        oracle = deepcopy(list(self.metrics)) if certify else None
        clone0 = self.metrics[0]

        def build(upd: Callable) -> Callable:
            init_fn = clone0.as_functions()[0]

            def program(states, w, *a, **k):
                new = weighted_rows_apply(stack_states(states), upd, init_fn(), w, a, k)
                return unstack_states(new, len(states))

            return program

        if not self._run_boot_fanout(build, counts, args, kwargs):
            return False, counts
        if certify:
            for om, idx in zip(oracle, _matrix_indices(counts, "poisson")):
                self._eager_resampled_update(om, idx, args, kwargs)
            if states_allclose([m.metric_state for m in self.metrics], [m.metric_state for m in oracle]):
                object.__setattr__(self, "_poisson_cert_done", self._poisson_cert_done + 1)
                if self._poisson_cert_sigs is None:
                    object.__setattr__(self, "_poisson_cert_sigs", set())
                self._poisson_cert_sigs.add(signature)
            else:
                rank_zero_warn(
                    f"Weighted-row poisson bootstrap disagreed with the eager path for "
                    f"`{type(self.metrics[0]).__name__}` (update is not row-additive); "
                    "keeping the eager result and falling back permanently for this instance."
                )
                for m, om in zip(self.metrics, oracle):
                    for name in m._defaults:
                        setattr(m, name, getattr(om, name))
                object.__setattr__(self, "_boot_ok", False)
                object.__setattr__(self, "_boot_program", None)
        return True, None

    def compute(self) -> Dict[str, Tensor]:
        """The mean, std, quantiles and raw values over the clones' results."""
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        values = computed_vals if computed_vals.is_floating_point() else computed_vals.to(torch.float32)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = values.mean(dim=0)
        if self.std:
            output_dict["std"] = values.std(dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=values.dtype, device=values.device)
            output_dict["quantile"] = torch.quantile(values, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()

    def as_functions(self) -> tuple:
        """Not exportable: each update draws from the wrapper's generator, so the
        update is not a pure function of ``(state, batch)``."""
        raise NotImplementedError(
            "BootStrapper resamples with its own torch.Generator (RNG) per update and is not a pure function "
            "of its inputs; export the base metric's as_functions() and drive resampled batches from your "
            "own generator instead."
        )

    def _journal_extra(self) -> Dict[str, Any]:
        return {
            "generator_device": self.generator.device.type,
            "generator_state": self.generator.get_state().numpy().tobytes().hex(),
        }

    def _journal_restore_extra(self, extra: Dict[str, Any]) -> None:
        if extra.get("generator_device") != self.generator.device.type:
            _faults.warn_fault(
                self,
                "journal",
                f"The journal record's bootstrap generator lives on {extra.get('generator_device')!r} and this"
                f" BootStrapper's on {self.generator.device.type!r}; its draws continue from its own generator.",
            )
            return
        state = bytes.fromhex(extra["generator_state"])
        self.generator.set_state(torch.frombuffer(bytearray(state), dtype=torch.uint8))

    def _apply(self, fn: Callable, recurse: bool = True) -> "BootStrapper":
        super()._apply(fn, recurse)
        if self.generator.device != self.device:  # the draws follow the clones: same seed, new device
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.generator.initial_seed())
            self.generator = generator
        return self


__all__ = ["BootStrapper"]
