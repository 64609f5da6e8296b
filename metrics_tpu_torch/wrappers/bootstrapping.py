"""BootStrapper: bootstrap estimates of any metric from resampled clones.

JAX counterpart: `metrics_tpu/wrappers/bootstrapping.py` (``_bootstrap_sampler``
`:28`, ``BootStrapper`` `:45`, the eager ``update`` `:185` and
``_eager_resampled_update`` `:247`, ``compute`` `:461`); reference
`wrappers/bootstrapping.py:26-155`.

The draws come from a ``torch.Generator`` on the metric's device, for every
clone in one call: a multinomial draw is a ``(num_bootstraps, N)`` index
matrix, and a Poisson draw a ``(num_bootstraps, N)`` count matrix whose row
sums, read on the host once per update, size one ``repeat_interleave`` that
realises every clone's indices. The JAX package's one-program clone fan-out
and its power-of-two chunks of a Poisson draw (which bound XLA's compile
cache) are not ported: each clone takes its resampled batch in one update.

A journal record (``save_state``) carries the generator's state
(``_journal_extra``), so a restored BootStrapper draws what the saved one
would have drawn next. The state of a CUDA generator does not fit a CPU
generator: a record loaded onto another device type keeps the new
instance's own draws, and says so once.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import Tensor, nn

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import faults as _faults
from metrics_tpu_torch.utils.data import apply_to_collection


def _bootstrap_sampler(
    size: int, num_bootstraps: int, sampling_strategy: str, generator: torch.Generator
) -> List[Tensor]:
    """Each clone's resampling indices into a batch of ``size`` rows, on the generator's device.

    ``"poisson"``: every row appears Poisson(1) times (one host read of the
    clones' lengths); ``"multinomial"``: ``size`` rows drawn with replacement.
    """
    device = generator.device
    if sampling_strategy == "poisson":
        counts = torch.poisson(torch.ones(num_bootstraps, size, device=device), generator=generator).to(torch.int64)
        lengths = counts.sum(dim=1).tolist()
        rows = torch.arange(size, device=device).repeat(num_bootstraps)
        flat = torch.repeat_interleave(rows, counts.reshape(-1), output_size=sum(lengths))
        return list(torch.split(flat, lengths))
    if sampling_strategy == "multinomial":
        return list(torch.randint(0, size, (num_bootstraps, size), generator=generator, device=device).unbind(0))
    raise ValueError("Unknown sampling strategy")


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

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch for every clone and update each on its own rows."""
        args_sizes = apply_to_collection(args, Tensor, len)
        kwargs_sizes = apply_to_collection(kwargs, Tensor, len)
        if len(args_sizes) > 0:
            size = args_sizes[0]
        elif len(kwargs_sizes) > 0:
            size = next(iter(kwargs_sizes.values()))
        else:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        draws = _bootstrap_sampler(size, self.num_bootstraps, self.sampling_strategy, self.generator)
        for metric, sample_idx in zip(self.metrics, draws):
            if sample_idx.numel() == 0:
                # an empty Poisson draw still counts as the clone's update, as in JAX
                metric._update_count += 1
                continue
            metric.update(
                *apply_to_collection(args, Tensor, torch.index_select, 0, sample_idx),
                **apply_to_collection(kwargs, Tensor, torch.index_select, 0, sample_idx),
            )

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
