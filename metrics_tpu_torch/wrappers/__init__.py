"""Wrappers around metrics (JAX counterpart: `metrics_tpu/wrappers`).

BootStrapper and MultioutputWrapper run their clones as one program over the
functional core after an eager, validated first call of each signature
(:mod:`metrics_tpu_torch.wrappers._fanout`), and MinMaxMetric runs its
``forward`` as one cached step; their eager paths give the values the fused
ones are held to.
"""
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from metrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from metrics_tpu_torch.wrappers.minmax import MinMaxMetric
from metrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from metrics_tpu_torch.wrappers.tracker import MetricTracker

__all__ = ["BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper"]
