"""Wrappers around metrics (JAX counterpart: `metrics_tpu/wrappers`).

The one-program clone fan-out (`wrappers/_fanout.py`), the fused wrapper
paths and the tracker's packed history belong to the dispatch engine and the
state journal, and are not ported yet; the eager paths here give the values
those paths are held to.
"""
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from metrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from metrics_tpu_torch.wrappers.minmax import MinMaxMetric
from metrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from metrics_tpu_torch.wrappers.tracker import MetricTracker

__all__ = ["BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper"]
