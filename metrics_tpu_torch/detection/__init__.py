"""Detection module metrics (JAX counterpart: `metrics_tpu/detection`)."""
from metrics_tpu_torch.detection.mean_ap import MeanAveragePrecision

__all__ = ["MeanAveragePrecision"]
