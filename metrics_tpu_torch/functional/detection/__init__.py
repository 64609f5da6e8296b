"""Functional detection utilities (JAX counterpart: `metrics_tpu/functional/detection`)."""
from metrics_tpu_torch.functional.detection.box_ops import box_area, box_convert, box_iou, mask_iou

__all__ = ["box_area", "box_convert", "box_iou", "mask_iou"]
