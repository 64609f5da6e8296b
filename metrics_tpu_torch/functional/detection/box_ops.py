"""Box geometry on tensors, in place of torchvision's box operations.

JAX counterpart: `metrics_tpu/functional/detection/box_ops.py` (``box_convert``
`:18`, ``box_area`` `:41`, ``box_iou`` `:46`, ``mask_iou`` `:59`); reference
`detection/mean_ap.py:24-26,61-74`. ``box_iou`` is one broadcast min/max and
clamp over the (N, M) pair grid, every step a separate elementwise operation
in float32 (so the card's values equal the CPU's, bit for bit); ``mask_iou``
is a dense boolean-mask IoU: one float32 product over the flattened masks
(exact integer counts), under ``high_precision``.
"""
from __future__ import annotations

import torch
from torch import Tensor

from metrics_tpu_torch.utils.compute import high_precision


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str) -> Tensor:
    """Convert between xyxy / xywh / cxcywh box formats."""
    allowed = ("xyxy", "xywh", "cxcywh")
    if in_fmt not in allowed or out_fmt not in allowed:
        raise ValueError(f"Unsupported box format conversion {in_fmt} -> {out_fmt}")
    if in_fmt == out_fmt:
        return boxes

    if in_fmt == "xywh":
        x, y, w, h = torch.split(boxes, 1, dim=-1)
        boxes = torch.cat([x, y, x + w, y + h], dim=-1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = torch.split(boxes, 1, dim=-1)
        boxes = torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)

    if out_fmt == "xyxy":
        return boxes
    x1, y1, x2, y2 = torch.split(boxes, 1, dim=-1)
    if out_fmt == "xywh":
        return torch.cat([x1, y1, x2 - x1, y2 - y1], dim=-1)
    return torch.cat([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_area(boxes: Tensor) -> Tensor:
    """Area of xyxy boxes, shape (N,) from (N, 4)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU of xyxy boxes: (N, 4) x (M, 4) -> (N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / union


@high_precision
def mask_iou(masks1: Tensor, masks2: Tensor) -> Tensor:
    """Pairwise IoU of boolean masks: (N, H, W) x (M, H, W) -> (N, M)."""
    m1 = masks1.reshape(masks1.shape[0], -1).to(torch.float32)
    m2 = masks2.reshape(masks2.shape[0], -1).to(torch.float32)
    inter = m1 @ m2.T
    union = m1.sum(dim=-1)[:, None] + m2.sum(dim=-1)[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


__all__ = ["box_convert", "box_area", "box_iou", "mask_iou"]
