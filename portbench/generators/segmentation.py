"""Inputs of ``data["kind"] == "segmentation"``: a pool of label maps, or of their float32 softmax scores.

``make_inputs`` makes ``distinct_batches`` batches of ``traffic["batch"]`` images. The targets are the
arg-max of smooth per-class random fields plus per-class biases fitted so that the classes cover the image
in the configuration's ``class_frequencies``; the predictions are the arg-max (``input: labels``) or the
float32 softmax (``input: softmax``) of logits that favour the target's class by ``pred_signal`` under
smooth and per-pixel noise, so that they agree with the targets on most pixels, in coherent regions.

``epoch_steps`` cycles through the pool in order, ``images_per_epoch`` images an epoch, the last step
partial as a loader without ``drop_last`` gives.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from generate import Step, seeded_generator

# fields of the fitted class biases are drawn this much smaller than the images (the fit is cheap there)
_FIT_DOWNSCALE = 8
_FIT_ROUNDS = 30


def _smooth(field: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling of (N, C, h, w) random fields to (N, C, *size): regions, not speckle."""
    return torch.nn.functional.interpolate(field, size=size, mode="bilinear", align_corners=False)


def _fit_class_bias(fields: torch.Tensor, frequencies: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-class biases such that ``argmax(bias + scale * fields)`` covers each class in ``frequencies``."""
    log_target = torch.log(frequencies)
    bias = log_target.clone()
    c = frequencies.numel()
    for _ in range(_FIT_ROUNDS):
        labels = torch.argmax(bias[None, :, None, None] + scale * fields, dim=1)
        got = torch.bincount(labels.reshape(-1), minlength=c).to(torch.float64) / labels.numel()
        bias = bias + 0.5 * (log_target - torch.log(got.clamp(min=1e-7)))
    return bias


def make_inputs(data: Dict, traffic: Dict, seed: int, device) -> List[Step]:
    """``data["distinct_batches"]`` batches of ``traffic["batch"]`` images, as the traffic's ``input`` asks."""
    device = torch.device(device)
    g = seeded_generator(seed, device)
    names = list(data["class_frequencies"])
    c, h, w = len(names), data["height"], data["width"]
    batch, n_batches = traffic["batch"], data["distinct_batches"]
    n_images = batch * n_batches
    frequencies = torch.tensor([data["class_frequencies"][k] for k in names], dtype=torch.float64, device=device)
    frequencies = frequencies / frequencies.sum()
    region_h, region_w = data["region_cells"]
    scale = data["region_scale"]
    fields = torch.randn((n_images, c, region_h, region_w), generator=g, device=device, dtype=torch.float32)
    fit_size = (max(h // _FIT_DOWNSCALE, region_h), max(w // _FIT_DOWNSCALE, region_w))
    bias = _fit_class_bias(_smooth(fields, fit_size).to(torch.float64), frequencies, scale).to(torch.float32)

    err_h, err_w = data["error_cells"]
    error_fields = torch.randn((n_images, c, err_h, err_w), generator=g, device=device, dtype=torch.float32)
    pool = []
    for b in range(n_batches):
        sl = slice(b * batch, (b + 1) * batch)
        target_logits = bias[None, :, None, None] + scale * _smooth(fields[sl], (h, w))
        target = torch.argmax(target_logits, dim=1)
        del target_logits
        logits = data["error_scale"] * _smooth(error_fields[sl], (h, w))
        logits += data["pixel_noise"] * torch.randn(logits.shape, generator=g, device=device, dtype=torch.float32)
        logits.scatter_add_(1, target.unsqueeze(1), torch.full_like(target.unsqueeze(1), 1, dtype=torch.float32)
                            .mul_(data["pred_signal"]))
        if traffic["input"] == "softmax":
            preds = torch.softmax(logits, dim=1)
        elif traffic["input"] == "labels":
            preds = torch.argmax(logits, dim=1)
        else:
            raise ValueError(f"unknown segmentation input {traffic['input']!r}")
        del logits
        pool.append((preds, target))
    return pool


def epoch_steps(data: Dict, traffic: Dict, inputs: List[Step]) -> List[Step]:
    """The pool cycled through in order, ``traffic["batch"]`` images a step, the last step partial."""
    batch, total = traffic["batch"], data["images_per_epoch"]
    steps = []
    for i, start in enumerate(range(0, total, batch)):
        preds, target = inputs[i % len(inputs)]
        n = min(batch, total - start)
        steps.append((preds[:n], target[:n]) if n < batch else (preds, target))
    return steps
