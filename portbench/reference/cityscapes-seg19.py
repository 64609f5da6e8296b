"""Plain reference of the Cityscapes suite: a confusion matrix, then mIoU and macro Dice from it.

Plain PyTorch, independent of the program under test. A pixel's predicted class is the arg-max of its
softmax (the first of equal maxima) or its label; the confusion matrix counts (target, prediction) pairs,
rows the target. From it:

- IoU of a class = tp / (tp + fp + fn); a class with an empty union scores 0 and stays in the mean (mIoU);
- Dice of a class = 2 tp / (2 tp + fp + fn); a class absent from both sides is left out of the macro mean;
- the Dice states per class are tp, fp, tn, fn, all read off the matrix.

``dtype`` is the float type in which the scores are compared and the ratios are formed: float64 for the
reference, bfloat16 for the control. Counts are int64 in both.
"""
from __future__ import annotations

from typing import Dict, List

import torch

# the counts of each distinct batch, computed once: a pool of batches is cycled through every epoch
_memo: Dict[tuple, torch.Tensor] = {}


def _predicted(preds: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if preds.is_floating_point():
        return torch.argmax(preds.to(dtype), dim=1)
    return preds


def _confusion(preds: torch.Tensor, target: torch.Tensor, num_classes: int, dtype: torch.dtype) -> torch.Tensor:
    """(C, C) int64 counts of one batch, image by image so that a float64 copy fits beside the inputs."""
    key = (preds.data_ptr(), tuple(preds.shape), target.data_ptr(), dtype)
    if key not in _memo:
        counts = torch.zeros(num_classes * num_classes, dtype=torch.int64, device=target.device)
        for i in range(target.shape[0]):
            pairs = target[i].reshape(-1).to(torch.int64) * num_classes + _predicted(preds[i : i + 1], dtype).reshape(-1)
            counts += torch.bincount(pairs, minlength=num_classes * num_classes)
        _memo[key] = counts.reshape(num_classes, num_classes)
    return _memo[key]


def _dice_stats(confmat: torch.Tensor) -> torch.Tensor:
    """(4, C): tp, fp, tn, fn of every class."""
    tp = torch.diagonal(confmat)
    fp = confmat.sum(dim=0) - tp
    fn = confmat.sum(dim=1) - tp
    tn = confmat.sum() - tp - fp - fn
    return torch.stack([tp, fp, tn, fn])


def accumulate(steps: List[tuple], config: Dict, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The suite's state after ``steps``: the confusion matrix and the Dice counts."""
    c = config["data"]["num_classes"]
    device = steps[0][1].device if steps else torch.device("cpu")
    confmat = torch.zeros(c, c, dtype=torch.int64, device=device)
    for preds, target in steps:
        confmat += _confusion(preds, target, c, dtype)
    return {"confmat": confmat, "dice": _dice_stats(confmat)}


def canonical(program_states: Dict[str, Dict], config: Dict) -> Dict[str, torch.Tensor]:
    """The program's states in the reference's form (read only to be judged)."""
    dice = program_states["dice"]
    return {
        "confmat": program_states["miou"]["confmat"].to(torch.int64),
        "dice": torch.stack([dice[k].reshape(-1).to(torch.int64) for k in ("tp", "fp", "tn", "fn")]),
    }


def compare_states(candidate: Dict[str, torch.Tensor], expected: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``state_counts_off``: the sum of absolute differences of every count (exact: 0)."""
    off = 0
    for key in ("confmat", "dice"):
        a, b = candidate[key].cpu(), expected[key].cpu()
        off += int((a - b).abs().sum()) if a.shape == b.shape else int(b.abs().sum()) + 1
    return {"state_counts_off": float(off)}


def values(state: Dict[str, torch.Tensor], config: Dict, dtype: torch.dtype) -> Dict[str, float]:
    """mIoU and macro Dice of a state, the ratios formed in ``dtype``."""
    confmat = state["confmat"]
    tp, fp, _, fn = state["dice"]
    union = (tp + fp + fn).to(dtype)
    iou = torch.where(union > 0, tp.to(dtype) / union.clamp(min=1), torch.zeros_like(union))
    present = (tp + fp + fn) > 0
    dice = (2 * tp).to(dtype) / (2 * tp + fp + fn).clamp(min=1).to(dtype)
    assert confmat.shape[0] == tp.shape[0]
    return {
        "miou": float(iou.mean()),
        "dice": float(dice[present].mean()) if bool(present.any()) else 0.0,
    }
