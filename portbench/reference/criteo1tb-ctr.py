"""Plain reference of the CTR suite: exact AUROC and average precision over every row, and the 15-bin
expected calibration error.

Plain PyTorch, independent of the program under test. Rows are sorted by score and grouped into runs of
equal scores; per run, the positives and negatives are counted in int64. Then

- AUROC = (sum over runs of pos * (negatives below the run) + pos * neg / 2) / (P * N): the area under the
  ROC curve with tied scores collapsed, formed from exact integer counts;
- AP = sum over runs, by descending score, of pos * (precision at the run's end) / P: the step area of the
  precision-recall curve, a tie run counting once;
- ECE (``l1``) = sum over bins of |right predictions - sum of confidences| / rows, where a binary row's
  confidence is its score and its right prediction is its label, and a score s falls in bin
  ``clamp(ceil(n_bins * s) - 1, 0, n_bins - 1)``: bins ``(j / n, (j + 1) / n]``, 0 in the first.

``dtype`` is the float type of the scores and of every float formed: float64 for the reference, bfloat16
for the control. Counts are int64 in both.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def _bins(scores: torch.Tensor, labels: torch.Tensor, n_bins: int, dtype: torch.dtype):
    s = scores.to(dtype)
    idx = torch.clamp(torch.ceil(s.to(torch.float64) * n_bins).to(torch.int64) - 1, 0, n_bins - 1)
    count = torch.bincount(idx, minlength=n_bins)
    right = torch.zeros(n_bins, dtype=torch.int64, device=idx.device).index_add_(0, idx, labels.to(torch.int64))
    conf = torch.zeros(n_bins, dtype=dtype, device=idx.device).index_add_(0, idx, s)
    return count, conf, right


def accumulate(steps: List[tuple], config: Dict, dtype: torch.dtype) -> Dict[str, object]:
    """The suite's state after ``steps``: every row, as it would be buffered, and the bin sums."""
    if steps:
        scores = torch.cat([s for s, _ in steps])
        labels = torch.cat([y for _, y in steps])
    else:
        scores, labels = torch.zeros(0), torch.zeros(0, dtype=torch.int64)
    n_bins = config["suite"]["ece"]["args"]["n_bins"]
    rows_scores = scores.to(dtype).to(scores.dtype) if dtype != torch.float64 else scores
    return {"rows": (rows_scores, labels), "bins": _bins(scores, labels, n_bins, dtype), "dtype": dtype}


def canonical(program_states: Dict[str, Dict], config: Dict) -> Dict[str, object]:
    """The program's states in the reference's form (read only to be judged): each buffering member's rows."""
    out = {}
    for member in ("auroc", "ap"):
        st = program_states[member]
        preds, target = st["preds"], st["target"]
        if isinstance(preds, list):
            preds = torch.cat([p.reshape(-1) for p in preds]) if preds else torch.zeros(0)
            target = torch.cat([t.reshape(-1) for t in target]) if target else torch.zeros(0, dtype=torch.int64)
        out[f"rows.{member}"] = (preds.reshape(-1), target.reshape(-1))
    ece = program_states["ece"]
    out["bins"] = (ece["count_bin"].to(torch.int64), ece["conf_bin"], ece["acc_bin"].to(torch.int64))
    return out


def _rows_off(candidate: tuple, expected: tuple) -> int:
    (cs, cy), (es, ey) = candidate, expected
    if cs.shape != es.shape or cy.shape != ey.shape:
        return abs(cs.numel() - es.numel()) + max(cs.numel(), es.numel())
    cs, cy = cs.to(es.device), cy.to(ey.device)
    return int(((cs.to(torch.float64) != es.to(torch.float64)) | (cy.to(torch.int64) != ey)).sum())


def compare_states(candidate: Dict[str, object], expected: Dict[str, object]) -> Dict[str, float]:
    """``rows_off`` rows that differ from the rows fed (exact: 0); ``bin_counts_off`` the summed absolute
    difference of the bins' row and right-prediction counts (exact: 0); ``conf_sum_gap`` the largest
    relative gap of a bin's sum of confidences."""
    row_keys = [k for k in candidate if k.startswith("rows")]
    rows_off = sum(_rows_off(candidate[k], expected["rows"]) for k in row_keys)
    (cc, cf, ca), (ec, ef, ea) = candidate["bins"], expected["bins"]
    counts_off = int((cc.cpu() - ec.cpu()).abs().sum() + (ca.cpu() - ea.cpu()).abs().sum())
    ef64, cf64 = ef.to(torch.float64).cpu(), cf.to(torch.float64).cpu()
    gap = float(((cf64 - ef64).abs() / ef64.abs().clamp(min=1.0)).max())
    return {"rows_off": float(rows_off), "bin_counts_off": float(counts_off), "conf_sum_gap": gap}


def _runs(scores: torch.Tensor, labels: torch.Tensor, descending: bool):
    """Per run of equal scores, in score order: (positives, rows), int64."""
    order = torch.argsort(scores, descending=descending)
    s, y = scores[order], labels[order].to(torch.int64)
    _, run_rows = torch.unique_consecutive(s, return_counts=True)
    run_id = torch.repeat_interleave(torch.arange(run_rows.numel(), device=s.device), run_rows)
    pos = torch.zeros(run_rows.numel(), dtype=torch.int64, device=s.device).index_add_(0, run_id, y)
    return pos, run_rows


def values(state: Dict[str, object], config: Dict, dtype: torch.dtype) -> Dict[str, float]:
    """AUROC, AP and ECE of a state, every float formed in ``dtype``."""
    scores, labels = state["rows"]
    scores = scores.to(dtype)
    n = scores.numel()
    pos, rows = _runs(scores, labels, descending=False)
    neg = rows - pos
    p, q = int(pos.sum()), int(neg.sum())
    twice_u = int((2 * pos * (torch.cumsum(neg, 0) - neg) + pos * neg).sum())
    auroc = torch.tensor(twice_u, dtype=torch.float64).to(dtype) / torch.tensor(2 * p * q, dtype=torch.float64).to(dtype)
    pos_d, rows_d = _runs(scores, labels, descending=True)
    precision = torch.cumsum(pos_d, 0).to(dtype) / torch.cumsum(rows_d, 0).to(dtype)
    ap = (pos_d.to(dtype) * precision).sum() / torch.tensor(p, dtype=dtype)
    count, conf, right = state["bins"]
    ece = (right.to(dtype) - conf.to(dtype)).abs().sum() / torch.tensor(n, dtype=torch.float64).to(dtype)
    return {"auroc": float(auroc), "ap": float(ap), "ece": float(ece)}
