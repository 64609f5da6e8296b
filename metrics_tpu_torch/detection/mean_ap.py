"""COCO-style Mean Average Precision / Recall.

JAX counterpart: `metrics_tpu/detection/mean_ap.py` (``_box_iou_np`` `:53`,
``_mask_iou_np`` `:98`, ``_input_validator`` `:107`, ``MeanAveragePrecision``
`:156`: update `:226`, materialisation `:267`,
``_compute_iou`` `:357`, ``_evaluate_image`` `:403`, ``_calculate`` `:503`,
summaries `:605-689`); reference `detection/mean_ap.py:185-933`, a
re-implementation of pycocotools' evaluation: per-(image, class) IoU, greedy
score-ordered matching to the ground truth at each IoU threshold, 101-point
interpolated precision, and the mAP/mAR summaries over IoU .5:.95, the
small/medium/large area ranges and 1/10/100 detections.

- ``update`` validates shapes only and appends the given tensors to five
  list states on the metric's device. Host inputs and COCO RLE masks become
  tensors first, so one conversion of boxes to xyxy serves both (JAX keeps
  a host copy of it, ``_box_convert_np``), and what ``compute()`` reads is
  already canonical. The states stay tensors: sync, ``state_dict`` and
  ``.to()`` treat them as any other list state.
- ``compute()`` copies the states to local numpy arrays, each state's rows
  of one dtype concatenated on the device and copied in one transfer. The
  greedy matching and the interpolation run on the host in numpy, as in
  JAX, with the same arithmetic and the same orders; the matching of a
  detection runs every area range and IoU threshold at once. An (image,
  class) cell whose IoU work is above JAX's threshold takes the device
  (``box_iou`` / ``mask_iou`` on the state's own device rows); those cells'
  IoUs come back in one copy. The power-of-two padding of JAX's device cells
  (for XLA's compile cache) is gone: it changed no value.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.detection.box_ops import box_convert, box_iou, mask_iou
from metrics_tpu_torch.functional.detection.rle import masks_from_any
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import autotune as _autotune

_STATES = ("detections", "detection_scores", "detection_labels", "groundtruths", "groundtruth_labels")


def _box_iou_np(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Host mirror of the device ``box_iou``: the same float32 steps and the same (unguarded)
    division, so the host/device cut-off never changes a value."""
    det = det.astype(np.float32)
    gt = gt.astype(np.float32)
    area_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_d[:, None] + area_g[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / union


def _pow2_bucket(n: int) -> int:
    """The next power of two (at least 8): the padded size of a blocked device cell."""
    return max(8, 1 << (int(n) - 1).bit_length())


def _box_iou_device_blocked(det: Tensor, gt: Tensor) -> Tensor:
    """The device alternative to :func:`_box_iou_np` (JAX's ``device_blocked`` variant):
    both operands padded to their power-of-two bucket, the device ``box_iou``, the
    live corner sliced out. The same float32 steps as the host mirror; the 1e-5
    tolerance covers the order of operations only."""
    det = torch.as_tensor(det).to(torch.float32)
    gt = torch.as_tensor(gt, device=det.device).to(torch.float32)
    nd, ng = det.shape[0], gt.shape[0]
    det_p = torch.nn.functional.pad(det, (0, 0, 0, _pow2_bucket(nd) - nd))
    gt_p = torch.nn.functional.pad(gt, (0, 0, 0, _pow2_bucket(ng) - ng))
    return box_iou(det_p, gt_p)[:nd, :ng]


# The host mirror is the reference (host=True: run on the host arrays, timed on the host clock): it is
# what small cells run with the autotuner off.
_autotune.register_variant("map_box_iou", "host_numpy", _box_iou_np, reference=True, host=True)
_autotune.register_variant("map_box_iou", "device_blocked", _box_iou_device_blocked, tolerance=1e-5)


def _mask_iou_np(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Host mirror of the device ``mask_iou``: float32 product (exact counts), union > 0 guard."""
    d = det.reshape(det.shape[0], -1).astype(np.float32)
    g = gt.reshape(gt.shape[0], -1).astype(np.float32)
    inter = d @ g.T
    union = d.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _input_validator(preds: Sequence[dict], targets: Sequence[dict], iou_type: str = "bbox") -> None:
    """Validate the list-of-dict input format (reference `mean_ap.py:134-176`); shapes only."""
    if not isinstance(preds, Sequence):
        raise ValueError("Expected argument `preds` to be of type Sequence")
    if not isinstance(targets, Sequence):
        raise ValueError("Expected argument `target` to be of type Sequence")
    if len(preds) != len(targets):
        raise ValueError("Expected argument `preds` and `target` to have the same length")
    iou_attribute = "boxes" if iou_type == "bbox" else "masks"

    for k in [iou_attribute, "scores", "labels"]:
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in [iou_attribute, "labels"]:
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    def _n_items(value: Any) -> int:
        # masks may arrive as an RLE dict / list of RLE dicts (decoded at update)
        if isinstance(value, dict):
            return 1
        if isinstance(value, (list, tuple)) and value and isinstance(value[0], dict):
            return len(value)
        # the shape is metadata: a tensor's needs no copy from the device
        shape = getattr(value, "shape", None)
        if shape is None:
            shape = np.asarray(value).shape
        return shape[0] if len(shape) and int(np.prod(shape)) else 0

    for i, item in enumerate(targets):
        n_boxes = _n_items(item[iou_attribute])
        n_labels = _n_items(item["labels"])
        if n_boxes != n_labels:
            raise ValueError(
                f"Input {iou_attribute} and labels of sample {i} in targets have a"
                f" different length (expected {n_boxes} labels, got {n_labels})"
            )
    for i, item in enumerate(preds):
        n_boxes = _n_items(item[iou_attribute])
        n_labels = _n_items(item["labels"])
        n_scores = _n_items(item["scores"])
        if not (n_boxes == n_labels == n_scores):
            raise ValueError(
                f"Input {iou_attribute}, labels and scores of sample {i} in predictions have a"
                f" different length (expected {n_boxes} labels and scores,"
                f" got {n_labels} labels and {n_scores} scores)"
            )


def _rows_to_host(rows: List[Tensor]) -> List[np.ndarray]:
    """Every row as a numpy array: the rows of one device and dtype are flattened and
    concatenated on their device, copied to the host in one transfer, and split by length."""
    out: List[Optional[np.ndarray]] = [None] * len(rows)
    groups: Dict[Tuple[torch.device, torch.dtype], List[int]] = {}
    for i, row in enumerate(rows):
        groups.setdefault((row.device, row.dtype), []).append(i)
    for (_, dtype), idx in groups.items():
        flat = torch.cat([rows[i].reshape(-1) for i in idx])
        if dtype == torch.bfloat16:  # numpy has no bfloat16
            flat = flat.to(torch.float32)
        host = flat.cpu().numpy()
        parts = np.split(host, np.cumsum([rows[i].numel() for i in idx])[:-1])
        for i, part in zip(idx, parts):
            out[i] = part.reshape(tuple(rows[i].shape))
    return out  # type: ignore[return-value]


def _group_by_class(labels: np.ndarray, class_index: Dict[int, int]) -> Dict[int, np.ndarray]:
    """{class position: ascending row indices whose label equals that class} (JAX's
    ``labels == class_id`` masks, from one stable sort of the labels)."""
    if labels.size == 0:
        return {}
    uniq, inverse = np.unique(labels, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind="stable")
    bounds = np.cumsum(np.bincount(inverse, minlength=len(uniq)))[:-1]
    out = {}
    for value, members in zip(uniq, np.split(order, bounds)):
        try:
            class_id = int(value)
        except (ValueError, OverflowError):  # NaN or inf: equal to no class
            continue
        if value == class_id and class_id in class_index:
            out[class_index[class_id]] = members
    return out


class MeanAveragePrecision(Metric):
    """COCO mAP/mAR over accumulated detections.

    Boxes are expected in absolute image coordinates; ``box_format`` selects
    xyxy/xywh/cxcywh input. With ``iou_type="segm"``, per-instance boolean
    masks of shape ``[num_boxes, H, W]`` (or COCO RLE dicts) are evaluated
    with dense mask IoU.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [dict(
        ...     boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
        ...     scores=torch.tensor([0.536]),
        ...     labels=torch.tensor([0]))]
        >>> target = [dict(
        ...     boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]),
        ...     labels=torch.tensor([0]))]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> result = metric.compute()
        >>> round(float(result["map"]), 4), round(float(result["map_50"]), 4)
        (0.6, 1.0)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = True

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: str = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        allowed_iou_types = ("segm", "bbox")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_thresholds = list(iou_thresholds or np.linspace(0.5, 0.95, round((0.95 - 0.5) / 0.05) + 1))
        self.rec_thresholds = list(rec_thresholds or np.linspace(0.0, 1.00, round(1.00 / 0.01) + 1))
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        if iou_type not in allowed_iou_types:
            raise ValueError(f"Expected argument `iou_type` to be one of {allowed_iou_types} but got {iou_type}")
        self.iou_type = iou_type
        # float bounds, as in JAX: the 1e10 "unbounded" sentinel must not meet an int32
        self.bbox_area_ranges = {
            "all": (0.0, float(1e5**2)),
            "small": (0.0, float(32**2)),
            "medium": (float(32**2), float(96**2)),
            "large": (float(96**2), float(1e5**2)),
        }
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        # (image, class) cells whose IoU the last compute() took on the host and on the device
        self.iou_cells = {"host": 0, "device": 0}

        self.add_state("detections", default=[], dist_reduce_fx=None)
        self.add_state("detection_scores", default=[], dist_reduce_fx=None)
        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruths", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)

    # ------------------------------------------------------------- update
    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:
        """Append per-image detection/groundtruth dicts (reference `mean_ap.py:333-393`).

        Validation reads shapes only; tensors are appended as given (on the
        metric's device), nothing is read back to the host.
        """
        _input_validator(preds, target, iou_type=self.iou_type)

        for item in preds:
            self.detections.append(self._get_safe_item_values(item))
            self.detection_labels.append(self._as_row(item["labels"]))
            self.detection_scores.append(self._as_row(item["scores"], np.float32))
        for item in target:
            self.groundtruths.append(self._get_safe_item_values(item))
            self.groundtruth_labels.append(self._as_row(item["labels"]))

    def _as_row(self, value: Any, dtype: Optional[np.dtype] = None) -> Tensor:
        if isinstance(value, Tensor):
            return value.to(self.device)  # as given: reshaped and cast at compute()
        out = np.asarray(value).reshape(-1)
        return torch.tensor(out.astype(dtype) if dtype is not None else out, device=self.device)

    def _get_safe_item_values(self, item: Dict[str, Any]) -> Tensor:
        value = item["boxes" if self.iou_type == "bbox" else "masks"]
        if not isinstance(value, Tensor):
            if self.iou_type == "bbox":  # host boxes: float32 first, as JAX's host path casts them
                arr = np.asarray(value)
                value = torch.tensor(arr.astype(np.float32).reshape(-1, 4) if arr.size else np.zeros((0, 4), np.float32))
            else:  # dense boolean masks [n, H, W], or COCO RLE dict(s) decoded on the host
                value = torch.tensor(masks_from_any(value))
        value = value.to(self.device)
        # the one step that is not idempotent runs here, once; compute() only reshapes and casts
        if self.iou_type == "bbox" and self.box_format != "xyxy" and value.numel():
            value = box_convert(value.reshape(-1, 4), in_fmt=self.box_format, out_fmt="xyxy")
        return value

    # ------------------------------------------------------------ compute
    def _materialize_states(self) -> Dict[str, List[np.ndarray]]:
        """Local numpy copies of the five states, each row normalised (reshape and dtype only);
        the states themselves stay tensors."""
        normalizers = {
            "detections": self._normalize_item,
            "groundtruths": self._normalize_item,
            "detection_scores": lambda v: v.reshape(-1).astype(np.float32),
            "detection_labels": lambda v: v.reshape(-1),
            "groundtruth_labels": lambda v: v.reshape(-1),
        }
        return {name: [normalizers[name](v) for v in _rows_to_host(getattr(self, name))] for name in _STATES}

    def _normalize_item(self, value: np.ndarray) -> np.ndarray:
        if self.iou_type != "bbox":
            return masks_from_any(value)
        return value.reshape(-1, 4).astype(np.float32) if value.size else np.zeros((0, 4), np.float32)

    @staticmethod
    def _get_classes(data: Dict[str, List[np.ndarray]]) -> List[int]:
        labels = data["detection_labels"] + data["groundtruth_labels"]
        if labels:
            return sorted(np.unique(np.concatenate(labels)).astype(np.int64).tolist())
        return []

    def _item_area(self, items: np.ndarray) -> np.ndarray:
        if self.iou_type == "bbox":
            b = items.reshape(-1, 4).astype(np.float32)
            return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        return items.reshape(items.shape[0], -1).sum(-1).astype(np.float64)

    def _device_item(self, row: Tensor) -> Tensor:
        """A state row on its device in its normalised form (float32 xyxy boxes; boolean masks)."""
        if self.iou_type == "bbox":
            return row.reshape(-1, 4).to(torch.float32)
        return (row.reshape((1,) + tuple(row.shape)) if row.ndim == 2 else row).to(torch.bool)

    def _compute_iou(self, det: np.ndarray, gt: np.ndarray) -> Optional[np.ndarray]:
        """IoU of one cell's score-ordered detections against its ground truth on the host, or
        None where the work is above JAX's threshold (`mean_ap.py:378-380`): box IoU counts
        nd * ng cells, mask IoU nd * ng * H * W, so large masks go to the device even for a
        handful of instances."""
        nd, ng = det.shape[0], gt.shape[0]
        work = nd * ng * (1 if self.iou_type == "bbox" else int(np.prod(det.shape[1:])))
        if work <= 65536 * (1 if self.iou_type == "bbox" else 64):
            if self.iou_type != "bbox":
                return _mask_iou_np(det, gt)
            # concrete host arrays: a first-seen shape class may sweep here (off: one predicate)
            if _autotune.dispatch("map_box_iou", (det, gt), sweep_on_miss=True, device=self.device) == "device_blocked":
                return _box_iou_device_blocked(torch.from_numpy(det).to(self.device),
                                               torch.from_numpy(gt).to(self.device)).cpu().numpy()
            return _box_iou_np(det, gt)
        return None

    def _device_ious(self, jobs: List[Tuple[int, np.ndarray, np.ndarray]]) -> List[np.ndarray]:
        """The IoUs of the cells above the threshold, on the states' own device rows: every
        cell's row indices sent in one copy, every cell's IoU back in one copy."""
        if not jobs:
            return []
        device = self.groundtruths[jobs[0][0]].device
        index = torch.from_numpy(np.concatenate([np.concatenate([d, g]) for _, d, g in jobs])).to(device)
        fn = box_iou if self.iou_type == "bbox" else mask_iou
        out, start = [], 0
        for img, det_sel, gt_sel in jobs:
            det_idx = index[start : start + len(det_sel)]
            gt_idx = index[start + len(det_sel) : start + len(det_sel) + len(gt_sel)]
            start += len(det_sel) + len(gt_sel)
            det = self._device_item(self.detections[img])[det_idx]
            gt = self._device_item(self.groundtruths[img])[gt_idx]
            out.append(fn(det, gt).reshape(-1))
        host = torch.cat(out).cpu().numpy()
        sizes = [len(d) * len(g) for _, d, g in jobs]
        parts = np.split(host, np.cumsum(sizes)[:-1])
        return [p.reshape(len(d), len(g)) for p, (_, d, g) in zip(parts, jobs)]

    def _threshold_values(self) -> np.ndarray:
        """Each IoU threshold as JAX's comparison ``float32_iou > thr`` sees it, in float64: a strongly
        typed float64 threshold compares in float64, a Python float in float32 (every IoU here is
        float32, on the host and from the device alike)."""
        return np.array([np.asarray(t, dtype=np.result_type(np.float32, t)).astype(np.float64)
                         for t in self.iou_thresholds])

    def _outside_area(self, areas: np.ndarray) -> np.ndarray:
        """(A, n): whether each item's area lies outside each area range, compared in the areas'
        dtype as JAX's ``areas < lo`` with a Python float bound is."""
        bounds = np.array(list(self.bbox_area_ranges.values())).astype(areas.dtype)
        return (areas[None, :] < bounds[:, :1]) | (areas[None, :] > bounds[:, 1:])

    def _match(
        self, iou: np.ndarray, gt_ignore: np.ndarray, gtind: np.ndarray, thr: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy matching (reference `mean_ap.py:543-670`) at every area range and IoU threshold at
        once: each detection, in score order, claims the best unmatched, unignored ground truth
        above the threshold (the first on a tie, in the ignore-last order of its area range).
        ``gt_ignore`` and ``gtind`` are (A, G), ``thr`` the thresholds of :meth:`_threshold_values`;
        returns the (A, T, D) det matches and ignores.

        A detection whose best IoU is at most the lowest threshold matches nothing and is
        skipped; so is one with a NaN IoU, which JAX's argmax picks and its compare rejects."""
        n_areas, n_gt = gt_ignore.shape
        n_det, n_thr = iou.shape[0], len(thr)
        det_matches = np.zeros((n_areas * n_thr, n_det), dtype=bool)
        det_ignore = np.zeros((n_areas * n_thr, n_det), dtype=bool)
        if thr.min() >= 0:
            live = np.nonzero(iou.max(axis=1).astype(np.float64) > thr.min())[0]
        else:  # a removed ground truth's 0 can beat a negative threshold
            live = np.arange(n_det)
        if len(live):
            rows = np.repeat(np.arange(n_areas), n_thr)  # (A*T,): the area range of each row
            ious = iou[:, gtind[rows]].transpose(1, 0, 2)  # (A*T, D, G), per area range's order
            ignored = gt_ignore[rows]
            removed = ignored.copy()  # matched or ignored
            thr_rows = np.tile(thr, n_areas)
            at = np.arange(n_areas * n_thr)
            for d in live:
                candidates = ious[:, d, :] * ~removed
                best = candidates.argmax(axis=1)
                hit = np.nonzero(candidates[at, best].astype(np.float64) > thr_rows)[0]
                if len(hit):
                    removed[hit, best[hit]] = True
                    det_matches[hit, d] = True
                    det_ignore[hit, d] = ignored[hit, best[hit]]
        return det_matches.reshape(n_areas, n_thr, n_det), det_ignore.reshape(n_areas, n_thr, n_det)

    def _evaluate_image(
        self, iou: Optional[np.ndarray], gt_out: np.ndarray, det_out: np.ndarray, scores_sorted: np.ndarray,
        thr: np.ndarray,
    ) -> List[tuple]:
        """One (image, class) cell for every area range (reference `mean_ap.py:543-642`): per range,
        (dtMatches, dtIgnore, dtScores, gtIgnore) as JAX's ``_evaluate_image`` returns them.
        ``gt_out`` (A, G) and ``det_out`` (A, D) flag the items outside each area range."""
        n_thr = len(self.iou_thresholds)
        n_areas, n_gt = gt_out.shape
        n_det = det_out.shape[1]
        if n_det == 0:  # some ground truth but no prediction (reference `mean_ap.py:475-496`)
            gt_ignore = np.sort(gt_out.astype(np.uint8), axis=1, kind="stable").astype(bool)
            empty = np.zeros((n_thr, 0), dtype=bool)
            return [(empty, empty, np.zeros(0), gt_ignore[a]) for a in range(n_areas)]
        det_ignore_area = np.repeat(det_out[:, None, :], n_thr, axis=1)  # (A, T, D)
        if n_gt == 0:  # some predictions but no ground truth (reference `mean_ap.py:498-527`)
            no_match = np.zeros((n_thr, n_det), dtype=bool)
            return [(no_match, det_ignore_area[a], scores_sorted, np.zeros(0, dtype=bool)) for a in range(n_areas)]
        # ground truth ignore-last, per area range
        gtind = np.argsort(gt_out.astype(np.uint8), axis=1, kind="stable")
        gt_ignore = np.take_along_axis(gt_out, gtind, axis=1)
        det_matches, det_ignore = self._match(iou, gt_ignore, gtind, thr)
        # unmatched detections outside the area range are ignored
        det_ignore = det_ignore | (~det_matches & det_ignore_area)
        return [(det_matches[a], det_ignore[a], scores_sorted, gt_ignore[a]) for a in range(n_areas)]

    def _calculate(self, class_ids: List[int], data: Dict[str, List[np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
        """Precision/recall tensors [T,R,K,A,M] / [T,K,A,M] (reference `mean_ap.py:704-759`)."""
        dets, scores = data["detections"], data["detection_scores"]
        gts = data["groundtruths"]
        max_detections = self.max_detection_thresholds[-1]
        class_index = {c: k for k, c in enumerate(class_ids)}
        nb_bbox_areas = len(self.bbox_area_ranges)

        # every (image, class) cell holding a detection or a ground truth, in image order
        cells = []
        jobs = []
        routes = {"host": 0, "device": 0}
        for img in range(len(gts)):
            det_groups = _group_by_class(data["detection_labels"][img], class_index)
            gt_groups = _group_by_class(data["groundtruth_labels"][img], class_index)
            if not det_groups and not gt_groups:
                continue
            det_out = self._outside_area(self._item_area(dets[img])) if det_groups else None
            gt_out = self._outside_area(self._item_area(gts[img])) if gt_groups else None
            for k in sorted(set(det_groups) | set(gt_groups)):
                det_sel = det_groups.get(k, np.zeros(0, np.int64))
                gt_sel = gt_groups.get(k, np.zeros(0, np.int64))
                scores_sorted = np.zeros(0, np.float32)
                if len(det_sel):
                    scores_filtered = scores[img][det_sel]
                    dtind = np.argsort(-scores_filtered, kind="stable")
                    det_sel = det_sel[dtind][:max_detections]
                    scores_sorted = scores_filtered[dtind][:max_detections]
                iou = None
                if len(det_sel) and len(gt_sel):
                    iou = self._compute_iou(dets[img][det_sel], gts[img][gt_sel])
                    if iou is None:
                        jobs.append((img, det_sel, gt_sel))
                        routes["device"] += 1
                    else:
                        routes["host"] += 1
                cells.append((k, iou, len(det_sel) > 0 and len(gt_sel) > 0, scores_sorted,
                              det_out[:, det_sel] if len(det_sel) else np.zeros((nb_bbox_areas, 0), dtype=bool),
                              gt_out[:, gt_sel] if len(gt_sel) else np.zeros((nb_bbox_areas, 0), dtype=bool)))
        device_ious = iter(self._device_ious(jobs))
        self.iou_cells = routes

        # per class and area range, the evaluated cells in image order
        eval_imgs: List[List[List[tuple]]] = [[[] for _ in range(nb_bbox_areas)] for _ in class_ids]
        thr = self._threshold_values()
        for k, iou, both, scores_sorted, det_out, gt_out in cells:
            if iou is None and both:
                iou = next(device_ious)
            for a, entry in enumerate(self._evaluate_image(iou, gt_out, det_out, scores_sorted, thr)):
                eval_imgs[k][a].append(entry)

        nb_iou_thrs = len(self.iou_thresholds)
        nb_rec_thrs = len(self.rec_thresholds)
        nb_classes = len(class_ids)
        nb_max_det_thrs = len(self.max_detection_thresholds)
        precision = -np.ones((nb_iou_thrs, nb_rec_thrs, nb_classes, nb_bbox_areas, nb_max_det_thrs))
        recall = -np.ones((nb_iou_thrs, nb_classes, nb_bbox_areas, nb_max_det_thrs))
        rec_thresholds = np.asarray(self.rec_thresholds)

        for idx_cls in range(nb_classes):
            for idx_bbox_area in range(nb_bbox_areas):
                entries = eval_imgs[idx_cls][idx_bbox_area]
                if not entries:
                    continue
                # the cells of this class and range concatenated once; each detection's rank in
                # its cell selects the first max_det of every cell, as JAX's per-cell slices do
                scores_all = np.concatenate([e[2] for e in entries])
                rank = np.concatenate([np.arange(len(e[2])) for e in entries])
                matches_all = np.concatenate([e[0] for e in entries], axis=1)
                ignore_all = np.concatenate([e[1] for e in entries], axis=1)
                gt_ignore = np.concatenate([e[3] for e in entries])
                for idx_max_det_thrs, max_det in enumerate(self.max_detection_thresholds):
                    keep = rank < max_det
                    self._calculate_recall_precision_scores(
                        recall,
                        precision,
                        idx_cls=idx_cls,
                        idx_bbox_area=idx_bbox_area,
                        idx_max_det_thrs=idx_max_det_thrs,
                        det_scores=scores_all[keep],
                        det_matches=matches_all[:, keep],
                        det_ignore=ignore_all[:, keep],
                        gt_ignore=gt_ignore,
                        rec_thresholds=rec_thresholds,
                    )
        return precision, recall

    @staticmethod
    def _calculate_recall_precision_scores(
        recall: np.ndarray,
        precision: np.ndarray,
        idx_cls: int,
        idx_bbox_area: int,
        idx_max_det_thrs: int,
        det_scores: np.ndarray,
        det_matches: np.ndarray,
        det_ignore: np.ndarray,
        gt_ignore: np.ndarray,
        rec_thresholds: np.ndarray,
    ) -> None:
        """101-point interpolation per threshold (reference `mean_ap.py:797-877`)."""
        nb_rec_thrs = len(rec_thresholds)
        # mergesort to be consistent with pycocotools/Matlab (reference `mean_ap.py:826-831`)
        inds = np.argsort(-det_scores, kind="mergesort")
        det_matches = det_matches[:, inds]
        det_ignore = det_ignore[:, inds]
        npig = np.count_nonzero(~gt_ignore)
        if npig == 0:
            return
        tps = det_matches & ~det_ignore
        fps = ~det_matches & ~det_ignore

        tp_sum = np.cumsum(tps, axis=1).astype(float)
        fp_sum = np.cumsum(fps, axis=1).astype(float)
        for idx, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
            nd = len(tp)
            rc = tp / npig
            pr = tp / (fp + tp + np.finfo(np.float64).eps)
            prec = np.zeros((nb_rec_thrs,))

            recall[idx, idx_cls, idx_bbox_area, idx_max_det_thrs] = rc[-1] if nd else 0

            # monotone envelope from the right (the reference's zigzag loop in one pass)
            pr = np.maximum.accumulate(pr[::-1])[::-1]

            inds_t = np.searchsorted(rc, rec_thresholds, side="left")
            num_inds = int(inds_t.argmax()) if inds_t.max() >= nd else nb_rec_thrs
            inds_t = inds_t[:num_inds]
            prec[:num_inds] = pr[inds_t]
            precision[idx, :, idx_cls, idx_bbox_area, idx_max_det_thrs] = prec

    def _summarize(
        self,
        results: Dict[str, np.ndarray],
        avg_prec: bool = True,
        iou_threshold: Optional[float] = None,
        area_range: str = "all",
        max_dets: int = 100,
    ) -> float:
        """Mean over valid (> -1) cells of the selected slice (reference `mean_ap.py:672-702`)."""
        area_inds = [i for i, k in enumerate(self.bbox_area_ranges.keys()) if k == area_range]
        mdet_inds = [i for i, k in enumerate(self.max_detection_thresholds) if k == max_dets]
        if avg_prec:
            prec = results["precision"]
            if iou_threshold is not None:
                thr = self.iou_thresholds.index(iou_threshold)
                prec = prec[thr, :, :, area_inds, mdet_inds]
            else:
                prec = prec[:, :, :, area_inds, mdet_inds]
        else:
            prec = results["recall"]
            if iou_threshold is not None:
                thr = self.iou_thresholds.index(iou_threshold)
                prec = prec[thr, :, area_inds, mdet_inds]
            else:
                prec = prec[:, :, area_inds, mdet_inds]
        valid = prec[prec > -1]
        return -1.0 if valid.size == 0 else float(valid.mean())

    def _summarize_results(self, precisions: np.ndarray, recalls: np.ndarray) -> Tuple[dict, dict]:
        results = dict(precision=precisions, recall=recalls)
        last_max_det_thr = self.max_detection_thresholds[-1]

        map_metrics = {"map": self._summarize(results, True)}
        map_metrics["map_50"] = (
            self._summarize(results, True, iou_threshold=0.5, max_dets=last_max_det_thr)
            if 0.5 in self.iou_thresholds
            else -1.0
        )
        map_metrics["map_75"] = (
            self._summarize(results, True, iou_threshold=0.75, max_dets=last_max_det_thr)
            if 0.75 in self.iou_thresholds
            else -1.0
        )
        map_metrics["map_small"] = self._summarize(results, True, area_range="small", max_dets=last_max_det_thr)
        map_metrics["map_medium"] = self._summarize(results, True, area_range="medium", max_dets=last_max_det_thr)
        map_metrics["map_large"] = self._summarize(results, True, area_range="large", max_dets=last_max_det_thr)

        mar_metrics = {}
        for max_det in self.max_detection_thresholds:
            mar_metrics[f"mar_{max_det}"] = self._summarize(results, False, max_dets=max_det)
        mar_metrics["mar_small"] = self._summarize(results, False, area_range="small", max_dets=last_max_det_thr)
        mar_metrics["mar_medium"] = self._summarize(results, False, area_range="medium", max_dets=last_max_det_thr)
        mar_metrics["mar_large"] = self._summarize(results, False, area_range="large", max_dets=last_max_det_thr)
        return map_metrics, mar_metrics

    def compute(self) -> dict:
        """mAP/mAR summary dict (reference `mean_ap.py:879-933`), float32 tensors on the metric's device."""
        data = self._materialize_states()
        classes = self._get_classes(data)
        precisions, recalls = self._calculate(classes, data)
        map_val, mar_val = self._summarize_results(precisions, recalls)

        map_per_class_values = np.asarray([-1.0])
        mar_max_dets_per_class_values = np.asarray([-1.0])
        if self.class_metrics:
            map_per_class_list = []
            mar_max_dets_per_class_list = []
            for class_idx in range(len(classes)):
                cls_precisions = precisions[:, :, class_idx][:, :, None]
                cls_recalls = recalls[:, class_idx][:, None]
                cls_map, cls_mar = self._summarize_results(cls_precisions, cls_recalls)
                map_per_class_list.append(cls_map["map"])
                mar_max_dets_per_class_list.append(cls_mar[f"mar_{self.max_detection_thresholds[-1]}"])
            map_per_class_values = np.asarray(map_per_class_list, dtype=np.float32)
            mar_max_dets_per_class_values = np.asarray(mar_max_dets_per_class_list, dtype=np.float32)

        # every value to the metric's device in one copy
        scalars = {**map_val, **mar_val}
        per_class = (map_per_class_values, mar_max_dets_per_class_values)
        packed = torch.from_numpy(np.concatenate(
            [np.asarray(list(scalars.values()), np.float32)] + [v.astype(np.float32).reshape(-1) for v in per_class]
        )).to(self.device)
        values = iter(packed.split([len(scalars)] + [v.size for v in per_class]))
        metrics = dict(zip(scalars, next(values).unbind()))
        metrics["map_per_class"] = next(values)
        metrics[f"mar_{self.max_detection_thresholds[-1]}_per_class"] = next(values)
        return metrics


__all__ = ["MeanAveragePrecision"]
