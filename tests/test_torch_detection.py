"""The port's detection metric and its box operations against the JAX package's.

``box_convert``, ``box_area``, ``box_iou`` and ``mask_iou`` on numpy inputs
from a seed; the COCO RLE codec (encode, decode, ``masks_from_any``) byte for
byte; and ``MeanAveragePrecision`` on the scenarios of
``tests/detection/test_mean_ap.py`` (``_random_scenario``: overlapping boxes
of every size range, some detections jittered copies of ground truth), in
every box format, with ``class_metrics``, custom IoU, recall and
max-detection thresholds, ``iou_type="segm"`` (dense masks and RLE), empty
images, cells large enough to take the device route (here the CPU's torch
ops), and the validation errors. Tolerances: every mAP/mAR value must equal
JAX's within ``MAP_ATOL`` (1e-6; bit for bit is what is seen); box
conversions, areas and mask IoUs bit for bit; box IoUs within
``BOX_IOU_RTOL`` (1e-6: XLA may fuse a product into the union's sum). Also:
the states through ``state_dict``, ``.to()`` and ``compute()`` twice, and
two emulated ranks synced row by row.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import metrics_tpu.functional.detection as jF
from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu.functional.detection import rle as jrle
import metrics_tpu_torch as tmt
import metrics_tpu_torch.functional.detection as tF
from metrics_tpu_torch.functional.detection import rle as trle
from tests.detection.test_mean_ap import _random_scenario
from tests.helpers.torch_sync import TorchFakeGather

MAP_ATOL = 1e-6
BOX_IOU_RTOL = 1e-6
FORMATS = ("xyxy", "xywh", "cxcywh")
DIST_ON = lambda: True  # noqa: E731


def _to_jax(dicts):
    return [{k: (v if isinstance(v, (dict, list)) else jnp.asarray(v)) for k, v in d.items()} for d in dicts]


def _to_torch(dicts):
    return [{k: (v if isinstance(v, (dict, list)) else torch.from_numpy(np.asarray(v))) for k, v in d.items()}
            for d in dicts]


def _assert_same_results(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        g, w = got[key], np.asarray(value)
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32 and g.shape == w.shape, key
        np.testing.assert_allclose(g.numpy(), w, atol=MAP_ATOL, rtol=0, err_msg=key)


def _run_both(preds, targets, updates=1, torch_inputs=True, **kwargs):
    jm, tm = JaxMAP(**kwargs), tmt.MeanAveragePrecision(device="cpu", **kwargs)
    step = -(-len(preds) // updates) if preds else 1
    for i in range(0, max(len(preds), 1), step):
        p, t = preds[i : i + step], targets[i : i + step]
        jm.update(_to_jax(p), _to_jax(t))
        tm.update(_to_torch(p) if torch_inputs else p, _to_torch(t) if torch_inputs else t)
    want = jm.compute()
    got = tm.compute()
    _assert_same_results(got, want)
    return tm, got


def _convert(dicts, fmt):
    """The scenario's xyxy boxes written in ``fmt``."""
    out = []
    for d in dicts:
        b = np.asarray(d["boxes"], np.float32).reshape(-1, 4)
        if fmt == "xywh":
            b = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], 1)
        elif fmt == "cxcywh":
            b = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], 1)
        out.append({**d, "boxes": b})
    return out


# ---------------------------------------------------------------- box operations
@pytest.mark.parametrize("in_fmt", FORMATS)
@pytest.mark.parametrize("out_fmt", FORMATS)
def test_box_convert_matches_jax(in_fmt, out_fmt):
    boxes = (np.random.RandomState(0).rand(17, 4) * 300).astype(np.float32)
    want = np.asarray(jF.box_convert(jnp.asarray(boxes), in_fmt, out_fmt))
    got = tF.box_convert(torch.from_numpy(boxes), in_fmt, out_fmt).numpy()
    np.testing.assert_array_equal(got, want)


def test_box_area_iou_and_mask_iou_match_jax():
    rng = np.random.RandomState(1)
    xy = rng.rand(23, 2) * 100
    b1 = np.concatenate([xy, xy + rng.rand(23, 2) * 50], 1).astype(np.float32)
    b1[3] = [5, 5, 5, 5]  # a degenerate box: 0 / 0 against itself
    b2 = np.concatenate([b1[:11] + 3, b1[11:12]]).astype(np.float32)
    np.testing.assert_array_equal(tF.box_area(torch.from_numpy(b1)).numpy(), np.asarray(jF.box_area(jnp.asarray(b1))))
    got = tF.box_iou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    want = np.asarray(jF.box_iou(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_allclose(got, want, rtol=BOX_IOU_RTOL, atol=0, equal_nan=True)
    m1 = rng.rand(5, 12, 9) > 0.6
    m2 = np.concatenate([rng.rand(3, 12, 9) > 0.5, np.zeros((1, 12, 9), bool)])
    m1[0] = False  # an empty mask against an empty mask: union 0 gives 0
    np.testing.assert_array_equal(tF.mask_iou(torch.from_numpy(m1), torch.from_numpy(m2)).numpy(),
                                  np.asarray(jF.mask_iou(jnp.asarray(m1), jnp.asarray(m2))))
    with pytest.raises(ValueError, match="Unsupported"):
        tF.box_convert(torch.from_numpy(b1), "xyxy", "yxyx")


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("shape,density", [((7, 5), 0.5), ((30, 41), 0.1), ((1, 1), 1.0), ((4, 6), 0.0)])
def test_rle_matches_jax(compress, shape, density):
    mask = np.random.RandomState(shape[0]).rand(*shape) < density
    got, want = trle.rle_encode(mask, compress=compress), jrle.rle_encode(mask, compress=compress)
    assert got == want
    np.testing.assert_array_equal(trle.rle_decode(got), mask)
    np.testing.assert_array_equal(trle.masks_from_any([got, got]), jrle.masks_from_any([want, want]))
    np.testing.assert_array_equal(trle.masks_from_any(got), jrle.masks_from_any(want))
    np.testing.assert_array_equal(trle.masks_from_any(mask), jrle.masks_from_any(mask))
    with pytest.raises(ValueError, match="RLE counts"):
        trle.rle_decode({"size": [shape[0], shape[1] + 1], "counts": trle.rle_encode(mask, False)["counts"]})


# ---------------------------------------------------------------- mean average precision
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("box_format", FORMATS)
def test_map_matches_jax_on_random_scenarios(seed, box_format):
    preds, targets = _random_scenario(np.random.RandomState(seed))
    _run_both(_convert(preds, box_format), _convert(targets, box_format), updates=2, box_format=box_format)


@pytest.mark.parametrize("torch_inputs", [True, False], ids=["tensors", "numpy"])
def test_map_class_metrics_and_input_kinds(torch_inputs):
    preds, targets = _random_scenario(np.random.RandomState(7), n_images=8, n_classes=5, max_boxes=10)
    tm, got = _run_both(_convert(preds, "cxcywh"), _convert(targets, "cxcywh"), updates=3, torch_inputs=torch_inputs,
                        box_format="cxcywh", class_metrics=True)
    assert got["map_per_class"].shape == (5,) and got["mar_100_per_class"].shape == (5,)


def test_map_integer_boxes_convert_like_jax():
    preds, targets = _random_scenario(np.random.RandomState(3))
    as_int = lambda ds: [{**d, "boxes": np.round(_convert([d], "xywh")[0]["boxes"]).astype(np.int32)} for d in ds]  # noqa: E731
    _run_both(as_int(preds), as_int(targets), box_format="xywh")


@pytest.mark.parametrize("kwargs", [
    dict(iou_thresholds=[0.3, 0.5, 0.75], rec_thresholds=[0.0, 0.25, 0.5, 0.75, 1.0]),
    dict(iou_thresholds=[0.1, 0.2], max_detection_thresholds=[1, 5, 20]),
    dict(max_detection_thresholds=[2, 3], class_metrics=True),
], ids=["iou-rec", "no-50-75", "max-det"])
def test_map_custom_thresholds(kwargs):
    preds, targets = _random_scenario(np.random.RandomState(11), n_images=7, max_boxes=12)
    _run_both(preds, targets, updates=2, **kwargs)


def test_map_empty_images():
    preds, targets = _random_scenario(np.random.RandomState(2), n_images=5)
    empty_det = dict(boxes=np.zeros((0, 4), np.float32), scores=np.zeros(0, np.float32), labels=np.zeros(0, np.int64))
    empty_gt = dict(boxes=np.zeros((0, 4), np.float32), labels=np.zeros(0, np.int64))
    preds = [empty_det, preds[0], empty_det, preds[1], preds[2]]
    targets = [targets[0], empty_gt, empty_gt, targets[1], empty_gt]
    _run_both(preds, targets, updates=2, class_metrics=True)
    _run_both([empty_det, empty_det], [empty_gt, empty_gt])  # no class at all: every value -1


def _scene_masks(rng, n, h, w, label_pool):
    masks = np.zeros((n, h, w), bool)
    for i in range(n):
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        masks[i, y : y + rng.randint(3, h // 2), x : x + rng.randint(3, w // 2)] = True
        masks[i] &= rng.rand(h, w) < 0.9
    return masks, rng.choice(label_pool, n)


def _mask_scenario(seed, n_images=5, h=24, w=32, max_instances=6, label_pool=(0, 1, 2), rle=False, min_instances=0):
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for _ in range(n_images):
        gt, gl = _scene_masks(rng, rng.randint(min_instances, max_instances), h, w, label_pool)
        det = np.concatenate([gt & (rng.rand(*gt.shape) < 0.85), _scene_masks(rng, 2, h, w, label_pool)[0]])
        dl = np.concatenate([gl, rng.choice(label_pool, 2)])
        if rle:
            det = [trle.rle_encode(m, compress=bool(i % 2)) for i, m in enumerate(det)]
            gt = [trle.rle_encode(m) for m in gt] if len(gt) else np.zeros((0, h, w), bool)
        preds.append(dict(masks=det, scores=rng.rand(len(dl)).astype(np.float32), labels=dl))
        targets.append(dict(masks=gt, labels=gl))
    return preds, targets


@pytest.mark.parametrize("rle", [False, True], ids=["dense", "rle"])
def test_map_segm_matches_jax(rle):
    preds, targets = _mask_scenario(4, rle=rle)
    tm, _ = _run_both(preds, targets, updates=2, iou_type="segm", class_metrics=True)
    assert tm.iou_cells["device"] == 0 and tm.iou_cells["host"] > 0
    assert all(r.dtype == torch.bool for r in tm.detections)


def test_map_device_route_cells_match_jax():
    """Cells above JAX's work threshold take the device route (here torch on the CPU): masks of
    256 x 256 with more than 64 (detection, ground truth) pairs, and a 300 x 300 box cell."""
    preds, targets = _mask_scenario(5, n_images=2, h=256, w=256, max_instances=14, label_pool=(3,), min_instances=10)
    tm, _ = _run_both(preds, targets, iou_type="segm")
    assert tm.iou_cells["device"] > 0
    rng = np.random.RandomState(6)
    xy = rng.rand(300, 2) * 400
    gt = np.concatenate([xy, xy + rng.rand(300, 2) * 80 + 2], 1).astype(np.float32)
    det = (gt + rng.randn(300, 4) * 4).astype(np.float32)
    det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
    preds = [dict(boxes=det, scores=rng.rand(300).astype(np.float32), labels=np.zeros(300, np.int64))]
    targets = [dict(boxes=gt, labels=np.zeros(300, np.int64))]
    tm, _ = _run_both(preds, targets, max_detection_thresholds=[1, 10, 300])
    assert tm.iou_cells == {"host": 0, "device": 1}


@pytest.mark.parametrize("case", ["length", "missing-key", "labels", "scores", "not-a-sequence"])
def test_map_validation_errors_match_jax(case):
    preds, targets = _random_scenario(np.random.RandomState(0), n_images=2, max_boxes=4)
    preds = [dict(p) for p in preds]
    targets = [dict(t) for t in targets]
    if case == "length":
        targets = targets[:1]
    elif case == "missing-key":
        del preds[0]["scores"]
    elif case == "labels":
        targets[1]["labels"] = np.zeros(len(targets[1]["labels"]) + 1, np.int64)
    elif case == "scores":
        preds[1]["scores"] = np.zeros(len(preds[1]["scores"]) + 2, np.float32)
    else:
        preds = dict(preds[0])
    with pytest.raises(ValueError) as jerr:
        JaxMAP().update(preds if case == "not-a-sequence" else _to_jax(preds), _to_jax(targets))
    with pytest.raises(ValueError) as terr:
        tmt.MeanAveragePrecision(device="cpu").update(preds if case == "not-a-sequence" else _to_torch(preds),
                                                      _to_torch(targets))
    assert str(terr.value) == str(jerr.value)


def test_map_constructor_errors():
    for kwargs, match in ((dict(box_format="yxyx"), "box_format"), (dict(iou_type="keypoints"), "iou_type"),
                          (dict(class_metrics=1), "class_metrics")):
        with pytest.raises(ValueError, match=match):
            tmt.MeanAveragePrecision(device="cpu", **kwargs)


def test_map_states_through_state_dict_to_and_two_computes():
    preds, targets = _random_scenario(np.random.RandomState(9), n_images=6)
    metric = tmt.MeanAveragePrecision(box_format="xywh", device="cpu")
    metric.update(_to_torch(_convert(preds, "xywh")), _to_torch(_convert(targets, "xywh")))
    first = metric.compute()
    assert all(isinstance(r, torch.Tensor) for name in ("detections", "groundtruths") for r in getattr(metric, name))
    metric._computed = None  # a second compute() from the same states, not the cached value
    again = metric.compute()
    for k in first:
        assert torch.equal(first[k], again[k]), k
    metric.persistent(True)
    state = metric.state_dict()
    assert len(state["detections"]) == 6
    loaded = tmt.MeanAveragePrecision(box_format="xywh", device="cpu")
    loaded.load_state_dict(state)
    loaded.to("cpu")
    with pytest.warns(UserWarning, match="before the ``update``"):  # loading a state is no update
        values = loaded.compute()
    for k, v in values.items():
        assert torch.equal(v, first[k]), k
    # rows converted once at update: the loaded xyxy rows are not converted again
    torch.testing.assert_close(loaded.detections[0], torch.from_numpy(preds[0]["boxes"]).reshape(-1, 4),
                               rtol=0, atol=1e-4)


def test_map_syncs_row_by_row_across_two_ranks():
    scenario = [_random_scenario(np.random.RandomState(20 + r), n_images=4) for r in range(2)]
    ranks = [tmt.MeanAveragePrecision(device="cpu") for _ in range(2)]
    for metric, (preds, targets) in zip(ranks, scenario):
        metric.update(_to_torch(preds), _to_torch(targets))
    ranks[0].sync(dist_sync_fn=TorchFakeGather(ranks), distributed_available=DIST_ON)
    assert len(ranks[0].detections) == 8
    got = ranks[0].compute()
    # the rows come image by image, each image's ranks in turn
    reference = JaxMAP()
    order = [(r, i) for i in range(4) for r in range(2)]
    reference.update(_to_jax([scenario[r][0][i] for r, i in order]), _to_jax([scenario[r][1][i] for r, i in order]))
    _assert_same_results(got, reference.compute())
    ranks[0].unsync()
    assert len(ranks[0].detections) == 4
