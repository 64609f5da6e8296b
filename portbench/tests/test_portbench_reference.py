"""The plain references against cases worked by hand."""
import torch
from conftest import small_cell


def test_segmentation_reference_counts_and_ratios(spec):
    cell = small_cell(spec, "seg19.labels-b8")
    ref = cell.reference
    config = {"data": {"num_classes": 3}}
    # 1 image of 2 x 3 pixels; rows of the matrix are the target
    target = torch.tensor([[[0, 0, 1], [1, 2, 2]]])
    preds = torch.tensor([[[0, 1, 1], [1, 2, 0]]])
    state = ref.accumulate([(preds, target)], config, torch.float64)
    assert state["confmat"].tolist() == [[1, 1, 0], [0, 2, 0], [1, 0, 1]]
    # tp, fp, tn, fn per class
    assert state["dice"].tolist() == [[1, 2, 1], [1, 1, 0], [3, 3, 4], [1, 0, 1]]
    values = ref.values(state, config, torch.float64)
    assert abs(values["miou"] - (1 / 3 + 2 / 3 + 1 / 2) / 3) < 1e-15
    assert abs(values["dice"] - (2 / 4 + 4 / 5 + 2 / 3) / 3) < 1e-15
    # softmax maps take their arg-max; the first of equal maxima
    soft = torch.tensor([[[[0.5, 0.2]], [[0.5, 0.7]], [[0.0, 0.1]]]])
    state = ref.accumulate([(soft, torch.tensor([[[1, 1]]]))], config, torch.float64)
    assert state["confmat"].tolist() == [[0, 0, 0], [1, 1, 0], [0, 0, 0]]


def test_segmentation_reference_leaves_absent_classes_out_of_dice_only(spec):
    ref = small_cell(spec, "seg19.labels-b8").reference
    config = {"data": {"num_classes": 3}}
    state = ref.accumulate([(torch.tensor([[[0, 1]]]), torch.tensor([[[0, 1]]]))], config, torch.float64)
    values = ref.values(state, config, torch.float64)
    assert values["miou"] == 2 / 3 and values["dice"] == 1.0


def test_ctr_reference_areas_with_ties_and_bins(spec):
    cell = small_cell(spec, "ctr.epoch-89m")
    ref = cell.reference
    # dyadic scores, as the traffic's multiples of 2**-12: none lies on a bin boundary j / 15
    scores = torch.tensor([0.125, 0.375, 0.375, 0.75, 0.75, 0.25])
    labels = torch.tensor([0, 1, 0, 1, 1, 0])
    state = ref.accumulate([(scores[:3], labels[:3]), (scores[3:], labels[3:])], cell.config, torch.float64)
    values = ref.values(state, cell.config, torch.float64)
    # pairs (pos, neg): 3 x 3 = 9; the tie at 0.375 counts a half: 8.5 / 9
    assert abs(values["auroc"] - 8.5 / 9) < 1e-15
    # descending runs: 0.75 (2 pos of 2), 0.375 (1 pos of 2, precision 3/4): (2 * 1 + 1 * 3/4) / 3
    assert abs(values["ap"] - (2 + 0.75) / 3) < 1e-15
    # 15 bins (j/15, (j+1)/15]: 0.125 -> 1, 0.25 -> 3, 0.375 -> 5, 0.75 -> 11
    count, conf, right = state["bins"]
    assert count[[1, 3, 5, 11]].tolist() == [1, 1, 2, 2] and right[[5, 11]].tolist() == [1, 2]
    ece = (0.125 + 0.25 + abs(1 - 0.75) + abs(2 - 1.5)) / 6
    assert abs(values["ece"] - ece) < 1e-12


def test_ctr_reference_counts_rows_that_differ(spec):
    ref = small_cell(spec, "ctr.epoch-89m").reference
    config = small_cell(spec, "ctr.epoch-89m").config
    s, y = torch.tensor([0.25, 0.5, 0.75]), torch.tensor([0, 1, 1])
    want = ref.accumulate([(s, y)], config, torch.float64)
    got = {"rows.auroc": (s.clone(), y.clone()), "rows.ap": (torch.tensor([0.25, 0.5, 0.5]), y.clone()),
           "bins": want["bins"]}
    numbers = ref.compare_states(got, want)
    assert numbers == {"rows_off": 1.0, "bin_counts_off": 0.0, "conf_sum_gap": 0.0}
