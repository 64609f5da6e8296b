"""The generator: deterministic by seed, and the epoch laid out as a loader gives it."""
import pytest
import torch
from conftest import small_cell

import generate


@pytest.mark.parametrize("workload", ["seg19.softmax-b2", "seg19.labels-b8", "ctr.epoch-89m"])
def test_the_same_seed_gives_the_same_inputs_and_another_seed_others(spec, workload):
    cell = small_cell(spec, workload)
    a = generate.make_inputs(cell.data, cell.traffic, 2**31 + 77, "cpu")
    b = generate.make_inputs(cell.data, cell.traffic, 2**31 + 77, "cpu")
    c = generate.make_inputs(cell.data, cell.traffic, 2**31 + 78, "cpu")
    assert len(a) == len(b) == len(c)
    for (pa, ta), (pb, tb) in zip(a, b):
        assert torch.equal(pa, pb) and torch.equal(ta, tb)
    assert any(not torch.equal(pa, pc) for (pa, _), (pc, _) in zip(a, c))


def test_segmentation_inputs_have_the_mix_shapes_classes_and_agreement(spec):
    cell = small_cell(spec, "seg19.softmax-b2")
    pool = generate.make_inputs(cell.data, cell.traffic, 5, "cpu")
    preds, target = pool[0]
    assert preds.shape == (2, 19, 64, 128) and preds.dtype == torch.float32
    assert target.shape == (2, 64, 128) and target.dtype == torch.int64
    assert torch.allclose(preds.sum(1), torch.ones(()), atol=1e-5)
    labels = small_cell(spec, "seg19.labels-b8")
    lp, lt = generate.make_inputs(labels.data, labels.traffic, 5, "cpu")[0]
    assert lp.shape == lt.shape == (8, 64, 128) and lp.dtype == torch.int64
    agree = torch.cat([(p.argmax(1) == t).reshape(-1) for p, t in pool]).double().mean()
    assert 0.8 < agree < 0.97
    # the road and building classes hold the most pixels, as in Cityscapes
    counts = torch.bincount(torch.cat([t.reshape(-1) for _, t in pool]), minlength=19)
    assert set(torch.topk(counts, 2).indices.tolist()) == {0, 2}


def test_epochs_end_in_a_partial_step_as_a_loader_without_drop_last_gives(spec):
    cell = small_cell(spec, "seg19.labels-b8")
    data = dict(cell.data, images_per_epoch=500)
    steps = generate.epoch_steps(data, cell.traffic, [(torch.zeros(8, 1), torch.zeros(8, 1))] * 16)
    assert len(steps) == 63 and [generate.step_samples(s) for s in steps[-2:]] == [8, 4]
    ctr = small_cell(spec, "ctr.epoch-89m")
    rows = torch.zeros(89_137_319, dtype=torch.int8)
    steps = generate.epoch_steps(dict(ctr.data), dict(ctr.traffic, batch=262_144), [(rows, rows)])
    assert len(steps) == 341 and generate.step_samples(steps[-1]) == 8_359
    assert sum(generate.step_samples(s) for s in steps) == 89_137_319


def test_scores_are_quantised_and_labels_are_clicks_at_the_rate(spec):
    cell = small_cell(spec, "ctr.epoch-89m")
    (scores, labels), = generate.make_inputs(cell.data, cell.traffic, 9, "cpu")
    assert scores.dtype == torch.float32 and labels.dtype == torch.int64 and scores.numel() == 600_000
    assert torch.equal(scores * 4096, torch.round(scores * 4096))
    assert 0.027 < labels.double().mean() < 0.033
