"""The comparison that decides ``correct`` fails the control and the faults a cell can have.

The control is the plain reference computed in bfloat16, the precision below the configuration's float32,
put in the program's place. The faults are planted underneath the timed path, in the program's
``MetricCollection``: a step that returns its state unchanged, half of the batch left out, an answer
altered where it is produced. The harness's look for a card is skipped: the program runs on the CPU at a
size a test run holds."""
import pytest
from conftest import small_cell
from test_portbench_run import WORKLOADS, small_run

import generate
import harness


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_comes_out_not_correct(spec, workload, seed):
    cell = small_cell(spec, workload)
    epoch = generate.epoch_steps(cell.data, cell.traffic, generate.make_inputs(cell.data, cell.traffic, seed, "cpu"))
    numbers = harness.control_numbers(cell, epoch, epoch[: len(epoch) // 2])
    verdict = harness.judge(numbers, cell.limits)
    assert not all(v["ok"] for v in verdict.values()), numbers


def _skip_every_other(original):
    calls = {"n": 0}

    def update(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] % 2:
            return original(self, *args, **kwargs)
    return update


def _half_batch(original):
    def update(self, preds, target):
        n = max(1, preds.shape[0] // 2)
        return original(self, preds[:n], target[:n])
    return update


def _altered_answer(original):
    def compute(self):
        values = dict(original(self))
        first = next(iter(values))
        values[first] = values[first] * (1 + 1e-3)
        return values
    return compute


FAULTS = {"state_unchanged": ("update", _skip_every_other), "half_batch": ("update", _half_batch),
          "altered_answer": ("compute", _altered_answer)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_fault_under_the_timed_path_makes_the_run_not_correct(spec, workload, fault, monkeypatch):
    import metrics_tpu_torch as mt

    method, plant = FAULTS[fault]
    monkeypatch.setattr(mt.MetricCollection, method, plant(getattr(mt.MetricCollection, method)))
    result = small_run(spec, workload, False)
    assert result["correct"] is False and result["failed"] > 0, result["check"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_sound_program_is_correct_at_the_test_size(spec, workload):
    assert small_run(spec, workload, False, seed=2**31 + 99)["correct"] is True


# the four-rank cell on four CPU processes (Gloo): five updates of the traffic's own batch, so every rank has one
DDP_ROWS = {"rows_per_epoch": 4 * 262_144 + 1_000}


def leave_out_the_exchange():
    """Planted in each rank: the program's gather returns this rank's rows in every rank's place."""
    from metrics_tpu_torch.parallel import sync

    def local_only(tensor, group=None):
        import torch.distributed as dist

        return tensor.contiguous().unsqueeze(0).expand((dist.get_world_size(group),) + tuple(tensor.shape)).clone()
    sync._all_gather = local_only


FOUR_RANK_CELL = {"name": "ctr.ddp4", "config": "criteo1tb-ctr", "traffic": "epoch-b262144-4ranks", "chips": 4,
                  "why": "four ranks, each a quarter of the updates; compute() syncs every rank's rows"}


def test_the_four_rank_cell_is_correct_on_gloo_and_not_without_the_exchange(spec):
    """A cell of four ranks, added as an entry alone to a copy of the spec: the harness runs it as four
    processes over Gloo, and the check fails it when the exchange between the ranks is left out."""
    spec = dict(spec, workloads=spec["workloads"] + [FOUR_RANK_CELL])
    sound = harness.run_cell(spec, "ctr.ddp4", 2**31 + 21, 0.5, False, "cpu", data_overrides=DDP_ROWS)
    assert sound["correct"] is True and sound["device"]["count"] == 4, sound["check"]
    broken = harness.run_cell(spec, "ctr.ddp4", 2**31 + 21, 0.5, False, "cpu", data_overrides=DDP_ROWS,
                              rank_setup=leave_out_the_exchange)
    assert broken["correct"] is False, broken["check"]
