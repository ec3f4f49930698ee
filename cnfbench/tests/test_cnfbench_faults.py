"""``correct`` comes out false when the timed path is broken underneath:
a run of the harness with the chip's look skipped, on the CPU at a small
size, with each fault that its kind of cell can have planted
(``faults.py``), and with the control (the reference at the precision below
the configuration's) in the program's place. A sound run is correct. The
limits here are the small size's, set between these readings as the
cells' are set between the card's (PERF.md)."""

import time

import pytest
import torch

from cnfbench import calibrate, faults, run
from cnfbench.tests.small import small_cell

TRAIN_LIMITS = {"grad_gap": 0.05, "update_gap": 0.07}
SERVE_LIMITS = {"mean_excess": 0.2, "worst_sample_excess": 0.5}
SEEDS = (11, 2**35 + 3, 987654321)


def one_run(cell, seed, fault=None):
    result = run.run_cell(cell, seed, 0.3, False, device="cpu", start_wall=time.time(),
                          fault=fault)
    return run.compare(cell, result)[0], result


@pytest.mark.parametrize("traffic,limits", [("train", TRAIN_LIMITS), ("serve", SERVE_LIMITS)])
@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_run_is_correct_and_the_control_is_not(traffic, limits, seed):
    cell = small_cell(traffic, "bfloat16", limits)
    correct, result = one_run(cell, seed)
    assert correct, result["numbers"]
    numbers = calibrate.control(cell, seed, torch.device("cpu"))
    assert any(numbers[k] > limit for k, limit in limits.items()), numbers


@pytest.mark.parametrize("fault", faults.KIND_FAULTS["train"])
def test_a_broken_train_step_is_not_correct(fault):
    correct, result = one_run(small_cell("train", "bfloat16", TRAIN_LIMITS), SEEDS[0], fault)
    assert not correct, result["numbers"]


@pytest.mark.parametrize("fault", faults.KIND_FAULTS["serve"])
def test_a_broken_answer_is_not_correct(fault):
    correct, result = one_run(small_cell("serve", "bfloat16", SERVE_LIMITS), SEEDS[0], fault)
    assert not correct, result["numbers"]


def test_faults_come_out_again():
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow

    before = ConvCFlow.log_loss
    undo = faults.plant("half_batch")
    assert ConvCFlow.log_loss is not before
    undo()
    assert ConvCFlow.log_loss is before


@pytest.mark.parametrize("fault", [None, *faults.KIND_FAULTS["train_multi"]])
def test_data_parallel_steps_across_four_processes(fault):
    """Four gloo processes, each with its own rows: a sound run is correct;
    a step that leaves the state unchanged, drops half of each process's
    rows or leaves out the exchange of gradients is not."""
    correct, result = one_run(small_cell("train-dp4", "bfloat16", TRAIN_LIMITS), SEEDS[1], fault)
    assert correct == (fault is None), result["numbers"]
    assert result["samples"] == result["calls"] * 4 * 4 * 8


def test_the_first_steps_loss_gap_is_read_apart():
    """``loss_gap`` is the worst of the three steps, ``first_loss_gap`` the
    first step's alone, before any optimizer step."""
    from cnfbench import checks

    leaf = {"w": torch.ones(3)}
    numbers = checks.train_numbers([1.01, 2.0, 3.3], leaf, leaf, [1.0, 2.0, 3.0], leaf, leaf)
    assert numbers["first_loss_gap"] == pytest.approx(0.01)
    assert numbers["loss_gap"] == pytest.approx(0.1)
