"""The traced window's record and the per-layer readers: a traced run of
the harness on the CPU at a small size (the profiler sees the host alone)
gives a record that every reader of its kind reads, with the same calls
timed untraced beside it; the NCCL reader takes each collective's least
time over the processes."""

import time

import pytest

from cnfbench import cells, run, trace
from cnfbench.tests.small import small_cell

TRAIN_READERS = ("mfu.train", "mfu.dp4", "kernels_per_step.train", "kernels_per_step.dp4",
                 "device_idle.train", "device_idle.dp4")
SERVE_READERS = ("mfu.serve", "device_idle.serve")


@pytest.mark.parametrize("traffic,readers", [("train", TRAIN_READERS), ("serve", SERVE_READERS),
                                             ("train-dp4", TRAIN_READERS)])
def test_a_traced_run_gives_a_record_its_readers_read(traffic, readers):
    cell = small_cell(traffic, "bfloat16", trace_calls=2)
    result = run.run_cell(cell, 7, 0.1, True, device="cpu", start_wall=time.time())
    record = result["record"]
    assert record["calls"] == 2 and record["untraced_window_s"] > 0
    assert record["window_s"] > 0 and record["busy_s"] == 0  # no card, no device events
    for name in readers:
        value = cells.reader(name)(record)
        assert value is not None and value >= 0, name
    # a reader of another kind of cell finds nothing
    other = TRAIN_READERS if readers is SERVE_READERS else SERVE_READERS
    assert cells.reader(other[0])(record) is None
    if traffic == "train-dp4":
        assert len(record["collectives_by_rank"]) == 4
    assert cells.reader("nccl_us_per_step.dp4")(record) is None  # no NCCL kernels here


def _collectives(*times):
    return [["ncclDevKernel_AllReduce_Sum_f32_RING_LL", t] for t in times]


def test_a_collective_is_its_least_time_over_the_processes():
    read = cells.reader("nccl_us_per_step.dp4")
    record = {"kind": "train", "steps": 2, "collectives_by_rank": [
        _collectives(30e-6, 500e-6), _collectives(400e-6, 40e-6), _collectives(35e-6, 45e-6)]}
    assert read(record) == pytest.approx(1e6 * (30e-6 + 40e-6) / 2)
    # a process whose trace lost a collective: the least process's total
    record["collectives_by_rank"][1] = _collectives(400e-6)
    assert read(record) == pytest.approx(1e6 * (35e-6 + 45e-6) / 2)
    assert read(dict(record, collectives_by_rank=[[], []])) is None
    assert read({"kind": "train", "steps": 2}) is None


def test_the_record_keeps_the_collectives_in_order():
    events = [(0.1, 0.2, "kernel_a", True), (0.3, 0.35, "ncclDevKernel_AllReduce", True),
              (0.5, 0.52, "ncclDevKernel_AllReduce", True), (0.0, 1.0, "host_op", False)]
    record = trace.reduce(events, (0.0, 1.0))
    assert [n for n, _ in record["collectives"]] == ["ncclDevKernel_AllReduce"] * 2
    assert [t for _, t in record["collectives"]] == pytest.approx([0.05, 0.02])
    assert record["busy_s"] == pytest.approx(0.17)
