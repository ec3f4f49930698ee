"""The program's spans in the traced record (``spans.py``): each moment of
the device's idle goes to the innermost ``cnf.*`` span, never to a
harness's ``cnfbench.*`` span; the record's other keys read as
``trace.reduce`` gives them; the new readers read a traced run of the small
CPU cells and give None for a record without the program's spans."""

import time

import pytest

from cnfbench import cells, run, spans, trace
from cnfbench.tests.small import small_cell

WINDOW = (0.0, 10.0)
EVENTS = [
    # the card: busy 0-1, 3-4, 8-9; idle 1-3, 4-8, 9-10
    (0.0, 1.0, "kernel_a", True), (3.0, 4.0, "kernel_b", True), (8.0, 9.0, "kernel_a", True),
    # the host: the harness's span, the program's nested spans, an op
    (0.5, 9.5, "cnfbench.call", False),
    (0.5, 6.0, "cnf.serve.call", False),
    (2.0, 2.5, "cnf.serve.replay", False),
    (5.0, 6.0, "cnf.serve.copy_out", False),
    (5.2, 5.4, "aten::clone", False),
    (-1.0, 0.2, "cnf.train.key", False),  # begins before the window
    (11.0, 12.0, "cnf.serve.call", False),  # after it
]


def test_idle_goes_to_the_innermost_program_span():
    got = spans.program_spans(EVENTS, WINDOW)
    by_name = got["program_spans"]
    assert set(by_name) == {"cnf.serve.call", "cnf.serve.replay", "cnf.serve.copy_out",
                            "cnf.train.key"}
    # the call's idle in 1-3 and 4-6, less its children's 2-2.5 and 5-6
    assert by_name["cnf.serve.call"] == pytest.approx(
        {"host_s": 5.5, "count": 1, "idle_s": 2.5})
    assert by_name["cnf.serve.replay"] == pytest.approx({"host_s": 0.5, "count": 1, "idle_s": 0.5})
    assert by_name["cnf.serve.copy_out"] == pytest.approx(
        {"host_s": 1.0, "count": 1, "idle_s": 1.0})
    assert by_name["cnf.train.key"] == pytest.approx({"host_s": 0.2, "count": 1, "idle_s": 0.0})
    # 7 s idle in all; 6-8 and 9-10 lie under the harness's span alone
    assert got["program_idle_s"] == pytest.approx(4.0)


def test_the_record_keeps_trace_reduce_s_keys_as_they_were():
    record = spans.reduce(EVENTS, WINDOW)
    old = trace.reduce(EVENTS, WINDOW)
    assert set(record) == set(old) | {"program_spans", "program_idle_s"}
    assert {k: record[k] for k in old} == old
    # without the program's spans: an empty map, which every new reader skips
    plain = [e for e in EVENTS if not e[2].startswith("cnf.")]
    assert spans.program_spans(plain, WINDOW) == {"program_spans": {}, "program_idle_s": 0.0}


def test_installed_puts_back_what_it_replaced():
    before = trace.reduce, run._rank
    with spans.installed():
        assert trace.reduce is spans.reduce and run._rank is spans._rank
    assert (trace.reduce, run._rank) == before


@pytest.mark.parametrize("traffic", ["train", "serve", "train-dp4"])
def test_a_traced_small_run_holds_the_program_s_spans(traffic):
    cell = small_cell(traffic, "bfloat16", trace_calls=2)
    with spans.installed():
        result = run.run_cell(cell, 2**31 + 7, 0.1, True, device="cpu", start_wall=time.time())
    record = result["record"]
    by_name = record["program_spans"]
    if traffic == "serve":
        assert by_name["cnf.serve.call"]["count"] == by_name["cnf.serve.args"]["count"] == 2
        names = ("program_idle.serve", "host_us_per_call.serve")
    else:  # the CPU's scan step: one span a call
        assert by_name["cnf.train.call"]["count"] == 2
        names = ("program_idle.train", "program_idle.dp4")
    assert "cnf.graph.capture" not in by_name and "cnf.kernels.build" not in by_name
    # no card: the whole window is idle, so each span's idle is its own time
    # less its children's
    assert record["program_idle_s"] == pytest.approx(sum(
        v["idle_s"] for v in by_name.values()))
    assert 0 < record["program_idle_s"] <= record["window_s"]
    for name in names:
        value = cells.reader(name)(record)
        assert value is not None and value > 0, name
    print(spans.line(record))
    # the record of a run without them (the accepted benchmark's) reads None
    for name in names:
        no_spans = {k: v for k, v in record.items()
                    if k not in ("program_spans", "program_idle_s")}
        assert cells.reader(name)(no_spans) is None
        assert cells.reader(name)(dict(no_spans, program_spans={}, program_idle_s=0.0)) is None


def test_the_metrics_keep_to_the_benchmark_s_contract():
    bench = cells.benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]}
    taken = {m["name"] for m in bench["per_layer"]}
    cell_names = {w["name"] for w in bench["workloads"]}
    keys = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in spans.METRICS:
        assert set(m) == keys and m["name"] not in taken and m["moves"] in e2e
        assert set(m["workloads"]) <= cell_names and callable(cells.reader(m["name"]))
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in cells.load(w).end_to_end}
