"""The program's spans in a traced window, and the device's idle time put
down to them.

The program marks its per-call host work with ``cnf.*`` spans
(``utils/profiling.py::span``), which the profiler records on the clock of
the card's activity. :func:`program_spans` maps each span name in the window
to its host time, its count and the device idle time it holds: each moment
of idle goes to the innermost ``cnf.*`` span the host was in (the harness's
``cnfbench.*`` spans are not the program's), so that the names' ``idle_s``
add up to ``program_idle_s``, the idle under any program span. A program
without spans gives an empty map, and the readers of these keys
(``metrics/program_idle.*``, ``metrics/host_us_per_call.serve``) give None.

The accepted benchmark's record (``trace.py``) does not hold these keys, and
``BENCHMARK.json`` lists none of their metrics. Until it does, a traced run
that reports them is made here:

    python -m cnfbench.spans --workload <cell> --seed <n>

which runs ``run.run_cell`` traced with :func:`reduce` in place of
``trace.reduce`` (in every process of the cell) and prints the result line
with :data:`METRICS` beside the cell's own per-layer metrics, and one
stderr line of rank 0's spans.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
from typing import Dict

from cnfbench import cells, run, trace

PREFIX = "cnf."
#: the per-layer metrics read from these keys, as ``BENCHMARK.json`` would
#: list them
METRICS = [
    {"name": "program_idle.train", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "train step (train/loop.py)", "moves": "train_samples_per_s",
     "workloads": ["flagship-bf16.train"]},
    {"name": "program_idle.dp4", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "train step (train/loop.py)", "moves": "train_samples_per_s.dp4",
     "workloads": ["flagship-bf16.train-dp4"]},
    {"name": "program_idle.serve", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "serving artifact (serve/export.py)", "moves": "serve_samples_per_s",
     "workloads": ["flagship-bf16.serve", "preset-f32.serve"]},
    {"name": "host_us_per_call.serve", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "serving artifact (serve/export.py)",
     "moves": "serve_samples_per_s", "workloads": ["flagship-bf16.serve", "preset-f32.serve"]},
]

_TRACE_REDUCE = trace.reduce
_RUN_RANK = run._rank


def _idle_gaps(events, w0, w1):
    """The device's idle intervals in the window, in time order: the
    complement of the union of its events (as ``trace.reduce`` finds them)."""
    device = sorted((max(s, w0), min(e, w1)) for s, e, _, on_device in events
                    if on_device and e > w0 and s < w1)
    gaps, end = [], w0
    for s, e in device:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def program_spans(events, window) -> dict:
    """``program_spans`` ({name: {host_s, count, idle_s}} of the host's
    ``cnf.*`` events in ``window``) and ``program_idle_s`` (the sum of their
    ``idle_s``) of ``events`` as ``trace.reduce`` takes them."""
    w0, w1 = window
    spans = [(max(s, w0), min(e, w1), n) for s, e, n, on_device in events
             if not on_device and n.startswith(PREFIX) and e > w0 and s < w1]
    gaps = _idle_gaps(events, w0, w1)
    starts = [g0 for g0, _ in gaps]
    before = [0.0]  # idle time before each gap
    for g0, g1 in gaps:
        before.append(before[-1] + g1 - g0)

    def idle_until(t):
        i = bisect.bisect_right(starts, t)
        return before[i] - (max(0.0, gaps[i - 1][1] - t) if i else 0.0)

    out: Dict[str, dict] = {}
    for s, e, n in spans:
        entry = out.setdefault(n, {"host_s": 0.0, "count": 0, "idle_s": 0.0})
        entry["host_s"] += e - s
        entry["count"] += 1
    # sweep the spans' ends and starts; between two marks the idle goes to
    # the innermost open span, the one that started last
    marks = sorted([(s, 1, k) for k, (s, _, _) in enumerate(spans)]
                   + [(e, 0, k) for k, (_, e, _) in enumerate(spans)])
    open_spans, last = set(), w0
    for t, starting, k in marks:
        if open_spans and t > last:
            inner = max(open_spans, key=lambda j: (spans[j][0], -spans[j][1]))
            out[spans[inner][2]]["idle_s"] += idle_until(t) - idle_until(last)
        last = t
        (open_spans.add if starting else open_spans.discard)(k)
    return {"program_spans": out,
            "program_idle_s": sum(v["idle_s"] for v in out.values())}


def reduce(events, window) -> dict:
    """``trace.reduce``'s record with :func:`program_spans`' keys beside
    its own, which read as they do without them."""
    record = _TRACE_REDUCE(events, window)
    record.update(program_spans(events, window))
    return record


def _rank(*args):
    """``run._rank`` with :func:`reduce` in a spawned process."""
    trace.reduce = reduce
    return _RUN_RANK(*args)


@contextlib.contextmanager
def installed():
    """Within the block, traced runs of ``run.run_cell`` hold the program's
    spans in their records, in every process of a cell."""
    saved = trace.reduce, run._rank
    trace.reduce, run._rank = reduce, _rank
    try:
        yield
    finally:
        trace.reduce, run._rank = saved


def line(record) -> str:
    """One line of each span's count, host and idle seconds."""
    spans = record.get("program_spans") or {}
    return "program spans: " + ("; ".join(
        f"{n} count {v['count']} host_s {v['host_s']:.6f} idle_s {v['idle_s']:.6f}"
        for n, v in sorted(spans.items())) or "none") + (
        f"; idle under any {record.get('program_idle_s', 0.0):.6f} s of "
        f"{record['window_s']:.6f}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    cell = cells.load(args.workload)
    cell.per_layer = cell.per_layer + [m for m in METRICS if cell.name in m["workloads"]]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    with installed():
        result = run.run_cell(cell, args.seed, args.seconds, True)
    out = run.result_line(cell, result, True, torch.cuda.get_device_name(0))
    print(line(result["record"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
