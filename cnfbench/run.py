"""Run one cell of the benchmark once and print its result line.

    python -m cnfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` profiles a window of the traffic's
``trace_calls`` calls and reports the per-layer metrics. Either way the
timed path's output is checked against the plain reference
(``reference/flow.py``) after the window, and the last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), then ``checks``,
each compared number beside its limit, which are also the last lines of
standard error.

Exit codes: 0 with a result (``correct`` may be false); 3 without a card
or with fewer than the cell asks for; 4 when the process has loaded JAX or
the JAX package; anything else a failure.
"""

from __future__ import annotations

import time

START_WALL = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from cnfbench import cells  # noqa: E402

#: top-level module names that nothing run here may load
FORBIDDEN = ("jax", "jaxlib", "flax", "arl_conditional_normalizing_flows_tpu")
RANKS_TIMEOUT_S = 330.0


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _one(cell, seed, seconds, trace, device, start_wall, rank=0, world=1):
    from cnfbench import serve_cell, train_cell

    if cell.traffic["kind"] == "train":
        return train_cell.run(cell, seed, seconds, trace, device, start_wall, rank, world)
    return serve_cell.run(cell, seed, seconds, trace, device, start_wall)


def _rank(rank, world, cell, seed, seconds, trace, device_type, start_wall, fault):
    """One process of a multi-process cell (``parallel.launch.run_ranks``
    has formed the group and made card ``rank`` the current one)."""
    from cnfbench import faults

    if fault:
        faults.plant(fault)
    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    result = _one(cell, seed, seconds, trace, device, start_wall, rank, world)
    result["forbidden"] = forbidden_modules()
    return result


def run_cell(cell, seed, seconds, trace, device="cuda", start_wall=None, fault=None):
    """The merged result of one run of ``cell``: rank 0's, with the
    set-up, memory and busy time of every process."""
    start_wall = START_WALL if start_wall is None else start_wall
    processes = int(cell.traffic.get("processes", 1))
    if processes == 1:
        from cnfbench import faults

        undo = faults.plant(fault) if fault else (lambda: None)
        try:
            result = _one(cell, seed, seconds, trace, device, start_wall)
        finally:
            undo()
        result["busy_s"] = [result["record"]["busy_s"]] if trace else []
        result["forbidden"] = []
        return result
    from arl_conditional_normalizing_flows_tpu_torch.parallel.launch import run_ranks

    device_type = "cuda" if str(device).startswith("cuda") else "cpu"
    fd, init_file = tempfile.mkstemp(prefix="cnfbench-", suffix=".init")
    os.close(fd)
    os.remove(init_file)
    # by its module's name, which a spawned process imports (not __main__)
    rank_fn = importlib.import_module("cnfbench.run")._rank
    results = run_ranks(rank_fn, processes, "nccl" if device_type == "cuda" else "gloo",
                        init_file, args=(cell, seed, seconds, trace, device_type, start_wall,
                                         fault),
                        device_type=device_type, timeout=RANKS_TIMEOUT_S)
    merged = dict(results[0])
    merged["setup_s"] = max(r["setup_s"] for r in results)
    merged["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in results)
    merged["failed"] = sum(r["failed"] for r in results)
    merged["busy_s"] = [r["record"]["busy_s"] for r in results] if trace else []
    if trace:
        merged["record"] = dict(merged["record"],
                                collectives_by_rank=[r["record"]["collectives"] for r in results])
    merged["forbidden"] = sorted({m for r in results for m in r["forbidden"]})
    return merged


def _percentile(values, q):
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def end_to_end(cell, result) -> dict:
    """The end-to-end metrics that ``cell`` reports, from an untraced run.
    A metric is read by its name up to the first dot: ``train_samples_per_s.dp4``
    is ``train_samples_per_s`` under a bound of its own."""
    values = {
        "setup_s": result["setup_s"],
        "train_samples_per_s": result["samples"] / result["window_s"],
        "serve_samples_per_s": result["samples"] / result["window_s"],
    }
    if result.get("latencies_ms"):
        values["serve_call_p95_ms"] = _percentile(result["latencies_ms"], 95)
    out = {}
    for m in cell.end_to_end:
        base = m["name"].split(".")[0]
        if base not in values:
            raise KeyError(f"the harness has no reading for {m['name']!r} in {cell.name}")
        out[m["name"]] = {"value": values[base], "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def per_layer(cell, result) -> dict:
    """The per-layer metrics that ``cell`` reports, from a traced run's
    record; a reader that finds nothing leaves its metric out."""
    record = result["record"]
    print(f"card: {power_limit()}", file=sys.stderr)
    untraced = record["untraced_window_s"]
    print(f"profiler: {record['calls']} calls take {record['window_s']:.6f} s traced and "
          f"{untraced:.6f} s untraced (+{100 * (record['window_s'] / untraced - 1):.2f}%); "
          f"the card busy {record['busy_s']:.6f} s of the traced window", file=sys.stderr)
    out = {}
    for m in cell.per_layer:
        value = cells.reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compare(cell, result):
    """(correct, checks): each compared number beside its limit."""
    numbers = result["numbers"]
    checks = {k: {"value": numbers[k], "limit": limit} for k, limit in cell.limits.items()}
    within = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return within and result["calls"] > 0 and result["failed"] == 0, checks


def result_line(cell, result, trace, device_kind) -> dict:
    correct, checks = compare(cell, result)
    line = {
        "correct": correct,
        "attempted": result["calls"],
        "failed": result["failed"],
        "metrics": per_layer(cell, result) if trace else end_to_end(cell, result),
        "device": {"platform": "gpu", "kind": device_kind, "count": cell.chips,
                   "memory_peak_bytes": result["memory_peak_bytes"]},
    }
    if trace:
        record = result["record"]
        line["device"]["busy_s"] = sum(result["busy_s"]) / len(result["busy_s"])
        line["device"]["window_s"] = record["window_s"]
        line["breakdown"] = {"device_ops": record["device_ops"],
                             "idle_gaps": record["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = cells.load(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    line = result_line(cell, result, bool(args.trace), torch.cuda.get_device_name(0))
    bad = sorted(set(forbidden_modules()) | set(result["forbidden"]))
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    print("set-up, seconds from the start: " + ", ".join(
        f"{name} {s:.3f}" for name, s in result["phases"]), file=sys.stderr)
    if result.get("call_ends_s"):
        print("calls end at s: " + " ".join(f"{t:.3f}" for t in result["call_ends_s"]),
              file=sys.stderr)
    print(f"window {result['window_s']:.3f} s, {result['calls']} calls; compared: "
          f"{json.dumps(result['numbers'])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
