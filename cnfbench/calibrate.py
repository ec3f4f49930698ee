"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card:

- the program's numbers over many seeds (sound runs, a short window each);
- the control's: the plain reference put in the program's place at the
  precision below the configuration's (float8 e4m3 for bfloat16 subnets,
  TF32 for float32), against the float32 reference, at the cell's own size
  (the same three steps, or as many answers as a run checks);
- each fault that the cell can have (``faults.py``), planted under the
  timed path of a run;
- the program's own lower-precision path where the configuration has one:
  a bfloat16 configuration's flow and coupling law in bfloat16
  (``flow_in_compute_dtype``) where it states them in float32.

    python -m cnfbench.calibrate --workload <cell> --seeds <n>... \\
        [--control-seeds <n>...] [--fault-seeds <n>...] \\
        [--program-control-seeds <n>...] [--seconds 2] [--out file]

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from cnfbench import cells, checks, faults, program, run, serve_cell, train_cell, weights
from cnfbench.reference import flow as reference

LOWER = {"bfloat16": "fp8", "float32": "tf32"}


def control(cell, seed, device) -> dict:
    """The control's numbers for ``seed``: what a run would compare, with
    the reference at the lower precision standing for the program."""
    t = cell.traffic
    s_weights, s_inputs, s_calls, _ = weights.streams(seed)
    model = program.build_model(cell, device)
    made = program.load_weights(model, s_weights, device)
    del model
    plan = reference.plan_of(cell.model)
    low = LOWER[cell.model["compute_dtype"]]
    if t["kind"] == "train":
        rows = t["batch"] * int(t.get("processes", 1))
        batches = weights.train_stacks(s_inputs, t["stacks"], t["steps_a_call"], rows,
                                       cell.model["io_shape"], cell.model["x_d"],
                                       train_cell.NUM_CLASSES, device)[0, :train_cell.CHECKED_STEPS]
        ref = reference.train_steps(plan, made, list(batches), t["learning_rate"])
        got = reference.train_steps(plan, made, list(batches), t["learning_rate"], low)
        return checks.train_numbers(
            got[0], got[1], {k: got[2][k] - made[k] for k in made},
            ref[0], ref[1], {k: ref[2][k] - made[k] for k in made})
    conditions = weights.condition_sets(s_inputs, t["condition_sets"], t["batch"],
                                        cell.model["io_shape"], serve_cell.NUM_CLASSES, device)
    seeds = np.random.default_rng(s_calls)
    answers, refs = [], []
    for k in range(t["checked_calls"]):
        s, y = int(seeds.integers(0, 2**62)), conditions[k % len(conditions)]
        refs.append(reference.sample_pixels(plan, made, s, y, t["draws"]))
        answers.append(torch.round(reference.sample_pixels(plan, made, s, y, t["draws"], low))
                       .to(torch.uint8))
    return checks.serve_numbers(answers, refs)


def program_control(cell):
    """``cell`` with the program's own lower-precision path on: the flow in
    the subnets' bfloat16. ``pallas_subnet`` refuses that mode, so a serve
    cell's runs on the default lowering, the same math on cuDNN's convs."""
    if cell.model["compute_dtype"] != "bfloat16" or int(cell.traffic.get("processes", 1)) > 1:
        raise ValueError(f"{cell.name} has no lower-precision path of the program read here")
    traffic = dict(cell.traffic)
    if traffic["lowering"] == "pallas_subnet":
        traffic["lowering"] = None
    model = dict(cell.model, flow_in_compute_dtype=True)
    return dataclasses.replace(cell, config=dict(cell.config, model=model), traffic=traffic)


def _program_and_faults(cell, seeds, fault_names, fault_seeds, seconds, device, rank=0,
                        world=1):
    """The program's numbers for each seed, then for each fault and fault
    seed, in this process (one of ``world`` in a group)."""
    def once(seed):
        if world > 1:
            return train_cell.run(cell, seed, seconds, False, device, time.time(), rank, world)
        return run.run_cell(cell, seed, seconds, False, device, start_wall=time.time())

    out = {"program": [], "faults": {}}
    for seed in seeds:
        t0 = time.time()
        r = once(seed)
        out["program"].append(dict(seed=seed, numbers=r.get("numbers"), losses=r.get("losses"),
                                   calls=r["calls"],
                                   failed=r["failed"], rate=r["samples"] / r["window_s"],
                                   setup_s=r["setup_s"], wall_s=time.time() - t0))
        print(f"program {seed}: {r.get('numbers')}", file=sys.stderr, flush=True)
    for name in fault_names:
        out["faults"][name] = []
        undo = faults.plant(name)
        try:
            for seed in fault_seeds:
                r = once(seed)
                out["faults"][name].append(dict(seed=seed, numbers=r.get("numbers")))
                print(f"fault {name} {seed}: {r.get('numbers')}", file=sys.stderr, flush=True)
        finally:
            undo()
    return out


def _rank(rank, world, cell, seeds, fault_names, fault_seeds, seconds, device_type):
    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    return _program_and_faults(cell, seeds, fault_names, fault_seeds, seconds, device, rank,
                               world)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--program-control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    cell = cells.load(args.workload)
    device = "cuda"
    out = {"workload": cell.name, "card": run.power_limit(), "program": [], "control": [],
           "faults": {}, "program_control": []}

    def emit():
        text = json.dumps(out)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        print(text, flush=True)

    kind = cell.traffic["kind"]
    world = int(cell.traffic.get("processes", 1))
    names = faults.KIND_FAULTS["train_multi" if world > 1 else kind] if args.fault_seeds else ()
    if world > 1:
        from arl_conditional_normalizing_flows_tpu_torch.parallel.launch import run_ranks

        fd, init_file = tempfile.mkstemp(prefix="cnfbench-calibrate-", suffix=".init")
        os.close(fd)
        os.remove(init_file)
        got = run_ranks(importlib.import_module("cnfbench.calibrate")._rank, world, "nccl",
                        init_file,
                        args=(cell, args.seeds, names, args.fault_seeds, args.seconds, "cuda"),
                        device_type="cuda", timeout=3000)[0]
    else:
        got = _program_and_faults(cell, args.seeds, names, args.fault_seeds, args.seconds,
                                  device)
    out.update(got)
    for seed in args.control_seeds:
        t0 = time.time()
        numbers = control(cell, seed, torch.device(device))
        out["control"].append(dict(seed=seed, numbers=numbers, wall_s=time.time() - t0))
        print(f"control {seed}: {numbers}", file=sys.stderr, flush=True)
    for seed in args.program_control_seeds:
        r = run.run_cell(program_control(cell), seed, args.seconds, False, device,
                         start_wall=time.time())
        out["program_control"].append(dict(seed=seed, numbers=r["numbers"], calls=r["calls"]))
        print(f"program control {seed}: {r['numbers']}", file=sys.stderr, flush=True)
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
