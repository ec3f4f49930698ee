"""A train cell: ``make_scan_train_step``'s graphed steps, closed loop, one
call of ``steps_a_call`` steps after another, its loss read after each as
``fit`` reads it; data-parallel when the traffic asks for processes, one a
card, each with its own rows.

Set-up builds the model with the benchmark's weights, its Adam state and
the scan step, captures the step, drives that same object through the
first three steps on rows that all differ (keeping the first gradient as
Adam got it and the parameters after the third) and makes one more call;
the window then drives it. A traced run first makes the traced window's
calls once untraced, timed by the host's clock. After the window the program's state is freed
and the reference follows the three steps in float32 on the same weights
and rows (over all processes' rows at once).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from cnfbench import checks, program, trace as trace_lib, weights
from cnfbench.reference import flow as reference

CHECKED_STEPS = 3
NUM_CLASSES = 10


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _named(model, values):
    """{parameter name: value} for a list in the order of parameters()."""
    return {k: v for (k, _), v in zip(model.named_parameters(), values)}


def _first_steps(model, state, multi, stack, mesh):
    """Drive the step through the first ``CHECKED_STEPS`` batches of
    ``stack``, one at a time: on the card through the graph
    that the window replays (copy the batch into its input, replay, read
    its loss sums), on the CPU through ``make_step_fns``'s step. Returns the
    losses (over all processes' rows), the first gradient as Adam got it
    (its first moment over 1 - b1) and the parameters after the last."""
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib
    from arl_conditional_normalizing_flows_tpu_torch.train.loop import make_step_fns
    from arl_conditional_normalizing_flows_tpu_torch.train.metrics import LOSS_KEYS

    opt = state.optimizer
    b1 = opt.param_groups[0]["betas"][0]
    params = list(model.parameters())
    losses, grad = [], None
    graphed = stack.device.type == "cuda"
    if graphed:
        multi.capture(state, stack)
    else:
        step, _ = make_step_fns(model, mesh=mesh, noise_mode="none")
    for k, xy in enumerate(stack[:CHECKED_STEPS]):
        if graphed:
            multi._acc.zero_()
            multi._xy.copy_(xy)
            multi.graph.replay()
            loss = multi._acc[LOSS_KEYS.index("loss")].clone()
            if mesh is not None:
                mesh_lib.all_reduce_mean(loss, mesh_lib.data_axis(mesh)[0])
        else:
            state, out = step(state, xy)
            loss = out["loss"]
        losses.append(float(loss))
        if k == 0:
            grad = _named(model, [
                opt.state[p]["exp_avg"].detach() / (1 - b1) if "exp_avg" in opt.state.get(p, {})
                else torch.zeros_like(p) for p in params])
    if graphed:
        from torch.autograd.graph import increment_version

        for p in params:
            increment_version(p)
    after = _named(model, [p.detach().clone() for p in params])
    return losses, {k: v.clone() for k, v in grad.items()}, after


def run(cell, seed, seconds, trace, device, start_wall, rank=0, world=1):
    """One process's part of a run; the result holds plain numbers and
    lists (and, on rank 0, the check's numbers)."""
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib
    from arl_conditional_normalizing_flows_tpu_torch.train.loop import (
        create_train_state,
        make_scan_train_step,
    )

    t = cell.traffic
    device = torch.device(device)
    phases = [("start", time.time() - start_wall)]
    s_weights, s_inputs, _, _ = weights.streams(seed)
    rows, steps = t["batch"], t["steps_a_call"]
    mesh = mesh_lib.make_mesh() if world > 1 else None
    model = program.build_model(cell, device)
    phases.append(("model", time.time() - start_wall))
    initial = program.load_weights(model, s_weights, device)
    _sync(device)
    phases.append(("weights", time.time() - start_wall))
    state = create_train_state(model, t["learning_rate"])
    phases.append(("optimizer", time.time() - start_wall))
    multi = make_scan_train_step(model, steps, mesh=mesh, noise_mode=t["noise"])
    every = weights.train_stacks(s_inputs, t["stacks"], steps, rows * world,
                                 cell.model["io_shape"], cell.model["x_d"], NUM_CLASSES, device)
    checked = every[0, :CHECKED_STEPS].clone() if rank == 0 else None
    stacks = every[:, :, rank * rows:(rank + 1) * rows].contiguous()
    del every
    _sync(device)
    phases.append(("step, inputs", time.time() - start_wall))

    losses, grad, after = _first_steps(model, state, multi, stacks[0], mesh)
    phases.append(("capture and the first steps", time.time() - start_wall))
    state, out = multi(state, stacks[1 % len(stacks)])
    float(out["loss"])
    phases.append(("one call", time.time() - start_wall))

    calls = failed = 0
    record = {}
    # every call ends with its loss read, so the window ends synchronised
    window = trace_lib.traced(record) if trace else contextlib.nullcontext()
    limit = t["trace_calls"] if trace else None
    stop = torch.zeros(1, device=device)
    setup_s = time.time() - start_wall
    untraced_s = None
    if trace:  # the traced window's calls once untraced: what the profiler adds
        u0 = time.perf_counter()
        for k in range(limit):
            state, out = multi(state, stacks[(k + 2) % len(stacks)])
            float(out["loss"])
        untraced_s = time.perf_counter() - u0
    ends = []
    t0 = time.perf_counter()
    with window:
        while True:
            with program.span("cnfbench.call", trace):
                state, out = multi(state, stacks[(calls + 2) % len(stacks)])
            with program.span("cnfbench.read_loss", trace):
                value = float(out["loss"])
            ends.append(time.perf_counter() - t0)
            calls += 1
            failed += not math.isfinite(value)
            done = calls >= limit if trace else time.perf_counter() - t0 >= seconds
            if mesh is not None:  # rank 0's clock ends every process's window
                stop.fill_(float(done))
                torch.distributed.broadcast(stop, src=0)
                done = bool(stop.item())
            if done:
                break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = dict(setup_s=setup_s, calls=calls, failed=failed, window_s=window_s,
                  steps=calls * steps, samples=calls * steps * rows * world,
                  memory_peak_bytes=peak, last_loss=value, phases=phases,
                  call_ends_s=ends)
    if trace:
        record.update(kind="train", config=cell.model, traffic=t, rows=rows,
                      steps=calls * steps, samples=result["samples"], calls=calls,
                      untraced_window_s=untraced_s)
        result["record"] = record
    del multi, state, model, stacks, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        plan = reference.plan_of(cell.model)
        ref_losses, ref_grad, ref_after = reference.train_steps(
            plan, initial, list(checked), t["learning_rate"])
        numbers = checks.train_numbers(
            losses, grad, {k: after[k] - initial[k] for k in initial},
            ref_losses, ref_grad, {k: ref_after[k] - initial[k] for k in initial})
        result["numbers"] = numbers
        result["losses"] = [losses, ref_losses]
    return result
