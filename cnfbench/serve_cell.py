"""A serve cell: one client in a closed loop, each call the seeded multidraw
artifact's ``call(seed, y)`` (``draws`` latents for each of ``batch``
condition planes, inverted, de-logited, uint8) with a new seed a call, its
result synchronised before the next is issued.

Set-up builds the model with the benchmark's weights, exports the artifact
and makes two calls, which capture the one shape the traffic uses. A
traced run first makes the traced window's calls once untraced, timed by
the host's clock. A call's
latency runs from CUDA events recorded at its issue and after its result.
A sample of the window's answers, drawn from the seed (a reservoir), is
kept; after the window the program's state is freed and the reference
computes each kept answer again from its seed and conditions.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time

import numpy as np
import torch

from cnfbench import checks, program, trace as trace_lib, weights
from cnfbench.reference import flow as reference

NUM_CLASSES = 10


class _Clock:
    """A call's latency in milliseconds: CUDA events on the card, the host's
    clock around a synchronous call on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.begin.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.begin.elapsed_time(self.end)
        return (time.perf_counter() - self.t) * 1e3


def run(cell, seed, seconds, trace, device, start_wall):
    from arl_conditional_normalizing_flows_tpu_torch.serve.export import (
        export_seeded_multidraw_sampler,
        make_image_serving_fn,
    )

    t = cell.traffic
    device = torch.device(device)
    phases = [("start", time.time() - start_wall)]
    s_weights, s_inputs, s_calls, s_pick = weights.streams(seed)
    h, w, _ = cell.model["io_shape"]
    x_d = cell.model["x_d"]
    model = program.build_model(cell, device)
    made = program.load_weights(model, s_weights, device)
    fn = make_image_serving_fn(model, x_d, de_logit=True, quantize_uint8=True)
    art = export_seeded_multidraw_sampler(fn, t["draws"], (h, w, x_d), (h, w, 1))
    del fn, model
    conditions = weights.condition_sets(s_inputs, t["condition_sets"], t["batch"],
                                        cell.model["io_shape"], NUM_CLASSES, device)
    seeds = np.random.default_rng(s_calls)
    pick = random.Random(s_pick)
    clock = _Clock(device)
    phases.append(("model, weights, artifact", time.time() - start_wall))
    for k in range(2):  # the capture, then a replay
        clock.start()
        art.call(int(seeds.integers(0, 2**62)), conditions[k % len(conditions)])
        clock.stop()
        phases.append(("capture" if k == 0 else "one call", time.time() - start_wall))

    kept, latencies, failed = [], [], 0
    want = (t["draws"], t["batch"], h, w, x_d)
    record = {}
    window = trace_lib.traced(record) if trace else contextlib.nullcontext()
    setup_s = time.time() - start_wall
    untraced_s = None
    if trace:  # the traced window's calls once untraced: what the profiler adds
        u0 = time.perf_counter()
        for k in range(t["trace_calls"]):
            clock.start()
            art.call(int(seeds.integers(0, 2**62)), conditions[k % len(conditions)])
            clock.stop()
        untraced_s = time.perf_counter() - u0
    t0 = time.perf_counter()
    with window:
        while True:
            call_seed, index = int(seeds.integers(0, 2**62)), len(latencies) % len(conditions)
            clock.start()
            with program.span("cnfbench.call", trace):
                out = art.call(call_seed, conditions[index])
            with program.span("cnfbench.wait", trace):
                latencies.append(clock.stop())
            failed += tuple(out.shape) != want or out.dtype != torch.uint8
            # a reservoir of t["checked_calls"] answers, uniform over the window's
            n = len(latencies)
            if len(kept) < t["checked_calls"]:
                kept.append((call_seed, index, out))
            elif (j := pick.randrange(n)) < t["checked_calls"]:
                kept[j] = (call_seed, index, out)
            if (n >= t["trace_calls"]) if trace else (time.perf_counter() - t0 >= seconds):
                break
    window_s = time.perf_counter() - t0
    calls = len(latencies)
    samples_a_call = t["draws"] * t["batch"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = dict(setup_s=setup_s, calls=calls, failed=failed, window_s=window_s,
                  samples=calls * samples_a_call, memory_peak_bytes=peak,
                  latencies_ms=latencies, phases=phases)
    if trace:
        record.update(kind="serve", config=cell.model, traffic=t, rows=samples_a_call,
                      calls=calls, samples=result["samples"], untraced_window_s=untraced_s)
        result["record"] = record
    del art, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    plan = reference.plan_of(cell.model)
    refs = [reference.sample_pixels(plan, made, s, conditions[i], t["draws"])
            for s, i, _ in kept]
    result["numbers"] = checks.serve_numbers([o for _, _, o in kept], refs)
    result["checked_samples"] = len(kept) * samples_a_call
    return result
