"""Tracing and profiling utilities (port of the JAX ``utils/profiling.py``).

The reference has no performance instrumentation (conv_cINN_make_model.py:50-52
only comments out ``@tf.function``). Here: ``torch.profiler`` traces written
as Chrome traces (open in Perfetto or ``chrome://tracing``), the program's
named spans on its per-call host paths, and a light step timer with
wall-time percentiles.

A span is recorded only while a profiler records: it then lands in the
profiler's trace beside the card's activity, on the same clock. Otherwise it
costs a check of the profiler's state.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, List, Optional

import torch


#: what :func:`span` returns while no profiler records
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named region of the program in the profiler's trace: a
    ``record_function`` while a profiler records, else one shared no-op
    context (an idle ``record_function`` costs about ten microseconds a
    call). The program's names start with ``cnf.``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block's host and, with a card, device activity; on exit
    write the Chrome trace ``logdir/trace.json``. Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sum the events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class step_timer:
    """Collects per-step wall times; ``summary()`` gives mean/p50/p95. Time
    a step on the card only after a ``torch.cuda.synchronize()`` inside the
    block: its launches return before the card has run them."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            "n": len(ts),
            "mean_s": statistics.fmean(ts),
            "p50_s": ts[len(ts) // 2],
            # nearest-rank p95: ceil(0.95*n) - 1 (int(n*0.95) is one rank
            # high and returns the MAX for n <= 20)
            "p95_s": ts[max(0, -(-len(ts) * 95 // 100) - 1)],
            "total_s": sum(ts),
        }
