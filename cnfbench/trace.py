"""The traced window: torch.profiler over a run's calls, reduced to the
record that the per-layer metrics read.

The reduction is a frozen copy of the smoke's ``kernel_breakdown``
(``chip_smoke.py``): the device events straight from the profiler's raw
records (building the event tree takes seconds for a train call's 100,000
kernels), busy time as the union of their intervals, sums by name. Beside
it: the window as the harness's own ``cnfbench.window`` span, each idle
gap of the device named by what the host was doing in its middle (the
innermost host event there), and the collectives (NCCL kernels) in the
order they ran, each with its device time.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Tuple

import torch

WINDOW_SPAN = "cnfbench.window"
TOP = 10
#: the longest gaps are named by the host's activity, the rest summed
NAMED_GAPS = 2000
#: host events looked back at from a gap's middle
SCAN = 4000


def _is_collective(name: str) -> bool:
    return "nccl" in name.lower()


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def _host_at(host, starts, t) -> str:
    """The innermost host event (the latest to start) running at ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - SCAN), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host, outside any op"


def reduce(events, window: Tuple[float, float]) -> dict:
    """The record of device ``events`` (start s, end s, name) and host
    events within ``window`` (start s, end s)."""
    w0, w1 = window
    device = sorted((max(s, w0), min(e, w1), n) for s, e, n, on_device in events
                    if on_device and e > w0 and s < w1)
    host = [(s, e, n) for s, e, n, on_device in events
            if not on_device and n != WINDOW_SPAN and e > w0 and s < w1]
    busy, end, by_name, gaps = 0.0, w0, {}, []
    for s, e, name in device:
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e - s, c + 1)
    if w1 > end:
        gaps.append((end, w1))
    host.sort()
    starts = [s for s, _, _ in host]
    idle: Dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for k, (g0, g1) in enumerate(gaps):
        name = "shorter gaps" if k >= NAMED_GAPS else _host_at(host, starts, 0.5 * (g0 + g1))
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return dict(
        window_s=w1 - w0,
        busy_s=busy,
        kernels=sum(c for n, (_, c) in by_name.items() if _is_kernel(n)),
        by_name={n: [t, c] for n, (t, c) in by_name.items()},
        collectives=[[n, e - s] for s, e, n in device if _is_collective(n)],
        device_ops=[[n, t] for n, (t, _) in ranked[:TOP]],
        idle_gaps=sorted(([n, t] for n, t in idle.items()), key=lambda x: -x[1])[:TOP],
    )


@contextlib.contextmanager
def traced(out: dict):
    """Profile the ``with`` block (the card's and the host's activity; the
    host's alone without a card) and fill ``out`` with :func:`reduce`'s
    record of it. The block runs inside the ``cnfbench.window`` span and
    must end synchronised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield
            sync()
    events: List[tuple] = []
    window = None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e9
        item = (s, s + e.duration_ns() / 1e9, e.name(), e.device_type() == DeviceType.CUDA)
        if e.name() == WINDOW_SPAN and not item[3]:
            window = item[:2]
        elif not (item[3] and e.is_user_annotation()):
            events.append(item)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    out.update(reduce(events, window))
