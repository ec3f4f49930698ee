"""One CUDA graph of a function: the capture that the port's graphed
entries share (``train/loop.py``'s train steps, ``serve/export.py``'s
serving entries)."""

from __future__ import annotations

import torch

from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import affine_coupling, fused_subnet
from arl_conditional_normalizing_flows_tpu_torch.utils.profiling import span


def _launches() -> dict:
    return {**affine_coupling.LAUNCHES, **fused_subnet.LAUNCHES}


def capture(fn, device, *, warmup: int = 1, pool=None, generator=None, before_capture=None):
    """``(graph, output, launches)`` of one ``fn()`` captured on ``device``.

    ``warmup`` eager calls of ``fn()`` run first on a side stream, so that
    every lazy first use (cuDNN's plans, the conv-chain kernel's
    shared-memory attribute, index tables and packed weights, the first load
    of a kernel library) falls outside the capture; then
    ``before_capture()``, when given, and the capture into ``pool`` (a
    private pool when None), with ``generator`` registered so that every
    replay draws anew. ``output`` is the captured call's result, which each
    replay overwrites. ``launches`` maps each hand-written kernel to the
    launches its wrapper counted during the capture: what every replay
    launches (the wrappers count at capture, not in replays).
    """
    with span("cnf.graph.capture"):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        current.wait_stream(side)
        if before_capture is not None:
            before_capture()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = _launches()
        with torch.cuda.graph(graph, pool=pool):
            output = fn()
        launches = {k: v - before[k] for k, v in _launches().items()}
        return graph, output, launches
