"""The program's model with the benchmark's weights, and the harness's
profiler spans around its calls into the program. The cells drive the
program through its public entries: ``train/loop.py``'s scan step,
``serve/export.py``'s seeded artifact, ``parallel/launch.py``'s processes."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from cnfbench import weights as weights_lib


def build_model(cell, device):
    """The configuration's ``ConvCFlow`` on ``device`` under the traffic's
    lowering (with its own initial weights, which ``load_weights``
    replaces)."""
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.model.items()}
    cfg = ConvFlowConfig(**fields, experimental_lowering=cell.traffic["lowering"])
    return ConvCFlow(cfg, device=device)


@torch.no_grad()
def load_weights(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """Draw the weights from ``seed`` on ``device`` and copy them into the
    model's parameters; returns them (the reference's copy)."""
    params = dict(model.named_parameters())
    made = weights_lib.make_weights({k: tuple(p.shape) for k, p in params.items()}, seed, device)
    for k, p in params.items():
        p.copy_(made[k])
    return made


def span(name: str, on: bool):
    """A profiler span ``name`` around the harness's calls into the
    program, when tracing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)
