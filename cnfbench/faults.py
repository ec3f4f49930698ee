"""Faults planted under the timed path, for the checks that ``correct``
fails when the program does: the tests on the CPU and ``calibrate.py`` on
the card read them. The benchmark's own runs plant none.

Each fault patches the program in this process; ``plant(name)`` applies
one by name and returns the function that takes it out again.
"""

from __future__ import annotations

import torch


def _state_unchanged(patch):
    """Every optimizer step puts the parameters and its own state back as
    they were before it (a fresh state back to zeros), inside a captured
    step too."""
    original = torch.optim.Adam.step

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        saved = [(p.detach().clone(), {k: v.clone() for k, v in self.state.get(p, {}).items()
                                       if torch.is_tensor(v)}) for p in params]
        original(self)
        for p, (value, st) in zip(params, saved):
            p.copy_(value)
            for k, v in self.state[p].items():
                if torch.is_tensor(v):
                    v.copy_(st[k]) if k in st else v.zero_()

    patch(torch.optim.Adam, "step", step)


def _half_batch(patch):
    """The loss is the mean over the first half of the rows only."""
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow

    original = ConvCFlow.log_loss
    patch(ConvCFlow, "log_loss", lambda self, xy: original(self, xy[: xy.shape[0] // 2]))


def _no_exchange(patch):
    """The gradients are not averaged across processes."""
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh

    patch(mesh, "all_reduce_gradients", lambda params, group=None: None)


def _half_answers(patch):
    """The inverse pass computes the first half of the rows and hands them
    out again for the second half."""
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow

    original = ConvCFlow.inverse

    def inverse(self, zy):
        half = original(self, zy[: zy.shape[0] // 2])
        return torch.cat([half, half[: zy.shape[0] - half.shape[0]]])

    patch(ConvCFlow, "inverse", inverse)


def _altered_answer(patch):
    """The first sample of every answer comes out inverted (255 - x)."""
    from arl_conditional_normalizing_flows_tpu_torch.serve import export

    original = export.ImageServingFn.__call__

    @torch.inference_mode()
    def call(self, z, y):
        x = original(self, z, y)
        x[0] = 255 - x[0]
        return x

    patch(export.ImageServingFn, "__call__", call)


FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_batch": _half_batch,
    "no_exchange": _no_exchange,
    "half_answers": _half_answers,
    "altered_answer": _altered_answer,
}
#: the faults each kind of cell can have
KIND_FAULTS = {
    "train": ("state_unchanged", "half_batch"),
    "train_multi": ("state_unchanged", "half_batch", "no_exchange"),
    "serve": ("half_answers", "altered_answer"),
}


def plant(name: str):
    """Apply the fault ``name``; returns a function that takes it out."""
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    FAULTS[name](patch)

    def undo():
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)

    return undo
