"""The numbers that decide ``correct``, each worked out from what the timed
path produced and what the plain reference gives for the same inputs.

Training (the first three steps of the object that the window then
drives): ``loss_gap``, the worst step's |program loss - reference loss| /
|reference loss|; ``first_loss_gap``, the same of the first step alone,
which no optimizer step has touched yet (Adam's first step moves every
element by the learning rate times the sign of its gradient, so that the
round-off of an element whose gradient is all but nought moves it a whole
step either way, and the later losses with it); ``grad_gap``, the worst leaf's gap between the norms of
the first gradient as Adam got it (its first moment after one step over
1 - b1) and the reference's, over the larger of that leaf's reference norm
and the median leaf's; ``update_gap``, the same of the parameters' change
over the three steps, without the leaves whose reference gradient is under
a thousandth of the median leaf's (they move under Adam by round-off).

Serving (the answers checked): the program's uint8 pixels against the
reference's unrounded ones, in levels of 1/255. A correct quantisation is
within half a level, so what is beyond half a level is error:
``mean_excess``, its mean over every pixel checked; ``worst_sample_excess``,
the largest mean over one sample's pixels.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's does not count in ``update_gap``
QUIET_LEAF = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             keys: List[str]) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger
    of its reference norm and the median leaf's."""
    p, r = _norms({k: program[k] for k in keys}), _norms({k: reference[k] for k in keys})
    median = statistics.median(r.values())
    return max(abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keys)


def train_numbers(prog_losses, prog_grad, prog_change, ref_losses, ref_grad,
                  ref_change) -> Dict[str, float]:
    keys = sorted(ref_grad)
    grads = _norms(ref_grad)
    median = statistics.median(grads.values())
    moving = [k for k in keys if grads[k] >= QUIET_LEAF * median]
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
              for p, r in zip(prog_losses, ref_losses)]
    return {
        "loss_gap": max(losses),
        "first_loss_gap": losses[0],
        "grad_gap": leaf_gap(prog_grad, ref_grad, keys),
        "update_gap": leaf_gap(prog_change, ref_change, moving),
        "quiet_leaves": float(len(keys) - len(moving)),
    }


def serve_numbers(answers: List[torch.Tensor], references: List[torch.Tensor]) -> Dict[str, float]:
    """``answers`` the program's uint8 (draws, B, H, W, x_d), ``references``
    the reference's unrounded pixels in [0, 255] of the same shape."""
    total, count, worst = 0.0, 0, 0.0
    for got, want in zip(answers, references):
        excess = ((got.float() - want).abs() - 0.5).clamp_min(0.0)
        per_sample = excess.flatten(2).mean(dim=-1)
        total += float(excess.double().sum())
        count += excess.numel()
        worst = max(worst, float(per_sample.max()))
    return {"mean_excess": total / count, "worst_sample_excess": worst}
