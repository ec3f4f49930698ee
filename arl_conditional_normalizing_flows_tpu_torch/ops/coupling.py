"""Plain affine coupling laws with a per-sample float32 log-det (port of the
JAX ``ops/coupling.py``, conv_cINN_make_model.py:1215-1253).

Forward ``v2 = exp(a) * u2 + b``, log-det ``sum(a)`` over the non-batch axes,
shape ``(B,)``, always accumulated in float32. Inverse
``u2 = exp(-a) * (v2 - b)``. The law runs in the wider operand dtype.
"""

from __future__ import annotations

import torch


def affine_forward(a, b, u2):
    """(v2, per-sample log-det (B,) float32)."""
    law_dt = torch.promote_types(a.dtype, u2.dtype)
    v2 = torch.exp(a.to(law_dt)) * u2.to(law_dt) + b.to(law_dt)
    delta = a.to(torch.float32).sum(dim=tuple(range(1, a.dim())))
    return v2, delta


def affine_inverse(a, b, v2):
    """u2 = exp(-a) * (v2 - b)."""
    law_dt = torch.promote_types(a.dtype, v2.dtype)
    return torch.exp(-a.to(law_dt)) * (v2.to(law_dt) - b.to(law_dt))
