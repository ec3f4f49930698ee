"""Multi-scale squeeze / factor-out (port of the JAX ``ops/squeeze.py``).

``squeeze`` is space_to_depth (conv_cINN_make_model.py:179-183): channel
``(dy*2+dx)*D + d`` of output pixel (i, j) is input pixel (2i+dy, 2j+dx)
channel d. ``unsqueeze`` is its exact inverse. ``factor_out`` moves the FIRST
half of the channels into the zy accumulator; ``factor_in`` brings the LAST
``split`` channels of zy back in front of v. All log-det neutral.
"""

from __future__ import annotations

import torch


def squeeze(u, block=2):
    """space_to_depth: (..., H, W, D) -> (..., H/b, W/b, b*b*D)."""
    *lead, h, w, d = u.shape
    b = block
    assert h % b == 0 and w % b == 0, "u must have spatial dims divisible by 2"
    u = u.reshape(*lead, h // b, b, w // b, b, d)
    nl = len(lead)
    perm = tuple(range(nl)) + (nl, nl + 2, nl + 1, nl + 3, nl + 4)
    return u.permute(perm).reshape(*lead, h // b, w // b, b * b * d)


def unsqueeze(v, block=2):
    """depth_to_space: (..., H, W, b*b*D) -> (..., b*H, b*W, D)."""
    *lead, h, w, d4 = v.shape
    b = block
    assert d4 % (b * b) == 0, "channel depth must be divisible by 4"
    d = d4 // (b * b)
    v = v.reshape(*lead, h, w, b, b, d)
    nl = len(lead)
    perm = tuple(range(nl)) + (nl, nl + 2, nl + 1, nl + 3, nl + 4)
    return v.permute(perm).reshape(*lead, b * h, b * w, d)


def factor_out(u, zy):
    """(v, zy_new): v = u[..., D/2:], zy_new = concat([zy, u[..., :D/2]])."""
    split = u.shape[-1] // 2
    factored = u[..., :split]
    v = u[..., split:]
    zy = factored if zy is None else torch.cat([zy, factored], dim=-1)
    return v, zy


def factor_in(v, zy, num_prev_factors):
    """Bring the last ``split`` channels of zy back in front of v.

    ``split`` is v's depth; when v is None (the final all-zy layer) it is
    ``zy_depth // 2**num_prev_factors`` (conv_cINN_make_model.py:316-321).
    """
    split = zy.shape[-1] // (2 ** num_prev_factors) if v is None else v.shape[-1]
    reintegrated = zy[..., -split:]
    zy_rest = zy[..., :-split]  # may be zero-width
    u = reintegrated if v is None else torch.cat([reintegrated, v], dim=-1)
    return u, zy_rest
