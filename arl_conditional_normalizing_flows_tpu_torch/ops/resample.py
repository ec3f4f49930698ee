"""Image down/up-sampling of the super-resolution pipelines (port of the JAX
``ops/resample.py``).

``down`` is the reference's 2x2 average pool by reshape and mean
(conv_cINN_base_functions.py:106-119); ``up`` is 2x2 nearest-neighbour by
repeat (conv_cINN_base_functions.py:151-157). Both take channel-last tensors
``(..., H, W, D)`` with any leading dims.
"""

from __future__ import annotations


def down(img, factor=2):
    """(..., H, W, D) -> (..., H/f, W/f, D) by block averaging."""
    *lead, h, w, d = img.shape
    f = factor
    if h % f or w % f:
        raise ValueError(f"spatial dims {(h, w)} are not multiples of {f}")
    return img.reshape(*lead, h // f, f, w // f, f, d).mean(dim=(-4, -2))


def up(img, factor=2):
    """(..., H, W, D) -> (..., f*H, f*W, D) by nearest-neighbour repeat."""
    return img.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2)
