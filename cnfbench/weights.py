"""Weights and inputs made from ``--seed``, on the card, in a few large
calls. The program and the reference get the same tensors."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

#: a kernel's draws are scaled to KERNEL_GAIN / sqrt(fan-in) (a head's to
#: HEAD_GAIN / sqrt(fan-in)), a bias's to BIAS_SCALE (a head's to
#: HEAD_BIAS_SCALE), and the A heads' learned scale is 1 + HEAD_SCALE_SPREAD
#: times a draw. Heads of order 0.3-1 whose sensitivity to their input stays
#: low, and whose biases are small: the inverse pass through 16 couplings
#: then amplifies a rounding error some tenfold, alike from seed to seed. At
#: a gain of 1 everywhere float32's round-off alone moved pixels by levels
#: (random weights of that scale make the map chaotic), and larger head
#: biases push every pixel's exp(-a) one way, so that some seeds amplify
#: ten times what others do.
KERNEL_GAIN = 0.5
HEAD_GAIN = 0.5
BIAS_SCALE = 0.3
HEAD_BIAS_SCALE = 0.05
HEAD_SCALE_SPREAD = 0.1
#: a row's pixels are u ** k, u uniform, k log-uniform in this range
INK = (1.0, 8.0)
LOGIT_A = 0.01


def streams(seed: int, n: int = 4) -> Tuple[int, ...]:
    """``n`` independent 63-bit seeds from ``seed`` (any whole number):
    weights, inputs, the calls' seeds, the sample of answers checked."""
    words = np.random.SeedSequence(abs(int(seed)), spawn_key=(int(seed < 0),)).generate_state(
        n, dtype=np.uint64)
    return tuple(int(w) >> 1 for w in words)


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """One float32 tensor a name: ``randn`` from a generator on ``device``
    seeded with ``seed``, in one draw for all of them, scaled by kind: a
    kernel (O, I, kh, kw) to ``KERNEL_GAIN`` (``HEAD_GAIN`` in a ``head``)
    over sqrt(I kh kw), a bias to ``BIAS_SCALE`` (``HEAD_BIAS_SCALE``), a
    0-d scale to 1 + ``HEAD_SCALE_SPREAD`` times its draw."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    scale, shift = [], []
    for k in names:
        shape = shapes[k]
        if len(shape) == 4:
            gain = HEAD_GAIN if ".head." in k else KERNEL_GAIN
            scale.append(gain / math.sqrt(math.prod(shape[1:])))
            shift.append(0.0)
        elif len(shape) == 0:
            scale.append(HEAD_SCALE_SPREAD)
            shift.append(1.0)
        else:
            scale.append(HEAD_BIAS_SCALE if ".head." in k else BIAS_SCALE)
            shift.append(0.0)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    flat = (flat * torch.repeat_interleave(torch.tensor(scale, device=device), counts)
            + torch.repeat_interleave(torch.tensor(shift, device=device), counts))
    return {k: t.view(shapes[k]) for k, t in zip(names, flat.split(sizes))}


def logitify(p, a=LOGIT_A):
    """Pixels in [0, 1] to cnf-conv's preprocessed values: the fudged logit
    rescaled to [0, 1] (conv_cINN_base_functions.py:174-231)."""
    b = (1.0 - 2.0 * a) / (1.0 - a)
    lo = math.log(a / (1.0 - a))
    q = a + (1.0 - a) * b * p
    return (torch.log(q / (1.0 - q)) - lo) / (-2.0 * lo)


def class_planes(labels, num_classes, h, w):
    """(n, h, w, 1) planes of the class labels rescaled to [0, 1]
    (conv_cINN.py:222-228)."""
    values = labels.float() / (num_classes - 1)
    return values.view(-1, 1, 1, 1).expand(-1, h, w, 1)


def train_stacks(seed: int, count: int, steps: int, rows: int, io_shape, x_d: int,
                 num_classes: int, device) -> torch.Tensor:
    """(count, steps, rows, H, W, x_d + 1) class-conditional batches, every
    row its own: x the preprocessed value of pixels u ** k (u uniform, k
    log-uniform in ``INK``: faint to dark digits), y' a class plane. Within
    a batch the rows run by class, lowest first: the mean over the batch is
    the same in any order, while a half left out moves it."""
    h, w, d = io_shape
    g = torch.Generator(device=device).manual_seed(seed)
    n = count * steps * rows
    lo, hi = math.log(INK[0]), math.log(INK[1])
    ink = torch.exp(lo + (hi - lo) * torch.rand((n, 1, 1, 1), generator=g, device=device))
    pixels = torch.rand((n, h, w, x_d), generator=g, device=device) ** ink
    labels = torch.randint(0, num_classes, (count * steps, rows), generator=g, device=device)
    labels = labels.sort(dim=1).values.reshape(n)
    xy = torch.cat([logitify(pixels), class_planes(labels, num_classes, h, w)], dim=-1)
    return xy.view(count, steps, rows, h, w, d).contiguous()


def condition_sets(seed: int, count: int, rows: int, io_shape, num_classes: int,
                   device) -> torch.Tensor:
    """(count, rows, H, W, 1) class planes, the labels drawn from ``seed``."""
    h, w, _ = io_shape
    g = torch.Generator(device=device).manual_seed(seed)
    labels = torch.randint(0, num_classes, (count * rows,), generator=g, device=device)
    return class_planes(labels, num_classes, h, w).reshape(count, rows, h, w, 1).contiguous()
