"""Instance noise (annealing and the permanent noise floor) and noise renewal
(port of the JAX ``ops/noise.py``).

Two variants, as in the reference:

- conv: ``alpha*xy + (1-alpha)*N(0,1)`` over the WHOLE xy tensor
  (conv_cINN_base_functions.py:635-654), for the annealing ramp (alpha 0 -> 1)
  and the permanent 2% noise floor (alpha=0.98, conv_cINN.py:307-315);
- toy: noise on the x components only, y untouched
  (TOYcINN_make_datasets.py:1324-1329).

``renew_noise`` is a fresh N(0,1) batch for noise pre-training
(conv_cINN_base_functions.py:661-675).

Every function takes a ``torch.Generator`` where JAX takes a key; the
generator lies on the device of the tensors it draws. Its state advances with
each draw, so "fresh noise every epoch" needs no key splitting. ``alpha`` may
be a Python float or a 0-d tensor on the tensor's device (as a captured CUDA
graph reads it).
"""

from __future__ import annotations

import numpy as np
import torch


def instance_noise(generator, xy, alpha):
    """alpha*xy + (1-alpha)*N(0,1) over the full tensor (conv variant)."""
    eps = torch.randn(xy.shape, generator=generator, dtype=xy.dtype, device=xy.device)
    return alpha * xy + (1.0 - alpha) * eps


def instance_noise_x_only(generator, xy, alpha, x_d):
    """Noise only the leading ``x_d`` feature dims; y untouched (toy variant).
    ``xy`` is (..., D) with x in [..., :x_d] and y' in [..., x_d:]."""
    # x_d=None would make BOTH slices the full tensor and silently double the
    # feature width
    assert x_d is not None and 0 < x_d < xy.shape[-1], (
        f"instance_noise_x_only needs 0 < x_d < {xy.shape[-1]}, got {x_d}"
    )
    x, y = xy[..., :x_d], xy[..., x_d:]
    eps = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return torch.cat([alpha * x + (1.0 - alpha) * eps, y], dim=-1)


def renew_noise(generator, shape, dtype=torch.float32):
    """A fresh standard-normal draw on the generator's device (noise
    pre-training data source)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device)


def annealing_alphas(num_annealing_epochs):
    """The reference's annealing schedule alpha_i = i / N for epoch i in
    [0, N) (TOYcINN.py:249-287, conv_cINN.py:589-628)."""
    return np.arange(num_annealing_epochs) / float(num_annealing_epochs)
