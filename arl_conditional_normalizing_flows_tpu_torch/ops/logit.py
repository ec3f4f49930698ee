"""Fudged-logit pixel transform (port of the JAX ``ops/logit.py``).

Forward (conv_cINN_base_functions.py:174-231): x in [0,1] -> logit(a +
(1-a)*b*x), rescaled from [logit(a), logit(1-a)] to [0,1], with
b = (1-2a)/(1-a). Inverse (conv_cINN_base_functions.py:287-318): the exact
algebraic inverse, used to recover pixels from samples. :func:`logitify_np`
is the same forward in numpy, for data prepared on the host.

The constant logit(a) is computed on the CPU and enters as a Python float,
so neither direction copies from the host to the card: both may run inside
a captured CUDA graph (the serving graph de-logits its samples).
"""

from __future__ import annotations

import numpy as np
import torch


def _logit(x):
    return torch.log(x / (1.0 - x))


def _logit_a(x, a) -> float:
    # logit(a) in the wider of x's dtype and float32, as the JAX version;
    # a Python float holds that value exactly
    dt = torch.promote_types(x.dtype, torch.float32)
    return _logit(torch.tensor(a, dtype=dt)).item()


def logitify(x, a=0.01):
    """x in [0,1] -> fudged logit rescaled to [0,1]."""
    b = (1.0 - 2.0 * a) / (1.0 - a)
    lo = _logit_a(x, a)
    hi = -lo  # logit(1-a) = -logit(a)
    z = _logit(a + (1.0 - a) * b * x)
    return (z - lo) / (hi - lo)


def logitify_np(x, a=0.01):
    """Pure-numpy :func:`logitify` for host-side data preparation. Same
    formula, float32 math."""
    x = np.asarray(x, np.float32)
    a = np.float32(a)
    b = (1.0 - 2.0 * a) / (1.0 - a)
    lo = np.float32(np.log(a / (1.0 - a), dtype=np.float32))
    hi = -lo
    arg = (a + (1.0 - a) * b * x).astype(np.float32)
    z = np.log(arg / (1.0 - arg), dtype=np.float32)
    return ((z - lo) / (hi - lo)).astype(np.float32)


def de_logitify(x, a=0.01):
    """Inverse of :func:`logitify`."""
    b = (1.0 - 2.0 * a) / (1.0 - a)
    lo = _logit_a(x, a)
    hi = -lo
    z = x * (hi - lo) + lo
    logistic = 1.0 / (1.0 + torch.exp(-z))
    return (logistic - a) / (b * (1.0 - a))
