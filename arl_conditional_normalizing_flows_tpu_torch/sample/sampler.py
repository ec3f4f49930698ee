"""Conditional sampling of conv models (port of the JAX ``sample/sampler.py``
image path).

Draw z ~ N(0, 1), concatenate the requested condition plane y', run the
inverse map (TOYcINN.py:438-448 pattern), then post-process: split off x,
optionally de-logit (conv_cINN_base_functions.py:287-318) and optionally
rebuild the SR-residual image x + y (conv_cINN.py:44-45).
"""

from __future__ import annotations

import torch

from arl_conditional_normalizing_flows_tpu_torch.ops import logit as logit_ops


def postprocess_sampled_xy(xy, y, x_d, *, de_logit=False, residual=False,
                           logit_a=0.01):
    """x from a sampled xy (..., H, W, x_d + y_d), shared by local sampling
    and the serving function. With ``residual``, a condition narrower than
    x falls back to the model's own mapped y channels."""
    x = xy[..., :x_d]
    y_out = xy[..., x_d:]
    if de_logit:
        x = logit_ops.de_logitify(x, logit_a)
    if residual:
        x = x + y[..., :x_d] if y.shape[-1] >= x_d else x + y_out
    return x


def sample_conditional_images(model, y_image, num_samples, x_d, *,
                              generator=None, de_logit=False, residual=False,
                              logit_a=0.01):
    """x | y' for an image-shaped condition.

    Args:
        model: a port ``ConvCFlow``; sampling runs on its device.
        y_image: (H, W, y_d) condition plane (a broadcast class plane,
            conv_cINN.py:250-268, or an upsampled low-res image for SR).
        generator: ``torch.Generator`` on the model's device for z.
    Returns:
        x images (num_samples, H, W, x_d).
    """
    device = model.device
    y_image = torch.as_tensor(y_image, dtype=torch.float32, device=device)
    h, w, y_d = y_image.shape
    z = torch.randn((num_samples, h, w, x_d), generator=generator, device=device)
    y = y_image.expand(num_samples, h, w, y_d)
    with torch.no_grad():
        xy = model.sample_xy(z, y)
    return postprocess_sampled_xy(xy, y, x_d, de_logit=de_logit,
                                  residual=residual, logit_a=logit_a)


def conditional_moments(samples, axis=0):
    """Mean/std/skew of a sample batch (population std, as ``jnp.std``)."""
    mean = torch.mean(samples, dim=axis)
    std = torch.std(samples, dim=axis, correction=0)
    c = samples - torch.mean(samples, dim=axis, keepdim=True)
    skew = torch.mean(c**3, dim=axis) / torch.clamp(std**3, min=1e-12)
    return {"mean": mean, "std": std, "skew": skew}
