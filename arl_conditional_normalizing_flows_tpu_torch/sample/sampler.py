"""Conditional sampling (port of the JAX ``sample/sampler.py``).

Draw z ~ N(0, 1), concatenate the requested condition y', run the inverse
map (TOYcINN.py:438-448 pattern). Toy models take a scalar or vector
condition (:func:`sample_conditional`, :func:`sweep_conditions`); conv
models an image-shaped one, then post-process: split off x, optionally
de-logit (conv_cINN_base_functions.py:287-318) and optionally rebuild the
SR-residual image x + y (conv_cINN.py:44-45).

Every function draws z from the ``generator`` it is given, on the model's
device (a generator on that device); the draws are torch's, not JAX's.

With a ``mesh`` (``parallel/mesh.py``) the fan-out is sharded on the samples
axis, as JAX's ``_jit_sample`` shards it (``sample/sampler.py:43-48``):
every process draws the whole z from an identically seeded generator,
inverts its slice of the samples, and ``all_gather`` puts the slices
together, so every process returns what one process would.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from arl_conditional_normalizing_flows_tpu_torch.ops import logit as logit_ops
from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib


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


def _fan_out(invert, z, y, mesh):
    """``invert(z, y)``; with ``mesh``, of this process's rows, gathered."""
    if mesh is None:
        return invert(z, y)
    rows = mesh_lib.local_batch_slice(z.shape[0], mesh)
    part = invert(z[rows], y[rows]).contiguous()
    group, size, _ = mesh_lib.data_axis(mesh)
    parts = [torch.empty_like(part) for _ in range(size)]
    dist.all_gather(parts, part, group=group)
    return torch.cat(parts)


def sample_conditional(model, y_value, num_samples, x_d, *, generator=None, mesh=None):
    """Toy-style sampling: x | y' for a scalar or (y_d,) vector condition,
    already standardized as the training labels were. Returns xy samples
    (num_samples, x_d + y_d) on the model's device; ``mesh`` shards the
    fan-out."""
    device = model.device
    y_value = torch.atleast_1d(torch.as_tensor(y_value, dtype=torch.float32, device=device))
    z = torch.randn((num_samples, x_d), generator=generator, device=device)
    y = y_value.expand(num_samples, y_value.shape[-1])
    with torch.no_grad():
        return _fan_out(lambda z, y: model.inverse(torch.cat([z, y], dim=-1)), z, y, mesh)


def sweep_conditions(model, y_values, num_samples, x_d, *, generator=None):
    """Class-interpolation sweep: samples for each condition in ``y_values``
    (the reference sweeps y in {-2..2} incl. off-manifold labels,
    TOYcINN.py:1115-1206), in one inverse pass of all of them. Returns
    (len(y_values), num_samples, x_d + y_d)."""
    device = model.device
    y_values = torch.as_tensor(y_values, dtype=torch.float32, device=device)
    if y_values.dim() == 1:
        y_values = y_values[:, None]
    n, y_d = y_values.shape
    z = torch.randn((n, num_samples, x_d), generator=generator, device=device)
    y = y_values[:, None, :].expand(n, num_samples, y_d)
    with torch.no_grad():
        xy = model.inverse(torch.cat([z, y], dim=-1).reshape(n * num_samples, x_d + y_d))
    return xy.reshape(n, num_samples, x_d + y_d)


def sample_conditional_images(model, y_image, num_samples, x_d, *,
                              generator=None, de_logit=False, residual=False,
                              logit_a=0.01, mesh=None):
    """x | y' for an image-shaped condition.

    Args:
        model: a port ``ConvCFlow``; sampling runs on its device.
        y_image: (H, W, y_d) condition plane (a broadcast class plane,
            conv_cINN.py:250-268, or an upsampled low-res image for SR).
        generator: ``torch.Generator`` on the model's device for z.
        mesh: shards the fan-out over its ``data`` axis.
    Returns:
        x images (num_samples, H, W, x_d).
    """
    device = model.device
    y_image = torch.as_tensor(y_image, dtype=torch.float32, device=device)
    h, w, y_d = y_image.shape
    z = torch.randn((num_samples, h, w, x_d), generator=generator, device=device)
    y = y_image.expand(num_samples, h, w, y_d)
    with torch.no_grad():
        xy = _fan_out(model.sample_xy, z, y, mesh)
    return postprocess_sampled_xy(xy, y, x_d, de_logit=de_logit,
                                  residual=residual, logit_a=logit_a)


def conditional_moments(samples, axis=0):
    """Mean/std/skew of a sample batch (population std, as ``jnp.std``)."""
    mean = torch.mean(samples, dim=axis)
    std = torch.std(samples, dim=axis, correction=0)
    c = samples - torch.mean(samples, dim=axis, keepdim=True)
    skew = torch.mean(c**3, dim=axis) / torch.clamp(std**3, min=1e-12)
    return {"mean": mean, "std": std, "skew": skew}
