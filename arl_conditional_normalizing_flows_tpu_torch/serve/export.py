"""Serving entry for conv models (port of ``make_image_serving_fn`` from the
JAX ``serve/export.py``; the artifact export, multidraw and pipelined
sampler are not ported yet, ROADMAP A.7)."""

from __future__ import annotations

import torch

from arl_conditional_normalizing_flows_tpu_torch.sample.sampler import (
    postprocess_sampled_xy,
)


def make_image_serving_fn(model, x_d: int, *, de_logit: bool = False,
                          residual: bool = False, logit_a: float = 0.01,
                          quantize_uint8: bool = False):
    """``f(z, y) -> x`` for a port ``ConvCFlow``: z (B,H,W,x_d) latent draw,
    y (B,H,W,y_d) condition plane, on the model's device; x (B,H,W,x_d)
    after the same post-processing as local sampling. ``quantize_uint8``
    returns round(clip(x, 0, 1) * 255) as uint8."""

    @torch.inference_mode()
    def fn(z, y):
        xy = model.sample_xy(z, y)
        x = postprocess_sampled_xy(xy, y, x_d, de_logit=de_logit,
                                   residual=residual, logit_a=logit_a)
        if quantize_uint8:
            x = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
        return x

    return fn
