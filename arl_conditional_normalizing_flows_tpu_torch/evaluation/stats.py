"""Quantitative evaluation (port of the JAX ``evaluation/stats.py``): the
measurable core of the reference's visual checks (TOYcINN.py:321-1206) and
the parity metrics of BASELINE.md.

The reference checks by eye that forward-mapped data looks N(0,1), that
inverse-mapped prior draws at fixed y reproduce the class manifold, and that
SR residual 2x2 blocks sum to ~0 (conv_cINN.py:44-45); these functions turn
each check into numbers. They take numpy arrays or tensors (on any device)
and compute in numpy on the host, as the JAX functions do.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def bits_per_dim(nll_x_nats: float, num_x_dims: int) -> float:
    """Convert an x-NLL in nats (z term + detJ term) to bits/dim."""
    return float(nll_x_nats) / (math.log(2.0) * num_x_dims)


def latent_normality_stats(z) -> Dict[str, float]:
    """How close the encoded latent is to N(0, I): per-dim mean/std deviation
    and excess kurtosis (TOYcINN.py:340-440 by eye)."""
    z = _np(z)
    z = z.reshape(len(z), -1)
    mean = z.mean(0)
    std = z.std(0)
    c = (z - mean) / np.maximum(std, 1e-12)
    kurt = (c**4).mean(0) - 3.0
    return {
        "mean_abs_mean": float(np.abs(mean).mean()),
        "mean_abs_std_err": float(np.abs(std - 1.0).mean()),
        "mean_abs_excess_kurtosis": float(np.abs(kurt).mean()),
    }


def moment_match_report(samples, reference) -> Dict[str, float]:
    """Max/mean absolute difference between sample and reference moments,
    with the Monte-Carlo standard error for scale (BASELINE.md)."""
    s, r = _np(samples), _np(reference)
    s = s.reshape(len(s), -1)
    r = r.reshape(len(r), -1)
    dm = np.abs(s.mean(0) - r.mean(0))
    ds = np.abs(s.std(0) - r.std(0))
    se = r.std(0) / math.sqrt(len(s))
    return {
        "max_mean_diff": float(dm.max()),
        "mean_mean_diff": float(dm.mean()),
        "max_std_diff": float(ds.max()),
        "mean_std_diff": float(ds.mean()),
        "mc_standard_error": float(se.mean()),
    }


def y_identity_error(xy_sampled, y_requested, x_d: int) -> Dict[str, float]:
    """|f_Y^-1 output y - requested y'|, the identity the lambda_y loss
    enforces (TOYcINN_make_model.py:142-143)."""
    y = _np(xy_sampled)[..., x_d:]
    yr = np.broadcast_to(_np(y_requested), y.shape)
    err = np.abs(y - yr)
    return {"mean_abs": float(err.mean()), "max_abs": float(err.max())}


def sr_residual_block_sums(x_residual) -> Dict[str, float]:
    """2x2 block sums of an SR residual, ~0 by construction
    (conv_cINN.py:44-45)."""
    x = _np(x_residual)
    b, h, w, d = x.shape
    blocks = x.reshape(b, h // 2, 2, w // 2, 2, d).sum(axis=(2, 4))
    return {
        "mean_abs_block_sum": float(np.abs(blocks).mean()),
        "max_abs_block_sum": float(np.abs(blocks).max()),
    }


def sector_fidelity(samples_xy, center: float, sector_width: float,
                    x_d: int = 2) -> Dict[str, float]:
    """Conditional fidelity for one sector of the continuous-sectors task
    (TOYcINN_make_datasets.py:1114-1300): circular angular error against the
    requested center, the fraction inside the requested sector, and the
    fraction inside the (slightly padded) unit disk."""
    s = _np(samples_xy)
    ang = np.arctan2(s[:, 1], s[:, 0]) % (2 * np.pi)
    err = np.abs(((ang - center + np.pi) % (2 * np.pi)) - np.pi)
    radius = np.hypot(s[:, 0], s[:, 1])
    out = {
        "mean_abs_angular_error": float(err.mean()),
        "frac_in_sector": float((err <= sector_width / 2).mean()),
        "frac_in_unit_disk": float((radius <= 1.05).mean()),
    }
    if s.shape[1] > x_d:
        out["y_identity_mean"] = float(s[:, x_d:].mean())
    return out
