"""Dense toy conditional INN (port of the JAX ``models/toy.py``; the
reference's TOYcINN_make_model.py:105-506).

The joint input is ``xy = concat([x, y'])`` with ``x_d`` data dims and
``io_shape - x_d`` condition dims. ``forward`` encodes xy' -> zy and
accumulates the PER-SAMPLE log|det J| (TOYcINN_make_model.py:386-387);
``inverse`` decodes zy -> xy' with the closed-form elementwise law, no linear
solve (cf. TOYcINN_make_model.py:373).

Direction convention, as in the JAX package: ``forward`` is the reference's
direction -1 (training), which walks the execution order REVERSED
(TOYcINN_make_model.py:299 ``range(N)[::direction]``); ``inverse`` is
direction +1. Layer ``j`` always uses toy mask ``j % 6`` and coupling ``j``;
the execution order is the (possibly shuffled) permutation in
``cfg.ordered_indices()``, which is part of the model's identity.

The coupling law is the plain one of ``ops/coupling.py``, as in JAX (no
kernel: a toy layer moves 3 features a sample). Each layer's feature index
tensors are built once, as buffers on the model's device, so that a step
makes no host-to-device copy and can be captured as a CUDA graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from arl_conditional_normalizing_flows_tpu_torch.device import resolve_device
from arl_conditional_normalizing_flows_tpu_torch.models.arch import ToyConfig
from arl_conditional_normalizing_flows_tpu_torch.models.subnets import DenseCouplingNet
from arl_conditional_normalizing_flows_tpu_torch.ops import coupling as coupling_ops
from arl_conditional_normalizing_flows_tpu_torch.ops import masks as mask_ops


def standard_normal_logprob(z, axis=-1):
    """log N(z; 0, I) summed over ``axis`` (tfp MultivariateNormalDiag with
    unit scales, TOYcINN_make_model.py:147-149)."""
    d = z.shape[axis]
    return -0.5 * torch.sum(torch.square(z), dim=axis) - 0.5 * d * math.log(2.0 * math.pi)


class ToyCINN(nn.Module):
    """The toy cINN. Weights are drawn from a ``torch.Generator`` seeded with
    ``seed`` on the CPU, then moved to ``device`` (the CUDA card when None;
    see :func:`~arl_conditional_normalizing_flows_tpu_torch.device.resolve_device`)."""

    def __init__(self, cfg: ToyConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        generator = torch.Generator().manual_seed(seed)
        self.partitions = [mask_ops.toy_partition(cfg.io_shape, j)
                           for j in range(cfg.num_coupling_layers)]
        self.couplings = nn.ModuleList(
            DenseCouplingNet(len(u1), len(u2), cfg.intermediate_dims, cfg.num_layers,
                             generator=generator)
            for u1, u2 in self.partitions)
        # layer j's u1 indices, u2 indices and combine order, one long tensor
        for j, (u1, u2) in enumerate(self.partitions):
            idx = np.concatenate([u1, u2, mask_ops.toy_combine_order(u1, u2)])
            self.register_buffer(f"index_{j}", torch.as_tensor(idx, dtype=torch.long),
                                 persistent=False)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _apply_layer(self, j, u, invert):
        n1 = len(self.partitions[j][0])
        idx = getattr(self, f"index_{j}")
        u1_idx, u2_idx, order = idx[:n1], idx[n1:self.cfg.io_shape], idx[self.cfg.io_shape:]
        u1 = mask_ops.toy_gather(u, u1_idx)
        u2 = mask_ops.toy_gather(u, u2_idx)
        a, b = self.couplings[j](u1)
        if invert:
            v2, delta = coupling_ops.affine_inverse(a, b, u2), None
        else:
            v2, delta = coupling_ops.affine_forward(a, b, u2)
        v = mask_ops.toy_scatter_combine(u1, v2, u1_idx, u2_idx, self.cfg.io_shape, order)
        return v, delta

    def _check_width(self, t):
        # the index-based masks would silently mis-slice a wider tensor
        if t.shape[-1] != self.cfg.io_shape:
            raise ValueError(f"expected io_shape={self.cfg.io_shape} features, "
                             f"got {t.shape[-1]}")

    def forward(self, xy):
        """xy' -> (zy, log_det) with log_det per sample, shape (B,)."""
        self._check_width(xy)
        u = xy
        log_det = torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
        for j in reversed(self.cfg.ordered_indices()):
            u, delta = self._apply_layer(j, u, invert=False)
            log_det = log_det + delta
        return u, log_det

    def inverse(self, zy):
        """zy -> xy' (the reference's direction +1, TOYcINN_make_model.py:299)."""
        self._check_width(zy)
        v = zy
        for j in self.cfg.ordered_indices():
            v, _ = self._apply_layer(j, v, invert=True)
        return v

    def sample_xy(self, z, y):
        """Conditional sampling: invert concat(z, y), z of x_d features."""
        return self.inverse(torch.cat([z, y], dim=-1))

    def log_loss(self, xy):
        """Joint NLL and its components (TOYcINN_make_model.py:404-451): each
        the batch mean of the negative component, as the reference's four
        Mean trackers."""
        cfg = self.cfg
        y_prime = xy[..., cfg.x_d:]
        zy, log_det = self.forward(xy)
        z = zy[..., :cfg.x_d]
        y = zy[..., cfg.x_d:]
        ll_z = standard_normal_logprob(z)
        ll_y = -cfg.lambda_y * torch.sum(torch.abs(y - y_prime), dim=-1)
        return {
            "loss": -torch.mean(ll_z + ll_y + log_det),
            "z_loss": -torch.mean(ll_z),
            "y_loss": -torch.mean(ll_y),
            "detJ_loss": -torch.mean(log_det),
        }
