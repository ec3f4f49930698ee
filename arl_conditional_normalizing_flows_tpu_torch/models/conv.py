"""Multi-scale convolutional conditional flow (port of the JAX
``models/conv.py``; the reference's ``cFlow``,
conv_cINN_make_model.py:1408-1904).

Per coupling block (conv_cINN_make_model.py:1629-1689): four coupling layers
with u1-mask order (0, 1, 2, 3), then, if the block's flag is set, a squeeze
and a factor-out of half the channels into the running zy accumulator.

``forward`` maps xy' -> zy with a PER-SAMPLE log|det J|; ``inverse`` maps
zy -> xy'. After the last block the accumulated zy and the remaining uv are
pushed BACKWARD through the squeeze/factor ops only, so zy has the exact
layout of xy (conv_cINN_make_model.py:1754-1771); ``inverse`` re-flattens
through the same ops first. Consecutive couplings with complementary masks
are fused: the second consumes the first one's compressed halves directly.

With ``experimental_lowering="pallas_coupling"`` the coupling law goes
through the hand-written kernels of ``ops/kernels/affine_coupling.py``; with
``"pallas_subnet"`` each coupling subnet's conv chain runs as one launch of
the kernel of ``ops/kernels/fused_subnet.py`` (:class:`FusedChainCouplingNet`)
and the law is the plain one. On CPU tensors the kernels' plain versions run.
``"dense_groups"`` and ``"fused_dilated"`` change how the subnets' grouped
and dilated convs are lowered (``models/subnets.py``).

Precision modes (JAX models/arch.py:88-102, models/conv.py:227-233): with
``flow_in_compute_dtype`` and a bfloat16 compute dtype the flow casts its
input to bfloat16 once, runs the squeeze, factor and mask moves, the heads
and the coupling law in bfloat16 (under ``pallas_coupling`` the kernels get
bfloat16 tensors) and casts the result back to float32 once; the log-det
still accumulates in float32. ``late_head_cast`` leaves only the heads in
the compute dtype and the law promotes them to the float32 flow.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from arl_conditional_normalizing_flows_tpu_torch.device import resolve_device
from arl_conditional_normalizing_flows_tpu_torch.models.arch import (
    BLOCK_MASK_ORDER,
    ConvFlowConfig,
    derive_blocks,
)
from arl_conditional_normalizing_flows_tpu_torch.models.subnets import (
    ConvCouplingNet,
    FusedChainCouplingNet,
)
from arl_conditional_normalizing_flows_tpu_torch.models.toy import standard_normal_logprob
from arl_conditional_normalizing_flows_tpu_torch.ops import coupling as coupling_ops
from arl_conditional_normalizing_flows_tpu_torch.ops import masks as mask_ops
from arl_conditional_normalizing_flows_tpu_torch.ops import squeeze as squeeze_ops
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (
    affine_coupling as coupling_kernels,
)


def check_ported(cfg: ConvFlowConfig) -> None:
    """Raise ``NotImplementedError`` for a compute dtype the port has no
    subnets for."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port runs float32 or "
            "bfloat16 subnets")


class ConvCouplingLayer(nn.Module):
    """One masked conv coupling layer (conv_cINN_make_model.py:337-1394)."""

    def __init__(self, in_shape, which_mask, num_res_blocks, cardinality,
                 num_kernels, ksize, dilations: Tuple[int, ...], layer_norm, *,
                 fused_subnet=False, use_kernel=False, fused_chain=False,
                 ref_compat_group_slice=False, ref_compat_group_init=False,
                 fuse_dilated_conv=False, dense_masked_groups=False,
                 keep_compute_dtype=False, late_cast=False,
                 dtype=torch.float32, generator):
        super().__init__()
        m = which_mask
        u1c_shape = mask_ops.compressed_shape(in_shape, m)
        u2c_shape = mask_ops.compressed_shape(in_shape, mask_ops.COMPLEMENT[m])
        shared = dict(
            in_shape=u1c_shape,
            out_channels=u2c_shape[-1],
            # checkerboard-compressed inputs have 2x channels / half the
            # spatial extent, so get half the kernels
            # (conv_cINN_make_model.py:419-423)
            num_kernels=num_kernels // 2 if m in (0, 1) else num_kernels,
            num_res_blocks=num_res_blocks,
            cardinality=cardinality,
            ksize=ksize,
            dilations=dilations,
            dtype=dtype,
            generator=generator,
        )
        if fused_chain:
            # the JAX PallasFusedCouplingNet: layer norm off, default groups,
            # a float32 head (late_cast does not reach it)
            net, common = FusedChainCouplingNet, shared
        else:
            net, common = ConvCouplingNet, dict(
                shared, layer_norm=layer_norm,
                ref_compat_group_slice=ref_compat_group_slice,
                ref_compat_group_init=ref_compat_group_init,
                fuse_dilated_conv=fuse_dilated_conv, dense_masked_groups=dense_masked_groups,
                keep_compute_dtype=keep_compute_dtype, late_cast=late_cast)
        if fused_subnet:
            self.net_ab = net(n_heads=2, **common)
        else:
            self.net_a = net(scale_head=True, **common)
            self.net_b = net(scale_head=False, **common)
        self.which_mask = m
        self.fused_subnet = fused_subnet
        self.use_kernel = use_kernel

    def _coupling_fn(self, u1c):
        if self.fused_subnet:
            return self.net_ab(u1c)
        return self.net_a(u1c), self.net_b(u1c)

    def forward_halves(self, u1c, u2c):
        """The law on compressed halves: (u1c, u2c) -> (v2c, per-sample
        delta log|det J|)."""
        a, b = self._coupling_fn(u1c)
        if self.use_kernel:
            return coupling_kernels.fused_affine_forward(
                a.contiguous(), b.contiguous(), u2c.contiguous())
        return coupling_ops.affine_forward(a, b, u2c)

    def inverse_halves(self, v1c, v2c):
        """Inverse law on compressed halves: (v1c, v2c) -> u2c."""
        a, b = self._coupling_fn(v1c)
        if self.use_kernel:
            return coupling_kernels.fused_affine_inverse(
                a.contiguous(), b.contiguous(), v2c.contiguous())
        return coupling_ops.affine_inverse(a, b, v2c)

    def forward(self, u):
        """u -> (v, per-sample delta log|det J|)."""
        m = self.which_mask
        u1c = mask_ops.compress(u, m)
        u2c = mask_ops.compress(u, mask_ops.COMPLEMENT[m])
        v2c, delta = self.forward_halves(u1c, u2c)
        return mask_ops.combine(u1c, v2c, m), delta

    def inverse(self, v):
        m = self.which_mask
        v1c = mask_ops.compress(v, m)
        v2c = mask_ops.compress(v, mask_ops.COMPLEMENT[m])
        return mask_ops.combine(v1c, self.inverse_halves(v1c, v2c), m)


def _maybe_squeeze_zy(zy):
    return None if zy is None else squeeze_ops.squeeze(zy)


def _maybe_unsqueeze_zy(zy):
    if zy is None or zy.shape[-1] == 0:
        return zy
    return squeeze_ops.unsqueeze(zy)


class ConvCFlow(nn.Module):
    """The conv cINN. Weights are drawn from ``torch.Generator`` seeded with
    ``seed`` on the CPU, then moved to ``device`` (the CUDA card when None;
    see :func:`~arl_conditional_normalizing_flows_tpu_torch.device.resolve_device`).
    """

    def __init__(self, cfg: ConvFlowConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        check_ported(cfg)
        self.cfg = cfg
        self.blocks = derive_blocks(cfg)
        dtype = getattr(torch, cfg.compute_dtype)
        generator = torch.Generator().manual_seed(seed)

        couplings = []
        plan = []  # ("couple", idx) | ("squeeze",) | ("factor", npf)
        for i, blk in enumerate(self.blocks):
            for m in BLOCK_MASK_ORDER:
                plan.append(("couple", len(couplings)))
                couplings.append(ConvCouplingLayer(
                    blk.io_shape, m, cfg.res_blocks[i], cfg.cardinality[i],
                    cfg.num_kernels[i], cfg.ksize,
                    blk.dilations_checkerboard if m in (0, 1) else blk.dilations_channelwise,
                    cfg.layer_norm,
                    fused_subnet=cfg.fused_subnet,
                    use_kernel=cfg.use_pallas_coupling,
                    fused_chain=cfg.fused_pallas_subnet,
                    ref_compat_group_slice=cfg.ref_compat_group_slice,
                    ref_compat_group_init=cfg.ref_compat_group_init,
                    fuse_dilated_conv=cfg.fuse_dilated_conv,
                    dense_masked_groups=cfg.dense_masked_groups,
                    keep_compute_dtype=cfg.flow_in_compute_dtype,
                    late_cast=cfg.late_head_cast,
                    dtype=dtype,
                    generator=generator,
                ))
            if blk.squeeze_factor:
                plan.append(("squeeze",))
                plan.append(("factor", blk.num_prev_factors))
        self.couplings = nn.ModuleList(couplings)
        self.plan = tuple(plan)
        self.sf_plan = tuple(op for op in plan if op[0] != "couple")
        # flow_in_compute_dtype: one cast on entry and one on exit a pass
        self.act_dtype = (dtype if cfg.flow_in_compute_dtype and dtype != torch.float32
                          else None)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _couple_pairs(self, plan):
        """``plan`` with consecutive complementary-mask couplings merged into
        ("pair", i, j): ``compress(combine(u1c, v2c, m), COMPLEMENT[m]) ==
        v2c`` and ``compress(..., m) == u1c`` exactly, so the full tensor
        between the two is never built."""
        out = []
        k = 0
        while k < len(plan):
            op = plan[k]
            nxt = plan[k + 1] if k + 1 < len(plan) else None
            if (
                op[0] == "couple"
                and nxt is not None
                and nxt[0] == "couple"
                and self.couplings[nxt[1]].which_mask
                == mask_ops.COMPLEMENT[self.couplings[op[1]].which_mask]
            ):
                out.append(("pair", op[1], nxt[1]))
                k += 2
            else:
                out.append(op)
                k += 1
        return out

    def forward(self, xy):
        """xy' -> (zy, log_det). zy has the shape of xy and is float32;
        log_det is (B,) float32."""
        uv = xy if self.act_dtype is None else xy.to(self.act_dtype)
        zy = None
        log_det = torch.zeros(xy.shape[:-3], dtype=torch.float32, device=xy.device)
        for op in self._couple_pairs(self.plan):
            if op[0] == "pair":
                first, second = self.couplings[op[1]], self.couplings[op[2]]
                m = first.which_mask
                mc = mask_ops.COMPLEMENT[m]
                u1c = mask_ops.compress(uv, m)
                u2c = mask_ops.compress(uv, mc)
                v2c, d1 = first.forward_halves(u1c, u2c)
                # the second layer's live half is v2c, its transformed half u1c
                w2c, d2 = second.forward_halves(v2c, u1c)
                uv = mask_ops.combine(v2c, w2c, mc)
                log_det = log_det + d1 + d2
            elif op[0] == "couple":
                uv, delta = self.couplings[op[1]](uv)
                log_det = log_det + delta
            elif op[0] == "squeeze":
                uv = squeeze_ops.squeeze(uv)
                zy = _maybe_squeeze_zy(zy)
            else:  # factor
                uv, zy = squeeze_ops.factor_out(uv, zy)

        if not self.sf_plan:
            return uv.float(), log_det

        # back to the xy layout through the squeeze/factor ops only
        # (conv_cINN_make_model.py:1754-1771)
        zy = torch.cat([zy, uv], dim=-1)
        vu = None
        for op in reversed(self.sf_plan):
            if op[0] == "factor":
                vu, zy = squeeze_ops.factor_in(vu, zy, op[1])
            else:  # squeeze, backward
                vu = squeeze_ops.unsqueeze(vu)
                zy = _maybe_unsqueeze_zy(zy)
        return vu.float(), log_det

    def inverse(self, zy):
        """zy (xy-shaped) -> xy' float32 (conv_cINN_make_model.py:1774-1798)."""
        uv = zy if self.act_dtype is None else zy.to(self.act_dtype)
        acc = None
        for op in self.sf_plan:  # re-flatten: squeeze/factor forward only
            if op[0] == "squeeze":
                uv = squeeze_ops.squeeze(uv)
                acc = _maybe_squeeze_zy(acc)
            else:
                uv, acc = squeeze_ops.factor_out(uv, acc)
        # all ops backward; the reversed (0,1,2,3) order pairs 3 with 2 and
        # 1 with 0
        for op in self._couple_pairs(tuple(reversed(self.plan))):
            if op[0] == "pair":
                first, second = self.couplings[op[1]], self.couplings[op[2]]
                m = first.which_mask
                mc = mask_ops.COMPLEMENT[m]
                v1c = mask_ops.compress(uv, m)
                v2c = mask_ops.compress(uv, mc)
                u2c = first.inverse_halves(v1c, v2c)
                # the next (mask mc) layer's halves are exactly (u2c, v1c)
                t2c = second.inverse_halves(u2c, v1c)
                uv = mask_ops.combine(u2c, t2c, mc)
            elif op[0] == "couple":
                uv = self.couplings[op[1]].inverse(uv)
            elif op[0] == "squeeze":
                uv = squeeze_ops.unsqueeze(uv)
                acc = _maybe_unsqueeze_zy(acc)
            else:  # factor backward
                uv, acc = squeeze_ops.factor_in(uv, acc, op[1])
        return uv.float()

    def _loss_components(self, zy, log_det, xy):
        cfg = self.cfg
        y_prime = xy[..., cfg.x_d :]
        z = zy[..., : cfg.x_d]
        y = zy[..., cfg.x_d :]
        ll_z = torch.sum(standard_normal_logprob(z, axis=-1), dim=(-2, -1))
        ll_y = -cfg.lambda_y * torch.sum(torch.abs(y - y_prime), dim=(-3, -2, -1))
        return {
            "loss": -torch.mean(ll_z + ll_y + log_det),
            "z_loss": -torch.mean(ll_z),
            "y_loss": -torch.mean(ll_y),
            "detJ_loss": -torch.mean(log_det),
        }

    def log_loss(self, xy):
        """Joint NLL and its components (conv_cINN_make_model.py:1800-1845):
        ll_z sums the per-pixel N(0,1) log-prob over space; ll_y is the
        lambda_y-weighted L1 between mapped and requested conditions."""
        zy, log_det = self.forward(xy)
        return self._loss_components(zy, log_det, xy)

    def log_loss_with_latent(self, xy):
        """(loss components, zy) from one forward pass."""
        zy, log_det = self.forward(xy)
        return self._loss_components(zy, log_det, xy), zy

    def sample_xy(self, z, y):
        """Conditional sampling: invert concat(z, y); z has x_d channels per
        pixel (conv_cINN_make_model.py:1619-1623)."""
        return self.inverse(torch.cat([z, y], dim=-1))
