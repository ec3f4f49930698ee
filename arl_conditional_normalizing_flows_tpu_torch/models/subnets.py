"""Coupling-function subnets (port of the JAX ``models/subnets.py``): the
toy's dense stacks (:class:`DenseCouplingNet`, TOYcINN_make_model.py:29-97)
and the conv flow's conv chains.

A conv subnet is a dilated grouped-conv ResNeXt stack
(conv_cINN_base_functions.py:330-627, conv_cINN_make_model.py:1076-1213):
entry k x k conv -> ``num_res_blocks`` x :class:`DilatedResidualBlock` ->
LeakyReLU -> [:class:`FlatLayerNorm`] -> k x k head. Parity details kept from
the JAX package: LeakyReLU slope 0.3, LayerNorm over all h*w*d elements with
eps 1e-3, orthogonal(0.1) kernels drawn over the ``(k*k*cin, cout)`` matrix,
zero biases, a linear b head and a tanh A head with a learned scale that
starts at 1.0.

Subnets take and return the JAX layout ``(B, h, w, c)``; inside, convs run on
``x.permute(0, 3, 1, 2)``, a channels-last NCHW view. Like flax's
``nn.Conv(dtype=...)``, each conv casts its input, kernel and bias to the
compute dtype and leaves its output there; the head is cast to float32
unless the ``flow_in_compute_dtype`` or ``late_head_cast`` mode keeps it in
the compute dtype. :class:`FusedChainCouplingNet` runs the same chain as one
kernel launch (``ops/kernels/fused_subnet.py``), with a float32 trunk.

Two other lowerings of the same function run as ``F.conv2d`` too, as the JAX
package runs them as XLA convolutions: ``dense_groups``
(:class:`DenseMaskedGroupConv`, a grouped conv as one block-diagonal dense
conv) and ``fused_dilated`` (all dilated branches of a residual block as one
masked dense conv, :func:`dilated_branch_mask`).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import fused_subnet

LEAKY_SLOPE = 0.3  # Keras LeakyReLU default alpha


def leaky_relu(x):
    """LeakyReLU with the slope in ``x``'s dtype, as JAX multiplies a bf16
    tensor by the weakly typed 0.3 rounded to bf16 (0.30078125)."""
    return F.leaky_relu(x, negative_slope=_slope(x.dtype))


@functools.cache
def _slope(dtype):
    return torch.tensor(LEAKY_SLOPE, dtype=dtype).item()


def orthogonal(shape, scale, generator):
    """Orthogonal(gain) draw of ``shape`` (HWIO) over the
    ``(prod(shape[:-1]), shape[-1])`` matrix, as flax's
    ``nn.initializers.orthogonal`` does (same distribution, torch's RNG)."""
    rows, cols = math.prod(shape[:-1]), shape[-1]
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return (scale * q).reshape(shape).float()


def glorot_uniform(fan_in, fan_out, generator):
    """An ``(fan_out, fan_in)`` Linear weight drawn as flax's
    ``glorot_uniform`` draws an ``(fan_in, fan_out)`` kernel: uniform in
    +-sqrt(6 / (fan_in + fan_out)) (same distribution, torch's RNG)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(fan_out, fan_in, generator=generator, dtype=torch.float64)
    return ((2.0 * u - 1.0) * limit).float()


class DenseCouplingNet(nn.Module):
    """The toy A/b pair: two stacks of ``num_layers+1`` Linear+LeakyReLU(0.3)
    with heads Linear(u2_size); the A head gets tanh, the b head is linear
    (TOYcINN_make_model.py:29-97; no learned scale, as the reference omits
    it, TOYcINN_make_model.py:91-92).

    Weights are glorot-uniform and biases zero, as flax's ``nn.Dense`` with
    ``glorot_uniform`` draws them (torch's ``nn.Linear`` default would give
    other weights and non-zero biases): the toy reference never passes its
    stored init to its Dense layers (TOYcINN_make_model.py:138 vs :29-97), so
    they take the Keras default, and with Orthogonal(0.1) the 7-layer stacks
    stay dead at lr 1e-4 and detJ never trains.

    ``dense`` holds the layers in flax's creation order (``Dense_0`` ...):
    the b stack, the b head, the A stack, the A head.
    """

    def __init__(self, in_size, u2_size, intermediate_dims, num_layers, *, generator):
        super().__init__()
        widths = [in_size] + [intermediate_dims] * (num_layers + 1) + [u2_size]
        layers = []
        for _ in range(2):  # b, then A
            for fan_in, fan_out in zip(widths[:-1], widths[1:]):
                lin = nn.Linear(fan_in, fan_out)
                with torch.no_grad():
                    lin.weight.copy_(glorot_uniform(fan_in, fan_out, generator))
                    lin.bias.zero_()
                layers.append(lin)
        self.dense = nn.ModuleList(layers)
        self.depth = num_layers + 2  # Linear layers a stack, its head included

    def forward(self, u1):
        """(A, b), each (..., u2_size)."""
        b_stack, a_stack = self.dense[:self.depth], self.dense[self.depth:]
        a = b = u1
        for lin in b_stack[:-1]:
            b = leaky_relu(lin(b))
        b = b_stack[-1](b)
        for lin in a_stack[:-1]:
            a = leaky_relu(lin(a))
        a = torch.tanh(a_stack[-1](a))
        return a, b


class Conv(nn.Module):
    """SAME-padded, stride-1 (dilated, grouped) conv computed in ``dtype``.

    ``weight`` is OIHW ``(cout, cin/groups, k, k)``. ``init_groups`` > 1
    draws that many output-column blocks of the kernel independently (the
    JAX ``per_group_orthogonal``) instead of one orthogonal matrix.
    """

    def __init__(self, cin, cout, ksize, *, dilation=1, groups=1, dtype,
                 generator, init_scale=0.1, init_groups=1):
        super().__init__()
        hwio = (ksize, ksize, cin // groups)
        w = torch.cat([orthogonal(hwio + (cout // init_groups,), init_scale, generator)
                       for _ in range(init_groups)], dim=-1)
        self.weight = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dilation = dilation
        self.groups = groups
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        # torch's "same" pads total//2 low and the rest high, as XLA's SAME.
        # The bias is added after the conv's output is rounded to dt, as flax
        # does: inside the conv it would be added before that rounding
        y = F.conv2d(x.to(dt), self.weight.to(dt), padding="same",
                     dilation=self.dilation, groups=self.groups)
        return y + self.bias.to(dt)[:, None, None]


class DenseMaskedGroupConv(Conv):
    """A grouped conv run as ONE dense conv with a block-diagonal kernel
    (the JAX ``DenseMaskedGroupConv``, models/subnets.py:166-208): a
    lowering, not a new function. ``weight`` has the grouped kernel's shape
    ``(cout, cin/groups, k, k)`` and its orthogonal init, so the parameters
    are those of :class:`Conv` with ``groups``; each call expands it into
    the dense ``(cout, cin, k, k)`` kernel and convolves with ``groups=1``.
    """

    def forward(self, x):
        dt = self.dtype
        g = self.groups
        cout, d, k0, k1 = self.weight.shape
        blocks = self.weight.reshape(g, cout // g, d, k0, k1)
        # dense[(g, o), (h, i)] = weight[(g, o), i] where g == h, else 0
        dense = torch.einsum("gh,goikl->gohikl", torch.eye(g, dtype=blocks.dtype,
                                                          device=blocks.device), blocks)
        y = F.conv2d(x.to(dt), dense.reshape(cout, g * d, k0, k1).to(dt), padding="same",
                     dilation=self.dilation)
        return y + self.bias.to(dt)[:, None, None]


def dilated_branch_mask(ksize, dilations, cardinality, nb_channels):
    """(mask, K): the 0/1 connectivity of the fused dilated-branch conv (the
    JAX ``_dilated_branch_mask``, models/subnets.py:211-240). A dilation-d
    k x k kernel is a sparse ``(k-1)*d + 1``-extent dense one, so one K x K
    conv (K for the largest dilation) whose kernel is multiplied by this
    mask computes every branch, each with its groups and its
    first-``nb/d``-channels slice. The mask is HWIO ``(K, K, nb, sum(nb/d))``,
    the branch outputs concatenated in dilation order."""
    dmax = max(dilations)
    K = (ksize - 1) * dmax + 1
    widths = [nb_channels // d for d in dilations]
    mask = np.zeros((K, K, nb_channels, sum(widths)), np.float32)
    off = 0
    for d, w in zip(dilations, widths):
        taps = [(K - 1) // 2 + (i - (ksize - 1) // 2) * d for i in range(ksize)]
        gsz = w // cardinality
        for g in range(cardinality):
            ins = slice(g * gsz, (g + 1) * gsz)  # reads y[..., :w] group g
            outs = slice(off + g * gsz, off + (g + 1) * gsz)
            for ty in taps:
                for tx in taps:
                    mask[ty, tx, ins, outs] = 1.0
        off += w
    return mask, K


class FlatLayerNorm(nn.Module):
    """LayerNorm over all h*w*d elements jointly (the reference's flatten ->
    LayerNorm -> reshape, conv_cINN_base_functions.py:345-361), eps 1e-3.

    Takes and returns NCHW; the statistics, and the output, are float32 (as
    flax's LayerNorm with float32 params).
    """

    def __init__(self, h, w, d):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(h * w * d))
        self.bias = nn.Parameter(torch.zeros(h * w * d))

    def forward(self, y):
        nhwc = y.permute(0, 2, 3, 1)
        flat = nhwc.reshape(nhwc.shape[0], -1).float()
        out = F.layer_norm(flat, flat.shape[-1:], self.weight, self.bias, eps=1e-3)
        return out.reshape(nhwc.shape).permute(0, 3, 1, 2)


class DilatedResidualBlock(nn.Module):
    """Pre-activation ResNeXt bottleneck with parallel dilated grouped convs
    and an identity shortcut (conv_cINN_base_functions.py:502-627).

    Branch ``i`` (dilation ``d``) reads the first ``nb/d`` channels and
    convolves them in ``cardinality`` groups (``ref_compat_group_slice``:
    every group reads the LAST group's channel slice, the reference's
    late-bound Lambda, conv_cINN_base_functions.py:401). At cardinality 1
    a branch is one dense conv of the whole trunk to ``nb/d`` channels, as
    the JAX ``_grouped_conv`` computes it.

    ``dense_masked_groups`` runs each grouped branch as a
    :class:`DenseMaskedGroupConv` (not at cardinality 1 nor under
    ``ref_compat_group_slice``, as in JAX). ``fuse_dilated_conv`` with more
    than one dilation replaces the branches by one masked dense conv: the
    parameters ``fused_dil_kernel`` (OIHW ``(sum(nb/d), nb, K, K)``, drawn
    orthogonal over the whole ``(K*K*nb, sum(nb/d))`` matrix, as flax draws
    it) and ``fused_dil_bias``, and ``branches`` is empty.
    """

    def __init__(self, hw, nb_channels, dilations, ksize, cardinality,
                 layer_norm, *, ref_compat_group_slice=False,
                 ref_compat_group_init=False, fuse_dilated_conv=False,
                 dense_masked_groups=False, dtype, generator, init_scale=0.1):
        super().__init__()
        h, w = hw
        nb = nb_channels
        widths = [nb // d for d in dilations]
        for wd in widths:
            assert wd % cardinality == 0, (wd, cardinality)
        common = dict(dtype=dtype, generator=generator, init_scale=init_scale)
        self.norms = (
            nn.ModuleList([FlatLayerNorm(h, w, nb), FlatLayerNorm(h, w, nb),
                           FlatLayerNorm(h, w, sum(widths))])
            if layer_norm else None
        )
        self.conv_pre = Conv(nb, nb, 1, **common)
        self.fused = fuse_dilated_conv and len(dilations) > 1
        if self.fused:
            if ref_compat_group_slice:
                raise ValueError("fuse_dilated_conv implements the documented grouped-conv "
                                 "semantics only")
            if ref_compat_group_init:
                raise ValueError("ref_compat_group_init (per-group orthogonal draws) is not "
                                 "implemented for the fused masked kernel; drop one of the "
                                 "two knobs")
            mask, _ = dilated_branch_mask(ksize, dilations, cardinality, nb)
            hwio = orthogonal(mask.shape, init_scale, generator)
            self.fused_dil_kernel = nn.Parameter(hwio.permute(3, 2, 0, 1).contiguous())
            self.fused_dil_bias = nn.Parameter(torch.zeros(mask.shape[-1]))
            self.register_buffer("fused_dil_mask",
                                 torch.from_numpy(mask.transpose(3, 2, 0, 1).copy()),
                                 persistent=False)
            self.branches = nn.ModuleList()
        else:
            groups = 1 if ref_compat_group_slice else cardinality
            branch = DenseMaskedGroupConv if dense_masked_groups and groups > 1 else Conv
            self.branches = nn.ModuleList([
                # cardinality 1: one dense conv over the whole trunk
                branch(nb if cardinality == 1 else wd // cardinality * groups, wd, ksize,
                       dilation=d, groups=groups,
                       init_groups=cardinality if ref_compat_group_init else 1,
                       **common)
                for wd, d in zip(widths, dilations)
            ])
        self.conv_post = Conv(sum(widths), nb, 1, **common)
        self.widths = widths
        self.dilations = tuple(dilations)
        self.ksize = ksize
        self.cardinality = cardinality
        self.ref_compat_group_slice = ref_compat_group_slice
        self.dtype = dtype

    def _common(self, t, i):
        t = leaky_relu(t)
        return t if self.norms is None else self.norms[i](t)

    def _branch_input(self, y, width):
        if self.cardinality == 1:
            return y
        if self.ref_compat_group_slice:
            d = width // self.cardinality
            return y[:, (self.cardinality - 1) * d : self.cardinality * d]
        return y[:, :width]

    def forward(self, y):
        shortcut = y
        y = self.conv_pre(self._common(y, 0))
        y = self._common(y, 1)
        if self.fused:
            dt = self.dtype
            kernel = (self.fused_dil_kernel * self.fused_dil_mask).to(dt)
            y = F.conv2d(y.to(dt), kernel, padding="same") + self.fused_dil_bias.to(dt)[:, None, None]
        else:
            y = torch.cat([conv(self._branch_input(y, wd))
                           for conv, wd in zip(self.branches, self.widths)], dim=1)
        y = self.conv_post(self._common(y, 2))
        return shortcut + y


class ConvCouplingNet(nn.Module):
    """One head-stack of the conv coupling function
    (conv_cINN_make_model.py:1076-1213).

    ``n_heads=2`` emits (A, b) from one trunk (the fused option); with
    ``n_heads=1`` the net is the A net when ``scale_head`` else the b net.
    The A head is ``tanh(head) * tanh_scale``. The head is cast to float32
    unless ``keep_compute_dtype`` (the ``flow_in_compute_dtype`` mode) or
    ``late_cast`` (``late_head_cast``) is set; then it stays in the compute
    dtype, and so do the tanh and the scale (JAX models/subnets.py:362-412).
    """

    def __init__(self, in_shape, out_channels, num_kernels, num_res_blocks,
                 cardinality, ksize, dilations: Tuple[int, ...], layer_norm, *,
                 scale_head=False, n_heads=1, ref_compat_group_slice=False,
                 ref_compat_group_init=False, fuse_dilated_conv=False,
                 dense_masked_groups=False, keep_compute_dtype=False, late_cast=False,
                 dtype=torch.float32, generator, init_scale=0.1):
        super().__init__()
        assert n_heads in (1, 2)
        h, w, cin = in_shape
        common = dict(dtype=dtype, generator=generator, init_scale=init_scale)
        self.conv_in = Conv(cin, num_kernels, ksize, **common)
        self.blocks = nn.ModuleList([
            DilatedResidualBlock(
                (h, w), num_kernels, dilations, ksize, cardinality, layer_norm,
                ref_compat_group_slice=ref_compat_group_slice,
                ref_compat_group_init=ref_compat_group_init,
                fuse_dilated_conv=fuse_dilated_conv, dense_masked_groups=dense_masked_groups,
                **common)
            for _ in range(num_res_blocks)
        ])
        self.norm = FlatLayerNorm(h, w, num_kernels) if layer_norm else None
        self.head = Conv(num_kernels, out_channels * n_heads, ksize, **common)
        self.tanh_scale = (
            nn.Parameter(torch.ones(())) if scale_head or n_heads == 2 else None
        )
        self.in_shape = tuple(in_shape)
        self.out_channels = out_channels
        self.n_heads = n_heads
        self.dtype = dtype
        self.float_head = not (keep_compute_dtype or late_cast)

    def _scale(self, a):
        return torch.tanh(a) * self.tanh_scale.to(a.dtype)

    def forward(self, u1):
        """u1 (B, h, w, cin) -> A or b (B, h, w, out), or (A, b) when fused."""
        y = self.conv_in(u1.to(self.dtype).permute(0, 3, 1, 2))
        for blk in self.blocks:
            y = blk(y)
        y = leaky_relu(y)
        if self.norm is not None:
            y = self.norm(y)
        head = self.head(y)
        return self._heads((head.float() if self.float_head else head).permute(0, 2, 3, 1))

    def _heads(self, head):
        """The head (B, h, w, out * n_heads) -> A or b, or (A, b)."""
        if self.n_heads == 1:
            return self._scale(head) if self.tanh_scale is not None else head
        c = self.out_channels
        return self._scale(head[..., :c]), head[..., c:]


class FusedChainCouplingNet(ConvCouplingNet):
    """``ConvCouplingNet`` whose whole conv chain runs as one call of
    :func:`~arl_conditional_normalizing_flows_tpu_torch.ops.kernels.fused_subnet.subnet_apply`
    (the JAX ``PallasFusedCouplingNet``, models/subnets.py:415-486): one
    kernel launch on the card, the plain version on the CPU.

    Its parameters, their names and their seeded init are those of
    ``ConvCouplingNet`` with layer norm off and the default group semantics,
    so a ``state_dict`` carries between the two unchanged. The chain keeps
    its trunk in float32 between stages, where ``ConvCouplingNet`` leaves
    each conv's output in the compute dtype: the two agree at float32 only.
    """

    def __init__(self, in_shape, out_channels, num_kernels, num_res_blocks,
                 cardinality, ksize, dilations: Tuple[int, ...], *,
                 scale_head=False, n_heads=1, dtype=torch.float32, generator,
                 init_scale=0.1):
        super().__init__(in_shape, out_channels, num_kernels, num_res_blocks,
                         cardinality, ksize, dilations, False, scale_head=scale_head,
                         n_heads=n_heads, dtype=dtype, generator=generator,
                         init_scale=init_scale)
        h, w, cin = in_shape
        self.spec = fused_subnet.SubnetSpec(
            h=h, w=w, cin=cin, kernels=num_kernels, res_blocks=num_res_blocks,
            cardinality=cardinality, ksize=ksize, dilations=tuple(dilations),
            out_total=out_channels * n_heads, compute_dtype=str(dtype).removeprefix("torch."))
        self._packed = None
        self._packed_key = None

    def flax_ordered_weights(self):
        """The chain's parameters with flax's HWIO shapes, in
        ``flax_param_order``'s order."""
        def hwio(conv):
            return [conv.weight.permute(2, 3, 1, 0), conv.bias]

        out = hwio(self.conv_in)
        for blk in self.blocks:
            out += hwio(blk.conv_pre)
            for conv in blk.branches:
                out += hwio(conv)
            out += hwio(blk.conv_post)
        return out + hwio(self.head)

    def packed(self):
        """The kernel's packed weights. Packed once and kept while no
        parameter changes (keyed on each one's version counter and storage);
        when a gradient may flow to the parameters, packed anew each call so
        that it does."""
        params = list(self.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return fused_subnet.pack(self.spec, self.flax_ordered_weights())
        key = tuple((p._version, p.data_ptr(), p.device) for p in params)
        if key != self._packed_key:
            # normal tensors even under inference_mode, so that a later
            # autograd-enabled CPU call may use them
            with torch.inference_mode(False), torch.no_grad():
                self._packed = fused_subnet.pack(self.spec, self.flax_ordered_weights())
            self._packed_key = key
        return self._packed

    def forward(self, u1):
        """u1 (B, h, w, cin) -> A or b (B, h, w, out), or (A, b) when fused."""
        return self._heads(fused_subnet.subnet_apply(
            self.spec, u1.float().contiguous(), self.packed()))
