"""Analytic roofline of the conv flow's convolutions (port of the JAX
``utils/roofline.py``).

The JAX module parses the optimized HLO of a compiled step. The port has no
HLO, so it counts the convolutions from the model itself: it walks a
``ConvCFlow``'s subnets, each at its coupling's compressed input shape (from
``derive_blocks``), and gives every conv that runs its FLOPs,
``2 * B*H*W * cout * k*k * cin/groups``, and its bytes, input + kernel +
output at the compute dtype. The count follows what the lowering executes,
as JAX's HLO count does: under ``dense_groups`` a grouped branch is a dense
block-diagonal conv (``cin/groups`` becomes ``cin``), under
``fused_dilated`` a block's branches are one ``K x K`` dense conv over the
whole trunk. Beside it, ``default_lowering_conv_flops`` counts the same
model's convs as the default lowering runs them; ``mfu`` divides that count,
so an A/B between lowerings (or between ``F.conv2d`` and the conv-chain
kernel) divides the same work.

A train step counts the backward too: per conv an input gradient and a
weight gradient, each the forward's FLOPs and bytes, except the input
gradient of the first coupling's entry convs, whose input (the data) no
parameter depends on; autograd does not compute it, as XLA drops it.

Each conv is bounded by ``max(flops/peak, bytes/bandwidth)`` and the bounds
are summed (couplings run one after another). The rest of a step (the
coupling law, the mask moves, Adam) is not counted: ``rest_bound_seconds`` is
0, so the bound is a conv-only lower bound and ``fraction_of_roofline`` is
conservative. Unlike the JAX count, 1x1 convs are counted: XLA's CPU
compiler turns them into dot products, which its HLO parser does not read,
while the port runs them as convolutions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

#: (bf16 dense peak FLOP/s, memory bytes/s) per device kind substring. The
#: H100 SXM row is its spec sheet (989 TFLOP/s bf16 dense, 3.35 TB/s); the
#: TPU rows are the JAX table's (public spec sheets), kept because the
#: table is ported whole; no report of the card reads them.
_DEVICE_PEAKS: List[Tuple[str, Tuple[float, float]]] = [
    ("h100 80gb hbm3", (989e12, 3.35e12)),
    ("h100 sxm", (989e12, 3.35e12)),
    ("v5 lite", (197e12, 819e9)),
    ("v5e", (197e12, 819e9)),
    ("v5p", (459e12, 2765e9)),
    ("v6 lite", (918e12, 1640e9)),
    ("v6e", (918e12, 1640e9)),
    ("v4", (275e12, 1228e9)),
    ("v3", (123e12, 900e9)),
    ("v2", (46e12, 700e9)),
]

#: rows cross-checked by a measurement (JAX: the v5e bench); the H100 row is
#: a spec-sheet constant no run has validated
_VALIDATED_KINDS = ("v5 lite", "v5e")

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def device_peaks(device_kind: str) -> Optional[Tuple[float, float]]:
    kind = device_kind.lower()
    for sub, peaks in _DEVICE_PEAKS:
        if sub in kind:
            return peaks
    return None


def peaks_validated(device_kind: str) -> bool:
    """True when this device kind's row of the peak table has been
    cross-checked by a measurement."""
    kind = device_kind.lower()
    return any(sub in kind for sub in _VALIDATED_KINDS)


@dataclasses.dataclass
class ConvOp:
    """One convolution: shapes NHWC (input, output) and HWIO (kernel), as
    the JAX ``ConvOp`` reads them from HLO."""

    name: str
    out_dtype: str
    out_shape: Tuple[int, ...]
    kernel_shape: Tuple[int, ...]
    in_shape: Tuple[int, ...]
    in_dtype: str
    kernel_dtype: str
    flops: float
    bytes: float


def _op(name, batch, h, w, cin, cout, k, cin_per_group, dtype) -> ConvOp:
    isz = _ITEMSIZE[dtype]
    kernel = (k, k, cin_per_group, cout)
    flops = 2.0 * batch * h * w * cout * k * k * cin_per_group
    nbytes = (batch * h * w * cin + k * k * cin_per_group * cout + batch * h * w * cout) * isz
    return ConvOp(name, dtype, (batch, h, w, cout), kernel, (batch, h, w, cin), dtype, dtype,
                  flops, float(nbytes))


def _conv(name, conv, batch, h, w, dtype, dense=False) -> ConvOp:
    cout, cin_g, k, _ = conv.weight.shape
    cin = cin_g * conv.groups
    return _op(name, batch, h, w, cin, cout, k, cin if dense else cin_g, dtype)


def _block_convs(prefix, blk, batch, h, w, dtype, default_lowering) -> List[ConvOp]:
    from arl_conditional_normalizing_flows_tpu_torch.models.subnets import DenseMaskedGroupConv

    ops = [_conv(f"{prefix}.conv_pre", blk.conv_pre, batch, h, w, dtype)]
    nb = blk.conv_pre.weight.shape[0]
    if blk.fused and not default_lowering:
        cout, _, kk, _ = blk.fused_dil_kernel.shape
        ops.append(_op(f"{prefix}.fused_dil_kernel", batch, h, w, nb, cout, kk, nb, dtype))
    elif blk.fused:  # the branches the default lowering runs instead
        card = blk.cardinality
        for i, wd in enumerate(blk.widths):
            cin = nb if card == 1 else wd
            ops.append(_op(f"{prefix}.branches.{i}", batch, h, w, cin, wd, blk.ksize,
                           nb if card == 1 else wd // card, dtype))
    else:
        for i, conv in enumerate(blk.branches):
            dense = isinstance(conv, DenseMaskedGroupConv) and not default_lowering
            ops.append(_conv(f"{prefix}.branches.{i}", conv, batch, h, w, dtype, dense))
    ops.append(_conv(f"{prefix}.conv_post", blk.conv_post, batch, h, w, dtype))
    return ops


def model_convs(model, batch: int, *, train: bool = False,
                default_lowering: bool = False) -> List[ConvOp]:
    """The convolutions of one forward pass of ``model`` (a port
    ``ConvCFlow``) at ``batch``, in the order they run; with ``train``, also
    the backward's (``<name>.grad_input`` and ``<name>.grad_weight``). With
    ``default_lowering`` the grouped and dilated branches are counted as
    the default lowering runs them."""
    ops = []
    for i, layer in enumerate(model.couplings):
        for net_name in ("net_ab", "net_a", "net_b"):
            net = getattr(layer, net_name, None)
            if net is None:
                continue
            h, w, _ = net.in_shape
            dtype = str(net.dtype).removeprefix("torch.")
            prefix = f"couplings.{i}.{net_name}"
            ops.append(_conv(f"{prefix}.conv_in", net.conv_in, batch, h, w, dtype))
            for r, blk in enumerate(net.blocks):
                ops += _block_convs(f"{prefix}.blocks.{r}", blk, batch, h, w, dtype,
                                    default_lowering)
            ops.append(_conv(f"{prefix}.head", net.head, batch, h, w, dtype))
    if not train:
        return ops
    backward = []
    for op in ops:
        # the first coupling reads the data: nothing needs its input gradient
        if not (op.name.startswith("couplings.0.") and op.name.endswith(".conv_in")):
            backward.append(dataclasses.replace(op, name=op.name + ".grad_input"))
        backward.append(dataclasses.replace(op, name=op.name + ".grad_weight"))
    return ops + backward


def roofline_statics(model, batch: int, device_kind: str, *, train: bool = False) -> dict:
    """The counted half of the roofline, with no measured time: a pure
    function of the model, the batch and the device kind (JAX's keys)."""
    convs = model_convs(model, batch, train=train)
    conv_flops = sum(c.flops for c in convs)
    conv_bytes = sum(c.bytes for c in convs)
    report = {
        "device_kind": device_kind,
        "conv_ops": len(convs),
        "conv_flops": conv_flops,
        "conv_bytes": conv_bytes,
        "default_lowering_conv_flops": sum(
            c.flops for c in model_convs(model, batch, train=train, default_lowering=True)),
        # the port counts convolutions only (module docstring)
        "total_flops": conv_flops,
        "total_bytes": conv_bytes,
    }
    peaks = device_peaks(device_kind)
    if peaks is None:
        report["note"] = "unknown device kind: no peak table entry"
        return report
    if not peaks_validated(device_kind):
        report["note"] = (
            "peak-table row for this device kind is a spec-sheet constant "
            "not yet cross-checked by a measurement in this repo"
        )
    peak_flops, hbm_bw = peaks
    conv_bound = sum(max(c.flops / peak_flops, c.bytes / hbm_bw) for c in convs)
    report.update(
        peak_bf16_flops=peak_flops,
        hbm_bytes_per_sec=hbm_bw,
        conv_bound_seconds=conv_bound,
        rest_bound_seconds=0.0,
        roofline_lower_bound_seconds=conv_bound,
        conv_ops_memory_bound=sum(1 for c in convs if c.bytes / hbm_bw > c.flops / peak_flops),
    )
    return report


def roofline_from_statics(statics: dict, measured_step_seconds: Optional[float],
                          batch: Optional[int] = None) -> dict:
    """:func:`roofline_statics` with a measured step time: ``mfu`` (from
    the default lowering's conv FLOPs), ``conv_hbm_utilization``,
    ``fraction_of_roofline`` = bound / measured and, with ``batch``,
    ``bound_samples_per_sec``."""
    report = dict(statics)
    bound_s = report.get("roofline_lower_bound_seconds")
    peak_flops = report.get("peak_bf16_flops")
    hbm_bw = report.get("hbm_bytes_per_sec")
    if measured_step_seconds and bound_s is not None:
        report["measured_step_seconds"] = measured_step_seconds
        report["mfu"] = report["default_lowering_conv_flops"] / measured_step_seconds / peak_flops
        report["conv_hbm_utilization"] = report["conv_bytes"] / measured_step_seconds / hbm_bw
        report["fraction_of_roofline"] = bound_s / measured_step_seconds
        if batch:
            report["bound_samples_per_sec"] = batch / bound_s
    return report


def roofline_report(model, batch: int, measured_step_seconds: Optional[float],
                    device_kind: str, *, train: bool = False) -> dict:
    """The conv roofline of ``model``'s forward pass (``train``: a train
    step) at ``batch`` beside a measured time on ``device_kind`` (e.g.
    ``torch.cuda.get_device_name()``)."""
    return roofline_from_statics(
        roofline_statics(model, batch, device_kind, train=train), measured_step_seconds, batch)
