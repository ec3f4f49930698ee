"""The operations and bytes of the conv flow, counted from its configuration,
and the H100's peaks: the yardstick that the roofline and MFU metrics
divide by.

Frozen copies of the program's counts as they stand when the benchmark was
written, so that a later change to the program cannot move its own
yardstick: the conv count of ``utils/roofline.py::model_convs`` (each conv
``2 B h w cout k k cin/groups`` operations, input + kernel + output bytes at
the compute dtype; a train step adds an input and a weight gradient a conv,
less the input gradient of the first coupling's entry convs), and K3's
``ops/kernels/fused_subnet.py::flops`` and ``io_bytes`` (the chain's grouped
products counted once; x, the weights and biases read once, the head written
once). ``tests/test_cnfbench_counts.py`` holds them equal to the program's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

#: NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, and TF32,
#: the fastest rate at which any float32 product of the program can run
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}
MASK_ORDER = (0, 1, 2, 3)


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    flops: float
    bytes: float


@dataclasses.dataclass(frozen=True)
class Chain:
    """One coupling subnet as K3 runs it (the program's ``SubnetSpec``)."""

    h: int
    w: int
    cin: int
    kernels: int
    res_blocks: int
    cardinality: int
    ksize: int
    dilations: Tuple[int, ...]
    out_total: int
    compute_dtype: str

    @property
    def widths(self):
        return tuple(self.kernels // d for d in self.dilations)

    @property
    def groups(self):
        return tuple(w // self.cardinality for w in self.widths)


def dilation_schedule(shape, ksize):
    """(checkerboard, channel-wise) dilations of a block
    (conv_cINN_make_model.py:1552-1610)."""
    if ksize <= 2:
        return (1,), (1,)
    min_cw = min(shape[0], shape[1])
    min_cb = min_cw / 2
    cb, cw = [], []
    d, dk = 1, ksize
    if dk > (min_cw + 1) / 2:
        return (1,), (1,)
    while dk < (min_cw + 1) / 2:
        cw.append(int(d))
        if d < (min_cb + 1) / 2:
            cb.append(int(d))
        dk = (ksize - 1) * (dk - 1) + 1
        d = (dk - ksize) / (ksize - 1) + 1
    return tuple(cb), tuple(cw)


def chains(cfg: dict) -> List[Tuple[str, Chain]]:
    """(coupling name, chain) of every subnet, in the order they run
    forward; a fused configuration has one ``net_ab`` a coupling, else
    ``net_a`` and ``net_b``."""
    h0, w0, d0 = cfg["io_shape"]
    out, scale, i = [], 1, 0
    sf = cfg["squeeze_factor_blocks"]
    for blk in range(len(sf)):
        if blk > 0 and sf[blk - 1]:
            scale *= 2
        h, w, d = h0 // scale, w0 // scale, d0 * scale
        cb, cw = dilation_schedule((h, w, d), cfg["ksize"]) if cfg["dilations"] else ((1,), (1,))
        for m in MASK_ORDER:
            if m in (0, 1):
                cin, other, hh, ww = 2 * d, 2 * d, h // 2, w // 2
            else:
                cin, other = (-(-d // 2), d // 2) if m == 2 else (d // 2, -(-d // 2))
                hh, ww = h, w
            kernels = cfg["num_kernels"][blk] // 2 if m in (0, 1) else cfg["num_kernels"][blk]
            nets = (("net_ab", 2),) if cfg["fused_subnet"] else (("net_a", 1), ("net_b", 1))
            for net, heads in nets:
                out.append((f"couplings.{i}.{net}", Chain(
                    hh, ww, cin, kernels, cfg["res_blocks"][blk], cfg["cardinality"][blk],
                    cfg["ksize"], cb if m in (0, 1) else cw, other * heads,
                    cfg["compute_dtype"])))
            i += 1
    return out


def _conv(name, batch, h, w, cin, cout, k, cin_per_group, item) -> Conv:
    flops = 2.0 * batch * h * w * cout * k * k * cin_per_group
    nbytes = (batch * h * w * cin + k * k * cin_per_group * cout + batch * h * w * cout) * item
    return Conv(name, flops, float(nbytes))


def model_convs(cfg: dict, batch: int, train: bool = False) -> List[Conv]:
    """The convs of one forward pass at ``batch`` as the default lowering
    runs them; with ``train`` also the backward's."""
    ops = []
    for prefix, c in chains(cfg):
        item = ITEMSIZE[c.compute_dtype]
        k, K = c.ksize, c.kernels
        ops.append(_conv(f"{prefix}.conv_in", batch, c.h, c.w, c.cin, K, k, c.cin, item))
        for r in range(c.res_blocks):
            p = f"{prefix}.blocks.{r}"
            ops.append(_conv(f"{p}.conv_pre", batch, c.h, c.w, K, K, 1, K, item))
            for j, (wd, g) in enumerate(zip(c.widths, c.groups)):
                ops.append(_conv(f"{p}.branches.{j}", batch, c.h, c.w, wd, wd, k, g, item))
            ops.append(_conv(f"{p}.conv_post", batch, c.h, c.w, sum(c.widths), K, 1,
                             sum(c.widths), item))
        ops.append(_conv(f"{prefix}.head", batch, c.h, c.w, K, c.out_total, k, K, item))
    if not train:
        return ops
    backward = []
    for op in ops:
        if not (op.name.startswith("couplings.0.") and op.name.endswith(".conv_in")):
            backward.append(dataclasses.replace(op, name=op.name + ".grad_input"))
        backward.append(dataclasses.replace(op, name=op.name + ".grad_weight"))
    return ops + backward


def chain_flops(c: Chain, batch: int) -> int:
    """K3's operations for one launch (2 a multiply-add), grouped convs
    counted grouped."""
    k2, K = c.ksize ** 2, c.kernels
    block = K * K + sum(k2 * g * w for g, w in zip(c.groups, c.widths)) + sum(c.widths) * K
    per_pixel = k2 * c.cin * K + c.res_blocks * block + k2 * K * c.out_total
    return 2 * batch * c.h * c.w * per_pixel


def chain_bytes(c: Chain, batch: int) -> int:
    """K3's bytes for one launch: x and the head at float32, the kernels at
    the compute dtype and the biases at float32, each once."""
    k2, K = c.ksize ** 2, c.kernels
    n_w = k2 * c.cin * K + c.res_blocks * (
        K * K + sum(k2 * g * w for g, w in zip(c.groups, c.widths)) + sum(c.widths) * K
    ) + k2 * K * c.out_total
    n_b = K + c.res_blocks * (K + sum(c.widths) + K) + c.out_total
    pixels = batch * c.h * c.w
    return 4 * pixels * (c.cin + c.out_total) + ITEMSIZE[c.compute_dtype] * n_w + 4 * n_b


def chain_bound_s(c: Chain, batch: int) -> float:
    """The least time one launch could take on the card."""
    return max(chain_flops(c, batch) / PEAK_FLOPS[c.compute_dtype],
               chain_bytes(c, batch) / HBM_BYTES_PER_S)
