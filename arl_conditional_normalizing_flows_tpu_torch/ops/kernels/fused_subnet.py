"""A coupling subnet's whole conv chain as one Hopper kernel.

Replaces the Pallas TPU kernel of the JAX package's
``ops/pallas/fused_subnet.py``: ``_build_pallas_fn`` (body ``subnet_math``),
reached by ``subnet_apply_pallas``. For ``x`` (B, h, w, cin) float32 it
computes the subnet's pre-tanh head (B, h, w, out_total) float32: an entry
k x k conv, ``res_blocks`` dilated grouped residual blocks, LeakyReLU and a
k x k head, with a float32 trunk, ``compute_dtype`` product operands, float32
sums and float32 biases. The CUDA source is ``csrc/fused_subnet.cu``, built
by ``build.py``.

Bound on an H100: operations. At the flagship (batch 128, 16 launches a
pass over four specs) a pass needs 50.4 GFLOP of grouped products, 51 us at
989 TFLOP/s in bf16, against ~1.3 MB of inputs and outputs per launch
(0.4 us at 3.35 TB/s). The design: one block per sample, the stage input in
shared memory, the float32 trunk in an L2-resident scratch tensor, grouped
convs computed grouped (the TPU kernel's block-diagonal expansion would be
4x the work), and each branch output multiplied straight into the post-1x1
so that no branch output reaches device memory. This first kernel runs the
products as float32 FMAs on CUDA cores; the tensor cores are a later PR's.

Weights are packed once per parameter version (:func:`pack`): every kernel,
in ``flax_param_order``'s order and flax's HWIO layout, in one
``compute_dtype`` buffer, and every bias in one float32 buffer.

Dispatch: a CPU tensor goes to the plain version :func:`subnet_apply_reference`;
a CUDA tensor launches the kernel or raises. :func:`subnet_apply` counts its
launches in :data:`LAUNCHES`. The kernel has no backward yet, so a CUDA call
that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"fused_subnet": 0}

LEAKY_SLOPE = 0.3

# launch limits, mirrored from csrc/fused_subnet.cu
THREADS = 512
TILE = 32
MAX_BRANCHES = 4
MAX_SHARED_BYTES = 232448
MAX_THREADS = 1024  # threads a block may have on the card
_INT_MAX = 2**31 - 1
_DTYPE_CODE = {"float32": 0, "bfloat16": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class SubnetSpec:
    """Static facts of one coupling subnet (the JAX ``SubnetSpec`` without
    the TPU's ``batch_tile``): layer norm off, default group semantics."""

    h: int
    w: int
    cin: int
    kernels: int  # trunk width K
    res_blocks: int
    cardinality: int
    ksize: int
    dilations: Tuple[int, ...]
    out_total: int  # out_channels * n_heads
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.compute_dtype not in _DTYPE_CODE:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: float32 or bfloat16")
        # cardinality 1 (a dense branch over the whole trunk) never comes from
        # a config: ConvFlowConfig asserts an even cardinality
        if self.cardinality < 2:
            raise ValueError(f"cardinality {self.cardinality}: the chain takes 2 or more")
        for d in self.dilations:
            if d < 1 or self.kernels % d or (self.kernels // d) % self.cardinality:
                raise ValueError(f"dilation {d}: K/d must split into {self.cardinality} groups")

    @property
    def widths(self) -> Tuple[int, ...]:
        return tuple(self.kernels // d for d in self.dilations)

    @property
    def groups(self) -> Tuple[int, ...]:
        """Input (and output) channels of one group, per branch."""
        return tuple(w_ // self.cardinality for w_ in self.widths)


def flax_param_order(spec: SubnetSpec) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """(flax param path, shape) of each weight of the chain, in the JAX
    ``flax_param_order``'s order: ``Conv_0`` entry; per block
    ``DilatedResidualBlock_r/{Conv_0 pre-1x1, Conv_1.. branches, Conv_{1+nd}
    post-1x1}``; ``Conv_1`` head."""
    k, K = spec.ksize, spec.kernels
    out = [("Conv_0/kernel", (k, k, spec.cin, K)), ("Conv_0/bias", (K,))]
    nd = len(spec.dilations)
    for r in range(spec.res_blocks):
        blk = f"DilatedResidualBlock_{r}"
        out.append((f"{blk}/Conv_0/kernel", (1, 1, K, K)))
        out.append((f"{blk}/Conv_0/bias", (K,)))
        for i, (w_, g) in enumerate(zip(spec.widths, spec.groups)):
            out.append((f"{blk}/Conv_{1 + i}/kernel", (k, k, g, w_)))
            out.append((f"{blk}/Conv_{1 + i}/bias", (w_,)))
        out.append((f"{blk}/Conv_{1 + nd}/kernel", (1, 1, sum(spec.widths), K)))
        out.append((f"{blk}/Conv_{1 + nd}/bias", (K,)))
    out.append(("Conv_1/kernel", (k, k, K, spec.out_total)))
    out.append(("Conv_1/bias", (spec.out_total,)))
    return tuple(out)


def pack(spec: SubnetSpec, flat):
    """``(weights, biases)``: the tensors of ``flat`` (flax shapes, in
    :func:`flax_param_order`'s order) packed for the kernel — every kernel
    flattened into one ``compute_dtype`` buffer, every bias into one float32
    buffer. Differentiable."""
    order = flax_param_order(spec)
    if len(flat) != len(order):
        raise ValueError(f"expected {len(order)} tensors, got {len(flat)}")
    kernels, biases = [], []
    for (name, shape), t in zip(order, flat):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        (kernels if name.endswith("kernel") else biases).append(t.reshape(-1))
    dt = getattr(torch, spec.compute_dtype)
    return torch.cat(kernels).to(dt), torch.cat(biases).float()


def unpack(spec: SubnetSpec, packed):
    """Inverse of :func:`pack`: views of the packed buffers with the flax
    shapes, in :func:`flax_param_order`'s order."""
    weights, biases = packed
    out, offsets = [], {True: 0, False: 0}
    for name, shape in flax_param_order(spec):
        is_kernel = name.endswith("kernel")
        buf, n = (weights if is_kernel else biases), math.prod(shape)
        out.append(buf[offsets[is_kernel]: offsets[is_kernel] + n].view(shape))
        offsets[is_kernel] += n
    return out


def packed_sizes(spec: SubnetSpec) -> Tuple[int, int]:
    """Elements of :func:`pack`'s two buffers: (kernels, biases)."""
    sizes = {True: 0, False: 0}
    for name, shape in flax_param_order(spec):
        sizes[name.endswith("kernel")] += math.prod(shape)
    return sizes[True], sizes[False]


def flops(spec: SubnetSpec, batch: int) -> int:
    """Operations of one call (2 per multiply-add), grouped convs counted
    grouped."""
    k2, K = spec.ksize ** 2, spec.kernels
    block = K * K + sum(k2 * g * w_ for g, w_ in zip(spec.groups, spec.widths)) \
        + sum(spec.widths) * K
    per_pixel = k2 * spec.cin * K + spec.res_blocks * block + k2 * K * spec.out_total
    return 2 * batch * spec.h * spec.w * per_pixel


def io_bytes(spec: SubnetSpec, batch: int) -> int:
    """Bytes one call must move: x, the packed weights and biases read once,
    the head written once."""
    n_w, n_b = packed_sizes(spec)
    item = getattr(torch, spec.compute_dtype).itemsize
    pixels = batch * spec.h * spec.w
    return 4 * pixels * (spec.cin + spec.out_total) + item * n_w + 4 * n_b


# ---------------------------------------------------------------------------
# plain version (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------


def _lrelu(v):
    return torch.where(v > 0, v, LEAKY_SLOPE * v)


def subnet_apply_reference(spec: SubnetSpec, x, packed):
    """Plain version of the chain (the JAX ``subnet_math``): every product's
    operands rounded to ``compute_dtype``, then multiplied and summed in
    float32; the trunk and biases in float32. ``x`` (B, h, w, cin); returns
    (B, h, w, out_total) float32."""
    dt = getattr(torch, spec.compute_dtype)
    it = iter(unpack(spec, packed))

    def r(t):  # round to the compute dtype, compute in float32
        return t.to(dt).float()

    def conv(t, hwio, dil=1, groups=1):
        """SAME conv of NHWC ``t`` (already rounded): total pad dil*(k-1),
        total//2 low and the rest high."""
        total = dil * (hwio.shape[0] - 1)
        lo = total // 2
        xp = F.pad(t.permute(0, 3, 1, 2), (lo, total - lo, lo, total - lo))
        w = hwio.float().permute(3, 2, 0, 1)
        return F.conv2d(xp, w, dilation=dil, groups=groups).permute(0, 2, 3, 1)

    entry_w, entry_b = next(it), next(it)
    y = conv(r(x), entry_w) + entry_b
    for _ in range(spec.res_blocks):
        pre_w, pre_b = next(it), next(it)
        t = r(_lrelu(r(_lrelu(y)) @ pre_w[0, 0].float() + pre_b))
        branches = [(next(it), next(it)) for _ in spec.dilations]
        post_w, post_b = next(it), next(it)
        u, row = None, 0
        for (bw, bb), d, w_ in zip(branches, spec.dilations, spec.widths):
            s = r(_lrelu(conv(t[..., :w_], bw, d, spec.cardinality) + bb))
            c = s @ post_w[0, 0, row: row + w_].float()
            u = c if u is None else u + c
            row += w_
        y = y + u + post_b
    head_w, head_b = next(it), next(it)
    return conv(r(_lrelu(y)), head_w) + head_b


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------


@functools.cache
def _library():
    lib = build.load_libraries("fused_subnet")["fused_subnet"]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_subnet_forward.argtypes = [p] * 5 + [i] * 15 + [p]
    lib.fused_subnet_forward.restype = i
    return lib


def shared_bytes(spec: SubnetSpec) -> int:
    """Dynamic shared memory of one block: the stage input in the compute
    dtype (16-byte aligned), then a tile of float32 rows."""
    item = getattr(torch, spec.compute_dtype).itemsize
    act = spec.h * spec.w * max(spec.cin, spec.kernels) * item
    return (act + 15) // 16 * 16 + TILE * max(sum(spec.widths), spec.kernels) * 4


def check_launch(spec: SubnetSpec, batch: int) -> None:
    """Raise ``ValueError``, before any launch, on what the kernel cannot be
    launched with: too many threads or branches, too much shared memory,
    sizes past int32."""
    if THREADS > MAX_THREADS:
        raise ValueError(f"{THREADS} threads a block > {MAX_THREADS}")
    if len(spec.dilations) > MAX_BRANCHES:
        raise ValueError(f"{len(spec.dilations)} dilations: the kernel takes at most "
                         f"{MAX_BRANCHES}")
    if shared_bytes(spec) > MAX_SHARED_BYTES:
        raise ValueError(f"shared memory {shared_bytes(spec)} bytes > {MAX_SHARED_BYTES} "
                         f"for {spec}")
    pixels = spec.h * spec.w
    n_weights = sum(packed_sizes(spec))
    widest = max(spec.kernels, spec.cin, spec.out_total, sum(spec.widths))
    if not 0 < batch <= _INT_MAX or pixels * widest > _INT_MAX or n_weights > _INT_MAX:
        raise ValueError(f"sizes past int32: batch {batch}, {spec}")


def _check_cuda(spec: SubnetSpec, x, weights, biases) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_subnet: no kernel for device {x.device}")
    if weights.device != x.device or biases.device != x.device:
        raise ValueError("fused_subnet: x and the packed weights lie on different devices")
    if x.shape[1:] != (spec.h, spec.w, spec.cin) or x.dim() != 4:
        raise ValueError(f"fused_subnet: x {tuple(x.shape)} is not (B, {spec.h}, "
                         f"{spec.w}, {spec.cin})")
    dt = getattr(torch, spec.compute_dtype)
    if x.dtype != torch.float32 or weights.dtype != dt or biases.dtype != torch.float32:
        raise ValueError(f"fused_subnet: need float32 x and biases, {dt} weights; got "
                         f"{x.dtype}, {biases.dtype}, {weights.dtype}")
    n_w, n_b = packed_sizes(spec)
    if weights.shape != (n_w,) or biases.shape != (n_b,):
        raise ValueError(f"fused_subnet: packed sizes {tuple(weights.shape)}, "
                         f"{tuple(biases.shape)} != ({n_w},), ({n_b},)")
    if not (x.is_contiguous() and weights.is_contiguous() and biases.is_contiguous()):
        raise ValueError("fused_subnet: inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weights, biases)):
        raise NotImplementedError(
            "fused_subnet: the CUDA kernel has no backward yet (ROADMAP B.5); "
            "call it under torch.no_grad()")
    check_launch(spec, x.shape[0])


def subnet_apply(spec: SubnetSpec, x, packed):
    """The chain's pre-tanh head (B, h, w, out_total) float32 for ``x``
    (B, h, w, cin) float32 and ``packed`` = :func:`pack`'s output."""
    weights, biases = packed
    if {t.device for t in (x, weights, biases)} == {torch.device("cpu")}:
        return subnet_apply_reference(spec, x, packed)
    _check_cuda(spec, x, weights, biases)
    B = x.shape[0]
    trunk = torch.empty(B * spec.h * spec.w * spec.kernels, dtype=torch.float32,
                        device=x.device)
    out = torch.empty(B, spec.h, spec.w, spec.out_total, dtype=torch.float32,
                      device=x.device)
    dil = list(spec.dilations) + [1] * (MAX_BRANCHES - len(spec.dilations))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_subnet_forward(
            x.data_ptr(), weights.data_ptr(), biases.data_ptr(), trunk.data_ptr(),
            out.data_ptr(), B, spec.h, spec.w, spec.cin, spec.kernels, spec.res_blocks,
            spec.cardinality, spec.ksize, len(spec.dilations), *dil, spec.out_total,
            _DTYPE_CODE[spec.compute_dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_subnet kernel launch failed with CUDA error {err}")
    LAUNCHES["fused_subnet"] += 1
    return out
