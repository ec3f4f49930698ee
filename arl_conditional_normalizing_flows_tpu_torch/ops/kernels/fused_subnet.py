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
shared memory, and each branch output multiplied straight into the post-1x1
so that no branch output reaches device memory. Every product runs on the
tensor cores (``mma.sync``, each stage an implicit GEMM over 16-pixel tiles,
grouped convs expanded block-diagonally only inside an n8 output tile): in
bf16 one m16n8k16 a k16 chunk, in float32 three m16n8k8 TF32 products a k8
chunk on split operands (``hi = tf32(a)``, ``lo = tf32(a - hi)``; ``lo*hi +
hi*lo + hi*hi`` keeps ~21 bits of each operand, inside the 1e-4 float32 is
held to), on one of two plans that :func:`narrow_plan` picks by the spec:
on chip (the trunk in registers, every weight brought into shared memory by
one bulk copy) or the scratch plan (the trunk in an L2-resident scratch
tensor; in bf16 each stage's weights brought by a bulk copy while the stage
before computes, in float32 streamed through a ring of bulk copies). On an
NVIDIA H100 80GB HBM3 (700 W) the narrow bf16 kernel takes 186.5 us at the
flagship's (128, 28, 28, 1) K 64, 0.058 of its bound, and 14.7-27.7 us at
its three small specs (the source note gives the float32 build's).

Two variants, picked by the spec (:func:`wide`): the narrow kernels above
take up to 4 dilated branches, a trunk up to 64 channels, a head up to 32
and a plan that fits shared memory; the wide variant
(``fused_subnet_forward_wide``) takes any width and size, as JAX's kernel
does. It is written for Hopper in both dtypes (the source note gives what
bounds it and its times): the stage input in shared memory where it fits
beside the ring (:func:`wide_shared_bytes`; else in scratch), the weights
streamed through a ring of :data:`SLOTS` shared slots by ``cp.async.bulk``
in the order of :func:`wide_schedule`, the entry, pre and post 1x1 and head
on ``wgmma`` (N up to 128 a pass), the branch tiles on ``mma.sync`` in
groups of :data:`GROUP_TILES`, their outputs multiplied straight into the
post 1x1, so that the scratch is the trunk alone. In float32 each k8 chunk
is three TF32 ``wgmma`` products on split operands, B's ``lo`` plane split
in shared memory by each warpgroup as its ring piece lands. On an NVIDIA
H100 80GB HBM3 (700 W) the bf16 build takes 820.0 us at the capacity
preset's (128, 28, 28, 1) K 128, 0.052 of its bound, and 182.9 us at (128,
14, 14, 2) K 128; it is latency-bound.

Weights are packed once per parameter version (:func:`pack`), every kernel
into one ``compute_dtype`` buffer and every bias into one float32 buffer.
For the tensor cores each stage is written in their B-fragment order with K
and N zero-padded (:func:`mma_layout`), so the kernel reshuffles nothing; in
float32 the pre and post 1x1s' rows permuted chunk by chunk for the trunk
hand-off (:data:`HANDOFF_ROWS`); for the wide variant each fragment as two
core matrices (:data:`CORE_ORDER`, :data:`TF32_CORE_ORDER`), and each branch
group chunk by chunk (:func:`_wide_order`), at the same offsets; in float32
where its stage input lies in scratch, the k x k stages' rows permuted as
the 1x1s' are (:func:`scratch_pairs`). The layout is derived here only: each
launch hands it to the kernel as a table of ints (:func:`layout_table`),
which the C entry checks and does not derive again.

Dispatch: a CPU tensor goes to the plain version :func:`subnet_apply_reference`;
a CUDA tensor launches the kernel or raises. :func:`subnet_apply` counts its
launches in :data:`LAUNCHES`, and by build in :data:`BUILD_LAUNCHES`.

Gradients: :func:`subnet_apply` is a ``torch.autograd.Function`` over ``x``
and the packed buffers, the counterpart of the JAX ``make_subnet_fn``'s
custom VJP. Its forward always launches the kernel on the card, whether or
not a gradient will flow; no forward falls back to the plain version. Its
backward (:func:`subnet_apply_vjp`) keeps only ``x`` and the packed buffers,
as JAX's ``f_fwd`` keeps ``(x, flat)``, and recomputes the chain with
:func:`subnet_apply_reference` under autograd (cuDNN convs on the card), as
JAX's ``f_bwd`` recomputes it with XLA outside any Pallas kernel. Gradients
reach the flax-shaped weights through :func:`pack`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"fused_subnet": 0}
#: the same launches by the build of the CUDA source that ran them
#: (:func:`kernel_build`)
BUILD_LAUNCHES: dict = {}

LEAKY_SLOPE = 0.3

# launch limits and tile constants, mirrored from csrc/fused_subnet.cu
THREADS = 512
MAX_BRANCHES = 10  # the most dilations ConvFlowConfig's schedule gives (its guard)
NARROW_BRANCHES = 4  # the narrow kernels' most; more take the wide variant
MAX_SHARED_BYTES = 232448
MAX_TRUNK_TILES = 8  # tensor cores: n8 tiles of the trunk (K <= 64)
MAX_HEAD_TILES = 4  # tensor cores: n8 tiles of the head (out_total <= 32)
FRAG = 128  # bf16: elements of one k16 x n8 B fragment (32 lanes x 4)
TF32_FRAG = 64  # tf32: elements of one k8 x n8 B fragment (32 lanes x 2), also 256 bytes
MAX_TABLE_VALUE = 2**30  # the largest int of layout_table the C entry takes
TABLE_SCALARS = 29  # the scalars that open layout_table (TABLE_FIELDS)
PLAN_HEAD = 672  # narrow kernels: their mbarriers and the branch walks' tap table
CHIP_SMALL_TILES = 4  # narrow, on chip: trunk n8 tiles of the build sized to small trunks
WIDE_GROUPS = 4  # wide: warpgroups a block
WIDE_THREADS = 512  # wide: threads a block
SLOT_BYTES = 4096  # wide bf16 and the tf32 scratch plan: a slot of a ring, 16 fragments
TF32_SLOT_BYTES = 8192  # wide tf32: a slot of its ring, 32 fragments (two k8 chunks of a pass)
SLOTS = 4  # wide: slots of the ring
BARRIER_BYTES = 64  # wide: a full mbarrier and a counter a slot
SLACK_BYTES = 2048  # wide: shared memory past the ring (or a lo plane) that wgmma may over-read
GROUP_TILES = 8  # wide: branch tiles that share a walk over the chunks
PASS_TILES = 16  # wide: n8 tiles of one wgmma (N <= 128)
MAX_THREADS = 1024  # threads a block may have on the card
_INT_MAX = 2**31 - 1
_DTYPE_CODE = {"float32": 0, "bfloat16": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BUILD_LAUNCHES.clear()


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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _bank_stride(c: int, item: int) -> int:
    """A shared-memory row stride of ``c`` channels (a multiple of 8) of
    ``item`` bytes each: an odd number of 16-byte units, so that the rows of
    8 consecutive pixels that ldmatrix reads fall on distinct banks."""
    if item == 4:
        return c + 4
    return c + 8 if (c // 8) % 2 == 0 else c


def _slices(spec: SubnetSpec) -> int:
    """8-channel slices a k chunk: two in bf16 (m16n8k16), one in tf32
    (m16n8k8)."""
    return 2 if spec.compute_dtype == "bfloat16" else 1


def _frag(spec: SubnetSpec) -> int:
    """Elements of one B fragment: :data:`FRAG` in bf16, :data:`TF32_FRAG`
    in float32 (256 bytes either way)."""
    return FRAG if spec.compute_dtype == "bfloat16" else TF32_FRAG


def _item(spec: SubnetSpec) -> int:
    return 2 if spec.compute_dtype == "bfloat16" else 4


@dataclasses.dataclass(frozen=True)
class BranchTile:
    """One n8 output tile of a branch in the tensor-core kernels: columns
    ``[c0, c0 + 8)`` of branch ``branch``, reading the input window of
    ``q`` 8-channel slices per tap from channel ``lo8`` (``q`` and
    ``chunks`` are the same for every tile of a branch)."""

    branch: int
    c0: int
    dil: int
    lo8: int
    q: int
    chunks: int  # k chunks: two slices each in bf16 (k16), one in tf32 (k8)
    w_off: int  # offsets within a residual block's weights and biases
    b_off: int


@dataclasses.dataclass(frozen=True)
class MmaLayout:
    """The tensor-core kernels' tiling and packing, its one source: the C
    entry takes it as :func:`layout_table` and checks it. Weights: every
    stage as ``[k chunk][n8 tile][lane][values]`` B fragments — in bf16 k16
    chunks, :data:`FRAG` elements each (4 a lane), in float32 k8 chunks,
    :data:`TF32_FRAG` each (2 a lane) — the entry, then per residual block
    the pre 1x1, each branch tile in order, the post 1x1; then the head.
    Biases: each stage's padded to its n8 tiles. Offsets count elements of
    the compute dtype."""

    kp: int  # trunk width K padded to 8
    nt: int  # n8 tiles of the trunk
    no: int  # n8 tiles of the head
    xs: int  # row strides (elements) of x and t in shared memory
    ts: int
    qx: int  # x's 8-channel slices per tap
    n_mt: int  # 16-pixel tiles of a sample
    ch_entry: int
    ch_pre: int
    ch_post: int
    ch_head: int
    tiles: Tuple[BranchTile, ...]
    w_block0: int
    w_block: int
    w_post: int
    w_head: int
    b_block0: int
    b_block: int
    b_post: int
    b_head: int
    w_total: int
    b_total: int
    trunk_per_sample: int  # float32 scratch elements a sample
    act_bytes: int  # shared memory of the stage input and a row of zeros
    w_stage: int  # weights of the largest stage (entry, a residual block, head)
    act_in_shared: int  # 1 where the wide variant holds the stage input in shared memory
    wide_shared: int  # the wide variant's dynamic shared memory a block
    n_pieces: int = 0  # pieces of one round of every stage of a ring (:func:`wide_schedule`)
    on_chip: int = 0  # 1: :func:`narrow_plan` puts the narrow kernel on chip

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)


def _wide_plan(act_bytes: int, item: int) -> Tuple[int, int]:
    """(act_in_shared, wide_shared) of the wide kernel whose weights have
    ``item`` bytes an element: the ring's barriers, the ring of weights
    (:data:`SLOTS` slots of :data:`SLOT_BYTES`, in float32 of
    :data:`TF32_SLOT_BYTES`), in float32 (tf32 products) each warpgroup's two
    lo planes of the pieces it multiplies (a slot's bytes each, taken by
    turns), then the stage input where it fits beside them (else it lives in
    scratch), at least :data:`SLACK_BYTES` past the ring or the planes either
    way."""
    if item == 4:
        ring = (SLOTS + 2 * WIDE_GROUPS) * TF32_SLOT_BYTES + BARRIER_BYTES
    else:
        ring = SLOTS * SLOT_BYTES + BARRIER_BYTES
    with_act = ring + max(act_bytes, SLACK_BYTES)
    if with_act <= MAX_SHARED_BYTES:
        return 1, with_act
    return 0, ring + SLACK_BYTES


def _split_tiles(n_mt: int, ch_post: int) -> int:
    """The scratch plan's split tiles (the C source's ``split_tiles``): its
    last round of 16-pixel tiles over the warps where that is one or two
    tiles whose chunks of the post 1x1 (k16 in bf16, k8 in float32) are at
    most a warp each, else 0."""
    warps = THREADS // 32
    tail = n_mt % warps
    return tail if tail <= 2 and tail * ch_post <= warps else 0


def _narrow_plan(n_mt: int, w_total: int, b_total: int, act_bytes: int, w_stage: int,
                 x_bytes: int, shares: int, item: int) -> Tuple[int, int, int]:
    """(on_chip, threads, shared bytes) of the narrow tensor-core kernel
    whose weights have ``item`` bytes an element, as the C source's
    ``narrow_plan``, from which the C entry launches (the layout table
    carries ``on_chip`` alone, which the entry checks). On chip where a warp
    a 16-pixel tile fits a block and the barriers, the branch walks' tap
    table, the biases, the whole packing and two stage inputs fit shared
    memory; else the scratch plan of :data:`THREADS` threads. In bf16 its
    head as on chip, then x (then, in its room, the split tiles' ``shares``
    bytes), the stage input and two stage buffers of weights. In float32
    (tf32 products) a ring's barriers, the plan head, the stage input and
    the ring of :data:`SLOTS` slots; its biases stay in device memory."""
    head = PLAN_HEAD + 4 * b_total
    chip = head + item * w_total + 2 * act_bytes
    if n_mt <= THREADS // 32 and chip <= MAX_SHARED_BYTES:
        return 1, 32 * n_mt, chip
    if item == 4:
        return 0, THREADS, BARRIER_BYTES + PLAN_HEAD + act_bytes + SLOTS * SLOT_BYTES
    return 0, THREADS, head + max(x_bytes, shares) + act_bytes + 4 * w_stage


@dataclasses.dataclass(frozen=True)
class NarrowPlan:
    """How the narrow tensor-core kernel runs a spec (:func:`narrow_plan`)."""

    on_chip: bool  # the trunk in registers, no scratch, one load of every weight
    threads: int  # threads a block (one sample a block)
    shared: int  # dynamic shared memory a block, in bytes
    split_tiles: int = 0  # scratch plan: last-round tiles split across warps


def narrow_plan(spec: SubnetSpec) -> NarrowPlan:
    """The narrow tensor-core kernel's plan for ``spec``, picked by its
    sizes alone and mirrored by the C entry, which launches it. In bf16:

    *On chip* (a sample of at most 16 pixel tiles whose whole packing and two
    stage inputs fit shared memory: the flagship's three small specs): a
    warp a 16-pixel tile, its trunk in registers for the whole chain, every
    stage's weights brought by one bulk copy (TMA) at the start, while x is
    converted, and the stage input in two buffers by turns, so that one
    block barrier a stage is enough. No scratch.

    *Scratch* (the rest, the flagship's 28 x 28 among them): :data:`THREADS`
    threads, a 16-pixel tile a warp in the residual blocks (two in the entry
    and the head; two in the blocks spill registers), the float32
    trunk in the scratch tensor, x and the stage input in shared memory, and
    the weights in two stage buffers, the next stage's brought by a bulk copy
    while the running one computes. The one or two tiles of the last round of
    warps (``split_tiles``: 49 = 3 x 16 + 1 at 28 x 28) are split across
    warps in the residual blocks, a k16 chunk of the post 1x1 each, their
    shares added in chunk order. A residual block is one phase: each
    tile's post 1x1 is followed by the next block's pre 1x1 while the trunk
    is in registers, its output written to a scratch copy of the stage input
    that one bulk copy brings in after the block's barrier.

    In float32 (three TF32 products a k8 chunk) the same two plans, sized
    for float32: on chip as in bf16 (the flagship's three small specs); the
    scratch plan (its 28 x 28) with the stage input in shared memory and the
    weights streamed through a ring of :data:`SLOTS` bulk copies in the
    order of :func:`wide_schedule`, a 16-pixel tile a warp a round in every
    phase, the residual blocks' last round split as in bf16 (a branch tile
    and its post 1x1 chunk a warp, the shares in the scratch); the block's
    first pre 1x1 goes through the scratch copy like the others (x has no
    buffer of its own)."""
    L = mma_layout(spec)
    on_chip, threads, shared = _narrow_plan(*_plan_sizes(spec, L))
    return NarrowPlan(bool(on_chip), threads, shared,
                      0 if on_chip else _split_tiles(L.n_mt, L.ch_post))


def _plan_sizes(spec: SubnetSpec, L: MmaLayout) -> Tuple[int, ...]:
    """:func:`_narrow_plan`'s arguments for ``spec`` of layout ``L``."""
    item = _item(spec)
    return (L.n_mt, L.w_total, L.b_total, L.act_bytes, L.w_stage,
            _ceil(spec.h * spec.w * L.xs * item, 16) * 16,
            _split_tiles(L.n_mt, L.ch_post) * L.ch_post * L.nt * 512, item)


@functools.lru_cache(maxsize=None)
def mma_layout(spec: SubnetSpec) -> MmaLayout:
    """The tensor-core kernels' layout of ``spec`` (its compute dtype's)."""
    kk, K = spec.ksize ** 2, spec.kernels
    S, frag, item = _slices(spec), _frag(spec), _item(spec)
    kp = _ceil(K, 8) * 8
    nt, no, qx = kp // 8, _ceil(spec.out_total, 8), _ceil(spec.cin, 8)
    ch_pre = _ceil(nt, S)
    wb, bb = ch_pre * nt * frag, kp  # the pre 1x1 opens each block
    tiles = []
    for i, (w_, g, dil) in enumerate(zip(spec.widths, spec.groups, spec.dilations)):
        # every tile of a branch takes the widest window's slices per tap, its
        # window moved left where it would pass the row's end
        windows = [(c0 // g * g // 8 * 8, (min(c0 + 8, w_) - 1) // g * g + g)
                   for c0 in range(0, w_, 8)]
        q = max(_ceil(hi - lo8, 8) for lo8, hi in windows)
        chunks = _ceil(kk * q, S)
        for c0, (lo8, _) in zip(range(0, w_, 8), windows):
            tiles.append(BranchTile(i, c0, dil, min(lo8, kp - 8 * q), q, chunks, wb, bb))
            wb, bb = wb + chunks * frag, bb + 8
    ch_post = _ceil(len(tiles), S)
    w_post, b_post = wb, bb
    wb, bb = wb + ch_post * nt * frag, bb + kp
    ch_entry, ch_head = _ceil(kk * qx, S), _ceil(kk * nt, S)
    w_entry = ch_entry * nt * frag
    w_head = w_entry + spec.res_blocks * wb
    b_head = kp + spec.res_blocks * bb
    xs, ts = _bank_stride(8 * qx, item), _bank_stride(kp, item)
    n_mt = _ceil(spec.h * spec.w, 16)
    w_total = w_head + ch_head * no * frag
    act_bytes = _ceil((spec.h * spec.w + 1) * max(xs, ts) * item, 16) * 16
    act_in_shared, wide_shared = _wide_plan(act_bytes, item)
    L = MmaLayout(
        kp=kp, nt=nt, no=no, xs=xs, ts=ts, qx=qx, n_mt=n_mt, ch_entry=ch_entry,
        ch_pre=ch_pre, ch_post=ch_post, ch_head=ch_head, tiles=tuple(tiles),
        w_block0=w_entry, w_block=wb, w_post=w_post, w_head=w_head, b_block0=kp,
        b_block=bb, b_post=b_post, b_head=b_head,
        w_total=w_total, b_total=b_head + 8 * no, trunk_per_sample=n_mt * 16 * kp,
        act_bytes=act_bytes, w_stage=max(w_entry, wb, w_total - w_head),
        act_in_shared=act_in_shared, wide_shared=wide_shared)
    on_chip, _, shared = _narrow_plan(*_plan_sizes(spec, L))
    return dataclasses.replace(
        L, on_chip=on_chip,
        n_pieces=sum(map(len, _schedule(spec, L, _wide_at(spec, L.nt, L.no, shared)))))


#: the scalars of :func:`layout_table`, in the order the C entry reads them
#: (``read_mma_layout`` in ``csrc/fused_subnet.cu``)
TABLE_FIELDS = ("kp", "nt", "no", "xs", "ts", "qx", "n_mt", "ch_entry", "ch_pre", "ch_post",
                "ch_head", "n_tiles", "w_block0", "w_block", "w_post", "w_head", "w_total",
                "b_block0", "b_block", "b_post", "b_head", "b_total", "trunk_per_sample",
                "act_bytes", "w_stage", "act_in_shared", "wide_shared", "n_pieces",
                "on_chip")
TILE_FIELDS = ("lo8", "q", "chunks", "w_off", "b_off")


def layout_table(spec: SubnetSpec, wide_variant=None):
    """:func:`mma_layout` as the int32 array the C entry reads: the
    :data:`TABLE_FIELDS`, then each of :data:`MAX_BRANCHES` branches' first
    tile and tile count (0, 0 past the last branch), then the
    :data:`TILE_FIELDS` of each tile, then :func:`wide_schedule` of the
    variant (:func:`wide`'s unless ``wide_variant`` says): its stages'
    lengths, then their pieces (``n_pieces`` counts them)."""
    return _layout_table(spec, _variant(spec, wide_variant))


@functools.lru_cache(maxsize=None)
def _layout_table(spec: SubnetSpec, wide_variant: bool):
    values = _table_values(spec, wide_variant)
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=None)
def _table_values(spec: SubnetSpec, wide_variant: bool) -> Tuple[int, ...]:
    """:func:`layout_table`'s values as Python ints (the array would wrap
    one past int32)."""
    L = mma_layout(spec)
    branches = [0, 0] * MAX_BRANCHES
    for t_i, t in enumerate(L.tiles):
        if branches[2 * t.branch + 1] == 0:
            branches[2 * t.branch] = t_i
        branches[2 * t.branch + 1] += 1
    schedule = _schedule(spec, L, wide_variant)
    n_pieces = sum(map(len, schedule))
    return tuple([n_pieces if f == "n_pieces" else getattr(L, f) for f in TABLE_FIELDS]
                 + branches + [getattr(t, f) for t in L.tiles for f in TILE_FIELDS]
                 + [len(stage) for stage in schedule]
                 + [v for stage in schedule for piece in stage for v in piece])


def wide_schedule(spec: SubnetSpec, wide_variant=None):
    """The pieces a ring of weights carries, (element offset in the packed
    weights, bytes) each, in the order the warps take them: one tuple a
    stage of the pieces of one round, which every round takes again; for
    the variant :func:`wide` picks unless ``wide_variant`` says.

    The wide kernel's ring (the C source's ``walk_pieces``, which its entry
    checks this against): the stages are the entry, per residual block the
    pre 1x1 and then the branches with the post 1x1, the head; a round is
    :data:`WIDE_GROUPS` 64-pixel tiles, each pass of up to
    :data:`PASS_TILES` output tiles in turn. A trunk-wide stage is a slot of
    its chunks a piece where a pass takes every tile, else a chunk (k16 in
    bf16 in slots of :data:`SLOT_BYTES`, k8 in float32 in slots of
    :data:`TF32_SLOT_BYTES`: two chunks of a 128-wide pass), a branch group
    a slot of its chunks a piece, the post 1x1 a piece as soon as a pair of
    branch tiles is done (bf16: their k16 chunk; float32: their two k8
    chunks where the pass takes every tile, else a tile's chunk at a time).

    float32 on the narrow kernel: its scratch plan's ring (``ring_walk``
    there): the stages are its phases, the entry with block 0's pre 1x1,
    each residual block (each branch tile's chunks, up to a slot of them a
    piece, and after each pair of tiles their two post 1x1 chunks; then the
    next block's pre 1x1) and the head; a round is a 16-pixel tile a warp;
    a trunk-wide stage is as many k8 chunks a piece as a slot holds. (The
    narrow bf16 kernel has no ring: its table carries the wide one's.)"""
    return _schedule(spec, mma_layout(spec), _variant(spec, wide_variant))


def _schedule(spec: SubnetSpec, L: MmaLayout, wide_variant: bool):
    if spec.compute_dtype != "bfloat16" and not wide_variant:
        return _ring_schedule(spec, L)
    F, S = _frag(spec), _slices(spec)
    frag = 256  # bytes of a B fragment of either product
    slot = (SLOT_BYTES if S == 2 else TF32_SLOT_BYTES) // frag  # fragments a slot holds

    def trunk_stage(w, ch, nts):
        out = []
        for j0 in range(0, nts, PASS_TILES):
            nt = min(PASS_TILES, nts - j0)
            per = slot // nt if nt == nts else 1
            out += [(w + (c0 * nts + j0) * F, min(per, ch - c0) * nt * frag)
                    for c0 in range(0, ch, per)]
        return tuple(out)

    def branch_stage(wb):
        out = []
        for j0 in range(0, L.nt, PASS_TILES):
            nt = min(PASS_TILES, L.nt - j0)

            def post(c, n=1):
                return wb + L.w_post + (c * L.nt + j0) * F, n * nt * frag

            def posts(gt):
                """the post 1x1's pieces once branch tile gt is done: in bf16
                a k16 chunk a pair of tiles; in float32 the k8 chunks of a
                pair where the pass takes every tile (end to end), else one
                a tile"""
                if S == 2:
                    return [post(gt // 2)] if gt % 2 else []
                if nt < L.nt:
                    return [post(gt)]
                return [post(gt - gt % 2, 1 + gt % 2)] if gt % 2 or gt + 1 == L.n_tiles else []

            for g0, ng in branch_groups(L):
                per, chunks, wg = slot // ng, L.tiles[g0].chunks, wb + L.tiles[g0].w_off
                out += [(wg + c0 * ng * F, min(per, chunks - c0) * ng * frag)
                        for c0 in range(0, chunks, per)]
                out += [p for gt in range(g0, g0 + ng) for p in posts(gt)]
            if S == 2 and L.n_tiles % 2:
                out.append(post(L.n_tiles // 2))
        return tuple(out)

    stages = [trunk_stage(0, L.ch_entry, L.nt)]
    for blk in range(spec.res_blocks):
        wb = L.w_block0 + blk * L.w_block
        stages += [trunk_stage(wb, L.ch_pre, L.nt), branch_stage(wb)]
    return tuple(stages + [trunk_stage(L.w_head, L.ch_head, L.no)])


def _ring_schedule(spec: SubnetSpec, L: MmaLayout):
    slot = SLOT_BYTES // (4 * TF32_FRAG)  # fragments a slot

    def chunks(w, ch, nts):
        """ch k8 chunks of nts fragments each from w, a slot of whole chunks a piece"""
        per = max(1, slot // nts)  # past the narrow kernel's tiles no ring runs it
        return [(w + c0 * nts * TF32_FRAG, min(per, ch - c0) * nts * 4 * TF32_FRAG)
                for c0 in range(0, ch, per)]

    R = spec.res_blocks
    stages = [chunks(0, L.ch_entry, L.nt) + (chunks(L.w_block0, L.ch_pre, L.nt) if R else [])]
    for blk in range(R):
        wb = L.w_block0 + blk * L.w_block
        stage = []
        for i, t in enumerate(L.tiles):
            stage += chunks(wb + t.w_off, t.chunks, 1)
            if i % 2 or i + 1 == L.n_tiles:  # the post 1x1's chunks of a pair of tiles
                stage += chunks(wb + L.w_post + (i - i % 2) * L.nt * TF32_FRAG, 1 + i % 2, L.nt)
        if blk + 1 < R:
            stage += chunks(wb + L.w_block, L.ch_pre, L.nt)
        stages.append(stage)
    stages.append(chunks(L.w_head, L.ch_head, L.no))
    return tuple(tuple(st) for st in stages)


def _flat_offsets(spec: SubnetSpec):
    """Offset of each flax param in the flat kernels (or biases), by name."""
    offs, at = {}, {True: 0, False: 0}
    for name, shape in flax_param_order(spec):
        is_kernel = name.endswith("kernel")
        offs[name] = at[is_kernel]
        at[is_kernel] += math.prod(shape)
    return offs


def _fragments(src, S: int = 2):
    """A stage's B matrix of source indices (8 S * chunks, 8 * tiles) in
    fragment order, [chunk][n8 tile][lane][values], t = lane % 4: in bf16
    (S = 2, m16n8k16) 4 values a lane, rows 2t, 2t+1, 2t+8, 2t+9 of column
    lane // 4; in tf32 (S = 1, m16n8k8) 2 values, rows t and t+4."""
    n = 2 * S
    c, j, lane, e = np.meshgrid(np.arange(src.shape[0] // (8 * S)), np.arange(src.shape[1] // 8),
                                np.arange(32), np.arange(n), indexing="ij")
    if S == 2:
        rows = 16 * c + 2 * (lane % 4) + (e & 1) + 8 * (e >> 1)
    else:
        rows = 8 * c + lane % 4 + 4 * e
    return src[rows, 8 * j + lane // 4].reshape(-1)


#: tf32: the row of a k8 chunk of the pre and post 1x1s that holds A's
#: column k. Their A is an accumulator tile as it stands (a lane's columns
#: 2t, 2t+1 of rows g, g+8 are the m16n8k8 A registers of columns t, t+4),
#: so the wrapper permutes the chunk's rows instead: column t holds
#: channel 2t, column t+4 channel 2t+1.
HANDOFF_ROWS = np.array([0, 2, 4, 6, 1, 3, 5, 7])


#: the wide kernel's order of one fragment: position (k half, n, k % 8) of a
#: k16 x n8 B tile, two 8 x 8 core matrices of 8 n rows of 16 bytes (what
#: wgmma and ldmatrix read from shared memory), taken from the m16n8k16 order
#: (lane 4n + k % 8 // 2, value k % 2 + 2 (k half))
_kh, _n, _k8 = np.meshgrid(np.arange(2), np.arange(8), np.arange(8), indexing="ij")
CORE_ORDER = ((4 * _n + _k8 // 2) * 4 + _k8 % 2 + 2 * _kh).reshape(-1)
#: the same in float32: position (k half, n, k % 4) of a k8 x n8 B tile, two
#: core matrices of 8 n rows of 4 floats (tf32 wgmma takes B K-major only),
#: taken from the m16n8k8 tf32 order (lane 4n + k % 4, value k half)
_kh, _n, _k4 = np.meshgrid(np.arange(2), np.arange(8), np.arange(4), indexing="ij")
TF32_CORE_ORDER = ((4 * _n + _k4) * 2 + _kh).reshape(-1)


def branch_groups(L: MmaLayout) -> Tuple[Tuple[int, int], ...]:
    """(first tile, tiles) of each group of the wide kernel's branch tiles:
    each branch's tiles in runs of :data:`GROUP_TILES` from its first."""
    out, t = [], 0
    while t < L.n_tiles:
        end = t
        while end < L.n_tiles and L.tiles[end].branch == L.tiles[t].branch:
            end += 1
        out += [(g0, min(GROUP_TILES, end - g0)) for g0 in range(t, end, GROUP_TILES)]
        t = end
    return tuple(out)


def _wide_order(spec: SubnetSpec):
    """For each element of the wide variant's packing, its position in the
    narrow one: every fragment in :data:`CORE_ORDER` (float32:
    :data:`TF32_CORE_ORDER`), and each branch group's fragments chunk by
    chunk (``[chunk][tile]``, so that a chunk of the whole group is one
    copy) where the narrow packing has them tile by tile. Every offset of
    :func:`mma_layout` holds for both."""
    L, F = mma_layout(spec), _frag(spec)
    core = CORE_ORDER if spec.compute_dtype == "bfloat16" else TF32_CORE_ORDER
    frags = np.arange(L.w_total // F)
    for r in range(spec.res_blocks):
        for g0, ng in branch_groups(L):
            ch = L.tiles[g0].chunks
            base = (L.w_block0 + r * L.w_block + L.tiles[g0].w_off) // F
            c, i = np.meshgrid(np.arange(ch), np.arange(ng), indexing="ij")
            frags[base + (c * ng + i).reshape(-1)] = (base + i * ch + c).reshape(-1)
    return (frags[:, None] * F + core[None, :]).reshape(-1)


@functools.lru_cache(maxsize=None)
def _mma_index(spec: SubnetSpec, wide_variant: bool):
    """For the tensor cores' packing (the wide variant's if
    ``wide_variant``): ``(w_src, b_src, w_inv, b_inv)`` — for each packed
    element the index of the flat flax value it holds, -1 for padding; and
    for each flat value its position in the packing. In tf32 the pre and
    post 1x1s' rows are permuted chunk by chunk (:data:`HANDOFF_ROWS`), and
    so are the k x k stages' where the wide variant reads its stage input
    from scratch (:func:`scratch_pairs`)."""
    L, offs = mma_layout(spec), _flat_offsets(spec)
    k2, K, cin, out = spec.ksize ** 2, spec.kernels, spec.cin, spec.out_total
    S, L_frag = _slices(spec), _frag(spec)
    w_src = np.full(L.w_total, -1, np.int64)
    b_src = np.full(L.b_total, -1, np.int64)

    def stage(rows, cols):
        return np.full((rows, cols), -1, np.int64)

    def fragments(b):
        return _fragments(b, S)

    def handoff(b):
        """b's rows as an accumulator-fed stage takes them"""
        if S == 2:
            return b
        return b.reshape(-1, 8, b.shape[1])[:, HANDOFF_ROWS].reshape(b.shape)

    def gathered(b):
        """b's rows as a k x k stage takes them (:func:`scratch_pairs`)"""
        return handoff(b) if wide_variant and scratch_pairs(spec) else b

    def slices(n_chunks, q):
        """(tap, channel) of each K row of a k x k conv stage, tap k2 past
        the last."""
        r = np.arange(8 * S * n_chunks)
        return r // 8 // q, 8 * (r // 8 % q) + r % 8

    def dense(b, tap, ch, n_ch, n_out, off):
        """rows of b whose (tap, ch) is real take the HWIO kernel at off"""
        ok = (tap < k2) & (ch < n_ch)
        b[ok, :n_out] = off + ((tap[ok] * n_ch + ch[ok]) * n_out)[:, None] + np.arange(n_out)
        return b

    tap, ch = slices(L.ch_entry, L.qx)
    w_src[:L.w_block0] = fragments(gathered(dense(stage(8 * S * L.ch_entry, 8 * L.nt), tap, ch,
                                                  cin, K, offs["Conv_0/kernel"])))
    b_src[:K] = offs["Conv_0/bias"] + np.arange(K)
    nd = len(spec.dilations)
    for r in range(spec.res_blocks):
        blk = f"DilatedResidualBlock_{r}"
        w0, b0 = L.w_block0 + r * L.w_block, L.b_block0 + r * L.b_block
        pre = stage(8 * S * L.ch_pre, 8 * L.nt)
        pre[:K, :K] = offs[f"{blk}/Conv_0/kernel"] + np.arange(K * K).reshape(K, K)
        w_src[w0: w0 + pre.size] = fragments(handoff(pre))
        b_src[b0: b0 + K] = offs[f"{blk}/Conv_0/bias"] + np.arange(K)
        post = stage(8 * S * L.ch_post, 8 * L.nt)
        rows_before = np.cumsum((0,) + spec.widths)
        for i, t in enumerate(L.tiles):
            w_, g = spec.widths[t.branch], spec.groups[t.branch]
            kern = offs[f"{blk}/Conv_{1 + t.branch}/kernel"]
            tap, ch = slices(t.chunks, t.q)
            ch = ch + t.lo8
            col = t.c0 + np.arange(8)
            start = col // g * g
            ok = (tap[:, None] < k2) & (col < w_) & (ch[:, None] >= start) \
                & (ch[:, None] < start + g)
            src = kern + ((tap[:, None] * g + ch[:, None] - start) * w_ + col)
            w_src[w0 + t.w_off: w0 + t.w_off + t.chunks * L_frag] = \
                fragments(gathered(np.where(ok, src, -1)))
            real = col < w_
            b_src[b0 + t.b_off: b0 + t.b_off + 8][real] = \
                offs[f"{blk}/Conv_{1 + t.branch}/bias"] + col[real]
            post[8 * i: 8 * i + 8][real, :K] = offs[f"{blk}/Conv_{1 + nd}/kernel"] \
                + (rows_before[t.branch] + col[real])[:, None] * K + np.arange(K)
        w_src[w0 + L.w_post: w0 + L.w_post + post.size] = fragments(handoff(post))
        b_src[b0 + L.b_post: b0 + L.b_post + K] = offs[f"{blk}/Conv_{1 + nd}/bias"] + np.arange(K)
    tap, ch = slices(L.ch_head, L.nt)
    w_src[L.w_head:] = fragments(gathered(dense(stage(8 * S * L.ch_head, 8 * L.no), tap, ch, K,
                                                out, offs["Conv_1/kernel"])))
    b_src[L.b_head: L.b_head + out] = offs["Conv_1/bias"] + np.arange(out)
    if wide_variant:
        w_src = w_src[_wide_order(spec)]

    n_w, n_b = _flax_sizes(spec)
    invs = []
    for src, n in ((w_src, n_w), (b_src, n_b)):
        real = np.flatnonzero(src >= 0)
        # every flax value lies in exactly one place of the packing
        assert len(real) == n and np.array_equal(np.sort(src[real]), np.arange(n))
        inv = np.empty(n, np.int64)
        inv[src[real]] = real
        invs.append(inv)
    return (torch.from_numpy(w_src), torch.from_numpy(b_src),
            torch.from_numpy(invs[0]), torch.from_numpy(invs[1]))


def scratch_pairs(spec: SubnetSpec) -> bool:
    """Whether the float32 wide variant reads its stage input from scratch
    (it does not fit shared memory: the preset's 28 x 28) as pairs of
    channels: each lane's A values of a k8 chunk, columns t and t + 4 of
    rows g and g + 8, are channels 2t and 2t + 1 of each row, one 8-byte
    load a row, because the packing permutes the rows of every chunk of its
    k x k stages (entry, branches, head) by :data:`HANDOFF_ROWS`, as it does
    the 1x1s' for the trunk hand-off. In shared memory ldmatrix gathers the
    chunk as it stands."""
    return spec.compute_dtype == "float32" and not mma_layout(spec).act_in_shared


@functools.lru_cache(maxsize=None)
def _mma_index_on(spec: SubnetSpec, device: torch.device, wide_variant: bool):
    """:func:`_mma_index` on ``device``, copied there once (so that a CUDA
    graph may capture :func:`unpack`)."""
    return tuple(t.to(device) for t in _mma_index(spec, wide_variant))


def _flax_sizes(spec: SubnetSpec) -> Tuple[int, int]:
    sizes = {True: 0, False: 0}
    for name, shape in flax_param_order(spec):
        sizes[name.endswith("kernel")] += math.prod(shape)
    return sizes[True], sizes[False]


def pack(spec: SubnetSpec, flat, wide_variant=None):
    """``(weights, biases)``: the tensors of ``flat`` (flax shapes, in
    :func:`flax_param_order`'s order) packed for the kernel — every kernel
    into one ``compute_dtype`` buffer, every bias into one float32 buffer;
    in B-fragment order (:func:`mma_layout`), reordered for the wide
    variant (:func:`_wide_order`), the variant :func:`wide` picks unless
    ``wide_variant`` says. Differentiable: the backward is :func:`unpack`."""
    order = flax_param_order(spec)
    if len(flat) != len(order):
        raise ValueError(f"expected {len(order)} tensors, got {len(flat)}")
    return _Pack.apply(spec, _variant(spec, wide_variant), *flat)


def _variant(spec: SubnetSpec, wide_variant) -> bool:
    return wide(spec) if wide_variant is None else bool(wide_variant)


class _Pack(torch.autograd.Function):
    """:func:`pack` with :func:`unpack` as its backward. Every flax value
    lies in exactly one packed slot (:func:`_mma_index` asserts it), so the
    adjoint of the fragment packing's gather is the gather by the inverse
    indices: no scatter-add, and nothing for the padding."""

    @staticmethod
    def forward(ctx, spec, wide_variant, *flat):
        ctx.spec, ctx.wide, ctx.dtypes = spec, wide_variant, [t.dtype for t in flat]
        return _pack(spec, flat, wide_variant)

    @staticmethod
    def backward(ctx, g_w, g_b):
        grads = unpack(ctx.spec, (g_w, g_b), ctx.wide)
        return (None, None, *(g.to(dt) for g, dt in zip(grads, ctx.dtypes)))


def _pack(spec: SubnetSpec, flat, wide_variant: bool):
    order = flax_param_order(spec)
    kernels, biases = [], []
    for (name, shape), t in zip(order, flat):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        (kernels if name.endswith("kernel") else biases).append(t.reshape(-1))
    dt = getattr(torch, spec.compute_dtype)
    kernels, biases = torch.cat(kernels), torch.cat(biases)
    w_src, b_src, _, _ = _mma_index_on(spec, kernels.device, wide_variant)
    kernels = torch.where(w_src >= 0, kernels[w_src.clamp(min=0)], 0)
    biases = torch.where(b_src >= 0, biases[b_src.clamp(min=0)], 0)
    return kernels.to(dt), biases.float()


def unpack(spec: SubnetSpec, packed, wide_variant=None):
    """Inverse of :func:`pack` (with the same ``wide_variant``): the weights
    with the flax shapes, in :func:`flax_param_order`'s order (views of the
    buffers in float32)."""
    weights, biases = packed
    _, _, w_inv, b_inv = _mma_index_on(spec, weights.device, _variant(spec, wide_variant))
    weights, biases = weights[w_inv], biases[b_inv]
    out, offsets = [], {True: 0, False: 0}
    for name, shape in flax_param_order(spec):
        is_kernel = name.endswith("kernel")
        buf, n = (weights if is_kernel else biases), math.prod(shape)
        out.append(buf[offsets[is_kernel]: offsets[is_kernel] + n].view(shape))
        offsets[is_kernel] += n
    return out


def packed_sizes(spec: SubnetSpec) -> Tuple[int, int]:
    """Elements of :func:`pack`'s two buffers, (kernels, biases): the
    layout's, the same for both variants."""
    L = mma_layout(spec)
    return L.w_total, L.b_total


def shared_bytes(spec: SubnetSpec) -> int:
    """Dynamic shared memory of one block of the narrow kernel,
    :func:`narrow_plan`'s (the wide variant's is :func:`wide_shared_bytes`)."""
    return narrow_plan(spec).shared


def wide_shared_bytes(spec: SubnetSpec) -> int:
    """Dynamic shared memory of one block of the wide variant: the ring of
    weights, its barriers, in float32 the warpgroups' lo planes and, where
    it fits, the stage input (``MmaLayout.wide_shared``)."""
    return mma_layout(spec).wide_shared


def wide(spec: SubnetSpec) -> bool:
    """Whether ``spec`` takes the wide variant, a Hopper kernel of its own
    in either dtype (wgmma, the weights through a ring): more than
    :data:`NARROW_BRANCHES` dilations, a trunk over ``8 * MAX_TRUNK_TILES``
    or head over ``8 * MAX_HEAD_TILES`` channels, or a narrow plan's shared
    memory past :data:`MAX_SHARED_BYTES`. Every other spec runs the narrow
    tensor-core kernel of its dtype. Decided by the spec alone."""
    L = mma_layout(spec)
    return _wide_at(spec, L.nt, L.no, narrow_plan(spec).shared)


def _wide_at(spec: SubnetSpec, nt: int, no: int, narrow_shared: int) -> bool:
    """:func:`wide` from the layout's trunk and head tiles and the narrow
    plan's shared bytes (what :func:`mma_layout` knows before it is made)."""
    return (len(spec.dilations) > NARROW_BRANCHES or nt > MAX_TRUNK_TILES
            or no > MAX_HEAD_TILES or narrow_shared > MAX_SHARED_BYTES)


@functools.lru_cache(maxsize=None)
def kernel_build(spec: SubnetSpec) -> str:
    """The build of ``csrc/fused_subnet.cu`` that a launch at ``spec``
    runs: the narrow tensor-core kernel's plan (``"bf16 on chip"``,
    ``"tf32 scratch"``, ...) or the wide variant (``"bf16 wide"``,
    ``"tf32 wide"``)."""
    prod = "bf16" if spec.compute_dtype == "bfloat16" else "tf32"
    if wide(spec):
        return f"{prod} wide"
    return f"{prod} {'on chip' if narrow_plan(spec).on_chip else 'scratch'}"


def scratch_per_sample(spec: SubnetSpec, wide_variant: bool) -> int:
    """float32 scratch elements a sample: the trunk (none in the narrow
    kernel's on-chip plan), in its scratch plan then a copy of the next
    stage input in the compute dtype and, in float32, the split tiles'
    shares of the post 1x1 (``narrow_scratch`` in the CUDA source); in the
    wide variant then the stage input where it does not fit shared memory
    (``wide_scratch`` there)."""
    L = mma_layout(spec)
    if not wide_variant:  # the trunk, then the next stage input's rows, then the shares
        if L.on_chip:
            return 0
        shares = 128 * _split_tiles(L.n_mt, L.ch_post) * L.ch_post * L.nt \
            if _item(spec) == 4 else 0
        return L.trunk_per_sample + spec.h * spec.w * L.ts * _item(spec) // 4 + shares
    return L.trunk_per_sample + (0 if L.act_in_shared else L.act_bytes // 4)


def trunk_elements(spec: SubnetSpec, batch: int, wide_variant=None) -> int:
    """float32 elements of the kernel's scratch (the trunk, and in the
    wide variant what does not fit shared memory) for ``batch`` samples,
    for the variant :func:`wide` picks unless ``wide_variant`` says."""
    if wide_variant is None:
        wide_variant = wide(spec)
    return batch * scratch_per_sample(spec, wide_variant)


def flops(spec: SubnetSpec, batch: int) -> int:
    """Operations of one call (2 per multiply-add), grouped convs counted
    grouped."""
    k2, K = spec.ksize ** 2, spec.kernels
    block = K * K + sum(k2 * g * w_ for g, w_ in zip(spec.groups, spec.widths)) \
        + sum(spec.widths) * K
    per_pixel = k2 * spec.cin * K + spec.res_blocks * block + k2 * K * spec.out_total
    return 2 * batch * spec.h * spec.w * per_pixel


def mma_flops(spec: SubnetSpec, batch: int) -> int:
    """Operations the narrow kernel issues on the tensor cores in one call:
    :func:`flops` plus the zeros of its padded and block-diagonal tiles,
    three times in float32 (three TF32 products a chunk)."""
    L, S = mma_layout(spec), _slices(spec)
    block = L.ch_pre * L.nt + sum(t.chunks for t in L.tiles) + L.ch_post * L.nt
    mmas = L.ch_entry * L.nt + spec.res_blocks * block + L.ch_head * L.no
    return (1 if S == 2 else 3) * 2 * 16 * 8 * 8 * S * mmas * L.n_mt * batch


def io_bytes(spec: SubnetSpec, batch: int) -> int:
    """Bytes one call must move: x, the weights and biases read once, the
    head written once. The weights are counted as the function needs them
    (grouped, flax's sizes), not with the bf16 packing's padding."""
    n_w, n_b = _flax_sizes(spec)
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
    return chain_math(spec, x, unpack(spec, packed))


def chain_math(spec: SubnetSpec, x, flat):
    """:func:`subnet_apply_reference` on the weights ``flat`` as
    :func:`unpack` gives them (flax shapes, :func:`flax_param_order`'s
    order): the chain that the plain version computes and that
    :func:`subnet_apply_vjp` differentiates."""
    dt = getattr(torch, spec.compute_dtype)
    it = iter(flat)

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


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/fused_subnet.cu``) with its entry points'
    argument types set."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ints = ctypes.POINTER(ctypes.c_int)
    head = [p] * 5 + [i] * 9 + [ints] + [i] * 2 + [ll] * 3 + [ints, i]
    lib.fused_subnet_forward.argtypes = head + [p, p]
    lib.fused_subnet_forward_wide.argtypes = head + [p, p]
    for fn in (lib.fused_subnet_forward, lib.fused_subnet_forward_wide):
        fn.restype = i
    return lib


@functools.cache
def _library():
    return bind_library(build.load_libraries("fused_subnet")["fused_subnet"])


def _layout_table_on(spec: SubnetSpec, device: torch.device, wide_variant=None):
    """:func:`layout_table` (of the variant :func:`wide` picks unless
    ``wide_variant`` says) as an int32 tensor on ``device``, made once (so
    that a CUDA graph may capture the launch), with its schedule written out
    piece by piece (each stage's round once a round): the wide kernel reads
    its branch tiles from it, and it and the tf32 scratch plan find any
    piece of their rings with one load."""
    return _layout_table_tensor(spec, device, _variant(spec, wide_variant))


@functools.lru_cache(maxsize=None)
def _layout_table_tensor(spec: SubnetSpec, device: torch.device, wide_variant: bool):
    L = mma_layout(spec)
    rounds = _ceil(L.n_mt, 4 * WIDE_GROUPS)
    head = list(_table_values(spec, wide_variant)[:TABLE_SCALARS + 2 * MAX_BRANCHES
                                                  + len(TILE_FIELDS) * L.n_tiles])
    pieces = [v for stage in _schedule(spec, L, wide_variant) for _ in range(rounds)
              for piece in stage for v in piece]
    return torch.tensor(head + pieces, dtype=torch.int32, device=device)


def launch_library(lib: ctypes.CDLL, spec: SubnetSpec, x, packed, trunk, out,
                   wide_variant=None) -> None:
    """One launch of ``lib``'s kernel into ``out`` with the scratch
    ``trunk``, on the current stream: :func:`subnet_apply`'s launch without
    its checks or its count (for tools that time altered builds, and tests
    that run the wide variant at a narrow spec); the variant :func:`wide`
    picks unless ``wide_variant`` says. Raises on a CUDA error."""
    weights, biases = packed
    if wide_variant is None:
        wide_variant = wide(spec)
    dil = (ctypes.c_int * len(spec.dilations))(*spec.dilations)
    table = layout_table(spec, wide_variant)
    args = (x.data_ptr(), weights.data_ptr(), biases.data_ptr(), trunk.data_ptr(),
            out.data_ptr(), x.shape[0], spec.h, spec.w, spec.cin, spec.kernels,
            spec.res_blocks, spec.cardinality, spec.ksize, len(spec.dilations), dil,
            spec.out_total, _DTYPE_CODE[spec.compute_dtype], weights.numel(), biases.numel(),
            trunk.numel(), table, len(table))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the rings' schedules: the wide kernel's, the tf32 scratch plan's
        ring = wide_variant or spec.compute_dtype == "float32"
        on_card = _layout_table_on(spec, x.device, wide_variant).data_ptr() if ring else None
        entry = lib.fused_subnet_forward_wide if wide_variant else lib.fused_subnet_forward
        err = entry(*args, on_card, stream)
    if err != 0:
        raise RuntimeError(f"fused_subnet kernel launch failed with CUDA error {err}")


def check_launch(spec: SubnetSpec, batch: int) -> None:
    """Raise ``ValueError``, before any launch, on what the kernel cannot be
    launched with: too many threads or branches, sizes past int32 (the
    tensor-core layout's ints, the packed buffers, a sample's scratch). Any trunk and
    head width and any stage input size is taken: past the narrow kernels'
    limits, by the wide variant."""
    if THREADS > MAX_THREADS:
        raise ValueError(f"{THREADS} threads a block > {MAX_THREADS}")
    if len(spec.dilations) > MAX_BRANCHES:
        raise ValueError(f"{len(spec.dilations)} dilations: the kernel takes at most "
                         f"{MAX_BRANCHES}")
    if max(_table_values(spec, wide(spec))) > MAX_TABLE_VALUE:
        raise ValueError(f"sizes past the tensor-core layout's ints: {spec}")
    pixels = spec.h * spec.w
    n_weights = sum(packed_sizes(spec))
    widest = max(spec.kernels, spec.cin, spec.out_total, sum(spec.widths))
    if (not 0 < batch <= _INT_MAX or pixels * widest > _INT_MAX or n_weights > _INT_MAX
            or scratch_per_sample(spec, wide(spec)) > _INT_MAX):
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
    if weights.data_ptr() % 16 or biases.data_ptr() % 16:
        raise ValueError("fused_subnet: the packed buffers must be 16-byte aligned")
    check_launch(spec, x.shape[0])


def subnet_apply_vjp(spec: SubnetSpec, x, packed, g, needs=(True, True, True)):
    """The gradients of :func:`subnet_apply` for the cotangent ``g`` of its
    output, with respect to ``x`` and the two packed buffers (None where
    ``needs`` says no): the chain recomputed from its inputs by
    :func:`chain_math` under autograd, as the JAX ``f_bwd`` recomputes
    ``subnet_apply_ref`` under ``jax.vjp``. Nothing of the forward's trunk
    is kept. The weights' gradients are taken in flax's shapes and packed
    (each packed value is one flax value, padding zero)."""
    need_x, need_w = needs[0], needs[1] or needs[2]
    x = x.detach().requires_grad_(need_x)
    flat = [t.detach().requires_grad_(need_w) for t in unpack(spec, packed)]
    wanted = ([x] if need_x else []) + (flat if need_w else [])
    if not wanted:
        return None, None, None
    with torch.enable_grad():
        grads = list(torch.autograd.grad(chain_math(spec, x, flat), wanted, g))
    g_x = grads.pop(0) if need_x else None
    if not need_w:
        return g_x, None, None
    g_w, g_b = pack(spec, grads)
    return g_x, g_w if needs[1] else None, g_b if needs[2] else None


class _SubnetApply(torch.autograd.Function):
    """K3 with the JAX custom VJP's residuals ``(x, weights)`` and its
    recomputing backward."""

    @staticmethod
    def forward(ctx, spec, x, weights, biases):
        ctx.spec = spec
        ctx.save_for_backward(x, weights, biases)
        return _subnet_forward(spec, x, weights, biases)

    # the recompute's gradients are taken outside the caller's graph, so a
    # second derivative through them raises instead of coming out wrong
    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weights, biases = ctx.saved_tensors
        return (None, *subnet_apply_vjp(ctx.spec, x, (weights, biases), g,
                                        ctx.needs_input_grad[1:]))


def subnet_apply(spec: SubnetSpec, x, packed):
    """The chain's pre-tanh head (B, h, w, out_total) float32 for ``x``
    (B, h, w, cin) float32 and ``packed`` = :func:`pack`'s output.
    Differentiable (:func:`subnet_apply_vjp`)."""
    weights, biases = packed
    return _SubnetApply.apply(spec, x, weights, biases)


def _subnet_forward(spec: SubnetSpec, x, weights, biases):
    if {t.device for t in (x, weights, biases)} == {torch.device("cpu")}:
        return subnet_apply_reference(spec, x, (weights, biases))
    _check_cuda(spec, x, weights, biases)
    B = x.shape[0]
    trunk = torch.empty(trunk_elements(spec, B), dtype=torch.float32, device=x.device)
    out = torch.empty(B, spec.h, spec.w, spec.out_total, dtype=torch.float32,
                      device=x.device)
    launch_library(_library(), spec, x, (weights, biases), trunk, out)
    LAUNCHES["fused_subnet"] += 1
    build_name = kernel_build(spec)
    BUILD_LAUNCHES[build_name] = BUILD_LAUNCHES.get(build_name, 0) + 1
    return out
