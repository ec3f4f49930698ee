"""Architecture configs and static derivations for the conv and toy flows.

A copy of ``arl_conditional_normalizing_flows_tpu/models/arch.py`` (the port
may not import the JAX package, whose ``__init__`` pulls in jax). Every field
of :class:`ConvFlowConfig` and :class:`ToyConfig` is kept so that a config
carries across unchanged; :func:`derive_blocks`, :func:`_dilation_schedule`,
:func:`arch_string` and :func:`shuffle_mask_indices` must give the same
outputs as the JAX functions, because ``arch_string`` is the checkpoint and
pre-training compatibility contract and the toy's layer order is part of its
identity.

Everything here is plain Python: per-block scales and io shapes
(conv_cINN_make_model.py:1487-1536), the fixed per-block mask order
(conv_cINN_make_model.py:1545-1550) and the automatic dilation schedule
(conv_cINN_make_model.py:1552-1610).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ConvFlowConfig:
    """Hyperparameters of the multi-scale conv cFlow
    (conv_cINN_make_model.py:1408-1484, conv_cINN.py:56-91).

    Field meanings are those of the JAX config; the port runs every value
    it admits, with float32 or bfloat16 subnets (``models/conv.py``).
    """

    io_shape: Tuple[int, int, int]  # (H, W, D) of the concatenated xy tensor
    x_d: int  # channels of x; y' occupies channels [x_d:]
    squeeze_factor_blocks: Tuple[int, ...] = (0, 1, 0, 0)
    res_blocks: Tuple[int, ...] = (3, 3, 3, 3)
    num_kernels: Tuple[int, ...] = (64, 64, 32, 32)
    cardinality: Tuple[int, ...] = (8, 8, 4, 4)
    ksize: int = 3
    dilations: bool = True
    layer_norm: bool = False
    lambda_y: float = 100.0  # conv_cINN_make_model.py:1438
    # one two-headed A/b subnet per coupling instead of two
    fused_subnet: bool = False
    # dtype of the coupling subnets' convs (params stay float32; log-det and
    # loss accumulate in float32 regardless)
    compute_dtype: str = "float32"
    # the reference's late-bound group slice (conv_cINN_base_functions.py:401)
    ref_compat_group_slice: bool = False
    # per-group independent orthogonal draws for grouped-conv kernels
    ref_compat_group_init: bool = False
    # one draw per unique kernel shape; applied after init by the trainer,
    # never by the model (JAX: train.create_train_state)
    ref_compat_shared_init: bool = False
    # None | "pallas_coupling" | "fused_dilated" | "dense_groups" |
    # "pallas_subnet" — at most one alternative lowering of the same math
    experimental_lowering: Optional[str] = None
    # keep every flow activation (inter-layer tensors, mask moves, coupling
    # law) in compute_dtype; the log-det still accumulates in float32. No-op
    # at a float32 compute dtype
    flow_in_compute_dtype: bool = False
    # leave only the coupling heads (A, b) in compute_dtype; the law promotes
    # them to the float32 flow. No-op at a float32 compute dtype
    late_head_cast: bool = False

    def __post_init__(self):
        n = len(self.squeeze_factor_blocks)
        assert (
            len(self.res_blocks) == n
            and len(self.num_kernels) == n
            and len(self.cardinality) == n
        ), "architecture lists must have equal length (conv_cINN_make_model.py:1459-1463)"
        h, w, _ = self.io_shape
        assert h % 2 == 0 and w % 2 == 0, "io spatial dims must be even"
        for k, c in zip(self.num_kernels, self.cardinality):
            assert k % 2 == 0 and c % 2 == 0, (
                "kernels and cardinality must be even (conv_cINN_make_model.py:1472-1479)"
            )
        assert all(s in (0, 1) for s in self.squeeze_factor_blocks)
        assert self.ksize >= 1, "ksize must be a positive kernel size"
        assert self.experimental_lowering in (
            None, "pallas_coupling", "fused_dilated", "dense_groups",
            "pallas_subnet",
        ), f"unknown experimental_lowering {self.experimental_lowering!r}"
        assert not (
            self.late_head_cast
            and self.experimental_lowering == "pallas_coupling"
        ), "late_head_cast requires the XLA coupling law (mixed-dtype promote)"
        if self.fused_pallas_subnet:
            assert not self.layer_norm, (
                "pallas_subnet does not implement layer_norm — use the "
                "flax subnet path"
            )
            assert not (
                self.ref_compat_group_slice or self.flow_in_compute_dtype
            ), "pallas_subnet supports only the default subnet semantics"

    @property
    def use_pallas_coupling(self) -> bool:
        """The coupling law goes through the hand-written coupling kernels."""
        return self.experimental_lowering == "pallas_coupling"

    @property
    def fuse_dilated_conv(self) -> bool:
        return self.experimental_lowering == "fused_dilated"

    @property
    def dense_masked_groups(self) -> bool:
        return self.experimental_lowering == "dense_groups"

    @property
    def fused_pallas_subnet(self) -> bool:
        return self.experimental_lowering == "pallas_subnet"


def perf_arch_config(io_shape=(28, 28, 2), x_d=1, **overrides) -> ConvFlowConfig:
    """The JAX package's capacity preset (not the reference-parity arch,
    JAX models/arch.py:155-178): 128 kernels at every scale, cardinality 8
    (branch widths 128/d stay divisible by 8 for dilations (1, 2, 4)), fused
    A/b subnets, bfloat16 compute. ``overrides`` replace any field."""
    base = dict(
        io_shape=io_shape,
        x_d=x_d,
        squeeze_factor_blocks=(0, 1, 0, 0),
        res_blocks=(3, 3, 3, 3),
        num_kernels=(128, 128, 128, 128),
        cardinality=(8, 8, 8, 8),
        ksize=3,
        fused_subnet=True,
        compute_dtype="bfloat16",
    )
    base.update(overrides)
    return ConvFlowConfig(**base)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Static per-coupling-block facts derived from the config."""

    io_shape: Tuple[int, int, int]
    num_prev_factors: int
    squeeze_factor: bool
    dilations_checkerboard: Tuple[int, ...]
    dilations_channelwise: Tuple[int, ...]


def derive_blocks(cfg: ConvFlowConfig) -> Tuple[BlockPlan, ...]:
    """Per-block scales, shapes, factor counts and dilation schedules.

    Mirrors conv_cINN_make_model.py:1487-1617, including the shifted scale
    bookkeeping (squeeze/factor happens AFTER the block's couplings, so a
    block's scale is set by the PREVIOUS block's squeeze flag).
    """
    sf = cfg.squeeze_factor_blocks
    h0, w0, d0 = cfg.io_shape

    scale = 1
    num_prev_factors = 0
    blocks = []
    for i in range(len(sf)):
        if i > 0 and sf[i - 1]:
            scale *= 2
            num_prev_factors += 1
        assert h0 % (scale * 2) == 0 and w0 % (scale * 2) == 0, (
            f"scale*2 must divide spatial dims at block {i} "
            "(conv_cINN_make_model.py:1526-1530)"
        )
        shape = (h0 // scale, w0 // scale, d0 * scale)
        dil_cb, dil_cw = (
            _dilation_schedule(shape, cfg.ksize) if cfg.dilations else ((1,), (1,))
        )
        if cfg.dilations:
            nkc = cfg.num_kernels[i] // cfg.cardinality[i]
            for d in dil_cw:
                assert nkc % d == 0, (
                    f"num_kernels/cardinality must be divisible by dilation {d} "
                    f"at block {i} (conv_cINN_make_model.py:1612-1617)"
                )
            # checkerboard couplings run with HALF the kernels
            # (conv_cINN_make_model.py:419-423); each dilated branch must
            # still split evenly into cardinality groups
            for d in dil_cb:
                assert (cfg.num_kernels[i] // 2 // d) % cfg.cardinality[i] == 0, (
                    f"checkerboard branch width (num_kernels/2/{d}) must be "
                    f"divisible by cardinality at block {i}"
                )
        blocks.append(
            BlockPlan(
                io_shape=shape,
                num_prev_factors=num_prev_factors,
                squeeze_factor=bool(sf[i]),
                dilations_checkerboard=dil_cb,
                dilations_channelwise=dil_cw,
            )
        )
    return tuple(blocks)


def _dilation_schedule(block_io_shape, ksize):
    """Auto dilation schedule (conv_cINN_make_model.py:1552-1610).

    Grow the dilated kernel size via dk' = (k-1)(dk-1)+1 while
    dk < (min_dim+1)/2; checkerboard-compressed inputs have half the spatial
    extent and get one fewer dilation level.
    """
    if ksize <= 2:
        # the reference's growth loop never ends for k < 3; the single-level
        # schedule is its fixed point
        return (1,), (1,)
    min_cw = min(block_io_shape[0], block_io_shape[1])
    min_cb = min_cw / 2

    cb, cw = [], []
    d = 1
    dk = ksize
    if dk > (min_cw + 1) / 2:
        return (1,), (1,)
    guard = 0
    while dk < (min_cw + 1) / 2:
        assert guard < 10, "dilation loop ran away (conv_cINN_make_model.py:1588-1590)"
        cw.append(int(d))
        if d < (min_cb + 1) / 2:
            cb.append(int(d))
        dk = (ksize - 1) * (dk - 1) + 1
        d = (dk - ksize) / (ksize - 1) + 1
        guard += 1
    return tuple(cb), tuple(cw)


#: per-block u1 mask order — fixed (conv_cINN_make_model.py:1545-1550)
BLOCK_MASK_ORDER = (0, 1, 2, 3)


def arch_string(cfg: ConvFlowConfig) -> str:
    """Architecture identity string (compatibility contract between
    pre-training and training, format after conv_cINN.py:519)."""
    j = lambda xs: "".join(str(int(x)) for x in xs)
    return (
        f"SqFa{j(cfg.squeeze_factor_blocks)}_NRB{j(cfg.res_blocks)}"
        f"_C{'.'.join(map(str, cfg.cardinality))}"
        f"_NK{'.'.join(map(str, cfg.num_kernels))}"
        f"_KS{cfg.ksize}_D{int(cfg.dilations)}_LN{int(cfg.layer_norm)}"
        f"_IO{cfg.io_shape[0]}x{cfg.io_shape[1]}x{cfg.io_shape[2]}_XD{cfg.x_d}"
    )


@dataclasses.dataclass(frozen=True)
class ToyConfig:
    """Hyperparameters of the dense toy cINN (TOYcINN.py:84-105,
    TOYcINN_make_model.py:105-217)."""

    io_shape: int = 3
    x_d: int = 2
    num_coupling_layers: int = 24
    intermediate_dims: int = 32
    num_layers: int = 6
    lambda_y: float = 100.0
    #: execution-order permutation of the coupling layers; layer j always uses
    #: toy mask ``j % 6``. None -> identity order (the driver shuffles with an
    #: explicit numpy Generator, :func:`shuffle_mask_indices`)
    mask_indices: Optional[Tuple[int, ...]] = None

    def ordered_indices(self) -> Tuple[int, ...]:
        if self.mask_indices is not None:
            assert sorted(self.mask_indices) == list(range(self.num_coupling_layers))
            return tuple(self.mask_indices)
        return tuple(range(self.num_coupling_layers))


def shuffle_mask_indices(rng, num_coupling_layers: int) -> Tuple[int, ...]:
    """Shuffle layer order within each group of 6, as the toy reference does
    (TOYcINN_make_model.py:207-217), with an explicit numpy Generator: the
    same permutation as the JAX function for the same generator state."""
    import numpy as np

    idx = np.arange(num_coupling_layers)
    for g in range(num_coupling_layers // 6):
        rng.shuffle(idx[6 * g : 6 * (g + 1)])
    return tuple(int(i) for i in idx)
