"""The port's other lowerings and precision modes against the JAX model, on
the CPU: ``fused_dilated`` and ``dense_groups`` (``forward``, ``inverse``,
``log_loss``, ``sample_xy``, fused and unfused heads, float32),
``flow_in_compute_dtype`` on the default lowering and with
``pallas_coupling`` (bf16, JAX's Pallas kernels in interpret mode),
``late_head_cast``; the blocks' equivalences with the default lowering
(JAX tests/test_models.py:290-398) and the models' with weights carried by
``convert/lowerings.py``; the ``.npz`` trees of both new lowerings in both
directions; where ``shared_shape_reinit`` refuses them, case by case
against JAX's; 3 Adam steps against optax; and the JAX package's capacity
preset (``perf_arch_config``, K 128) under ``pallas_subnet``, cut to 8 x 8,
in float32 and bf16, with one Adam step.

The arch is 16 x 16 (:data:`ARCH`): its block 0 has the dilations (1, 2), so
``fused_dilated`` builds a fused kernel there, which 8 x 8's one-level
schedule would not."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import test_torch_flow as flow  # noqa: E402
from test_torch_train import few_threads  # noqa: E402,F401  (two torch threads, autouse)
from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models.init_compat import (  # noqa: E402
    shared_shape_reinit as j_shared_shape_reinit,
)
from arl_conditional_normalizing_flows_tpu.models.subnets import (  # noqa: E402
    _dilated_branch_mask as j_mask,
)
from arl_conditional_normalizing_flows_tpu.ops.pallas import affine_coupling as jac  # noqa: E402
from arl_conditional_normalizing_flows_tpu.train import loop as jloop  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.convert.lowerings import (  # noqa: E402
    state_dict_from_default_lowering,
)
from arl_conditional_normalizing_flows_tpu_torch.models.arch import (  # noqa: E402
    ConvFlowConfig,
    perf_arch_config,
)
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.init_compat import (  # noqa: E402
    shared_shape_reinit,
)
from arl_conditional_normalizing_flows_tpu_torch.models.subnets import (  # noqa: E402
    DenseMaskedGroupConv,
    DilatedResidualBlock,
    FusedChainCouplingNet,
    dilated_branch_mask,
)
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    fused_subnet as tfs,
)
from arl_conditional_normalizing_flows_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_step_fns,
)

ARCH = dict(io_shape=(16, 16, 2), x_d=1, squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
            num_kernels=(16, 16), cardinality=(2, 2), ksize=3)
B = 4
LOWERINGS = ("fused_dilated", "dense_groups")
BF16 = dict(compute_dtype="bfloat16")
FLOW_BF16 = dict(BF16, flow_in_compute_dtype=True)
LATE = dict(BF16, late_head_cast=True)


def key(kw):
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def models(kw_items):
    """(jax model, flax params as numpy, port model on the CPU) sharing
    weights, at :data:`ARCH` with the fields ``kw_items``."""
    kw = dict(ARCH, **dict(kw_items))
    jm = JConvCFlow(JConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2,) + ARCH["io_shape"]))["params"]
    params = flow.perturb(flow.to_numpy_tree(params), np.random.default_rng(1))
    tm = ConvCFlow(ConvFlowConfig(**kw), device="cpu", seed=3)
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return jm, params, tm


def inputs():
    """xy' (uniform x, class-plane y'), and z and y for sampling."""
    h, w, _ = ARCH["io_shape"]
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(B, h, w, 1))
    y = np.broadcast_to(rng.uniform(size=(B, 1, 1, 1)), (B, h, w, 1))
    xy = np.concatenate([x, y], axis=-1).astype(np.float32)
    z = rng.normal(size=(B, h, w, 1)).astype(np.float32)
    return xy, z, np.full((B, h, w, 1), 0.5, np.float32)


@functools.lru_cache(maxsize=None)
def jax_results(kw_items):
    """The JAX model's forward, inverse, log_loss and sample_xy on
    :func:`inputs`, its Pallas coupling kernels in interpret mode; float32
    jitted, bf16 op by op (flax rounds each bf16 op; XLA's CPU fusion would
    drop roundings between them, ``tests/test_torch_flow.py::jax_results``)."""
    jm, params, _ = models(kw_items)
    bf16 = dict(kw_items).get("compute_dtype") == "bfloat16"

    def run(params, xy, z, y):
        v = {"params": params}
        zy, ld = jm.apply(v, xy)
        return dict(zy=zy, ld=ld, back=jm.apply(v, zy, method="inverse"),
                    loss=jm.apply(v, xy, method="log_loss"),
                    sample=jm.apply(v, z, y, method="sample_xy"))

    old = jac.INTERPRET
    jac.INTERPRET = True
    try:
        out = (run if bf16 else jax.jit(run))(params, *inputs())
    finally:
        jac.INTERPRET = old
    return {k: ({n: float(c) for n, c in r.items()} if k == "loss" else np.asarray(r))
            for k, r in out.items()}


def port_results(tm):
    xy, z, y = (torch.from_numpy(a) for a in inputs())
    with torch.no_grad():
        zy, ld = tm(xy)
        return dict(zy=zy.numpy(), ld=ld.numpy(), back=tm.inverse(zy).numpy(),
                    loss={k: float(v) for k, v in tm.log_loss(xy).items()},
                    sample=tm.sample_xy(z, y).numpy())


def assert_matches(got, want, tol, ld_tol, loss_rtol, loss_atol=0.0):
    np.testing.assert_allclose(got["zy"], want["zy"], rtol=tol, atol=tol)
    np.testing.assert_allclose(got["ld"], want["ld"], rtol=ld_tol, atol=ld_tol)
    np.testing.assert_allclose(got["back"], want["back"], rtol=tol, atol=tol)
    np.testing.assert_allclose(got["sample"], want["sample"], rtol=tol, atol=tol)
    assert set(got["loss"]) == set(want["loss"]) == {"loss", "z_loss", "y_loss", "detJ_loss"}
    for k, v in want["loss"].items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=loss_rtol, atol=loss_atol, err_msg=k)


# ---------------------------------------------------------------------------
# (a) the two lowerings, float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused_subnet", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("lowering", LOWERINGS)
def test_lowering_matches_jax(lowering, fused_subnet):
    kw = key(dict(experimental_lowering=lowering, fused_subnet=fused_subnet))
    got = port_results(models(kw)[2])
    tol, ld_tol, loss_tol = flow.TOLS["small"]
    assert_matches(got, jax_results(kw), tol, ld_tol, 1e-5, loss_tol)
    xy = inputs()[0]
    np.testing.assert_allclose(got["back"], xy, rtol=2e-4, atol=2e-4)


def test_lowerings_build_what_jax_builds():
    """The fused kernel exists exactly in the blocks with more than one
    dilation, at K = (k-1)*max(d) + 1; dense-masked branches exactly where
    the groups are > 1."""
    tm = models(key(dict(experimental_lowering="fused_dilated", fused_subnet=True)))[2]
    blocks = [blk for layer in tm.couplings for blk in layer.net_ab.blocks]
    assert any(blk.fused for blk in blocks)
    one_level = ConvCFlow(ConvFlowConfig(**dict(ARCH, io_shape=(8, 8, 2),
                                                experimental_lowering="fused_dilated")),
                          device="cpu")
    blocks += [blk for layer in one_level.couplings for net in (layer.net_a, layer.net_b)
               for blk in net.blocks]
    assert not all(blk.fused for blk in blocks)
    for blk in blocks:
        assert blk.fused == (len(blk.dilations) > 1)
        if blk.fused:
            assert len(blk.branches) == 0
            assert blk.fused_dil_kernel.shape[-1] == 2 * max(blk.dilations) + 1
    tm = models(key(dict(experimental_lowering="dense_groups", fused_subnet=True)))[2]
    assert all(isinstance(b, DenseMaskedGroupConv)
               for layer in tm.couplings for blk in layer.net_ab.blocks for b in blk.branches)
    # under ref_compat_group_slice the branch reads one slice as one dense
    # conv: JAX keeps nn.Conv there
    tm = ConvCFlow(ConvFlowConfig(**dict(ARCH, experimental_lowering="dense_groups",
                                         ref_compat_group_slice=True)), device="cpu")
    assert not any(isinstance(m, DenseMaskedGroupConv) for m in tm.modules())


def test_perf_arch_config_is_jaxs():
    from arl_conditional_normalizing_flows_tpu.models.arch import (
        perf_arch_config as j_perf_arch_config,
    )

    for kw in ({}, dict(experimental_lowering="dense_groups", io_shape=(16, 16, 2))):
        assert (dataclasses.asdict(perf_arch_config(**kw))
                == dataclasses.asdict(j_perf_arch_config(**kw)))


# ---------------------------------------------------------------------------
# (b), (c) the precision modes, bf16
# ---------------------------------------------------------------------------

# bf16 tolerances (zy, inverse and samples; log-det; the loss components,
# relative), from the measured worst errors. flow_in_compute_dtype on the
# default lowering: bit-equal to JAX's op-by-op run but for the float32 loss
# sums (1.3e-6 relative). With pallas_coupling, JAX's interpreted kernel
# rounds exp(a), the product and the sum to bf16 one by one where the
# port's (the kernel's plain version, as the card's kernel) rounds once:
# zy 0.0195 (one bf16 ulp at |zy| in [2, 4)), samples 0.047, log-det 6.4e-3
# on |8.9|, y_loss 0.94% (lambda_y = 100 times the L1 of y's one-ulp
# differences). late_head_cast: zy 4.8e-7, log-det and loss 0.
MODE_TOLS = {
    "flow": (1e-6, 1e-6, 1e-5),
    "flow-pallas_coupling": (0.1, 0.02, 0.02),
    "late": (2e-6, 1e-5, 1e-5),
}
MODE_CASES = [
    pytest.param(dict(FLOW_BF16, fused_subnet=True), "flow", id="flow_in_compute_dtype"),
    pytest.param(dict(FLOW_BF16, fused_subnet=False), "flow", id="flow_in_compute_dtype-unfused"),
    pytest.param(dict(FLOW_BF16, fused_subnet=True, experimental_lowering="pallas_coupling"),
                 "flow-pallas_coupling", id="flow_in_compute_dtype-pallas_coupling"),
    pytest.param(dict(LATE, fused_subnet=True), "late", id="late_head_cast"),
]


@pytest.mark.parametrize("kw,tols", MODE_CASES)
def test_precision_mode_matches_jax(kw, tols):
    got = port_results(models(key(kw))[2])
    assert_matches(got, jax_results(key(kw)), *MODE_TOLS[tols])
    assert got["zy"].dtype == got["ld"].dtype == got["back"].dtype == np.float32


def test_flow_in_compute_dtype_runs_the_flow_and_the_kernels_in_bf16(monkeypatch):
    """The coupling law gets bf16 tensors, the kernels' wrappers included,
    and the log-det is float32; the heads are bf16."""
    from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import affine_coupling as tac

    seen = []
    real_fwd, real_inv = tac.fused_affine_forward, tac.fused_affine_inverse

    def fwd(a, b, u2):
        seen.append(("fwd", a.dtype, b.dtype, u2.dtype))
        v2, ld = real_fwd(a, b, u2)
        assert v2.dtype == torch.bfloat16 and ld.dtype == torch.float32
        return v2, ld

    def inv(a, b, v2):
        seen.append(("inv", a.dtype, b.dtype, v2.dtype))
        return real_inv(a, b, v2)

    monkeypatch.setattr(tac, "fused_affine_forward", fwd)
    monkeypatch.setattr(tac, "fused_affine_inverse", inv)
    tm = models(key(dict(FLOW_BF16, fused_subnet=True,
                         experimental_lowering="pallas_coupling")))[2]
    with torch.no_grad():
        zy, _ = tm(torch.from_numpy(inputs()[0]))
        tm.inverse(zy)
    n = len(tm.couplings)
    assert seen == [("fwd",) + (torch.bfloat16,) * 3] * n + [("inv",) + (torch.bfloat16,) * 3] * n


def test_late_head_cast_is_a_no_op_at_float32_and_under_pallas_subnet():
    xy = torch.from_numpy(inputs()[0])
    for base in (dict(fused_subnet=True), dict(fused_subnet=False),
                 dict(fused_subnet=True, compute_dtype="bfloat16",
                      experimental_lowering="pallas_subnet")):
        plain = ConvCFlow(ConvFlowConfig(**dict(ARCH, **base)), device="cpu", seed=3)
        late = ConvCFlow(ConvFlowConfig(**dict(ARCH, **base, late_head_cast=True)),
                         device="cpu", seed=3)
        with torch.no_grad():
            for a, b in zip(plain(xy) + (plain.inverse(xy),), late(xy) + (late.inverse(xy),)):
                assert torch.equal(a, b), base
    # flow_in_compute_dtype at float32 is a no-op too (JAX: act_dtype None)
    plain = ConvCFlow(ConvFlowConfig(**ARCH), device="cpu", seed=3)
    flow32 = ConvCFlow(ConvFlowConfig(**dict(ARCH, flow_in_compute_dtype=True)),
                       device="cpu", seed=3)
    assert flow32.act_dtype is None
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(plain(xy), flow32(xy)))


@pytest.mark.parametrize("kw", [
    dict(late_head_cast=True, experimental_lowering="pallas_coupling"),
    dict(flow_in_compute_dtype=True, experimental_lowering="pallas_subnet"),
    dict(ref_compat_group_slice=True, experimental_lowering="pallas_subnet"),
])
def test_config_keeps_jaxs_cross_field_asserts(kw):
    for cls in (ConvFlowConfig, JConfig):
        with pytest.raises(AssertionError):
            cls(**dict(ARCH, **kw))


# ---------------------------------------------------------------------------
# (d) equivalence with the default lowering
# ---------------------------------------------------------------------------


def test_branch_mask_is_jaxs():
    for args in ((3, (1, 2), 2, 8), (3, (1, 2, 4), 8, 64), (3, (1, 2, 4), 4, 16), (5, (1, 3), 2, 12)):
        mask, k = dilated_branch_mask(*args)
        want, k2 = j_mask(*args)
        assert k == k2 and np.array_equal(mask, want), args


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_block_equals_the_branch_block_with_its_weights(lowering):
    """JAX's test_fused_dilated_conv_equivalence and
    test_dense_masked_group_conv_equivalence on the port's blocks: the branch
    kernels written into the fused kernel's live taps, or carried 1:1 into
    the dense-masked branches, give the default block's output."""
    nb, card, ksize, dils = 8, 2, 3, (1, 2)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, nb, 8, 8)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    common = dict(hw=(8, 8), nb_channels=nb, dilations=dils, ksize=ksize, cardinality=card,
                  layer_norm=False, dtype=torch.float32)
    branchy = DilatedResidualBlock(**common, generator=g)
    other = DilatedResidualBlock(**common, generator=g, fuse_dilated_conv=lowering == LOWERINGS[0],
                                 dense_masked_groups=lowering == LOWERINGS[1])
    assert other.fused == (lowering == "fused_dilated")
    state = {f"b.{k}": v for k, v in branchy.state_dict().items()}
    wrapped = torch.nn.ModuleDict({"b": other})
    wrapped.load_state_dict(state_dict_from_default_lowering(wrapped, state))
    with torch.no_grad():
        torch.testing.assert_close(other(x), branchy(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_model_equals_the_default_lowering_with_its_weights(lowering):
    default = ConvCFlow(ConvFlowConfig(**dict(ARCH, fused_subnet=True)), device="cpu", seed=5)
    tm = ConvCFlow(ConvFlowConfig(**dict(ARCH, fused_subnet=True, experimental_lowering=lowering)),
                   device="cpu", seed=9)
    tm.load_state_dict(state_dict_from_default_lowering(tm, default.state_dict()))
    xy = torch.from_numpy(inputs()[0])
    with torch.no_grad():
        zy, ld = tm(xy)
        want_zy, want_ld = default(xy)
    torch.testing.assert_close(zy, want_zy, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(ld, want_ld, rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# (e) the .npz trees, (f) shared_shape_reinit
# ---------------------------------------------------------------------------


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("fused_subnet", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("lowering", LOWERINGS)
def test_flax_tree_round_trip(lowering, fused_subnet):
    """flax -> port -> flax gives JAX's tree back, names and values."""
    _, params, tm = models(key(dict(experimental_lowering=lowering, fused_subnet=fused_subnet)))
    back = dict(flat(flax_from_state_dict(tm.state_dict(), tm)))
    want = dict(flat(params))
    assert set(back) == set(want)
    names = {p[-2] for p in want}
    if lowering == "dense_groups":
        assert {"DenseMaskedGroupConv_0", "DenseMaskedGroupConv_1"} <= names
    else:
        assert {p[-1] for p in want} >= {"fused_dil_kernel", "fused_dil_bias"}
    for path, v in want.items():
        assert back[path].shape == np.shape(v) and np.array_equal(back[path], v), path


# per case: (config fields, whether JAX's shared_shape_reinit refuses it)
SHARED_CASES = [
    pytest.param(dict(experimental_lowering="dense_groups"), True, id="dense_groups"),
    pytest.param(dict(experimental_lowering="fused_dilated"), True, id="fused_dilated"),
    pytest.param(dict(experimental_lowering="fused_dilated", io_shape=(8, 8, 2)), False,
                 id="fused_dilated-one_dilation"),
    pytest.param(dict(experimental_lowering="dense_groups", ref_compat_group_slice=True), False,
                 id="dense_groups-group_slice"),
    pytest.param(dict(experimental_lowering="fused_dilated", dilations=False), False,
                 id="fused_dilated-no_dilations"),
]


@pytest.mark.parametrize("kw,refuses", SHARED_CASES)
def test_shared_init_refuses_where_jax_does(kw, refuses):
    cfg = dict(ARCH, fused_subnet=True, ref_compat_shared_init=True, **kw)
    jm = JConvCFlow(JConfig(**cfg))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1,) + cfg["io_shape"]))
    tm = ConvCFlow(ConvFlowConfig(**cfg), device="cpu", seed=0)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    if refuses:
        with pytest.raises(ValueError, match="shared_init"):
            j_shared_shape_reinit(variables, 0)
        with pytest.raises(ValueError, match="shared_init"):
            create_train_state(tm, 3e-4, seed=0)
        # nothing was written before the refusal
        assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    else:
        j_shared_shape_reinit(variables, 0)
        shared_shape_reinit(tm, 0)


# ---------------------------------------------------------------------------
# (g) Adam steps against optax
# ---------------------------------------------------------------------------

LR = 3e-4
STEPS = 3
# per case: (loss rtol, tight bound, the fraction of elements within it).
# dense_groups (float32), measured: loss 1.2e-6 relative, every element
# within 1e-7 (max 2.4e-8). flow_in_compute_dtype (bf16; JAX op by op): the
# first loss bit-equal, the third 4.7e-4 relative; 99.6% of elements within
# 1e-4, max 9.2e-4 (test_torch_train.py's STEP_TOLS["bfloat16"])
ADAM_TOLS = {"dense_groups": (1e-5, 1e-7, 0.999), "flow_in_compute_dtype": (1e-3, 1e-4, 0.95)}
ADAM_CASES = {"dense_groups": dict(experimental_lowering="dense_groups", fused_subnet=True),
              "flow_in_compute_dtype": dict(FLOW_BF16, fused_subnet=True)}


def xy_stack(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(STEPS, B) + ARCH["io_shape"]).astype(np.float32)


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_steps_match_optax(case):
    kw = ADAM_CASES[case]
    jm, params, _ = models(key(kw))
    state = jloop.TrainState.create(
        apply_fn=jm.apply, params={"params": jax.tree_util.tree_map(jnp.asarray, params)},
        tx=optax.adam(LR))
    jstep, _ = jloop.make_step_fns(jm, noise_mode="none")
    want_losses = []
    # bf16 op by op, as flax rounds each bf16 op (jax_results)
    with jax.disable_jit(kw.get("compute_dtype") == "bfloat16"):
        for xy in xy_stack(0):
            state, out = jstep(state, jnp.asarray(xy), jax.random.PRNGKey(0), jnp.float32(1.0))
            want_losses.append(float(out["loss"]))
    want = flow.to_numpy_tree(state.params["params"])

    tm = ConvCFlow(ConvFlowConfig(**dict(ARCH, **kw)), device="cpu", seed=3)
    tm.load_state_dict(state_dict_from_flax(params, tm))
    tstate = create_train_state(tm, LR)
    step, _ = make_step_fns(tm, noise_mode="none")
    losses = [float(step(tstate, torch.from_numpy(xy))[1]["loss"]) for xy in xy_stack(0)]
    loss_rtol, tight, fraction = ADAM_TOLS[case]
    np.testing.assert_allclose(losses, want_losses, rtol=loss_rtol)
    target = state_dict_from_flax(want, tm)
    err = np.concatenate([np.abs(p.detach().numpy() - target[n].numpy()).ravel()
                          for n, p in tm.named_parameters()])
    assert np.mean(err <= tight) >= fraction, np.quantile(err, [0.9, 0.99, 0.999])
    assert err.max() <= 2 * LR * STEPS, err.max()


# ---------------------------------------------------------------------------
# (h) the JAX package's capacity preset under pallas_subnet
# ---------------------------------------------------------------------------

#: perf_arch_config cut to 8 x 8 and one residual block a scale, as JAX's
#: tests/test_models.py:237-243 cuts it, on the conv-chain kernel's
#: lowering: K 128 at both scales, a trunk that takes K3's wide variant on
#: the card in bf16 (the preset's compute dtype)
PRESET = dict(io_shape=(8, 8, 2), squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
              num_kernels=(128, 128), cardinality=(8, 8), experimental_lowering="pallas_subnet")


@functools.lru_cache(maxsize=None)
def preset_models(dtype):
    """(jax model, flax params as numpy, port model on the CPU) of the cut
    preset at ``dtype``, sharing weights (biases perturbed off zero)."""
    from arl_conditional_normalizing_flows_tpu.models.arch import (
        perf_arch_config as j_perf_arch_config,
    )

    jm = JConvCFlow(j_perf_arch_config(**PRESET, compute_dtype=dtype))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2,) + PRESET["io_shape"]))["params"]
    params = flow.perturb(flow.to_numpy_tree(params), np.random.default_rng(1))
    tm = ConvCFlow(perf_arch_config(**PRESET, compute_dtype=dtype), device="cpu", seed=3)
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return jm, params, tm


def preset_inputs():
    h, w, _ = PRESET["io_shape"]
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(B, h, w, 1))
    y = np.broadcast_to(rng.uniform(size=(B, 1, 1, 1)), (B, h, w, 1))
    return np.concatenate([x, y], axis=-1).astype(np.float32)


def test_preset_builds_the_wide_chain():
    """The cut preset's channel-wise couplings run a 128-wide trunk, past
    the narrow bf16 kernel: on the card they take K3's wide variant."""
    tm = preset_models("bfloat16")[2]
    specs = {m.spec for m in tm.modules() if isinstance(m, FusedChainCouplingNet)}
    assert {s.kernels for s in specs} == {64, 128}
    assert any(tfs.wide(s) for s in specs) and not all(tfs.wide(s) for s in specs)
    for s in specs:
        tfs.check_launch(s, B)


# (zy and inverse, log-det, loss components relative). float32: the small
# arch's (test_torch_flow.TOLS); measured zy 1.8e-7, log-det 9.5e-7 on |4.8|,
# loss 1e-7 relative. bf16: both chains round the same operands to bf16 and
# sum in float32; measured zy 1.1e-6, log-det 3.3e-6, inverse 1.8e-7, loss
# 2e-7 relative; the bounds are 10-30x that
PRESET_TOLS = {"float32": (3e-5, 3e-4, 3e-4), "bfloat16": (3e-5, 1e-4, 1e-5)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preset_matches_jax(dtype):
    """forward, inverse and log_loss of the cut preset against JAX's with
    the same weights; JAX's conv chain off the TPU is its plain version, run
    op by op in bf16 (flax rounds each bf16 op)."""
    jm, params, tm = preset_models(dtype)
    xy = preset_inputs()

    def run(params, xy):
        v = {"params": params}
        zy, ld = jm.apply(v, xy)
        return dict(zy=zy, ld=ld, back=jm.apply(v, zy, method="inverse"),
                    loss=jm.apply(v, xy, method="log_loss"))

    with jax.disable_jit(dtype == "bfloat16"):
        want = run(params, jnp.asarray(xy))
    with torch.no_grad():
        zy, ld = tm(torch.from_numpy(xy))
        back = tm.inverse(zy)
        loss = tm.log_loss(torch.from_numpy(xy))
    tol, ld_tol, loss_rtol = PRESET_TOLS[dtype]
    np.testing.assert_allclose(zy.numpy(), want["zy"], rtol=tol, atol=tol)
    np.testing.assert_allclose(ld.numpy(), want["ld"], rtol=ld_tol, atol=ld_tol)
    np.testing.assert_allclose(back.numpy(), want["back"], rtol=tol, atol=tol)
    np.testing.assert_allclose(back.numpy(), xy, rtol=tol, atol=tol)
    assert set(loss) == set(want["loss"]) == {"loss", "z_loss", "y_loss", "detJ_loss"}
    for k, v in want["loss"].items():
        np.testing.assert_allclose(float(loss[k]), float(v), rtol=loss_rtol, err_msg=k)


# (loss rtol, tight bound, the fraction of elements within it). float32,
# measured: loss bit-equal, 99.9993% of elements within 1e-7 (max 1.1e-6).
# bf16: loss 2.1e-7 relative, 99.95% within 1e-5; an element whose gradient
# is near zero may take Adam's full step the other way (max 6.0e-4, 2 LR)
PRESET_ADAM_TOLS = {"float32": (1e-5, 1e-7, 0.9999), "bfloat16": (1e-5, 1e-5, 0.999)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preset_adam_step_matches_optax(dtype):
    """One Adam step (3e-4, no noise) of the cut preset against optax's from
    the same weights: the loss and the updated parameters."""
    jm, params, _ = preset_models(dtype)
    xy = preset_inputs()
    state = jloop.TrainState.create(
        apply_fn=jm.apply, params={"params": jax.tree_util.tree_map(jnp.asarray, params)},
        tx=optax.adam(LR))
    jstep, _ = jloop.make_step_fns(jm, noise_mode="none")
    with jax.disable_jit(dtype == "bfloat16"):
        state, out = jstep(state, jnp.asarray(xy), jax.random.PRNGKey(0), jnp.float32(1.0))
    want = flow.to_numpy_tree(state.params["params"])

    tm = ConvCFlow(perf_arch_config(**PRESET, compute_dtype=dtype), device="cpu", seed=3)
    tm.load_state_dict(state_dict_from_flax(params, tm))
    tstate = create_train_state(tm, LR)
    step, _ = make_step_fns(tm, noise_mode="none")
    loss = float(step(tstate, torch.from_numpy(xy))[1]["loss"])
    target = state_dict_from_flax(want, tm)
    err = np.concatenate([np.abs(p.detach().numpy() - target[n].numpy()).ravel()
                          for n, p in tm.named_parameters()])
    loss_rtol, tight, fraction = PRESET_ADAM_TOLS[dtype]
    np.testing.assert_allclose(loss, float(out["loss"]), rtol=loss_rtol)
    assert np.mean(err <= tight) >= fraction, np.quantile(err, [0.9, 0.99, 0.999])
    assert err.max() <= 2 * LR, err.max()
