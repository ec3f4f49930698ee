"""The port's serving slice as a whole against the JAX model: ``ConvCFlow``
forward/inverse, ``log_loss``, ``sample_xy`` and ``make_image_serving_fn``
with weights transplanted by ``convert/from_jax.py``, on the
``pallas_coupling`` and ``pallas_subnet`` lowerings. The JAX side runs its
Pallas coupling kernels in interpret mode and, off the TPU, its conv-chain
kernel's plain version (``subnet_apply_ref``); the port's CPU tensors take
the kernels' plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops.pallas import affine_coupling as jac  # noqa: E402
from arl_conditional_normalizing_flows_tpu.sample import sampler as jsampler  # noqa: E402
from arl_conditional_normalizing_flows_tpu.serve.export import (  # noqa: E402
    make_image_serving_fn as j_serving_fn,
)
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.subnets import (  # noqa: E402
    FusedChainCouplingNet,
)
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    affine_coupling as tac,
)
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    fused_subnet as tfs,
)
from arl_conditional_normalizing_flows_tpu_torch.sample import sampler as tsampler  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.serve.export import (  # noqa: E402
    make_image_serving_fn,
)

# the small arch of tests/test_fused_subnet.py
ARCH = dict(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1),
            res_blocks=(1, 1), num_kernels=(16, 16), cardinality=(2, 2), ksize=3)
B = 4
#: the JAX bench's flagship (bench.py) in bf16, the main path's dtype, at
#: batch 2 on the default lowering
BENCH_ARCH = dict(io_shape=(28, 28, 2), x_d=1, squeeze_factor_blocks=(0, 1, 0, 0),
                  res_blocks=(3, 3, 3, 3), num_kernels=(64, 64, 32, 32),
                  cardinality=(8, 8, 4, 4), ksize=3, compute_dtype="bfloat16")
BENCH_B = 2
PALLAS = "pallas_coupling"
SUBNET = "pallas_subnet"
# the lowerings that run the serving tests; the ids of the pallas_coupling
# cases are those of the tests before pallas_subnet was ported
SERVING_CASES = [
    pytest.param(True, PALLAS, id="True"),
    pytest.param(False, PALLAS, id="False"),
    pytest.param(True, SUBNET, id="True-pallas_subnet"),
    pytest.param(False, SUBNET, id="False-pallas_subnet"),
]


def to_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: perturb(v, rng) for k, v in tree.items()}
    if tree.ndim == 0:
        return np.asarray(1.2, np.float32)
    if tree.ndim == 1:
        return (tree + 0.05 * rng.normal(size=tree.shape)).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def models(fused_subnet, lowering, arch="small"):
    """(jax model, flax params as numpy, port model on the CPU) sharing
    weights; ``arch`` "small" (:data:`ARCH`) or "bench_bf16"
    (:data:`BENCH_ARCH`)."""
    base = ARCH if arch == "small" else BENCH_ARCH
    kw = dict(base, fused_subnet=fused_subnet, experimental_lowering=lowering)
    jm = JConvCFlow(JConfig(**kw))
    rng = np.random.default_rng(1)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2,) + base["io_shape"]))["params"]
    params = perturb(to_numpy_tree(params), rng)
    tm = ConvCFlow(ConvFlowConfig(**kw), device="cpu", seed=3)
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return jm, params, tm


def inputs(arch="small"):
    """xy' (uniform x, class-plane y'), and z and y for sampling."""
    n, (h, w, _) = (B, ARCH["io_shape"]) if arch == "small" else (BENCH_B,
                                                                   BENCH_ARCH["io_shape"])
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(n, h, w, 1))
    y = np.broadcast_to(rng.uniform(size=(n, 1, 1, 1)), (n, h, w, 1))
    xy = np.concatenate([x, y], axis=-1).astype(np.float32)
    z = rng.normal(size=(n, h, w, 1)).astype(np.float32)
    return xy, z, np.full((n, h, w, 1), 0.5, np.float32)


@functools.lru_cache(maxsize=None)
def jax_results(fused_subnet, lowering, arch="small", jit=None):
    """The JAX model's outputs on :func:`inputs`, its Pallas coupling
    kernels run in interpret mode. By default (``jit`` None) the small arch
    runs as one jitted program (far quicker than eager interpret) and the
    bf16 bench arch op by op, as flax rounds each bf16 op: jitted, XLA's CPU
    compiler fuses bf16 ops and drops roundings between them, which moves
    JAX's own loss by 0.36 nats on 9,529 and its log-det by 0.063
    (``tests/torch_bf16_parity_report.py``)."""
    jm, params, _ = models(fused_subnet, lowering, arch)

    def run(params, xy, z, y):
        v = {"params": params}
        zy, ld = jm.apply(v, xy)
        out = dict(zy=zy, ld=ld, back=jm.apply(v, zy, method="inverse"))
        if lowering is not None or arch != "small":
            out["loss"] = jm.apply(v, xy, method="log_loss")
        if lowering is not None:
            out["sample"] = jm.apply(v, z, y, method="sample_xy")
            out["served"] = j_serving_fn(jm, v, 1, de_logit=True)(z, y)
        return out

    old = jac.INTERPRET
    jac.INTERPRET = True
    try:
        jitted = arch == "small" if jit is None else jit
        out = (jax.jit(run) if jitted else run)(params, *inputs(arch))
    finally:
        jac.INTERPRET = old
    return {k: ({n: float(c) for n, c in r.items()} if k == "loss" else np.asarray(r))
            for k, r in out.items()}


# (zy and inverse, log-det, loss) tolerances. small: float32. bench_bf16:
# bf16 rounds at the same places in both, so what is left is float32 ulps
# (tanh, exp) that now and then flip a bf16 rounding downstream; measured zy
# 4.8e-7, log-det 1.8e-4 on |16|, inverse 3.6e-7, loss 9.8e-4 on 9,529 (an
# ulp of it), and the bounds are about 6-10x that
TOLS = {"small": (3e-5, 3e-4, 3e-4), "bench_bf16": (3e-6, 1e-3, 1e-2)}
BENCH_CASE = pytest.param(True, None, "bench_bf16", id="bench_bf16-None")


@pytest.mark.parametrize("fused_subnet,lowering,arch", [
    pytest.param(True, PALLAS, "small", id="True-pallas_coupling"),
    pytest.param(False, PALLAS, "small", id="False-pallas_coupling"),
    pytest.param(True, None, "small", id="True-None"),
    pytest.param(True, SUBNET, "small", id="True-pallas_subnet"),
    pytest.param(False, SUBNET, "small", id="False-pallas_subnet"),
    BENCH_CASE,
])
def test_forward_inverse_match_jax(fused_subnet, lowering, arch):
    _, _, tm = models(fused_subnet, lowering, arch)
    ref = jax_results(fused_subnet, lowering, arch)
    tol, ld_tol, _ = TOLS[arch]
    xy = inputs(arch)[0]
    with torch.no_grad():
        zy_t, ld_t = tm(torch.from_numpy(xy))
        back_t = tm.inverse(zy_t)
    assert zy_t.shape == xy.shape and ld_t.shape == (xy.shape[0],)
    np.testing.assert_allclose(zy_t.numpy(), ref["zy"], rtol=tol, atol=tol)
    np.testing.assert_allclose(ld_t.numpy(), ref["ld"], rtol=ld_tol, atol=ld_tol)
    np.testing.assert_allclose(back_t.numpy(), ref["back"], rtol=tol, atol=tol)
    np.testing.assert_allclose(back_t.numpy(), xy, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fused_subnet,lowering,arch", [
    pytest.param(*c.values, "small", id=c.id) for c in SERVING_CASES] + [BENCH_CASE])
def test_log_loss_matches_jax(fused_subnet, lowering, arch):
    _, _, tm = models(fused_subnet, lowering, arch)
    ref = jax_results(fused_subnet, lowering, arch)
    tol, _, loss_tol = TOLS[arch]
    xy = torch.from_numpy(inputs(arch)[0])
    with torch.no_grad():
        comps, zy = tm.log_loss_with_latent(xy)
        again = tm.log_loss(xy)
    assert set(comps) == set(ref["loss"]) == {"loss", "z_loss", "y_loss", "detJ_loss"}
    for k, v in ref["loss"].items():
        np.testing.assert_allclose(float(comps[k]), v, rtol=1e-5 if arch == "small" else 0,
                                   atol=loss_tol)
        assert torch.equal(comps[k], again[k])
    np.testing.assert_allclose(zy.numpy(), ref["zy"], rtol=tol, atol=tol)


@pytest.mark.parametrize("fused_subnet,lowering", SERVING_CASES)
def test_sample_xy_and_serving_fn_match_jax(fused_subnet, lowering):
    _, _, tm = models(fused_subnet, lowering)
    ref = jax_results(fused_subnet, lowering)
    _, z, y = (torch.from_numpy(a) for a in inputs())
    with torch.no_grad():
        xy_t = tm.sample_xy(z, y)
    np.testing.assert_allclose(xy_t.numpy(), ref["sample"], rtol=3e-5, atol=3e-5)
    x_t = make_image_serving_fn(tm, 1, de_logit=True)(z, y)
    assert x_t.shape == (B, 8, 8, 1)
    np.testing.assert_allclose(x_t.numpy(), ref["served"], rtol=3e-5, atol=3e-5)
    q_t = make_image_serving_fn(tm, 1, de_logit=True, quantize_uint8=True)(z, y)
    assert q_t.dtype == torch.uint8
    # JAX's quantize_uint8 on its served values; values within 3e-5 of each
    # other may still round to neighbouring levels
    q_j = np.round(np.clip(ref["served"], 0.0, 1.0) * 255.0).astype(int)
    assert np.abs(q_t.numpy().astype(int) - q_j).max() <= 1


def test_sample_conditional_images_and_moments():
    jm, params, tm = models(True, PALLAS)
    y_image = np.full((8, 8, 1), 0.25, np.float32)
    g = torch.Generator().manual_seed(0)
    x = tsampler.sample_conditional_images(tm, y_image, 16, 1, generator=g, de_logit=True)
    assert x.shape == (16, 8, 8, 1) and torch.isfinite(x).all()
    # same z through the JAX sampler's pieces gives the same images
    g = torch.Generator().manual_seed(0)
    z = torch.randn((16, 8, 8, 1), generator=g)
    y = np.broadcast_to(y_image, (16, 8, 8, 1))
    xy_j = jm.apply({"params": params}, jnp.asarray(z.numpy()), jnp.asarray(y),
                    method="sample_xy")
    x_j = jsampler.postprocess_sampled_xy(xy_j, jnp.asarray(y), 1, de_logit=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=3e-5, atol=3e-5)
    mt = tsampler.conditional_moments(x)
    mj = jsampler.conditional_moments(jnp.asarray(x.numpy()))
    for k in ("mean", "std", "skew"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("residual", [False, True])
def test_postprocess_matches_jax(rng, residual):
    xy = rng.uniform(size=(2, 4, 4, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 4, 4, 2)).astype(np.float32)
    out_t = tsampler.postprocess_sampled_xy(torch.from_numpy(xy), torch.from_numpy(y), 1,
                                            de_logit=True, residual=residual)
    out_j = jsampler.postprocess_sampled_xy(jnp.asarray(xy), jnp.asarray(y), 1,
                                            de_logit=True, residual=residual)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)


def test_flow_takes_the_kernel_wrappers():
    """With pallas_coupling every coupling calls the kernel wrappers (on the
    CPU they return the plain versions, so no launch is counted); without
    it, the plain law."""
    _, _, tm = models(True, PALLAS)
    assert all(c.use_kernel for c in tm.couplings) and len(tm.couplings) == 8
    _, _, tm_plain = models(True, None)
    assert not any(c.use_kernel for c in tm_plain.couplings)
    before = dict(tac.LAUNCHES)
    with torch.no_grad():
        tm(torch.from_numpy(inputs()[0]))
    assert tac.LAUNCHES == before


def test_pallas_subnet_flow_takes_the_chain_wrapper():
    """Under pallas_subnet every subnet is a FusedChainCouplingNet (on the
    CPU its plain version runs, so no launch is counted) and the coupling
    law is the plain one."""
    for fused_subnet, names in ((True, ("net_ab",)), (False, ("net_a", "net_b"))):
        _, _, tm = models(fused_subnet, SUBNET)
        for c in tm.couplings:
            assert not c.use_kernel
            assert all(isinstance(getattr(c, n), FusedChainCouplingNet) for n in names)
    before = dict(tfs.LAUNCHES), dict(tac.LAUNCHES)
    with torch.no_grad():
        tm(torch.from_numpy(inputs()[0]))
    assert (tfs.LAUNCHES, tac.LAUNCHES) == before


@pytest.mark.parametrize("fused_subnet", [True, False])
def test_default_state_dict_loads_into_pallas_subnet_model(fused_subnet):
    """The default lowering's state_dict carries into a pallas_subnet model
    unchanged and gives the same float32 results (the JAX
    tests/test_fused_subnet.py::test_full_model_equivalence)."""
    kw = dict(ARCH, fused_subnet=fused_subnet)
    m0 = ConvCFlow(ConvFlowConfig(**kw), device="cpu", seed=5)
    m1 = ConvCFlow(ConvFlowConfig(**kw, experimental_lowering=SUBNET), device="cpu", seed=6)
    rng = np.random.default_rng(4)
    with torch.no_grad():  # non-zero biases and tanh scales
        for p in m0.parameters():
            if p.dim() <= 1:
                p.add_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)) * 0.05)
    m1.load_state_dict(m0.state_dict())
    xy = torch.from_numpy(inputs()[0])
    with torch.no_grad():
        z0, ld0 = m0(xy)
        z1, ld1 = m1(xy)
        x0, x1 = m0.inverse(z0), m1.inverse(z1)
    torch.testing.assert_close(z1, z0, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(ld1, ld0, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(x1, x0, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(x1, xy, rtol=2e-4, atol=2e-4)


def test_converter_takes_the_dotted_pallas_subnet_tree():
    """pallas_subnet subnets name their leaves with dots
    (``DilatedResidualBlock_0.Conv_1.kernel``); a missing or an extra dotted
    leaf raises."""
    _, params, tm = models(True, SUBNET)
    assert "DilatedResidualBlock_0.Conv_1.kernel" in params["couplings_0"]["net_ab"]
    state = state_dict_from_flax(params, tm)
    w = params["couplings_0"]["net_ab"]["DilatedResidualBlock_0.Conv_1.kernel"]
    assert torch.equal(state["couplings.0.net_ab.blocks.0.branches.0.weight"],
                       torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    missing = {k: dict(v) for k, v in params.items()}
    missing["couplings_2"] = {"net_ab": dict(params["couplings_2"]["net_ab"])}
    del missing["couplings_2"]["net_ab"]["DilatedResidualBlock_0.Conv_2.bias"]
    with pytest.raises(KeyError, match="not set"):
        state_dict_from_flax(missing, tm)
    extra = {k: dict(v) for k, v in params.items()}
    extra["couplings_1"] = {"net_ab": dict(params["couplings_1"]["net_ab"], **{
        "DilatedResidualBlock_0.Conv_9.kernel": np.zeros((1, 1, 1, 1), np.float32)})}
    with pytest.raises(KeyError, match="no port counterpart"):
        state_dict_from_flax(extra, tm)
    twice = {k: dict(v) for k, v in params.items()}
    twice["couplings_1"] = {"net_ab": dict(params["couplings_1"]["net_ab"],
                                           Conv_0={"bias": w[0, 0, 0]})}
    with pytest.raises(KeyError, match="two flax params"):
        state_dict_from_flax(twice, tm)


def test_converter_raises_on_missing_and_extra_keys():
    _, params, tm = models(True, PALLAS)
    missing = {k: dict(v) for k, v in params.items()}
    del missing["couplings_0"]["net_ab"]["tanh_scale"]
    with pytest.raises(KeyError, match="not set"):
        state_dict_from_flax(missing, tm)
    extra = dict(params, couplings_99={"net_ab": {"tanh_scale": np.float32(1.0)}})
    with pytest.raises(KeyError, match="no port counterpart"):
        state_dict_from_flax(extra, tm)
    extra_leaf = {k: dict(v) for k, v in params.items()}
    extra_leaf["couplings_1"]["net_ab"] = dict(extra_leaf["couplings_1"]["net_ab"],
                                               Conv_7={"kernel": np.zeros((1, 1, 1, 1))})
    with pytest.raises(KeyError, match="no port counterpart"):
        state_dict_from_flax(extra_leaf, tm)


def test_bf16_subnets_run_and_invert():
    """bf16 subnet compute keeps a float32 flow: finite outputs, float32
    log-det, exact-enough round trip (the subnets see identical inputs
    both ways)."""
    cfg = ConvFlowConfig(**dict(ARCH, fused_subnet=True, compute_dtype="bfloat16",
                                experimental_lowering="pallas_coupling"))
    tm = ConvCFlow(cfg, device="cpu", seed=0)
    xy = torch.from_numpy(inputs()[0])
    with torch.no_grad():
        zy, ld = tm(xy)
        back = tm.inverse(zy)
    assert zy.dtype == ld.dtype == torch.float32
    torch.testing.assert_close(back, xy, rtol=2e-4, atol=2e-4)
