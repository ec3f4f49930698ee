"""The port's gradients against the JAX package's, on the CPU: K1's and K3's
``torch.autograd.Function`` s against ``jax.vjp`` of the JAX custom VJPs
(``fused_affine_forward``, ``make_subnet_fn``), and every parameter's
gradient of the model's ``log_loss`` against ``jax.grad`` on transplanted
weights under the default, ``pallas_coupling`` and ``pallas_subnet``
lowerings. The port's CPU tensors take the kernels' plain forwards inside the
same ``Function`` s that launch the kernels on the card, so the backward
tested here is the card's. JAX runs jitted: its bf16 gradients, measured
both jitted and op by op (as flax rounds each bf16 op), differ from the
port's by the same figures (those beside each bound)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_flow as flow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops.pallas import affine_coupling as jac  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops.pallas import fused_subnet as jfs  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    affine_coupling as tac,
)
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    fused_subnet as tfs,
)


def _rel(got, want):
    """max |got - want| over max |want|: the error on the tensor's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# K1: fused_affine_forward
# ---------------------------------------------------------------------------


def _law_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = np.tanh(rng.normal(size=shape))
    b, u2, g_v2 = (rng.normal(size=shape) for _ in range(3))
    g_ld = rng.normal(size=shape[:1])
    return [v.astype(np.float32) for v in (a, b, u2, g_v2, g_ld)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_forward_function_matches_jax_vjp(dtype):
    a, b, u2, g_v2, g_ld = _law_inputs((8, 4, 4, 2), seed=0)
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(v, jdt) for v in (a, b, u2)]
    _, vjp = jax.vjp(jac.fused_affine_forward, *jargs)
    want = vjp((jnp.asarray(g_v2, jdt), jnp.asarray(g_ld)))

    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(v).to(tdt).requires_grad_() for v in (a, b, u2)]
    v2, ld = tac.fused_affine_forward(*targs)
    assert type(v2.grad_fn).__name__ == "_AffineForwardBackward"
    got = torch.autograd.grad((v2, ld), targs,
                              (torch.from_numpy(g_v2).to(tdt), torch.from_numpy(g_ld)))
    for name, gt, gj in zip(("da", "db", "du2"), got, want):
        assert gt.dtype == tdt and gt.shape == a.shape
        gt, gj = gt.float().numpy(), np.asarray(gj, np.float32)
        if dtype == "float32":
            # the tolerances of tests/test_pallas_kernels.py::
            # test_fused_gradients_match_reference
            np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            # the same bf16 ops in the same order; exp of the two libraries
            # may differ by a float32 ulp, which can flip a bf16 rounding:
            # at most one bf16 ulp (2**-8 relative). Measured: bit-exact
            np.testing.assert_allclose(gt, gj, rtol=2**-8, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# K3: subnet_apply
# ---------------------------------------------------------------------------

# group widths (channels a group) 8, 4 and 2, then 2 and 1
CHAIN_SPECS = {
    "groups8_4_2": dict(h=6, w=6, cin=2, kernels=32, res_blocks=1, cardinality=4, ksize=3,
                        dilations=(1, 2, 4), out_total=4),
    "groups2_1": dict(h=5, w=7, cin=3, kernels=16, res_blocks=1, cardinality=8, ksize=3,
                      dilations=(1, 2), out_total=4),
}
# float32: the 3e-4 of tests/test_fused_subnet.py:94-116, elementwise
# (measured: 6.0e-7 of the largest gradient). bf16: the worst relative error
# (max |diff| / max |JAX's|) over x and every weight; the two frameworks
# round the cotangents to bf16 at other points (JAX's dot_general
# transposes, the port's autograd of its roundings), and a pre-1x1 bias,
# whose gradient sums them over every pixel, moves most: measured 9.7e-3
# (groups2_1) and 1.14e-2 (groups8_4_2) op by op, 9.7e-3 and 1.1e-2 jitted
CHAIN_F32_TOL = 3e-4
CHAIN_BF16_TOL = 3e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CHAIN_SPECS))
def test_subnet_function_matches_jax_vjp(name, dtype):
    kw = dict(CHAIN_SPECS[name], compute_dtype=dtype)
    spec, jspec = tfs.SubnetSpec(**kw), jfs.SubnetSpec(batch_tile=2, **kw)
    rng = np.random.default_rng(3)
    flat = [(rng.normal(size=shape) * (0.1 if len(shape) == 1 else np.prod(shape[:-1]) ** -0.5))
            .astype(np.float32) for _, shape in tfs.flax_param_order(spec)]
    x = rng.normal(size=(3, spec.h, spec.w, spec.cin)).astype(np.float32)
    g = rng.normal(size=(3, spec.h, spec.w, spec.out_total)).astype(np.float32)

    def jax_vjp(x, flat, g):
        return jax.vjp(jfs.make_subnet_fn(jspec), x, flat)[1](g)

    gx_j, gflat_j = jax.jit(jax_vjp)(jnp.asarray(x), [jnp.asarray(w) for w in flat],
                                     jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    flat_t = [torch.from_numpy(w).requires_grad_() for w in flat]
    out_t = tfs.subnet_apply(spec, xt, tfs.pack(spec, flat_t))
    assert type(out_t.grad_fn).__name__ == "_SubnetApplyBackward"
    got = torch.autograd.grad(out_t, [xt] + flat_t, torch.from_numpy(g))
    want = [gx_j] + list(gflat_j)
    names = ["x"] + [n for n, _ in tfs.flax_param_order(spec)]
    if dtype == "float32":
        for n, gt, gj in zip(names, got, want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=CHAIN_F32_TOL,
                                       atol=CHAIN_F32_TOL, err_msg=n)
    else:
        errs = {n: _rel(gt.numpy(), gj) for n, gt, gj in zip(names, got, want)}
        worst = max(errs, key=errs.get)
        assert errs[worst] < CHAIN_BF16_TOL, (worst, errs[worst])


def test_subnet_function_refuses_a_second_derivative():
    """K3's backward takes its gradients outside the caller's graph, so a
    second derivative through it raises instead of coming out wrong."""
    spec = tfs.SubnetSpec(**CHAIN_SPECS["groups2_1"], compute_dtype="float32")
    rng = np.random.default_rng(5)
    flat = [torch.from_numpy((rng.normal(size=shape) * 0.1).astype(np.float32))
            for _, shape in tfs.flax_param_order(spec)]
    x = torch.from_numpy(rng.normal(size=(2, spec.h, spec.w, spec.cin)).astype(np.float32))
    x.requires_grad_()
    out = tfs.subnet_apply(spec, x, tfs.pack(spec, flat))
    g_x, = torch.autograd.grad(out.square().sum(), [x], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g_x.sum().backward()


# ---------------------------------------------------------------------------
# the model: log_loss
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def bf16_models():
    """(jax model, flax params, port model on the CPU) at the small arch in
    bf16 on the default lowering, weights as :func:`test_torch_flow.models`."""
    kw = dict(flow.ARCH, fused_subnet=True, compute_dtype="bfloat16")
    jm = JConvCFlow(JConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2,) + flow.ARCH["io_shape"]))["params"]
    params = flow.perturb(flow.to_numpy_tree(params), np.random.default_rng(1))
    tm = ConvCFlow(ConvFlowConfig(**kw), device="cpu", seed=3)
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def f32_models():
    """(JAX's float32 ``log_loss`` gradients on the default lowering, port
    model for each lowering) on one set of weights, as
    :func:`test_torch_flow.models`. One ``jax.grad`` serves the three port
    lowerings: JAX's lowerings differ only in their Pallas kernels, whose
    VJPs JAX's own tests hold to the plain path
    (``tests/test_pallas_kernels.py::test_fused_gradients_match_reference``,
    ``tests/test_fused_subnet.py::test_gradients_match_flax``), and the
    jit of each JAX lowering's gradient is the file's costliest step."""
    jm, params, _ = flow.models(True, None)
    want = jax_loss_grads(jm, params, flow.inputs()[0])
    port = {}
    for lowering in (None, flow.PALLAS, flow.SUBNET):
        kw = dict(flow.ARCH, fused_subnet=True, experimental_lowering=lowering)
        tm = ConvCFlow(ConvFlowConfig(**kw), device="cpu", seed=3)
        tm.load_state_dict(state_dict_from_flax(params, tm))
        port[lowering] = tm
    return want, port


def jax_loss_grads(jm, params, xy):
    """``jax.grad`` of JAX's ``log_loss``'s loss, its Pallas coupling
    kernels in interpret mode, as numpy."""
    def loss(p):
        return jm.apply({"params": p}, jnp.asarray(xy), method="log_loss")["loss"]

    old = jac.INTERPRET
    jac.INTERPRET = True
    try:
        grads = jax.jit(jax.grad(loss))(params)
    finally:
        jac.INTERPRET = old
    return flow.to_numpy_tree(grads)


# the worst relative error (max |diff| / max |JAX's|) over the parameters.
# float32, sums in another order, against JAX's default lowering
# (:func:`f32_models`): measured 5.9e-7 (default), 7.2e-7 (pallas_coupling),
# 5.5e-7 (pallas_subnet); 6.1e-6 with unfused subnets
# under pallas_coupling (not a case here, for time). bf16: measured 6.6e-2,
# on a head bias, with a median of 7.7e-3 over the parameters (jitted or op
# by op). JAX sums a bf16 bias's cotangent in bf16 and PyTorch in float32:
# against the same weights' float32 gradient, JAX's bias gradients are off
# by up to 7.2e-2 and the port's by 5.6e-4 there
MODEL_TOL = {"float32": 3e-5, "bfloat16": 0.15}
MODEL_BF16_MEDIAN_TOL = 2e-2


@pytest.mark.parametrize("lowering,dtype", [
    pytest.param(None, "float32", id="default"),
    pytest.param(flow.PALLAS, "float32", id="pallas_coupling"),
    pytest.param(flow.SUBNET, "float32", id="pallas_subnet"),
    pytest.param(None, "bfloat16", id="default-bf16"),
])
def test_log_loss_gradients_match_jax(lowering, dtype):
    xy = flow.inputs()[0]
    if dtype == "float32":
        grads, port = f32_models()
        tm = port[lowering]
    else:
        jm, params, tm = bf16_models()
        grads = jax_loss_grads(jm, params, xy)
    want = state_dict_from_flax(grads, tm)
    named = dict(tm.named_parameters())
    loss = tm.log_loss(torch.from_numpy(xy))["loss"]
    got = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert set(got) == set(want)
    errs = {k: _rel(got[k].numpy(), want[k].numpy()) for k in got}
    worst = max(errs, key=errs.get)
    assert errs[worst] < MODEL_TOL[dtype], (worst, errs[worst])
    if dtype == "bfloat16":
        assert np.median(list(errs.values())) < MODEL_BF16_MEDIAN_TOL
