"""The port's ``ConvCouplingNet`` against the flax one, with the flax
weights carried over by ``convert/from_jax.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.models import subnets as jsubnets  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.models import subnets as tsubnets  # noqa: E402

# the subnet of tests/test_fused_subnet.py: two dilated branches
KW = dict(out_channels=2, num_kernels=16, num_res_blocks=2, cardinality=2,
          ksize=3, dilations=(1, 2))
IN_SHAPE = (8, 8, 2)


def to_numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturb(tree, rng):
    """Non-trivial biases, LayerNorm params and tanh scale, so that each is
    covered by the comparison."""
    if isinstance(tree, dict):
        return {k: perturb(v, rng) for k, v in tree.items()}
    if tree.ndim == 0:
        return np.asarray(1.3, np.float32)
    if tree.ndim == 1:
        return (tree + 0.05 * rng.normal(size=tree.shape)).astype(np.float32)
    return tree


def transplant(pf, net, name):
    """Load the flax subnet tree ``pf`` into the port ``net`` through the
    model-level converter (a holder gives it the ``couplings.0.<name>``
    prefix the converter maps)."""
    holder = torch.nn.Module()
    holder.couplings = torch.nn.ModuleList([torch.nn.Module()])
    setattr(holder.couplings[0], name, net)
    holder.load_state_dict(state_dict_from_flax({"couplings_0": {name: pf}}, holder))


def _nets(rng, *, n_heads, scale_head=False, layer_norm=False, dtype="float32",
          **over):
    kw = dict(KW, **over)
    jdt = jnp.dtype(dtype)
    jnet = jsubnets.ConvCouplingNet(n_heads=n_heads, scale_head=scale_head,
                                    layer_norm=layer_norm, dtype=jdt, **kw)
    x = rng.normal(size=(3,) + IN_SHAPE).astype(np.float32)
    pf = perturb(to_numpy_tree(jnet.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]), rng)
    tnet = tsubnets.ConvCouplingNet(
        IN_SHAPE, n_heads=n_heads, scale_head=scale_head, layer_norm=layer_norm,
        dtype=getattr(torch, dtype), generator=torch.Generator().manual_seed(0), **kw)
    transplant(pf, tnet, "net_ab" if n_heads == 2 else ("net_a" if scale_head else "net_b"))
    out_j = jnet.apply({"params": pf}, jnp.asarray(x))
    with torch.no_grad():
        out_t = tnet(torch.from_numpy(x))
    if n_heads == 1:
        out_j, out_t = (out_j,), (out_t,)
    return [np.asarray(o) for o in out_j], [o.numpy() for o in out_t]


@pytest.mark.parametrize("layer_norm", [False, True])
@pytest.mark.parametrize("n_heads,scale_head", [(2, False), (1, True), (1, False)])
def test_subnet_matches_flax_f32(rng, n_heads, scale_head, layer_norm):
    outs_j, outs_t = _nets(rng, n_heads=n_heads, scale_head=scale_head,
                           layer_norm=layer_norm)
    for oj, ot in zip(outs_j, outs_t):
        assert ot.dtype == np.float32 and ot.shape == oj.shape
        np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)


def test_subnet_even_ksize_asymmetric_same_padding(rng):
    """Even kernels pad total//2 low and the rest high (XLA SAME); a
    symmetric pad would compute another function."""
    outs_j, outs_t = _nets(rng, n_heads=2, ksize=4)
    for oj, ot in zip(outs_j, outs_t):
        np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)


def test_subnet_ref_compat_group_slice(rng):
    outs_j, outs_t = _nets(rng, n_heads=2, ref_compat_group_slice=True)
    for oj, ot in zip(outs_j, outs_t):
        np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer_norm", [False, True])
def test_subnet_matches_flax_bf16(rng, layer_norm):
    """bf16 convs round where flax's do (the conv's output, then the bias
    added in bf16; LeakyReLU's slope rounded to bf16), so every bf16 value
    is the same: the b head is bit-exact, and the A head differs only by
    float32 ulps of ``tanh`` (measured 1.1e-8 and 6.0e-8 on outputs up to
    0.45)."""
    outs_j, outs_t = _nets(rng, n_heads=2, layer_norm=layer_norm, dtype="bfloat16")
    for oj, ot in zip(outs_j, outs_t):
        assert ot.dtype == np.float32  # the head is cast to float32
        np.testing.assert_allclose(ot, oj.astype(np.float32), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(outs_t[1], outs_j[1].astype(np.float32))


def test_leaky_relu_bf16_is_bit_exact_with_flax(rng):
    """On bf16 the slope is 0.3 rounded to bf16, as JAX's weakly typed
    multiply; on float32 it is 0.3."""
    v = rng.normal(size=(4096,)).astype(np.float32) * 10.0
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        ref = np.asarray(jsubnets.leaky_relu(jnp.asarray(v).astype(jdt)).astype(jnp.float32))
        out = tsubnets.leaky_relu(torch.from_numpy(v).to(tdt))
        assert out.dtype == tdt
        np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize("ref_compat_group_slice", [False, True])
@pytest.mark.parametrize("dilations", [(1, 2), (1,)])
def test_subnet_cardinality1_matches_flax(rng, dilations, ref_compat_group_slice):
    """At cardinality 1 each branch is one dense conv of the whole trunk
    with a (k, k, K, K/d) kernel, whatever ref_compat_group_slice says (the
    JAX ``_grouped_conv``); the converter carries that shape across."""
    outs_j, outs_t = _nets(rng, n_heads=2, cardinality=1, dilations=dilations,
                           ref_compat_group_slice=ref_compat_group_slice)
    for oj, ot in zip(outs_j, outs_t):
        np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)
    net = tsubnets.ConvCouplingNet(IN_SHAPE, n_heads=2, layer_norm=False,
                                   generator=torch.Generator().manual_seed(0),
                                   **dict(KW, cardinality=1, dilations=dilations))
    for conv, d in zip(net.blocks[0].branches, dilations):
        assert tuple(conv.weight.shape) == (KW["num_kernels"] // d, KW["num_kernels"], 3, 3)


def test_port_init_orthogonal_with_zero_bias():
    net = tsubnets.ConvCouplingNet(IN_SHAPE, n_heads=2, layer_norm=False,
                                   generator=torch.Generator().manual_seed(0), **KW)
    assert net.tanh_scale.item() == 1.0
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0, name
        elif p.dim() == 4:
            cout = p.shape[0]
            m = p.detach().permute(2, 3, 1, 0).reshape(-1, cout).double()  # (k*k*cin, cout)
            gram = m.T @ m if m.shape[0] >= cout else m @ m.T
            torch.testing.assert_close(gram, 0.01 * torch.eye(gram.shape[0], dtype=gram.dtype),
                                       rtol=0, atol=1e-6)
