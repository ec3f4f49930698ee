"""The port's conv-chain module (``ops/kernels/fused_subnet.py``) against the
JAX package's ``ops/pallas/fused_subnet.py``: the plain version against the
Pallas kernel in interpret mode and against ``subnet_apply_ref``, the weight
order and packing, and ``FusedChainCouplingNet`` against ``ConvCouplingNet``.
The kernel itself needs a card (``tests/test_torch_kernels_gpu.py``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.ops.pallas import fused_subnet as jfs  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models import subnets as tsubnets  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    fused_subnet as tfs,
)

# the spec of tests/test_fused_subnet.py:79-82, then one more residual block,
# an even kernel size (asymmetric SAME padding), an odd size with both, and
# three dilations
BASE = dict(h=8, w=8, cin=2, kernels=16, res_blocks=1, cardinality=2, ksize=3,
            dilations=(1, 2), out_total=4)
SPECS = {
    "base": BASE,
    "res_blocks2": dict(BASE, res_blocks=2),
    "ksize4": dict(BASE, ksize=4),
    "odd": dict(BASE, h=6, w=6, kernels=8, res_blocks=2, ksize=4),
    "dil124": dict(BASE, kernels=32, cardinality=4, dilations=(1, 2, 4)),
}


def spec_pair(name, dtype="float32"):
    kw = dict(SPECS[name], compute_dtype=dtype)
    return tfs.SubnetSpec(**kw), jfs.SubnetSpec(batch_tile=2, **kw)


def weights(spec, seed=0):
    """Flax-shaped weights in flax_param_order, scaled so that activations
    stay O(1) through the chain, with non-zero biases."""
    rng = np.random.default_rng(seed)
    out = []
    for _, shape in tfs.flax_param_order(spec):
        scale = 0.1 if len(shape) == 1 else 1.0 / np.sqrt(np.prod(shape[:-1]))
        out.append((rng.normal(size=shape) * scale).astype(np.float32))
    return out


def x_for(spec, batch=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, spec.h, spec.w, spec.cin)).astype(np.float32)


def port_reference(spec, x, flat):
    packed = tfs.pack(spec, [torch.from_numpy(w) for w in flat])
    return tfs.subnet_apply(spec, torch.from_numpy(x), packed).numpy()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_flax_param_order_matches_jax(name):
    spec, jspec = spec_pair(name)
    assert tfs.flax_param_order(spec) == jfs.flax_param_order(jspec)


@pytest.mark.parametrize("name", ["base", "res_blocks2", "ksize4", "odd"])
def test_reference_matches_jax_pallas_and_ref_f32(name):
    spec, jspec = spec_pair(name)
    flat, x = weights(spec), x_for(spec)
    out = port_reference(spec, x, flat)
    jflat = [jnp.asarray(w) for w in flat]
    ref = np.asarray(jfs.subnet_apply_ref(jspec, jnp.asarray(x), jflat))
    pallas = np.asarray(jfs.subnet_apply_pallas(jspec, jnp.asarray(x), jflat, interpret=True))
    assert out.shape == (4, spec.h, spec.w, spec.out_total) and out.dtype == np.float32
    # float32 sums in another order
    np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_reference_matches_jax_bf16():
    spec, jspec = spec_pair("dil124", "bfloat16")
    flat, x = weights(spec), x_for(spec)
    out = port_reference(spec, x, flat)
    ref = np.asarray(jfs.subnet_apply_ref(jspec, jnp.asarray(x), [jnp.asarray(w) for w in flat]))
    # the same bf16-rounded operands and float32 sums; a sum taken in
    # another order can land on the other side of a bf16 rounding of an
    # intermediate, which moves outputs of size ~1 by about a bf16 ulp (2**-8)
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    assert np.abs(out - ref).mean() < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_then_unpack_gives_the_weights(dtype):
    spec, _ = spec_pair("dil124", dtype)
    flat = [torch.from_numpy(w) for w in weights(spec)]
    weights_buf, biases_buf = tfs.pack(spec, flat)
    assert weights_buf.dtype == getattr(torch, dtype) and biases_buf.dtype == torch.float32
    assert (weights_buf.numel(), biases_buf.numel()) == tfs.packed_sizes(spec)
    for (name, _), w, back in zip(tfs.flax_param_order(spec), flat,
                                  tfs.unpack(spec, (weights_buf, biases_buf))):
        expect = w.to(getattr(torch, dtype)) if name.endswith("kernel") else w
        assert torch.equal(back, expect), name


def _chain_nets(dtype=torch.float32, n_heads=2, scale_head=False, seed=0):
    kw = dict(in_shape=(8, 8, 2), out_channels=2, num_kernels=16, num_res_blocks=2,
              cardinality=2, ksize=3, dilations=(1, 2), n_heads=n_heads,
              scale_head=scale_head, dtype=dtype)
    fused = tsubnets.FusedChainCouplingNet(generator=torch.Generator().manual_seed(seed), **kw)
    conv = tsubnets.ConvCouplingNet(layer_norm=False,
                                    generator=torch.Generator().manual_seed(seed), **kw)
    return fused, conv


@pytest.mark.parametrize("n_heads,scale_head", [(2, False), (1, True), (1, False)])
def test_fused_chain_net_equals_conv_coupling_net_f32(n_heads, scale_head):
    """Same parameter names and seeded init as ConvCouplingNet; at float32
    the same values and, through the plain version, the same gradients."""
    fused, conv = _chain_nets(n_heads=n_heads, scale_head=scale_head)
    assert list(fused.state_dict()) == list(conv.state_dict())
    for k, v in conv.state_dict().items():
        assert torch.equal(fused.state_dict()[k], v), k
    rng = np.random.default_rng(2)
    with torch.no_grad():  # non-zero biases and tanh scale
        for name, p in conv.named_parameters():
            if p.dim() <= 1:
                p.add_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)) * 0.05)
    fused.load_state_dict(conv.state_dict())
    x = torch.from_numpy(x_for(fused.spec, batch=3))
    out_f, out_c = fused(x), conv(x)
    out_f = out_f if isinstance(out_f, tuple) else (out_f,)
    out_c = out_c if isinstance(out_c, tuple) else (out_c,)
    for a, b in zip(out_f, out_c):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    sum(o.square().sum() for o in out_f).backward()
    sum(o.square().sum() for o in out_c).backward()
    grads_c = dict(conv.named_parameters())
    for name, p in fused.named_parameters():
        torch.testing.assert_close(p.grad, grads_c[name].grad, rtol=1e-4, atol=1e-5)


def test_packed_weights_follow_load_state_dict():
    fused, _ = _chain_nets(dtype=torch.bfloat16)
    other, _ = _chain_nets(dtype=torch.bfloat16, seed=1)
    x = torch.from_numpy(x_for(fused.spec, batch=2))
    with torch.inference_mode():
        first_a, _ = fused(x)
        packed = fused.packed()
        assert fused.packed() is packed  # kept while no parameter changes
    with torch.no_grad():
        fused.load_state_dict(other.state_dict())
        a, b = fused(x)
        a_other, b_other = other(x)
        assert fused.packed() is not packed
    assert not torch.equal(a, first_a)
    assert torch.equal(a, a_other) and torch.equal(b, b_other)


def test_launch_guards_raise_before_launching():
    big = tfs.SubnetSpec(**dict(BASE, h=64, w=64, kernels=64, compute_dtype="float32"))
    assert tfs.shared_bytes(big) > tfs.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tfs.check_launch(big, 1)
    many = tfs.SubnetSpec(**dict(BASE, kernels=32, dilations=(1, 2, 4, 8, 16)))
    with pytest.raises(ValueError, match="dilations"):
        tfs.check_launch(many, 1)
    with pytest.raises(ValueError, match="int32"):
        tfs.check_launch(tfs.SubnetSpec(**BASE), 2**31)
    with pytest.raises(ValueError, match="cardinality"):
        tfs.SubnetSpec(**dict(BASE, cardinality=1))
    spec = tfs.SubnetSpec(**BASE)
    flat = [torch.from_numpy(w) for w in weights(spec)]
    packed = [t.to("meta") for t in tfs.pack(spec, flat)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfs.subnet_apply(spec, torch.empty(1, 8, 8, 2, device="meta"), packed)
    # the flagship's largest spec fits at both dtypes
    flagship = dict(h=28, w=28, cin=1, kernels=64, res_blocks=3, cardinality=8, ksize=3,
                    dilations=(1, 2, 4), out_total=2)
    for dtype in ("bfloat16", "float32"):
        tfs.check_launch(tfs.SubnetSpec(**flagship, compute_dtype=dtype), 128)


def test_launch_limits_mirror_the_cuda_source():
    src = (Path(tfs.__file__).resolve().parents[2] / "csrc" / "fused_subnet.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == tfs.THREADS
    assert int(consts["kTile"]) == tfs.TILE
    assert int(consts["kMaxBranches"]) == tfs.MAX_BRANCHES
    assert int(consts["kMaxShared"]) == tfs.MAX_SHARED_BYTES


def test_flops_count_grouped_work():
    """The flagship's four specs: 50.4 GFLOP a pass at batch 128, four
    launches of each."""
    specs = [(14, 14, 4, 32, 8, (1, 2, 4), 8), (28, 28, 1, 64, 8, (1, 2, 4), 2),
             (7, 7, 8, 16, 4, (1, 2), 16), (14, 14, 2, 32, 4, (1, 2), 4)]
    total = sum(4 * tfs.flops(tfs.SubnetSpec(h, w, c, K, 3, card, 3, d, o), 128)
                for h, w, c, K, card, d, o in specs)
    assert abs(total / 1e9 - 50.4) < 0.05
    spec = tfs.SubnetSpec(**BASE)
    assert tfs.io_bytes(spec, 4) == 4 * 4 * 64 * (2 + 4) + 2 * tfs.packed_sizes(spec)[0] \
        + 4 * tfs.packed_sizes(spec)[1]
