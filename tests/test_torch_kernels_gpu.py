"""The hand-written kernels against their plain versions on a CUDA card:
the coupling law (K1/K2) and the coupling subnet's conv chain (K3); the
train step replayed as a CUDA graph against eager steps, with K1/K3
launching inside the replay; and the seeded serving entry replayed as a
CUDA graph against the eager entry, with K2/K3 launching inside the replay;
K1-K3 at noise pre-training's batch of 512; the toy cINN's train step
and seeded serving entry as CUDA graphs against their eager runs; the
record path's streaming sources against the in-RAM ones on the card; and
the data-parallel step in a one-process NCCL group (the gradient
all-reduce inside the graph) against the plain step.

Needs a card and imports no JAX, so it runs on a machine with a card and
without jax, skipping the repo's conftest (which configures JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test here skips.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    affine_coupling as tac,
)
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    fused_subnet as tfs,
)

from arl_conditional_normalizing_flows_tpu_torch.serve import export  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.train import CheckpointManager, loop  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(shape, dtype, device):
    rng = np.random.default_rng(0)
    a = np.tanh(rng.normal(size=shape))
    b, u = rng.normal(size=shape), rng.normal(size=shape)
    return [torch.from_numpy(v.astype(np.float32)).to(device, dtype) for v in (a, b, u)]


def _rel(got, want):
    """max |got - want| over max |want|: the error on the tensor's scale."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# the main path's rows, a ragged n, then odd n (the scalar path) at rank 4
# and 2; then rows wider than K1's 1024-thread block (float32: 2050 vectors,
# bf16: 1025; odd: 4099 scalars), looped, and a tensor larger than K2's
# one-wave grid, looped
LAW_SHAPES = [(128, 784), (128, 392), (3, 1000), (3, 5, 7, 3), (5, 393), (4, 8200),
              (3, 4099), (1024, 4096)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LAW_SHAPES)
def test_kernels_match_plain_versions(cuda, shape, dtype):
    a, b, u = _inputs(shape, getattr(torch, dtype), cuda)
    _check_law(a, b, u, shape, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["a", "u2", "all"])
@pytest.mark.parametrize("shape", [(128, 784), (4, 8200), (1024, 4096)])
def test_kernels_take_misaligned_views(cuda, shape, which, dtype):
    """A contiguous view one element past a 16-byte boundary takes the
    scalar path and gives the same values, at the main path's rows and at
    the looped shapes of :data:`LAW_SHAPES`."""
    a, b, u = _inputs(shape, getattr(torch, dtype), cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    if which in ("a", "all"):
        a = shifted(a)
    if which in ("u2", "all"):
        u = shifted(u)
    if which == "all":
        b = shifted(b)
    _check_law(a, b, u, shape, dtype)


def _check_law(a, b, u, shape, dtype):
    before = dict(tac.LAUNCHES)
    with torch.no_grad():
        v2, ld = tac.fused_affine_forward(a, b, u)
        v2r, ldr = tac.affine_forward_reference(a, b, u)
        u2 = tac.fused_affine_inverse(a, b, v2)
        u2r = tac.affine_inverse_reference(a, b, v2)
    torch.cuda.synchronize()
    assert tac.LAUNCHES["affine_forward"] == before["affine_forward"] + 1
    assert tac.LAUNCHES["affine_inverse"] == before["affine_inverse"] + 1
    assert v2.dtype == a.dtype and ld.dtype == torch.float32 and ld.shape == (shape[0],)
    # float32: expf against torch.exp, a few ulps; bf16: the same float32
    # value rounded once, at most one bf16 ulp apart
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(v2, v2r, rtol=tol, atol=tol)
    torch.testing.assert_close(ld, ldr, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(u2, u2r, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LAW_SHAPES)
def test_affine_forward_gradients_match_plain_version(cuda, shape, dtype):
    """Through K1 (counted), the autograd.Function's backward gives the
    gradients of autograd through the plain version."""
    ts = [t.requires_grad_() for t in _inputs(shape, getattr(torch, dtype), cuda)]

    def grads(fn):
        v2, ld = fn(*ts)
        return torch.autograd.grad(v2.float().square().sum() + 2.0 * ld.sum(), ts)

    before = tac.LAUNCHES["affine_forward"]
    got = grads(tac.fused_affine_forward)
    assert tac.LAUNCHES["affine_forward"] == before + 1
    want = grads(tac.affine_forward_reference)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == "float32":
            # as tests/test_pallas_kernels.py::test_fused_gradients_match_reference
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        else:
            # the backward in bf16 ops (as JAX's) against autograd's float32
            # ops rounded once: a few bf16 roundings, measured on the CPU at
            # these shapes 6.5e-3 of the largest gradient
            assert _rel(g, w) < 2e-2


def test_kernels_reject_what_they_do_not_take(cuda):
    a, b, u = _inputs((4, 6), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tac.fused_affine_forward(a.t(), b.t(), u.t())
    with pytest.raises(ValueError, match="dtype"):
        tac.fused_affine_forward(a.half(), b.half(), u.half())
    with pytest.raises(ValueError, match="dtype"):
        tac.fused_affine_inverse(a, b, u.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shapes"):
        tac.fused_affine_inverse(a, b, u[:2])
    # the JAX fused_affine_inverse defines no gradient; K1 has one
    with pytest.raises(NotImplementedError, match="defines no gradient"):
        tac.fused_affine_inverse(a.requires_grad_(), b, u)


# a small odd size with an even kernel (asymmetric padding), the four specs
# of the flagship's couplings at the main path's batch of 128, then pixel
# counts that fill no 16-pixel tile of the bf16 kernel with cin 3 and 1 and
# group widths 4, 3, 2 and 1
CHAIN_SPECS = {
    "odd_6x6x2": dict(h=6, w=6, cin=2, kernels=8, res_blocks=2, cardinality=2, ksize=4,
                      dilations=(1, 2), out_total=4),
    "flagship_14x14x4": dict(h=14, w=14, cin=4, kernels=32, res_blocks=3, cardinality=8,
                             ksize=3, dilations=(1, 2, 4), out_total=8),
    "flagship_28x28x1": dict(h=28, w=28, cin=1, kernels=64, res_blocks=3, cardinality=8,
                             ksize=3, dilations=(1, 2, 4), out_total=2),
    "flagship_7x7x8": dict(h=7, w=7, cin=8, kernels=16, res_blocks=3, cardinality=4,
                           ksize=3, dilations=(1, 2), out_total=16),
    "flagship_14x14x2": dict(h=14, w=14, cin=2, kernels=32, res_blocks=3, cardinality=4,
                             ksize=3, dilations=(1, 2), out_total=4),
    "tiles_5x3x3": dict(h=5, w=3, cin=3, kernels=32, res_blocks=2, cardinality=8, ksize=3,
                        dilations=(1, 2, 4), out_total=4),
    "groups1_7x7x1": dict(h=7, w=7, cin=1, kernels=16, res_blocks=2, cardinality=8, ksize=3,
                          dilations=(1, 2), out_total=2),
    # groups of 3 channels: input windows of 1-3 slices, one moved left
    "groups3_3x4x1": dict(h=3, w=4, cin=1, kernels=24, res_blocks=2, cardinality=8, ksize=3,
                          dilations=(1,), out_total=2),
}


def _chain_weights(spec, device, rng):
    """Flax-shaped weights from numpy: kernels N(0, 1/fan_in) so that
    activations stay O(1) through the chain, biases N(0, 0.01)."""
    flat = []
    for _, shape in tfs.flax_param_order(spec):
        scale = 0.1 if len(shape) == 1 else 1.0 / np.sqrt(np.prod(shape[:-1]))
        flat.append(torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)))
    return [t.to(device) for t in flat]


def _chain_inputs(spec, batch, device, wide_variant=None):
    """x and packed weights (:func:`_chain_weights`) from numpy, packed for
    the variant :func:`tfs.wide` picks unless ``wide_variant`` says."""
    rng = np.random.default_rng(0)
    flat = _chain_weights(spec, "cpu", rng)
    x = rng.normal(size=(batch, spec.h, spec.w, spec.cin)).astype(np.float32)
    packed = tfs.pack(spec, flat, wide_variant=wide_variant)
    return torch.from_numpy(x).to(device), [t.to(device) for t in packed]


BATCH = 128


@pytest.fixture
def no_tf32(monkeypatch):
    """The plain version's float32 convs in full float32, not TF32."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.fixture
def deterministic_cudnn(monkeypatch):
    """cuDNN's deterministic algorithms, for tests that compare two runs bit
    for bit: its default weight gradients may sum in another order from one
    run to the next."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


def _builds_after(spec, before):
    """Whether the launches by build since ``before`` (a copy of
    BUILD_LAUNCHES) are one launch of the build that ``spec`` names."""
    build = tfs.kernel_build(spec)
    return {k: v - before.get(k, 0) for k, v in tfs.BUILD_LAUNCHES.items()
            if v != before.get(k, 0)} == {build: 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CHAIN_SPECS))
def test_chain_kernel_matches_plain_version(cuda, no_tf32, name, dtype):
    spec = tfs.SubnetSpec(**CHAIN_SPECS[name], compute_dtype=dtype)
    batch = BATCH if name.startswith("flagship") else 3
    x, packed = _chain_inputs(spec, batch, cuda)
    before, builds = tfs.LAUNCHES["fused_subnet"], dict(tfs.BUILD_LAUNCHES)
    with torch.no_grad():
        out = tfs.subnet_apply(spec, x, packed)
        ref = tfs.subnet_apply_reference(spec, x, packed)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES["fused_subnet"] == before + 1 and _builds_after(spec, builds)
    # every spec here takes the narrow tensor-core kernel of its dtype
    assert tfs.kernel_build(spec).startswith("bf16" if dtype == "bfloat16" else "tf32")
    assert out.shape == (batch, spec.h, spec.w, spec.out_total) and out.dtype == torch.float32
    # float32: sums in another order; bf16: a float32 sum in another order
    # can land on the other side of a bf16 rounding of an intermediate,
    # which moves outputs of size ~1 by about a bf16 ulp (2**-8)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


def test_chain_kernel_rejects_what_it_does_not_take(cuda):
    spec = tfs.SubnetSpec(**CHAIN_SPECS["odd_6x6x2"], compute_dtype="float32")
    x, (w, b) = _chain_inputs(spec, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfs.subnet_apply(spec, x.transpose(1, 2), (w, b))
    with pytest.raises(ValueError, match="float32 x"):
        tfs.subnet_apply(spec, x, (w.to(torch.bfloat16), b))
    with pytest.raises(ValueError, match="packed sizes"):
        tfs.subnet_apply(spec, x, (w[:-1], b))
    with pytest.raises(ValueError, match="is not"):
        tfs.subnet_apply(spec, x[..., :1].contiguous(), (w, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["odd_6x6x2", "flagship_14x14x4", "tiles_5x3x3"])
def test_chain_gradients_match_plain_version(cuda, no_tf32, name, dtype):
    """Through K3 (counted), the autograd.Function's recomputing backward
    gives the gradients of autograd through the plain version, for x and
    the flax-shaped weights through pack. The loss's cotangent is the
    forward's output, so the kernel's values reach the gradients."""
    spec = tfs.SubnetSpec(**CHAIN_SPECS[name], compute_dtype=dtype)
    batch = BATCH if name.startswith("flagship") else 3
    x, _ = _chain_inputs(spec, batch, cuda)
    flat = [t.requires_grad_() for t in _chain_weights(spec, cuda, np.random.default_rng(1))]
    x.requires_grad_()

    def grads(fn):
        out = fn(spec, x, tfs.pack(spec, flat))
        return torch.autograd.grad(out.square().sum() / 2, [x] + flat)

    before = tfs.LAUNCHES["fused_subnet"]
    got = grads(tfs.subnet_apply)
    assert tfs.LAUNCHES["fused_subnet"] == before + 1
    want = grads(tfs.subnet_apply_reference)
    torch.cuda.synchronize()
    # float32: the kernel's output within 1e-4 of the plain version's (sums
    # in another order); bf16: within 2e-2, a bf16 ulp flipped here and there
    tol = 1e-4 if dtype == "float32" else 2e-2
    for (n, _), g, w in zip([("x", None)] + list(tfs.flax_param_order(spec)), got, want):
        assert _rel(g, w) < tol, n


def test_bf16_chain_kernel_rejects_what_it_does_not_take(cuda):
    """More branches than any config has raise before launching; a packed
    buffer of another layout's size raises too. A trunk over 64 wide, once
    refused, takes the wide variant."""
    many = tfs.SubnetSpec(**dict(CHAIN_SPECS["odd_6x6x2"], kernels=2048, cardinality=2,
                                 dilations=tuple(2 ** i for i in range(11))),
                          compute_dtype="float32")
    x = torch.zeros(2, many.h, many.w, many.cin, device=cuda)
    packed = [torch.zeros(n, device=cuda) for n in tfs.packed_sizes(many)]
    with pytest.raises(ValueError, match="dilations"):
        with torch.no_grad():
            tfs.subnet_apply(many, x, packed)
    wide = tfs.SubnetSpec(**dict(CHAIN_SPECS["odd_6x6x2"], kernels=72),
                          compute_dtype="bfloat16")
    x, packed = _chain_inputs(wide, 2, cuda)
    with torch.no_grad():
        out = tfs.subnet_apply(wide, x, packed)
        torch.testing.assert_close(out, tfs.subnet_apply_reference(wide, x, packed),
                                   rtol=2e-2, atol=2e-2)
    spec = tfs.SubnetSpec(**CHAIN_SPECS["odd_6x6x2"], compute_dtype="bfloat16")
    x, (w, b) = _chain_inputs(spec, 2, cuda)
    f32 = dataclasses.replace(spec, compute_dtype="float32")
    with pytest.raises(ValueError, match="packed sizes"):
        with torch.no_grad():
            tfs.subnet_apply(spec, x, (w[: tfs.packed_sizes(f32)[0]], b))


# the JAX package's capacity preset (perf_arch_config): its four conv chains,
# two past the narrow bf16 kernel (K 128), and a small spec past both its
# trunk and head tiles
WIDE_SPECS = {
    "preset_14x14x4": dict(h=14, w=14, cin=4, kernels=64, res_blocks=3, cardinality=8,
                           ksize=3, dilations=(1, 2, 4), out_total=8),
    "preset_28x28x1": dict(h=28, w=28, cin=1, kernels=128, res_blocks=3, cardinality=8,
                           ksize=3, dilations=(1, 2, 4), out_total=2),
    "preset_7x7x8": dict(h=7, w=7, cin=8, kernels=64, res_blocks=3, cardinality=8, ksize=3,
                         dilations=(1, 2), out_total=16),
    "preset_14x14x2": dict(h=14, w=14, cin=2, kernels=128, res_blocks=3, cardinality=8,
                           ksize=3, dilations=(1, 2), out_total=4),
    "wide_6x6x1": dict(h=6, w=6, cin=1, kernels=128, res_blocks=1, cardinality=8, ksize=3,
                       dilations=(1, 2, 4), out_total=40),
    # five dilated branches (a schedule of 66 x 66 images and up)
    "dil5_8x8x2": dict(h=8, w=8, cin=2, kernels=32, res_blocks=2, cardinality=2, ksize=3,
                       dilations=(1, 2, 4, 8, 16), out_total=4),
    # a stage input past shared memory (rows of 264 channels, ~414 KB): the
    # wide bf16 kernel's path with the stage input in scratch, two wgmma
    # passes over the trunk
    "scratch_28x28x1": dict(h=28, w=28, cin=1, kernels=256, res_blocks=3, cardinality=8,
                            ksize=3, dilations=(1, 2, 4), out_total=2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(WIDE_SPECS))
def test_chain_kernel_matches_plain_version_at_the_preset(cuda, no_tf32, name, dtype):
    """K3 at the capacity preset's specs (batch 128), small wide specs and
    one whose stage input does not fit shared memory (the wide bf16 kernel's
    two paths), on the variant the spec picks, with the tolerances of the
    flagship's."""
    spec = tfs.SubnetSpec(**WIDE_SPECS[name], compute_dtype=dtype)
    if dtype == "bfloat16" and name.startswith("preset_") and spec.kernels == 128:
        assert tfs.mma_layout(spec).act_in_shared
    if dtype == "bfloat16" and name.startswith("scratch"):
        assert not tfs.mma_layout(spec).act_in_shared
    batch = BATCH if name.startswith("preset") else 3
    x, packed = _chain_inputs(spec, batch, cuda)
    before, builds = tfs.LAUNCHES["fused_subnet"], dict(tfs.BUILD_LAUNCHES)
    with torch.no_grad():
        out = tfs.subnet_apply(spec, x, packed)
        ref = tfs.subnet_apply_reference(spec, x, packed)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES["fused_subnet"] == before + 1 and _builds_after(spec, builds)
    assert out.shape == (batch, spec.h, spec.w, spec.out_total)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


#: the narrow bf16 kernel's scratch plan besides the flagship's 28 x 28 (49
#: tiles, the 49th split): 34 tiles (two split), 25 and 32 tiles (none), 17
SCRATCH_SPECS = {
    "scratch_23x23x1": dict(h=23, w=23, cin=1, kernels=32, res_blocks=2, cardinality=8,
                            ksize=3, dilations=(1, 2, 4), out_total=2),
    "scratch_20x20x2": dict(h=20, w=20, cin=2, kernels=16, res_blocks=1, cardinality=4,
                            ksize=3, dilations=(1, 2), out_total=4),
    "scratch_32x16x3": dict(h=32, w=16, cin=3, kernels=24, res_blocks=2, cardinality=8,
                            ksize=3, dilations=(1,), out_total=2),
    # 17 tiles (one split), a trunk of 5 n8 tiles and a head of 3
    "scratch_17x16x1": dict(h=17, w=16, cin=1, kernels=40, res_blocks=1, cardinality=4,
                            ksize=3, dilations=(1, 2), out_total=20),
}
#: the narrow bf16 kernel's specs: the flagship's four (its 28 x 28 on the
#: scratch plan, the rest on chip), the preset's two narrow ones, the odd
#: ones (on chip) and the scratch plan's others
NARROW_SPECS = [*CHAIN_SPECS, "preset_14x14x4", "preset_7x7x8", *SCRATCH_SPECS]
SPLIT = {"flagship_28x28x1": 1, "scratch_23x23x1": 2, "scratch_20x20x2": 0, "scratch_32x16x3": 0,
         "scratch_17x16x1": 1}


@pytest.mark.parametrize("batch", [1, BATCH, 133, 2048])
@pytest.mark.parametrize("name", NARROW_SPECS)
def test_narrow_bf16_kernel_matches_plain_version_at_every_batch(cuda, no_tf32, name, batch):
    """The narrow bf16 kernel on the plan its spec picks (narrow_plan), at
    one sample, the main path's 128, a batch past one block an SM (133 on
    132 SMs) and the serving call's 2,048, against its plain version, with
    the tolerances of batch 128."""
    spec = tfs.SubnetSpec(**(CHAIN_SPECS.get(name) or WIDE_SPECS.get(name)
                             or SCRATCH_SPECS[name]), compute_dtype="bfloat16")
    plan = tfs.narrow_plan(spec)
    assert not tfs.wide(spec) and plan.on_chip == (name not in SPLIT)
    assert plan.split_tiles == SPLIT.get(name, 0)
    assert (tfs.trunk_elements(spec, batch) == 0) == plan.on_chip
    x, packed = _chain_inputs(spec, batch, cuda)
    before = tfs.LAUNCHES["fused_subnet"]
    with torch.no_grad():
        out = tfs.subnet_apply(spec, x, packed)
        torch.cuda.synchronize()
        ref = tfs.subnet_apply_reference(spec, x, packed)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES["fused_subnet"] == before + 1
    assert out.shape == (batch, spec.h, spec.w, spec.out_total)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


#: the build of csrc/fused_subnet.cu that each float32 spec names
#: (fused_subnet.py::kernel_build): the narrow kernel's tf32 products on
#: chip or on the scratch plan, the wide variant's tf32 build past its tiles
F32_BUILDS = {"flagship_14x14x4": "tf32 on chip", "flagship_28x28x1": "tf32 scratch",
              "flagship_7x7x8": "tf32 on chip", "flagship_14x14x2": "tf32 on chip",
              "preset_14x14x4": "tf32 scratch", "preset_7x7x8": "tf32 scratch",
              "preset_28x28x1": "tf32 wide", "preset_14x14x2": "tf32 wide",
              "scratch_23x23x1": "tf32 scratch", "scratch_20x20x2": "tf32 scratch",
              "scratch_32x16x3": "tf32 scratch", "scratch_17x16x1": "tf32 scratch"}


@pytest.mark.parametrize("batch", [3, 2048])
@pytest.mark.parametrize("name", list(F32_BUILDS))
def test_float32_kernel_matches_plain_version_at_every_batch(cuda, no_tf32, name, batch):
    """Each float32 spec of the flagship, the preset and the scratch plan's
    at a batch that is a multiple of nothing the kernel tiles and at the
    serving call's 2,048: one launch of the build its spec names (the
    narrow kernel's tf32 products on its plan, or the wide variant's tf32
    build, its stage input in scratch at the preset's 28 x 28 and in shared
    memory at its 14 x 14), within 1e-4 of the plain version, TF32 off."""
    spec = tfs.SubnetSpec(**(CHAIN_SPECS.get(name) or WIDE_SPECS.get(name)
                             or SCRATCH_SPECS[name]), compute_dtype="float32")
    assert tfs.kernel_build(spec) == F32_BUILDS[name]
    plan = tfs.narrow_plan(spec)
    assert tfs.wide(spec) == (F32_BUILDS[name] == "tf32 wide")
    assert tfs.wide(spec) or plan.on_chip == F32_BUILDS[name].endswith("on chip")
    x, packed = _chain_inputs(spec, batch, cuda)
    before, builds = tfs.LAUNCHES["fused_subnet"], dict(tfs.BUILD_LAUNCHES)
    with torch.no_grad():
        out = tfs.subnet_apply(spec, x, packed)
        torch.cuda.synchronize()
        ref = tfs.subnet_apply_reference(spec, x, packed)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES["fused_subnet"] == before + 1 and _builds_after(spec, builds)
    assert out.shape == (batch, spec.h, spec.w, spec.out_total)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["odd_6x6x2", "flagship_28x28x1", "tiles_5x3x3",
                                  "groups3_3x4x1"])
def test_wide_variant_matches_plain_version_at_narrow_specs(cuda, no_tf32, name, dtype):
    """The wide variant, launched by hand at specs the narrow kernels take
    (odd sizes, ragged tiles, windows moved left) on weights packed for it,
    gives the plain version's chain as the narrow kernel does."""
    spec = tfs.SubnetSpec(**CHAIN_SPECS[name], compute_dtype=dtype)
    assert not tfs.wide(spec)
    batch = BATCH if name.startswith("flagship") else 3
    x, packed = _chain_inputs(spec, batch, cuda, wide_variant=True)
    trunk = torch.empty(tfs.trunk_elements(spec, batch, wide_variant=True), device=cuda)
    out = torch.empty(batch, spec.h, spec.w, spec.out_total, device=cuda)
    with torch.no_grad():
        tfs.launch_library(tfs._library(), spec, x, packed, trunk, out, wide_variant=True)
        ref = tfs.chain_math(spec, x, tfs.unpack(spec, packed, wide_variant=True))
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


#: the float32 wide build past the preset: six dilated branches (groups of
#: 1 to 32 channels), and a trunk of 200 (25 n8 tiles: a wgmma pass of 16
#: and one of 9, whose N of 128 reads past the piece) with a head of 2 tiles
TF32_WIDE_SPECS = {
    "dil6_10x10x2": dict(h=10, w=10, cin=2, kernels=64, res_blocks=2, cardinality=2, ksize=3,
                         dilations=(1, 2, 4, 8, 16, 32), out_total=4),
    "k200_9x9x3": dict(h=9, w=9, cin=3, kernels=200, res_blocks=2, cardinality=2, ksize=3,
                       dilations=(1, 2, 4), out_total=12),
}


@pytest.mark.parametrize("batch", [3, BATCH])
@pytest.mark.parametrize("name", list(TF32_WIDE_SPECS))
def test_tf32_wide_build_matches_plain_version_past_the_preset(cuda, no_tf32, name, batch):
    """The float32 wide build at a spec of six dilations and at a trunk
    that is no multiple of PASS_TILES x 8 (two wgmma passes, the second
    over 9 tiles): one launch of "tf32 wide" within 1e-4 of the plain
    version, TF32 off."""
    spec = tfs.SubnetSpec(**TF32_WIDE_SPECS[name], compute_dtype="float32")
    assert tfs.kernel_build(spec) == "tf32 wide"
    assert len(spec.dilations) >= 5 or spec.kernels % (tfs.PASS_TILES * 8)
    x, packed = _chain_inputs(spec, batch, cuda)
    before, builds = tfs.LAUNCHES["fused_subnet"], dict(tfs.BUILD_LAUNCHES)
    with torch.no_grad():
        out = tfs.subnet_apply(spec, x, packed)
        torch.cuda.synchronize()
        ref = tfs.subnet_apply_reference(spec, x, packed)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES["fused_subnet"] == before + 1 and _builds_after(spec, builds)
    assert out.shape == (batch, spec.h, spec.w, spec.out_total)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["preset_28x28x1", "preset_14x14x2", "wide_6x6x1",
                                  "dil5_8x8x2"])
def test_wide_chain_gradients_match_plain_version(cuda, no_tf32, name, dtype):
    """test_chain_gradients_match_plain_version at the wide specs: the
    recomputing backward needs no change there."""
    spec = tfs.SubnetSpec(**WIDE_SPECS[name], compute_dtype=dtype)
    batch = BATCH if name.startswith("preset") else 3
    x, _ = _chain_inputs(spec, batch, cuda)
    flat = [t.requires_grad_() for t in _chain_weights(spec, cuda, np.random.default_rng(1))]
    x.requires_grad_()

    def grads(fn):
        out = fn(spec, x, tfs.pack(spec, flat))
        return torch.autograd.grad(out.square().sum() / 2, [x] + flat)

    before = tfs.LAUNCHES["fused_subnet"]
    got = grads(tfs.subnet_apply)
    assert tfs.LAUNCHES["fused_subnet"] == before + 1
    want = grads(tfs.subnet_apply_reference)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    for (n, _), g, w in zip([("x", None)] + list(tfs.flax_param_order(spec)), got, want):
        assert _rel(g, w) < tol, n


# ---------------------------------------------------------------------------
# the train step as a CUDA graph
# ---------------------------------------------------------------------------

SMALL = dict(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
             num_kernels=(16, 16), cardinality=(2, 2), ksize=3, fused_subnet=True)
LOWERINGS = [None, "pallas_coupling", "pallas_subnet"]
GRAPH_STEPS = 3
LR = 1e-3


def _small_model(device, lowering, seed=0):
    return ConvCFlow(ConvFlowConfig(**SMALL, experimental_lowering=lowering), device=device,
                     seed=seed)


def _stack(device, n=GRAPH_STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, 4, 8, 8, 2)).astype(np.float32)).to(device)


def _replay_kernels(fn):
    """Names of the kernels ``fn()`` runs on the card, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_graphed_steps_equal_eager_steps(cuda, no_tf32, lowering):
    """k steps replayed from one captured step give the parameters and
    losses of k eager steps from the same state, and the replays launch K1
    (pallas_coupling) or K3 (pallas_subnet) once a coupling a step."""
    graphed, eager = _small_model(cuda, lowering), _small_model(cuda, lowering)
    xy = _stack(cuda)
    multi = loop.make_scan_train_step(graphed, GRAPH_STEPS, noise_mode="none")
    assert isinstance(multi, loop._GraphedSteps)
    state_g = loop.create_train_state(graphed, LR)
    state_g, out = multi(state_g, xy)
    state_e = loop.create_train_state(eager, LR)
    step, _ = loop.make_step_fns(eager, noise_mode="none")
    losses = [float(step(state_e, b)[1]["loss"]) for b in xy]
    torch.cuda.synchronize()
    assert state_g.step == state_e.step == GRAPH_STEPS
    # the same kernels in the same order: float32 sums that may land in
    # another order where cuDNN's backward uses atomics
    np.testing.assert_allclose(float(out["loss"]), np.mean(losses), rtol=1e-5)
    for (name, p), q in zip(graphed.named_parameters(), eager.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)

    names = _replay_kernels(lambda: multi(state_g, xy))
    per_step = len(graphed.couplings) * GRAPH_STEPS
    assert sum("affine_forward" in n for n in names) == (
        per_step if lowering == "pallas_coupling" else 0)
    assert sum("fused_subnet" in n for n in names) == (
        per_step if lowering == "pallas_subnet" else 0)


def test_graphed_steps_update_what_eval_reads(cuda, no_tf32):
    """The replays write the parameters in place; the conv-chain kernel's
    packed weights, cached on the parameters' versions, follow them."""
    model, twin = _small_model(cuda, "pallas_subnet"), _small_model(cuda, "pallas_subnet")
    state = loop.create_train_state(model, LR)
    state, _ = loop.make_scan_train_step(model, GRAPH_STEPS, noise_mode="none")(
        state, _stack(cuda))
    _, eval_step = loop.make_step_fns(model, noise_mode="none")
    twin.load_state_dict(model.state_dict())
    _, eval_twin = loop.make_step_fns(twin, noise_mode="none")
    xy = _stack(cuda, n=1, seed=1)[0]
    got = eval_step(state, xy)["loss"]
    want = eval_twin(loop.create_train_state(twin, LR), xy)["loss"]
    torch.testing.assert_close(got, want)


def test_graphed_noise_is_drawn_anew_each_replay(cuda):
    """At lr 0 the parameters stay put, so two calls on the same stack give
    different losses only through the noise: the generator registered with
    the graph advances with every replay."""
    model = _small_model(cuda, None)
    state = loop.create_train_state(model, 0.0)
    multi = loop.make_scan_train_step(model, 2, noise_mode="full")
    g = torch.Generator(device=cuda).manual_seed(0)
    xy = _stack(cuda, n=2)
    first = float(multi(state, xy, g, 0.5)[1]["loss"])
    second = float(multi(state, xy, g, 0.5)[1]["loss"])
    clean = float(multi(state, xy, g, 1.0)[1]["loss"])
    assert first != second and np.isfinite([first, second]).all()
    assert clean == float(multi(state, xy, g, 1.0)[1]["loss"])


def test_capture_without_a_warm_up_raises(cuda, monkeypatch):
    """No warm-up: the capture raises, and no eager step is taken in its
    place."""
    monkeypatch.setattr(loop, "_WARMUP_STEPS", 0)
    model = _small_model(cuda, "pallas_subnet")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = loop.create_train_state(model, LR)
    multi = loop.make_scan_train_step(model, GRAPH_STEPS, noise_mode="none")
    with pytest.raises(RuntimeError, match="warm-up"):
        multi(state, _stack(cuda))
    assert multi.graph is None and state.step == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_cpu_checkpoint_restores_into_a_capturable_adam(cuda, tmp_path):
    """A checkpoint written on the CPU restores on the card into Adam that
    stays capturable, and the graphed steps continue from it."""
    cpu = loop.create_train_state(_small_model("cpu", None), LR)
    step, _ = loop.make_step_fns(cpu.model, noise_mode="none")
    step(cpu, _stack("cpu", n=1)[0])
    mgr = CheckpointManager(str(tmp_path / "ck"), config=cpu.model.cfg)
    mgr.save(0, cpu)
    state = loop.create_train_state(_small_model(cuda, None, seed=1), LR)
    mgr.restore(state)
    assert state.optimizer.param_groups[0]["capturable"] and state.step == 1
    state, out = loop.make_scan_train_step(state.model, 2, noise_mode="none")(
        state, _stack(cuda, n=2))
    assert state.step == 3 and np.isfinite(float(out["loss"]))


# ---------------------------------------------------------------------------
# the data-parallel step in a one-process NCCL group
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh(cuda):
    """A 1-D data mesh over a one-process NCCL group (TCP rendezvous on a
    free port), ended after the test."""
    import socket

    import torch.distributed as dist

    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with mesh.distributed(f"127.0.0.1:{port}", 1, 0):
        assert dist.get_backend() == "nccl"
        yield mesh.make_mesh()


def _noisy_runs(model, xy, multi):
    g = torch.Generator(device=xy.device).manual_seed(3)
    state = loop.create_train_state(model, LR)
    outs = [multi(state, xy, g, 0.5)[1] for _ in range(2)]
    torch.cuda.synchronize()
    return [{k: float(v) for k, v in o.items()} for o in outs]


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_graphed_data_parallel_step_equals_the_plain_graph(cuda, no_tf32, deterministic_cudnn,
                                                           nccl_mesh, lowering):
    """Two calls of graphed steps with instance noise: with the gradient
    all-reduce inside the graph (one a step, counted at the capture) over
    one process, the losses and parameters of the plain graph bit for bit
    (the sum over one process and the division by 1 are exact), and the
    same hand-written kernels a step."""
    plain_model, dp_model = _small_model(cuda, lowering), _small_model(cuda, lowering)
    xy = _stack(cuda)
    plain = loop.make_scan_train_step(plain_model, GRAPH_STEPS, noise_mode="full")
    dp = loop.make_scan_train_step(dp_model, GRAPH_STEPS, nccl_mesh, noise_mode="full")
    assert _noisy_runs(plain_model, xy, plain) == _noisy_runs(dp_model, xy, dp)
    assert (plain.collectives["all_reduce_gradients"],
            dp.collectives["all_reduce_gradients"]) == (0, 1)
    assert plain.launches == dp.launches
    for (name, p), q in zip(plain_model.named_parameters(), dp_model.parameters()):
        assert torch.equal(p, q), name


def test_eager_data_parallel_step_equals_the_plain_step(cuda, no_tf32, deterministic_cudnn,
                                                        nccl_mesh):
    model, dp_model = _small_model(cuda, "pallas_coupling"), _small_model(cuda, "pallas_coupling")
    plain, _ = loop.make_step_fns(model, noise_mode="full")
    dp, _ = loop.make_step_fns(dp_model, nccl_mesh, noise_mode="full")
    for m, step in ((model, plain), (dp_model, dp)):
        g = torch.Generator(device=cuda).manual_seed(3)
        state = loop.create_train_state(m, LR)
        m.losses = [float(step(state, xy, g, 0.5)[1]["loss"]) for xy in _stack(cuda)]
    assert model.losses == dp_model.losses
    for (name, p), q in zip(model.named_parameters(), dp_model.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_graphed_fsdp_step_equals_eager_fsdp_and_the_plain_graph(cuda, no_tf32, deterministic_cudnn,
                                                                   nccl_mesh, lowering):
    """A (1, 1) FSDP mesh of the one-process group: two calls of graphed
    FSDP steps with instance noise give the plain graph's losses and
    parameters bit for bit (a shard is the whole parameter; the sums over
    one process and the division by 1 are exact), and eager FSDP steps'
    as graphed steps give eager ones'. The graph launches the plain graph's
    hand-written kernels and, counted at the capture, one reduce-scatter,
    one all-gather and the two all-reduces (the shards' gradients over
    ``data``, the replicated scalars' over every process) a step."""
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh

    mesh2d = mesh.make_2d_mesh(1, 1)
    plain_model, fsdp_model, eager_model = (_small_model(cuda, lowering) for _ in range(3))
    sharding = mesh.state_shardings(mesh2d, fsdp_model)
    xy = _stack(cuda)
    plain = loop.make_scan_train_step(plain_model, GRAPH_STEPS, noise_mode="full")
    graphed = loop.make_scan_train_step(fsdp_model, GRAPH_STEPS, mesh2d, noise_mode="full",
                                        state_sharding=sharding)
    assert isinstance(graphed, loop._GraphedSteps)
    runs = _noisy_runs(fsdp_model, xy, graphed)
    assert _noisy_runs(plain_model, xy, plain) == runs
    for (name, p), q in zip(plain_model.named_parameters(), fsdp_model.parameters()):
        assert torch.equal(p, q), name
    assert graphed.launches == plain.launches
    assert graphed.collectives == {"all_reduce_gradients": 1, "reduce_scatter_gradients": 1,
                                   "all_reduce_shard_gradients": 1, "all_gather_parameters": 1}
    assert set(plain.collectives.values()) == {0}

    step, _ = loop.make_step_fns(eager_model, mesh2d, noise_mode="full",
                                 state_sharding=mesh.state_shardings(mesh2d, eager_model))
    g = torch.Generator(device=cuda).manual_seed(3)
    state = loop.create_train_state(eager_model, LR)
    for run in runs:
        losses = [float(step(state, b, g, 0.5)[1]["loss"]) for b in xy]
        np.testing.assert_allclose(run["loss"], np.mean(losses), rtol=1e-5)
    for (name, p), q in zip(fsdp_model.named_parameters(), eager_model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)


# ---------------------------------------------------------------------------
# the seeded serving entry as a CUDA graph
# ---------------------------------------------------------------------------

DRAWS = 3


def _seeded(model):
    fn = export.make_image_serving_fn(model, 1, de_logit=True, quantize_uint8=True)
    return fn, export.export_seeded_multidraw_sampler(fn, DRAWS, (8, 8, 1), (8, 8, 1))


def _planes(device, b=5):
    return torch.linspace(0, 1, b, device=device).view(b, 1, 1, 1).expand(b, 8, 8, 1)


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_graphed_seeded_call_equals_the_eager_entry(cuda, lowering):
    """The graphed call gives the eager entry's bytes for the same seed; the
    warm-up call and the capture launch K2 (pallas_coupling) or K3
    (pallas_subnet) once a coupling each, replays count nothing in the
    wrappers, and the graph's launches (those counted at its capture) are
    one of K2 or K3 a coupling. (torch.profiler is not asked: in one card
    run its profile of a replay here showed none of K3's launches, in the
    next all of them.)"""
    fn, art = _seeded(_small_model(cuda, lowering))
    y = _planes(cuda)
    tac.reset_launches()
    tfs.reset_launches()
    got = art.call(11, y)
    art.call(11, y)
    want = export.make_seeded_multidraw_fn(art.fn, DRAWS, (8, 8, 1))(11, y)
    assert got.shape == (DRAWS, 5, 8, 8, 1) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    n = len(art.fn.model.couplings)
    eager = {"affine_forward": 0, "affine_inverse": n if lowering == "pallas_coupling" else 0,
             "fused_subnet": n if lowering == "pallas_subnet" else 0}
    # the warm-up, the capture and the eager entry; not the two replays
    assert {**tac.LAUNCHES, **tfs.LAUNCHES} == {k: 3 * v for k, v in eager.items()}
    assert art.graph(y.shape).launches == eager


def test_graphed_seed_does_not_depend_on_call_history(cuda):
    """A seed's samples are those of a fresh artifact whatever calls came
    before; another seed gives others; a returned result is a copy that later
    replays leave as it was."""
    model = _small_model(cuda, "pallas_subnet")
    _, art = _seeded(model)
    _, fresh = _seeded(model)
    y = _planes(cuda)
    first = art.call(3, y)
    for seed in (4, 5, 6):
        art.call(seed, y)
    assert torch.equal(art.call(3, y), fresh.call(3, y))
    other = art.call(4, y)
    assert not torch.equal(first, other)
    assert torch.equal(first, fresh.call(3, y))


def test_graphs_are_cached_by_shape_and_pipelined_equals_sequential(cuda):
    """Each batch gets its graph; the pipelined sampler's chunks are the
    sequential calls' bytes."""
    _, art = _seeded(_small_model(cuda, "pallas_coupling"))
    for b in (1, 5, 2):
        assert art.call(0, _planes(cuda, b)).shape == (DRAWS, b, 8, 8, 1)
    assert len(art._graphs) == 3
    y = _planes(cuda)
    pipe = export.PipelinedSampler(art, DRAWS, n_in_flight=2)
    got = pipe.sample(y, 8, start_seed=20)
    want = torch.cat([art.call(20 + k, y) for k in range(3)]).cpu().numpy()
    assert np.array_equal(got, want)


def test_graphs_of_many_batch_sizes_share_their_memory(cuda):
    """call's graphs share one memory pool: after the graph of the largest
    batch, the graphs of a dozen smaller ones reserve no more than 4 MiB of
    card memory between them, where a pool each would hold at least one
    2 MiB block of the allocator each."""
    _, art = _seeded(_small_model(cuda, "pallas_subnet"))
    art.call(0, _planes(cuda, 64))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # what the warm-ups cached outside the pool
    before = torch.cuda.memory_reserved(cuda)
    for b in range(1, 13):
        assert art.call(b, _planes(cuda, b)).shape == (DRAWS, b, 8, 8, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert len(art._graphs) == 13
    assert torch.cuda.memory_reserved(cuda) - before <= 4 * 2**20


def test_a_new_capture_does_not_move_the_noise_stream(cuda):
    """A capture restores the generator after its warm-up steps: a second
    call through a fresh capture (as a resumed run makes) draws the noise
    that the first graph's replays would have drawn. At lr 0 only the noise
    moves the loss."""
    xy = _stack(cuda, n=2)
    losses = []
    for recapture in (False, True):
        state = loop.create_train_state(_small_model(cuda, None), 0.0)
        g = torch.Generator(device=cuda).manual_seed(0)
        multi = loop.make_scan_train_step(state.model, 2, noise_mode="full")
        multi(state, xy, g, 0.5)
        if recapture:
            multi = loop.make_scan_train_step(state.model, 2, noise_mode="full")
        losses.append(float(multi(state, xy, g, 0.5)[1]["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


def test_load_artifact_on_the_card(cuda, tmp_path):
    """An artifact saved from the card loads on the card and on the CPU; the
    card's reload serves the same bytes."""
    _, art = _seeded(_small_model(cuda, "pallas_subnet"))
    art = export.export_seeded_multidraw_sampler(art.fn, DRAWS, (8, 8, 1), (8, 8, 1),
                                                 platforms=["cuda", "cpu"])
    path = str(tmp_path / "seeded.pt")
    export.save_artifact(path, art)
    y = _planes(cuda)
    loaded = export.load_artifact(path)
    assert loaded.device.type == "cuda"
    assert torch.equal(loaded.call(9, y), art.call(9, y))
    on_cpu = export.load_artifact(path, device="cpu")
    assert on_cpu.call(9, y.cpu()).shape == (DRAWS, 5, 8, 8, 1)


# ---------------------------------------------------------------------------
# noise pre-training's batch of 512, and the toy cINN as a CUDA graph
# ---------------------------------------------------------------------------

PRETRAIN_BATCH = 512


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [784, 392])
def test_kernels_match_plain_versions_at_the_pretrain_batch(cuda, n, dtype):
    """K1/K2 at cnf-pretrain-noise's batch, (512, 784) and (512, 392)."""
    shape = (PRETRAIN_BATCH, n)
    a, b, u = _inputs(shape, getattr(torch, dtype), cuda)
    _check_law(a, b, u, shape, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [k for k in CHAIN_SPECS if k.startswith("flagship")])
def test_chain_kernel_matches_plain_version_at_the_pretrain_batch(cuda, no_tf32, name, dtype):
    """K3 at the flagship's four specs and cnf-pretrain-noise's batch of 512
    (four waves of blocks on 132 SMs), with the tolerances of batch 128."""
    spec = tfs.SubnetSpec(**CHAIN_SPECS[name], compute_dtype=dtype)
    x, packed = _chain_inputs(spec, PRETRAIN_BATCH, cuda)
    before = tfs.LAUNCHES["fused_subnet"]
    with torch.no_grad():
        out = tfs.subnet_apply(spec, x, packed)
        ref = tfs.subnet_apply_reference(spec, x, packed)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES["fused_subnet"] == before + 1
    assert out.shape == (PRETRAIN_BATCH, spec.h, spec.w, spec.out_total)
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


def _toy(device, seed=0):
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import ToyConfig
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

    cfg = ToyConfig(num_coupling_layers=12, intermediate_dims=16, num_layers=2,
                    mask_indices=(2, 0, 1, 5, 3, 4, 6, 11, 7, 10, 8, 9))
    return ToyCINN(cfg, device=device, seed=seed)


def _toy_stack(device, n=GRAPH_STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, 64, 3)).astype(np.float32)).to(device)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_graphed_toy_steps_equal_eager_steps(cuda, alpha):
    """k x-only-noise steps of the toy replayed from one captured step give
    the parameters and losses of k eager steps from the same state and the
    same generator: the layers' index tensors live on the card, so the step
    makes no host-to-device copy and the capture holds it. At alpha 0.5 the
    noise drawn in the replays is the eager steps' (one generator, seeded
    alike, registered with the graph)."""
    graphed, eager = _toy(cuda), _toy(cuda)
    xy = _toy_stack(cuda)
    multi = loop.make_scan_train_step(graphed, GRAPH_STEPS, noise_mode="x_only", x_d=2)
    assert isinstance(multi, loop._GraphedSteps)
    state_g = loop.create_train_state(graphed, LR)
    state_g, out = multi(state_g, xy, torch.Generator(device=cuda).manual_seed(3), alpha)
    state_e = loop.create_train_state(eager, LR)
    step, _ = loop.make_step_fns(eager, noise_mode="x_only", x_d=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    losses = [float(step(state_e, b, g, alpha)[1]["loss"]) for b in xy]
    torch.cuda.synchronize()
    assert state_g.step == state_e.step == GRAPH_STEPS
    np.testing.assert_allclose(float(out["loss"]), np.mean(losses), rtol=1e-5)
    for (name, p), q in zip(graphed.named_parameters(), eager.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)
    assert multi.launches == {"affine_forward": 0, "affine_inverse": 0, "fused_subnet": 0}


def test_toy_artifact_replay_is_the_eager_entry(cuda, tmp_path):
    """A seeded multidraw toy artifact: the graphed call gives the eager
    entry's values bit for bit, and so does the saved and reloaded one."""
    fn = export.make_toy_serving_fn(_toy(cuda), 2)
    art = export.export_seeded_multidraw_sampler(fn, DRAWS, (2,), (1,))
    y = torch.linspace(-1, 1, 50, device=cuda).view(50, 1)
    got = art.call(4, y)
    art.call(5, y)
    want = export.make_seeded_multidraw_fn(art.fn, DRAWS, (2,))(4, y)
    assert got.shape == (DRAWS, 50, 3) and torch.equal(got, want)
    assert torch.equal(art.call(4, y), got)
    path = str(tmp_path / "toy.pt")
    export.save_artifact(path, art)
    assert torch.equal(export.load_artifact(path).call(4, y), got)


# ---------------------------------------------------------------------------
# the record path: the streaming sources against the in-RAM ones on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_type", ["class", "SR4,2", "SR2,1"])
def test_streaming_sources_yield_the_in_ram_batches_on_the_card(cuda, tmp_path, model_type):
    """From one CUDA generator state, cloned: the batches bit-equal (both
    sources build SR pairs on the CPU), and the generators left in the same
    state."""
    from arl_conditional_normalizing_flows_tpu_torch.data import images, native_loader, records

    x, y = images.synthetic_digits(num_per_class=40, num_classes=3)
    if model_type == "class":
        records.write_class_sorted_dataset(str(tmp_path), "train", x, y, [0, 2], False)
        ram = images.ClassConditionalSource(x, y, [0, 2], 16, use_logits=True)
        stream = native_loader.StreamingClassSource(
            [records.class_file(str(tmp_path), "train", c) for c in (0, 2)], [0, 2], 16,
            use_logits=True)
    else:
        records.write_class_sorted_dataset(str(tmp_path), "train", x, y, [0, 1, 2], True)
        ram = images.SRSource(x, model_type, 16)
        stream = native_loader.StreamingSRSource(records.combined_file(str(tmp_path), "train"),
                                                 model_type, 16)
    g = torch.Generator(device=cuda).manual_seed(3)
    twin = torch.Generator(device=cuda)
    twin.set_state(g.get_state())
    a, b = list(ram.epoch(g)), list(stream.epoch(twin))
    assert len(a) == len(b) == ram.num_batches > 0
    for u, v in zip(a, b):
        assert u.device.type == v.device.type == "cuda" and u.shape == v.shape
        assert torch.equal(u, v)
    assert torch.equal(g.get_state(), twin.get_state())
    stream.close()


# ---------------------------------------------------------------------------
# the other lowerings and precision modes ([modes] in chip_smoke.py)
# ---------------------------------------------------------------------------

#: 16 x 16: block 0 has the dilations (1, 2), so fused_dilated builds a
#: fused kernel there
MODES_SMALL = dict(SMALL, io_shape=(16, 16, 2))
MODE_FIELDS = {
    "fused_dilated": dict(experimental_lowering="fused_dilated"),
    "dense_groups": dict(experimental_lowering="dense_groups"),
    "flow_in_compute_dtype": dict(flow_in_compute_dtype=True),
    "flow_in_compute_dtype+pallas_coupling": dict(flow_in_compute_dtype=True,
                                                  experimental_lowering="pallas_coupling"),
    "late_head_cast": dict(late_head_cast=True),
}


def _mode_model(device, mode, seed=0, dtype="bfloat16"):
    return ConvCFlow(ConvFlowConfig(**dict(MODES_SMALL, compute_dtype=dtype,
                                           **MODE_FIELDS[mode])), device=device, seed=seed)


@pytest.mark.parametrize("n", [784, 392])
@pytest.mark.parametrize("rows", [128, 2048])
def test_bf16_kernels_match_plain_versions_at_the_modes_path(cuda, rows, n):
    """K1/K2 on bf16 at the shapes of flow_in_compute_dtype +
    pallas_coupling's training step (128) and seeded serving call (2,048)."""
    shape = (rows, n)
    a, b, u = _inputs(shape, torch.bfloat16, cuda)
    _check_law(a, b, u, shape, "bfloat16")


@pytest.mark.parametrize("mode", list(MODE_FIELDS))
def test_mode_graphed_steps_equal_eager_steps(cuda, no_tf32, mode):
    """Each mode's steps replayed from one captured step equal its eager
    steps from the same state; under flow_in_compute_dtype +
    pallas_coupling K1 launches once a coupling a step inside the replays
    (counted at the capture)."""
    graphed, eager = _mode_model(cuda, mode), _mode_model(cuda, mode)
    xy = _stack(cuda, seed=1)
    xy = torch.cat([xy, xy], dim=-2).repeat_interleave(2, dim=-3)  # (3, 4, 16, 16, 2)
    multi = loop.make_scan_train_step(graphed, GRAPH_STEPS, noise_mode="none")
    state_g = loop.create_train_state(graphed, LR)
    state_g, out = multi(state_g, xy)
    state_e = loop.create_train_state(eager, LR)
    step, _ = loop.make_step_fns(eager, noise_mode="none")
    losses = [float(step(state_e, b)[1]["loss"]) for b in xy]
    torch.cuda.synchronize()
    assert state_g.step == state_e.step == GRAPH_STEPS
    np.testing.assert_allclose(float(out["loss"]), np.mean(losses), rtol=1e-5)
    for (name, p), q in zip(graphed.named_parameters(), eager.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)
    k1 = len(graphed.couplings) if graphed.cfg.use_pallas_coupling else 0
    assert multi.launches["affine_forward"] == k1 and multi.launches["affine_inverse"] == 0


@pytest.mark.parametrize("lowering", ["fused_dilated", "dense_groups"])
def test_lowering_equals_the_default_lowering_on_the_card(cuda, no_tf32, lowering):
    """At float32 with the default lowering's weights carried over
    (``convert/lowerings.py``), the lowering gives the default's zy and
    log-det on the card."""
    from arl_conditional_normalizing_flows_tpu_torch.convert.lowerings import (
        state_dict_from_default_lowering,
    )

    default = ConvCFlow(ConvFlowConfig(**MODES_SMALL), device=cuda, seed=0)
    model = _mode_model(cuda, lowering, seed=1, dtype="float32")
    model.load_state_dict(state_dict_from_default_lowering(model, default.state_dict()))
    xy = _stack(cuda, n=1)[0].repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
    with torch.no_grad():
        zy, ld = model(xy)
        want_zy, want_ld = default(xy)
    torch.testing.assert_close(zy, want_zy, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(ld, want_ld, rtol=3e-4, atol=3e-4)


def test_bf16_flow_serving_call_launches_k2_in_the_replay(cuda):
    """flow_in_compute_dtype + pallas_coupling: the graphed seeded call is
    the eager entry's bytes, its result float32 until the uint8 cast, and K2
    runs once a coupling in each replay on the bf16 flow."""
    model = _mode_model(cuda, "flow_in_compute_dtype+pallas_coupling")
    assert model.act_dtype == torch.bfloat16
    fn = export.make_image_serving_fn(model, 1, de_logit=True, quantize_uint8=True)
    art = export.export_seeded_multidraw_sampler(fn, DRAWS, (16, 16, 1), (16, 16, 1))
    y = torch.linspace(0, 1, 5, device=cuda).view(5, 1, 1, 1).expand(5, 16, 16, 1)
    got = art.call(3, y)
    want = export.make_seeded_multidraw_fn(art.fn, DRAWS, (16, 16, 1))(3, y)
    assert got.shape == (DRAWS, 5, 16, 16, 1) and torch.equal(got, want)
    n = len(model.couplings)
    assert art.graph(y.shape).launches == {"affine_forward": 0, "affine_inverse": n,
                                           "fused_subnet": 0}
    with torch.no_grad():
        x = model.sample_xy(torch.zeros(5, 16, 16, 1, device=cuda), y)
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
