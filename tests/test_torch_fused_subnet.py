"""The port's conv-chain module (``ops/kernels/fused_subnet.py``) against the
JAX package's ``ops/pallas/fused_subnet.py``: the plain version against the
Pallas kernel in interpret mode and against ``subnet_apply_ref``, the weight
order and packing, and ``FusedChainCouplingNet`` against ``ConvCouplingNet``.
The kernel itself needs a card (``tests/test_torch_kernels_gpu.py``)."""

import dataclasses
import math
import re
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.ops.pallas import fused_subnet as jfs  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models import arch  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models import subnets as tsubnets  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (  # noqa: E402
    fused_subnet as tfs,
)

# the spec of tests/test_fused_subnet.py:79-82, then one more residual block,
# an even kernel size (asymmetric SAME padding), an odd size with both, three
# and five dilations (a schedule of 66 x 66 images and up), and a trunk and
# head past the narrow bf16 kernel's tiles (the capacity preset's trunk
# width, a head of 5 n8 tiles): the wide variant's
WIDE = dict(h=6, w=6, cin=1, kernels=128, res_blocks=1, cardinality=8, ksize=3,
            dilations=(1, 2, 4), out_total=40)
BASE = dict(h=8, w=8, cin=2, kernels=16, res_blocks=1, cardinality=2, ksize=3,
            dilations=(1, 2), out_total=4)
SPECS = {
    "base": BASE,
    "res_blocks2": dict(BASE, res_blocks=2),
    "ksize4": dict(BASE, ksize=4),
    "odd": dict(BASE, h=6, w=6, kernels=8, res_blocks=2, ksize=4),
    "dil124": dict(BASE, kernels=32, cardinality=4, dilations=(1, 2, 4)),
    "dil5": dict(BASE, kernels=32, dilations=(1, 2, 4, 8, 16)),
    "wide": WIDE,
}
#: more dilations than any ConvFlowConfig's schedule gives (its guard stops
#: at 10): what the kernels refuse
ELEVEN = dict(BASE, kernels=2048, dilations=tuple(2 ** i for i in range(11)))


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


@pytest.mark.parametrize("name", ["base", "res_blocks2", "ksize4", "odd", "dil5", "wide"])
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


def test_wide_reference_matches_jax_pallas_bf16():
    """At the wide spec (K 128, out_total 40), the plain version against
    JAX's Pallas kernel in interpret mode, in bf16."""
    spec, jspec = spec_pair("wide", "bfloat16")
    flat, x = weights(spec), x_for(spec)
    out = port_reference(spec, x, flat)
    jflat = [jnp.asarray(w) for w in flat]
    pallas = np.asarray(jfs.subnet_apply_pallas(jspec, jnp.asarray(x), jflat, interpret=True))
    # test_reference_matches_jax_bf16's tolerance: a float32 sum in another
    # order can flip a bf16 rounding of an intermediate
    np.testing.assert_allclose(out, pallas, rtol=1e-2, atol=1e-2)
    assert np.abs(out - pallas).mean() < 1e-4


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
    # a stage input past shared memory: the wide variant's (its tf32 build in
    # float32), no refusal
    big = tfs.SubnetSpec(**dict(BASE, h=64, w=64, kernels=64, compute_dtype="float32"))
    assert tfs.shared_bytes(big) > tfs.MAX_SHARED_BYTES and tfs.wide(big)
    tfs.check_launch(big, 1)
    many = tfs.SubnetSpec(**ELEVEN)
    with pytest.raises(ValueError, match="dilations"):
        tfs.check_launch(many, 1)
    dil5 = tfs.SubnetSpec(**SPECS["dil5"])
    tfs.check_launch(dil5, 1)
    assert tfs.wide(dil5) and not tfs.wide(tfs.SubnetSpec(**SPECS["dil124"]))
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
    src = _cuda_source()
    consts = dict(re.findall(r"^constexpr int (k\w+) = (\d+);", src, re.M))
    assert int(consts["kThreads"]) == tfs.THREADS
    assert int(consts["kMaxBranches"]) == tfs.MAX_BRANCHES
    assert int(consts["kNarrowBranches"]) == tfs.NARROW_BRANCHES
    assert int(consts["kMaxShared"]) == tfs.MAX_SHARED_BYTES
    assert int(consts["kMaxTrunkTiles"]) == tfs.MAX_TRUNK_TILES
    assert int(consts["kMaxHeadTiles"]) == tfs.MAX_HEAD_TILES
    assert int(consts["kFrag"]) == tfs.FRAG
    assert int(consts["kMaxTableValue"]) == tfs.MAX_TABLE_VALUE
    assert int(consts["kTableScalars"]) == tfs.TABLE_SCALARS == len(tfs.TABLE_FIELDS)
    for name, value in (("kWideGroups", tfs.WIDE_GROUPS), ("kWideThreads", tfs.WIDE_THREADS),
                        ("kSlotBytes", tfs.SLOT_BYTES), ("kSlots", tfs.SLOTS),
                        ("kTf32SlotBytes", tfs.TF32_SLOT_BYTES),
                        ("kBarrierBytes", tfs.BARRIER_BYTES), ("kSlack", tfs.SLACK_BYTES),
                        ("kGroupTiles", tfs.GROUP_TILES), ("kPassTiles", tfs.PASS_TILES)):
        assert int(consts[name]) == value, name
    for name, value in (("kPlanHead", tfs.PLAN_HEAD), ("kChipSmallTiles", tfs.CHIP_SMALL_TILES)):
        assert int(consts[name]) == value, name
    # the two products' traits: chunk depth, fragment and element sizes
    for trait, (slices, frag, item) in (("Bf16", (2, tfs.FRAG, 2)),
                                        ("Tf32", (1, tfs.TF32_FRAG, 4))):
        body = re.search(rf"struct {trait} \{{(.*?)\n\}};", src, re.S).group(1)
        got = dict(re.findall(r"static constexpr int (k\w+) = (\d+);", body))
        assert {k: int(v) for k, v in got.items()} == \
            {"kSlices": slices, "kFrag": frag, "kItem": item}, trait
    assert tfs.FRAG * 2 == tfs.TF32_FRAG * 4 == 256  # a fragment is 256 bytes either way
    # the narrow kernel's plan: the same sizes on both sides (narrow_plan
    # there, _narrow_plan here); the C entry launches from its own and
    # refuses a table whose on_chip is not its own
    plan = re.search(r"NarrowPlan narrow_plan\(.*?\n\}", src, re.S).group(0)
    assert "kPlanHead + bias_bytes(L)" in plan
    assert "head + static_cast<int64_t>(Prod::kItem) * L.w_total + 2LL * L.act_bytes" in plan
    assert "L.n_mt <= kWarps && chip <= kMaxShared" in plan
    assert "kBarrierBytes + kPlanHead + L.act_bytes + kSlots * kSlotBytes" in plan
    assert "head + x_room(d, L) + L.act_bytes + 4LL * L.w_stage" in plan
    split = re.search(r"int split_tiles\(.*?\n\}", src, re.S).group(0)
    assert "tail <= 2 && tail * L.ch_post <= kWarps ? tail : 0" in split
    assert "L.on_chip == (P.on_chip ? 1 : 0)" in src
    assert src.count("<<<batch, P.threads, P.shared, stream>>>") == 4
    # the wide kernel: its warpgroups (one lane of which feeds the ring), a
    # slot one chunk of a wgmma pass (N <= 128) or of a branch group
    assert tfs.WIDE_THREADS == 128 * tfs.WIDE_GROUPS <= tfs.MAX_THREADS
    assert tfs.SLOT_BYTES == tfs.PASS_TILES * 2 * tfs.FRAG and tfs.BARRIER_BYTES == 16 * tfs.SLOTS
    assert tfs.PASS_TILES % tfs.GROUP_TILES == 0
    # the bf16 kernel's B fragment: m16n8k16, 32 lanes x 4 values; the
    # float32 one's m16n8k8 tf32, 32 lanes x 2 values, and the split that
    # _tf32_mm emulates (hi: the top 19 bits; lo = a - hi, read as tf32);
    # the wide kernel's products: wgmma with A from registers, B from the ring
    assert tfs.FRAG == 16 * 8 and "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert tfs.TF32_FRAG == 8 * 8 and "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    split = re.search(r"void split\(float v, uint32_t& hi, uint32_t& lo\) \{(.*?)\}", src,
                      re.S).group(1)
    assert "hi = __float_as_uint(v) & 0xffffe000u;" in split
    assert "lo = __float_as_uint(v - __uint_as_float(hi));" in split
    for n in (8, 16, 32, 64, 128):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16" in src
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32" in src
    # the tf32 wide build's lo planes: Tf32::split's lo, written by the
    # generic proxy and fenced for wgmma's async proxy
    assert "return v - __uint_as_float(__float_as_uint(v) & 0xffffe000u);" in src
    assert "fence.proxy.async.shared::cta" in src
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in src


def test_ablation_variants_find_their_text():
    """chain_ablation.py's altered copies of the kernel each find the text
    they edit once in the CUDA source (a build of a stale one raises on the
    card; this says so on the CPU)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chain_ablation

    src = _cuda_source()
    assert chain_ablation.VARIANTS["full"] == []
    for name, edits in chain_ablation.VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, (name, old)


def _cuda_source():
    return (Path(tfs.__file__).resolve().parents[2] / "csrc" / "fused_subnet.cu").read_text()


def test_entry_points_mirror_bind_library():
    """Each C entry point takes as many arguments as ``bind_library``
    declares for it; the wide one a device copy of the table besides."""
    src = _cuda_source()
    lib = types.SimpleNamespace(fused_subnet_forward=types.SimpleNamespace(),
                                fused_subnet_forward_wide=types.SimpleNamespace())
    tfs.bind_library(lib)
    for name in ("fused_subnet_forward", "fused_subnet_forward_wide"):
        params = re.search(rf'extern "C" int {name}\((.*?)\)', src, re.S).group(1)
        assert len(params.split(",")) == len(getattr(lib, name).argtypes), name
    wide = re.search(r'extern "C" int fused_subnet_forward_wide\((.*?)\)', src, re.S).group(1)
    assert "const int* device_table" in wide


def test_layout_table_order_mirrors_the_cuda_source():
    """The C entry reads the bf16 layout's table in the order
    ``layout_table`` writes it: its scalars, then five ints a branch tile."""
    src = _cuda_source()
    head = re.search(r"int\* head\[\] = \{(.*?)\};", src, re.S).group(1)
    # the narrow kernel's layout (L), then the scalars only the wide kernel reads (W)
    assert tuple(f.lower() for f in re.findall(r"&[LW]\.(\w+)", head)) == tfs.TABLE_FIELDS
    tile = re.search(r"struct BranchTile \{\s*int ([\w, ]+);", src).group(1)
    assert tuple(f.strip() for f in tile.split(",")) == tfs.TILE_FIELDS


def test_flops_count_grouped_work():
    """The flagship's four specs: 50.4 GFLOP a pass at batch 128, four
    launches of each."""
    specs = [(14, 14, 4, 32, 8, (1, 2, 4), 8), (28, 28, 1, 64, 8, (1, 2, 4), 2),
             (7, 7, 8, 16, 4, (1, 2), 16), (14, 14, 2, 32, 4, (1, 2), 4)]
    total = sum(4 * tfs.flops(tfs.SubnetSpec(h, w, c, K, 3, card, 3, d, o), 128)
                for h, w, c, K, card, d, o in specs)
    assert abs(total / 1e9 - 50.4) < 0.05
    # bytes: x and the head, the weights and biases as the function needs
    # them (grouped), not the bf16 packing with its padding
    spec = tfs.SubnetSpec(**BASE)
    n_w, n_b = (sum(math.prod(shape) for name, shape in tfs.flax_param_order(spec)
                    if name.endswith(kind)) for kind in ("kernel", "bias"))
    assert tfs.io_bytes(spec, 4) == 4 * 4 * 64 * (2 + 4) + 2 * n_w + 4 * n_b
    assert tfs.packed_sizes(spec)[0] > n_w


# the bf16 kernel's tiling at the flagship's four specs and at sizes that
# fill no 16-pixel tile, with group widths 1, 2 and 3, trunk widths that are
# no multiple of 16 or 8, cin 1 and 3, out_total 2, 4 and 9
LAYOUT_SPECS = {
    **SPECS,
    "flagship_14x14x4": dict(h=14, w=14, cin=4, kernels=32, res_blocks=3, cardinality=8,
                             ksize=3, dilations=(1, 2, 4), out_total=8),
    "flagship_28x28x1": dict(h=28, w=28, cin=1, kernels=64, res_blocks=3, cardinality=8,
                             ksize=3, dilations=(1, 2, 4), out_total=2),
    "flagship_7x7x8": dict(h=7, w=7, cin=8, kernels=16, res_blocks=3, cardinality=4,
                           ksize=3, dilations=(1, 2), out_total=16),
    "flagship_14x14x2": dict(h=14, w=14, cin=2, kernels=32, res_blocks=3, cardinality=4,
                             ksize=3, dilations=(1, 2), out_total=4),
    "tiles_5x3x3": dict(h=5, w=3, cin=3, kernels=32, res_blocks=1, cardinality=8, ksize=3,
                        dilations=(1, 2, 4), out_total=4),
    "groups3_k12": dict(h=4, w=5, cin=1, kernels=12, res_blocks=1, cardinality=2, ksize=3,
                        dilations=(1, 2), out_total=9),
    # windows of 1-3 slices in one branch: the last tile's moves left
    "groups3_k24": dict(h=3, w=4, cin=1, kernels=24, res_blocks=1, cardinality=8, ksize=3,
                        dilations=(1,), out_total=2),
    # 17 pixel tiles: the narrow kernel's scratch plan at a small size, the
    # 17th tile split across warps
    "scratch_17x16x1": dict(h=17, w=16, cin=1, kernels=40, res_blocks=1, cardinality=4, ksize=3,
                            dilations=(1, 2), out_total=20),
    # the JAX package's capacity preset (perf_arch_config): its two specs past
    # the narrow bf16 kernel, which take the wide variant
    "preset_28x28x1": dict(h=28, w=28, cin=1, kernels=128, res_blocks=3, cardinality=8,
                           ksize=3, dilations=(1, 2, 4), out_total=2),
    "preset_14x14x2": dict(h=14, w=14, cin=2, kernels=128, res_blocks=3, cardinality=8,
                           ksize=3, dilations=(1, 2), out_total=4),
}
SMALL_LAYOUT_SPECS = [n for n in LAYOUT_SPECS if not n.startswith(("flagship", "preset"))]


def _bf16_spec(name):
    return tfs.SubnetSpec(**LAYOUT_SPECS[name], compute_dtype="bfloat16")


@pytest.mark.parametrize("wide_variant", [False, True])
@pytest.mark.parametrize("name", sorted(LAYOUT_SPECS))
def test_bf16_unpack_of_pack_gives_the_weights(name, wide_variant):
    """The fragment layout, and the wide variant's reordering of it, hold
    every flax value once: unpack gives back the flax-shaped weights
    (rounded to bf16) and the biases."""
    spec = _bf16_spec(name)
    flat = [torch.from_numpy(w) for w in weights(spec)]
    packed = tfs.pack(spec, flat, wide_variant=wide_variant)
    assert tuple(t.numel() for t in packed) == tfs.packed_sizes(spec)
    assert packed[0].dtype == torch.bfloat16 and packed[1].dtype == torch.float32
    n_values = sum(w.numel() for w in flat)
    assert int((packed[0] != 0).sum() + (packed[1] != 0).sum()) == n_values  # the rest is padding
    for (pname, shape), w, back in zip(tfs.flax_param_order(spec), flat,
                                       tfs.unpack(spec, packed, wide_variant=wide_variant)):
        assert tuple(back.shape) == shape, pname
        expect = w.to(torch.bfloat16) if pname.endswith("kernel") else w
        assert torch.equal(back, expect), pname


def _dense_b(buf, off, chunks, tiles):
    """A stage's (16 * chunks, 8 * tiles) B matrix from its m16n8k16 B
    fragments: lane l of fragment (c, j) holds B[16c + 2t + e % 2 + 8 (e // 2),
    8j + l // 4] as value e, t = l % 4."""
    frags = buf[off: off + chunks * tiles * tfs.FRAG].reshape(chunks, tiles, 32, 4)
    b = np.zeros((16 * chunks, 8 * tiles), np.float32)
    c, j, lane, e = np.meshgrid(np.arange(chunks), np.arange(tiles), np.arange(32),
                                np.arange(4), indexing="ij")
    b[16 * c + 2 * (lane % 4) + e % 2 + 8 * (e // 2), 8 * j + lane // 4] = frags
    return b


def _core_b(buf, off, chunks, tiles):
    """A stage's (16 * chunks, 8 * tiles) B matrix from the wide variant's
    fragments: fragment (c, j) holds B[16c + 8h + k, 8j + n] at 64h + 8n + k
    (two 8 x 8 core matrices, n rows of 16 bytes)."""
    frags = buf[off: off + chunks * tiles * tfs.FRAG].reshape(chunks, tiles, 2, 8, 8)
    return frags.transpose(0, 2, 4, 1, 3).reshape(16 * chunks, 8 * tiles)


def _tile_b(buf, w0, L, i, wide_variant, tf32=False):
    """Branch tile i's (16 * chunks, 8) B matrix (tf32: (8 * chunks, 8)) in
    the block whose weights start at w0: its fragments one after another,
    or (wide) chunk by chunk across its group."""
    t = L.tiles[i]
    frag, dense, core = (tfs.TF32_FRAG, _tf32_b, _tf32_core_b) if tf32 else \
        (tfs.FRAG, _dense_b, _core_b)
    if not wide_variant:
        return dense(buf, w0 + t.w_off, t.chunks, 1)
    g0, ng = next(g for g in tfs.branch_groups(L) if g[0] <= i < g[0] + g[1])
    first = w0 + L.tiles[g0].w_off
    return np.concatenate([core(buf, first + (c * ng + i - g0) * frag, 1, 1)
                           for c in range(t.chunks)])


def test_bf16_packing_is_in_fragment_order():
    """The pre 1x1 of the flagship's largest spec, read back through the
    m16n8k16 fragment layout, is the flax (K, K) kernel; a branch tile is
    the grouped kernel expanded block-diagonally inside its n8 tile."""
    spec = _bf16_spec("flagship_28x28x1")
    L = tfs.mma_layout(spec)
    flat = weights(spec)
    buf = tfs.pack(spec, [torch.from_numpy(w) for w in flat])[0].float().numpy()
    pre = _dense_b(buf, L.w_block0, L.ch_pre, L.nt)
    np.testing.assert_array_equal(pre, _bf16(flat[2][0, 0]))
    # the third tile of the dilation-1 branch: columns 16..23, groups of 8
    t = L.tiles[2]
    assert (t.branch, t.c0, t.lo8, t.q, t.chunks) == (0, 16, 16, 1, 5)
    b = _dense_b(buf, L.w_block0 + t.w_off, t.chunks, 1)
    kern = _bf16(flat[4])  # (3, 3, 8, 64)
    for tap in range(9):
        np.testing.assert_array_equal(b[8 * tap: 8 * tap + 8], kern[tap // 3, tap % 3, :, 16:24])
    assert not b[72:].any()  # the last chunk's second slice is past the last tap
    # the dilation-4 branch (16 wide, groups of 2): block-diagonal in its tile
    t = L.tiles[12]
    assert (t.branch, t.c0, t.lo8, t.q) == (2, 0, 0, 1)
    b = _dense_b(buf, L.w_block0 + t.w_off, t.chunks, 1)
    kern = _bf16(flat[8])  # (3, 3, 2, 16)
    for col in range(8):
        g0 = col // 2 * 2
        rows = b[:72, col].reshape(9, 8)
        np.testing.assert_array_equal(rows[:, g0: g0 + 2], kern[:, :, :, col].reshape(9, 2))
        assert not np.delete(rows, [g0, g0 + 1], axis=1).any()


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _tf32_b(buf, off, chunks, tiles):
    """A stage's (8 * chunks, 8 * tiles) B matrix from its m16n8k8 tf32
    fragments: lane l of fragment (c, j) holds B[8c + t + 4e, 8j + l // 4]
    as value e, t = l % 4."""
    frags = buf[off: off + chunks * tiles * tfs.TF32_FRAG].reshape(chunks, tiles, 32, 2)
    b = np.zeros((8 * chunks, 8 * tiles), np.float32)
    c, j, lane, e = np.meshgrid(np.arange(chunks), np.arange(tiles), np.arange(32),
                                np.arange(2), indexing="ij")
    b[8 * c + lane % 4 + 4 * e, 8 * j + lane // 4] = frags
    return b


def _tf32_core_b(buf, off, chunks, tiles):
    """A stage's (8 * chunks, 8 * tiles) B matrix from the float32 wide
    variant's fragments: fragment (c, j) holds B[8c + 4h + k, 8j + n] at
    32h + 4n + k (two core matrices, n rows of 4 floats)."""
    frags = buf[off: off + chunks * tiles * tfs.TF32_FRAG].reshape(chunks, tiles, 2, 8, 4)
    return frags.transpose(0, 2, 4, 1, 3).reshape(8 * chunks, 8 * tiles)


def _tf32(a):
    """``a`` as the tensor cores read a tf32 operand: its top 19 bits (sign,
    exponent, 10 bits of mantissa), the low 13 bits dropped."""
    return (np.asarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_mm(a, b, lo_products=True):
    """a @ b as the kernel's tf32 products: each operand split into hi =
    tf32(v) and lo = v - hi (which the tensor cores read as tf32(lo)), then
    lo @ hi + hi @ lo + hi @ hi with float32 sums (``lo_products`` False:
    hi @ hi alone, one TF32 product)."""
    ah, bh = _tf32(a), _tf32(b)
    if not lo_products:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _handoff(a):
    """An accumulator-fed operand (the pre and post 1x1s' A in tf32) as the
    kernel holds it: in each k8 chunk, column k is channel HANDOFF_ROWS[k]."""
    n = a.shape[-1]
    return a[..., np.arange(n) // 8 * 8 + tfs.HANDOFF_ROWS[np.arange(n) % 8]]


def _im2col(t, q, lo8, dil, k, chunks, S=2):
    """(B, h, w, 8 S * chunks): the tensor-core kernel's A operand of a SAME
    k x k conv over t, S slices a chunk (2 in bf16, 1 in tf32) — slice s
    is tap s // q, channels lo8 + 8 (s % q) + [0, 8)."""
    n, h, w, c = t.shape
    total = dil * (k - 1)
    lo = total // 2
    tp = np.pad(t, ((0, 0), (lo, total - lo), (lo, total - lo), (0, max(0, 8 * q + lo8 - c))))
    cols = []
    for s in range(S * chunks):
        tap, c8 = divmod(s, q)
        if tap >= k * k:
            cols.append(np.zeros((n, h, w, 8), np.float32))
            continue
        ty, tx = divmod(tap, k)
        ch = lo8 + 8 * c8
        cols.append(tp[:, ty * dil: ty * dil + h, tx * dil: tx * dil + w, ch: ch + 8])
    return np.concatenate(cols, axis=-1)


def _mma_chain(spec, x, packed, wide_variant=False, lo_products=True):
    """The chain computed from the tensor-core packing (``wide_variant``:
    the wide variant's) the way the kernel does: each stage an implicit
    GEMM of im2col slices by the B fragments. bf16: operands rounded to bf16
    where the kernel rounds them. float32: k8 chunks, every product as the
    kernel's three TF32 products (:func:`_tf32_mm`), the pre and post 1x1s'
    A in the hand-off's column order, and the k x k stages' too where the
    wide variant reads its stage input from scratch as channel pairs
    (``scratch_pairs``)."""
    L, k = tfs.mma_layout(spec), spec.ksize
    tf32 = spec.compute_dtype == "float32"
    S = 1 if tf32 else 2
    buf, bias = packed[0].float().numpy(), packed[1].numpy()
    _b = (_tf32_core_b if tf32 else _core_b) if wide_variant else (_tf32_b if tf32 else _dense_b)
    rnd = (lambda a: a) if tf32 else _bf16  # noqa: E731
    mm = (lambda a, b: _tf32_mm(a, b, lo_products)) if tf32 else np.matmul  # noqa: E731
    fed = _handoff if tf32 else (lambda a: a)  # noqa: E731
    kxk = fed if wide_variant and tfs.scratch_pairs(spec) else (lambda a: a)  # noqa: E731
    lrelu = lambda v: np.where(v > 0, v, np.float32(0.3) * v)  # noqa: E731

    def pad_to(a, c):
        return np.pad(a, ((0, 0),) * 3 + ((0, c - a.shape[-1]),))

    def tile_b(w0, i):
        return _tile_b(buf, w0, L, i, wide_variant, tf32)

    xp = pad_to(rnd(x), 8 * L.qx)
    y = mm(kxk(_im2col(xp, L.qx, 0, 1, k, L.ch_entry, S)), _b(buf, 0, L.ch_entry, L.nt)) \
        + bias[:L.kp]
    for r in range(spec.res_blocks):
        w0, b0 = L.w_block0 + r * L.w_block, L.b_block0 + r * L.b_block
        a = fed(pad_to(rnd(lrelu(y)), 8 * S * L.ch_pre))
        t = rnd(lrelu(mm(a, _b(buf, w0, L.ch_pre, L.nt)) + bias[b0: b0 + L.kp]))
        s = [rnd(lrelu(mm(kxk(_im2col(t, tile.q, tile.lo8, tile.dil, k, tile.chunks, S)),
                          tile_b(w0, i))
                       + bias[b0 + tile.b_off: b0 + tile.b_off + 8]))
             for i, tile in enumerate(L.tiles)]
        s = fed(pad_to(np.concatenate(s, axis=-1), 8 * S * L.ch_post))
        u = mm(s, _b(buf, w0 + L.w_post, L.ch_post, L.nt))
        y = y + u + bias[b0 + L.b_post: b0 + L.b_post + L.kp]
    a = rnd(lrelu(y))
    out = mm(kxk(_im2col(a, L.nt, 0, 1, k, L.ch_head, S)), _b(buf, L.w_head, L.ch_head, L.no)) \
        + bias[L.b_head: L.b_head + 8 * L.no]
    return out[..., :spec.out_total]


@pytest.mark.parametrize("wide_variant", [False, True])
@pytest.mark.parametrize("name", SMALL_LAYOUT_SPECS)
def test_bf16_layout_computes_the_chain(name, wide_variant):
    """What the kernel computes from the fragment layout (or the wide
    variant's core matrices and branch groups) — its K slices, input
    windows, padding and offsets, emulated at matrix level — is the plain
    version's chain."""
    spec = _bf16_spec(name)
    x = x_for(spec, batch=2)
    packed = tfs.pack(spec, [torch.from_numpy(w) for w in weights(spec)],
                      wide_variant=wide_variant)
    out = _mma_chain(spec, x, packed, wide_variant)
    ref = tfs.chain_math(spec, torch.from_numpy(x),
                         tfs.unpack(spec, packed, wide_variant=wide_variant)).numpy()
    # the same bf16 roundings; float32 sums in another order (the kernel's
    # tolerance, CHAIN_TOL in chip_smoke.py)
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)
    assert np.abs(out - ref).mean() < 1e-4


@pytest.mark.parametrize("name", sorted(LAYOUT_SPECS))
def test_bf16_layout_table_holds_the_layout(name):
    """The table the kernel takes is ``mma_layout``: its scalars, each
    branch's run of tiles in order (zeros past the last branch), each
    tile's window and offsets, then the wide kernel's schedule."""
    spec = _bf16_spec(name)
    L, table = tfs.mma_layout(spec), list(tfs.layout_table(spec))
    n_head = len(tfs.TABLE_FIELDS)
    n_tiles = len(tfs.TILE_FIELDS) * L.n_tiles
    stages = tfs.wide_schedule(spec)
    n_sched = len(stages) + 2 * L.n_pieces
    assert len(stages) == 2 + 2 * spec.res_blocks
    assert len(table) == n_head + 2 * tfs.MAX_BRANCHES + n_tiles + n_sched
    assert table[len(table) - n_sched:] == [len(st) for st in stages] \
        + [v for st in stages for piece in st for v in piece]
    table = table[:len(table) - n_sched]
    assert table[:n_head] == [getattr(L, f) for f in tfs.TABLE_FIELDS]
    runs = table[n_head: n_head + 2 * tfs.MAX_BRANCHES]
    first = 0
    for br in range(tfs.MAX_BRANCHES):
        tiles = [t for t in L.tiles if t.branch == br]
        assert runs[2 * br: 2 * br + 2] == ([first, len(tiles)] if tiles else [0, 0])
        assert all(t is L.tiles[first + i] for i, t in enumerate(tiles))
        first += len(tiles)
    rows = np.reshape(table[n_head + 2 * tfs.MAX_BRANCHES:], (-1, len(tfs.TILE_FIELDS)))
    for t, row in zip(L.tiles, rows, strict=True):
        assert list(row) == [getattr(t, f) for f in tfs.TILE_FIELDS]
    assert all(0 <= v <= tfs.MAX_TABLE_VALUE for v in table)  # what the C entry takes


def test_bf16_launch_guards():
    """The narrow bf16 kernel's tiles take a trunk up to 64 wide and a head
    up to 32 wide; past that the wide variant takes the spec, so
    check_launch accepts it. What stays refused: more branches than any
    ConvFlowConfig has, and sizes past the layout's ints."""
    for kw in (dict(BASE, kernels=72), dict(BASE, out_total=40), WIDE):
        spec = tfs.SubnetSpec(**kw, compute_dtype="bfloat16")
        assert tfs.wide(spec)
        tfs.check_launch(spec, 1)
        tfs.check_launch(dataclasses.replace(spec, compute_dtype="float32"), 1)
    # the float32 narrow kernel has the bf16 one's tiles: past them, the
    # wide variant's tf32 build
    assert tfs.wide(tfs.SubnetSpec(**dict(BASE, kernels=72), compute_dtype="float32"))
    assert tfs.kernel_build(tfs.SubnetSpec(**dict(BASE, kernels=72),
                                           compute_dtype="float32")) == "tf32 wide"
    many = tfs.SubnetSpec(**ELEVEN, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="dilations"):
        tfs.check_launch(many, 1)
    huge = tfs.SubnetSpec(**dict(BASE, h=4096, w=4096, kernels=64), compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="sizes past"):
        tfs.check_launch(huge, 1)
    # the flagship's largest spec (the scratch plan): the mbarriers and the
    # tap table, the biases (792), x's room (rows of 8, then the 49th tile's
    # 7 shares of the post 1x1), the stage input (rows of 72) and a zero row,
    # then two buffers of one residual block's weights (158 fragments)
    assert tfs.shared_bytes(_bf16_spec("flagship_28x28x1")) == \
        672 + 4 * 792 + 7 * 8 * 512 + (28 * 28 + 1) * 72 * 2 + 2 * 158 * 256


#: the narrow bf16 kernel's plan at each spec of LAYOUT_SPECS that it takes:
#: on chip (the trunk in registers, a warp a pixel tile) or the scratch plan
ON_CHIP = {"flagship_28x28x1": False, "scratch_17x16x1": False, "odd": True, "groups3_k12": True, "flagship_7x7x8": True,
           "flagship_14x14x4": True, "flagship_14x14x2": True}


@pytest.mark.parametrize("name", sorted(LAYOUT_SPECS))
def test_narrow_plan_follows_the_spec(name):
    """narrow_plan picks on chip where a warp a 16-pixel tile fits a block
    (16 tiles) and the packing and two stage inputs fit shared memory beside
    the barriers; else the scratch plan of 512 threads, x, the stage input
    and two stage buffers of weights. The shared bytes, threads and scratch
    follow the plan, wide() takes what the plan cannot fit, and the table
    carries on_chip to the C entry, which checks it against its own plan."""
    spec = _bf16_spec(name)
    L, plan = tfs.mma_layout(spec), tfs.narrow_plan(spec)
    hw = spec.h * spec.w
    head = tfs.PLAN_HEAD + 4 * L.b_total  # the mbarriers, the tap table and the biases
    chip = head + 2 * L.w_total + 2 * L.act_bytes
    # the last round's one or two tiles split a post 1x1 chunk a warp, their
    # shares (NT n8 tiles of f32 a lane) in x's room
    tail = L.n_mt % 16
    split = tail if tail <= 2 and tail * L.ch_post <= 16 else 0
    room = max(-(-hw * L.xs * 2 // 16) * 16, split * L.ch_post * L.nt * 512)
    scratch = head + room + L.act_bytes + 4 * L.w_stage
    on_chip = L.n_mt <= tfs.THREADS // 32 and chip <= tfs.MAX_SHARED_BYTES
    assert plan == tfs.NarrowPlan(on_chip, 32 * L.n_mt if on_chip else tfs.THREADS,
                                  chip if on_chip else scratch, 0 if on_chip else split)
    table = list(tfs.layout_table(spec))
    assert L.on_chip == table[tfs.TABLE_FIELDS.index("on_chip")] == int(on_chip)
    assert plan.threads % 32 == 0 and plan.threads <= tfs.THREADS
    if name in ON_CHIP:
        assert plan.on_chip == ON_CHIP[name] and not tfs.wide(spec)
    # on chip no scratch; else the trunk and a bf16 copy of the stage input
    want = 0 if plan.on_chip else 3 * (L.trunk_per_sample + hw * L.ts // 2)
    assert tfs.trunk_elements(spec, 3, wide_variant=False) == want
    if not tfs.wide(spec):
        assert tfs.shared_bytes(spec) == plan.shared <= tfs.MAX_SHARED_BYTES
        assert tfs.trunk_elements(spec, 3) == want
    assert tfs.kernel_build(spec) == ("bf16 wide" if tfs.wide(spec) else
                                      f"bf16 {'on chip' if plan.on_chip else 'scratch'}")


def test_narrow_plan_at_the_flagship_and_the_preset():
    """The flagship's three small specs and the preset's two narrow ones run
    on chip, a block of 13 or 4 warps and no scratch; its 28 x 28 on the
    scratch plan in 226,448 bytes (the tap table, the biases, x's room, which
    then holds the 49th tile's 7 shares of the post 1x1, the stage input, two
    buffers of a residual block's 40,448 bytes of weights), its scratch the trunk's
    200,704 bytes and a 112,896-byte copy of the stage input a sample."""
    want = {(14, 14, 4, 32, 8, (1, 2, 4), 8): (True, 416, 88832),
            (28, 28, 1, 64, 8, (1, 2, 4), 2): (False, 512, 226448, 1),
            (7, 7, 8, 16, 4, (1, 2), 16): (True, 128, 29568),
            (14, 14, 2, 32, 4, (1, 2), 4): (True, 416, 81824),
            (14, 14, 4, 64, 8, (1, 2, 4), 8): (True, 416, 201376),
            (7, 7, 8, 64, 8, (1, 2), 16): (True, 128, 154272)}
    for (h, w, cin, k, card, dil, out), plan in want.items():
        spec = tfs.SubnetSpec(h, w, cin, k, 3, card, 3, dil, out)
        assert tfs.narrow_plan(spec) == tfs.NarrowPlan(*plan) and not tfs.wide(spec)
        scratch = 0 if plan[0] else 128 * (200704 + 112896) // 4
        assert tfs.narrow_plan(spec).split_tiles == (0 if plan[0] else 1)
        assert tfs.trunk_elements(spec, 128) == scratch


# (h, w, cin, K, dilations, out_total) of the capacity preset's four conv
# chains and, for each dtype, whether it takes the wide variant
PRESET_SPECS = {(14, 14, 4, 64, (1, 2, 4), 8): (False, False),
                (28, 28, 1, 128, (1, 2, 4), 2): (True, True),
                (7, 7, 8, 64, (1, 2), 16): (False, False),
                (14, 14, 2, 128, (1, 2), 4): (True, True)}


def test_every_config_schedule_fits_the_kernels_branches():
    """ConvFlowConfig's dilation schedule gives at most MAX_BRANCHES
    dilations a block: 10 at 4096 x 4096, and its guard refuses larger
    images."""
    def most(size):
        cfg = arch.ConvFlowConfig(io_shape=(size, size, 2), x_d=1,
                                  squeeze_factor_blocks=(0,), res_blocks=(1,),
                                  num_kernels=(2048,), cardinality=(2,))
        return max(len(b.dilations_channelwise) for b in arch.derive_blocks(cfg))

    assert most(28) == 3 and most(66) == 5 and most(4096) == tfs.MAX_BRANCHES == 10
    with pytest.raises(AssertionError, match="ran away"):
        most(8192)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_check_launch_takes_the_capacity_preset(dtype):
    """Every conv chain that the JAX package's perf_arch_config builds under
    pallas_subnet launches, at 128 and 2,048: the flagship's specs and the
    preset's narrow ones on the narrow kernels, the rest on the wide variant,
    whose scratch holds the trunk and, where it does not fit shared memory,
    the stage input (float32 at 28 x 28)."""
    cfg = arch.perf_arch_config(experimental_lowering="pallas_subnet", compute_dtype=dtype)
    model = ConvCFlow(cfg, device="cpu", seed=0)
    specs = {}
    for m in model.modules():
        if isinstance(m, tsubnets.FusedChainCouplingNet):
            specs[m.spec] = specs.get(m.spec, 0) + 1
    got = {(s.h, s.w, s.cin, s.kernels, s.dilations, s.out_total): s for s in specs}
    assert set(got) == set(PRESET_SPECS) and set(specs.values()) == {4}
    for key, spec in got.items():
        assert spec.compute_dtype == dtype and spec.res_blocks == 3 and spec.cardinality == 8
        for batch in (128, 2048):
            tfs.check_launch(spec, batch)
        is_wide = PRESET_SPECS[key][dtype == "float32"]
        assert tfs.wide(spec) == is_wide
        hw = spec.h * spec.w
        if not is_wide:
            assert tfs.trunk_elements(spec, 2) == 2 * tfs.scratch_per_sample(spec, False)
        else:
            # the branch outputs in registers: the scratch is the trunk, and
            # the stage input where it does not fit shared memory (float32's
            # 785 rows of 132 floats at 28 x 28)
            L = tfs.mma_layout(spec)
            in_scratch = dtype == "float32" and hw == 784
            assert bool(L.act_in_shared) == (not in_scratch)
            assert tfs.trunk_elements(spec, 2) == \
                2 * (L.trunk_per_sample + (L.act_bytes // 4 if in_scratch else 0))
    for name in LAYOUT_SPECS:  # the flagship's and the small specs stay on the narrow kernel
        if name.startswith("flagship"):
            assert not tfs.wide(_bf16_spec(name))


#: a trunk of 256 over 28 x 28: a stage input past shared memory, two wgmma
#: passes over the trunk
K256 = dict(h=28, w=28, cin=1, kernels=256, res_blocks=3, cardinality=8, ksize=3,
            dilations=(1, 2, 4), out_total=2)
# (spec, whether the wide variant holds its stage input in shared memory):
# the preset's two K 128 specs and the small wide spec do, a trunk of 256
# over 28 x 28 (rows of 264 channels, ~414 KB) does not
SHARED_PLAN = {"preset_28x28x1": True, "preset_14x14x2": True, "wide": True,
               "k256_28x28x1": False}


@pytest.mark.parametrize("name", sorted(SHARED_PLAN))
def test_wide_shared_memory_plan(name):
    """The wide bf16 kernel's shared memory: the ring of weights and its
    barriers, then the stage input where it fits in the 232,448 bytes a
    block may have (else it lives in scratch after the trunk); the branch
    outputs never reach scratch. At the preset's (28, 28, 1) K 128 the
    scratch is the trunk's 401,408 bytes a sample."""
    spec = tfs.SubnetSpec(**(LAYOUT_SPECS.get(name) or K256), compute_dtype="bfloat16")
    L = tfs.mma_layout(spec)
    assert tfs.wide(spec) and bool(L.act_in_shared) == SHARED_PLAN[name]
    ring = tfs.SLOTS * tfs.SLOT_BYTES + tfs.BARRIER_BYTES
    assert ring == 16448
    if L.act_in_shared:
        assert tfs.wide_shared_bytes(spec) == ring + max(L.act_bytes, tfs.SLACK_BYTES)
        assert tfs.wide_shared_bytes(spec) <= tfs.MAX_SHARED_BYTES
        assert tfs.scratch_per_sample(spec, True) == L.trunk_per_sample
    else:
        assert ring + L.act_bytes > tfs.MAX_SHARED_BYTES
        assert tfs.wide_shared_bytes(spec) == ring + tfs.SLACK_BYTES
        assert tfs.scratch_per_sample(spec, True) == L.trunk_per_sample + L.act_bytes // 4
    assert L.trunk_per_sample == 16 * L.n_mt * L.kp
    if name == "preset_28x28x1":
        assert 4 * tfs.scratch_per_sample(spec, True) == 401408
        assert (L.act_bytes, tfs.wide_shared_bytes(spec)) == (213520, 229968)
    # the float32 wide build: the ring (slots twice bf16's), the
    # warpgroups' lo planes (two each, a slot each), then the stage input
    # where it fits (twice bf16's rows), else the slack
    f32 = dataclasses.replace(spec, compute_dtype="float32")
    L32 = tfs.mma_layout(f32)
    planes = tfs.BARRIER_BYTES + (tfs.SLOTS + 2 * tfs.WIDE_GROUPS) * tfs.TF32_SLOT_BYTES
    assert tfs.wide_shared_bytes(f32) == planes + (L32.act_bytes if L32.act_in_shared
                                                   else tfs.SLACK_BYTES)


def test_wide_packing_groups_and_core_order():
    """The wide variant's packing at the preset's (28, 28, 1) K 128: each
    fragment as two 8 x 8 core matrices of n rows, and each branch group's
    fragments chunk by chunk, so that one chunk of a group is one copy of
    8 x 256 bytes; a slot holds one chunk of the pre and post 1x1s."""
    spec = _bf16_spec("preset_28x28x1")
    L = tfs.mma_layout(spec)
    assert tfs.branch_groups(L) == ((0, 8), (8, 8), (16, 8), (24, 4))
    assert sorted(tfs.CORE_ORDER) == list(range(tfs.FRAG))
    flat = weights(spec)
    narrow = tfs.pack(spec, [torch.from_numpy(w) for w in flat], wide_variant=False)[0]
    wide_buf = tfs.pack(spec, [torch.from_numpy(w) for w in flat], wide_variant=True)[0]
    narrow, wide_buf = narrow.float().numpy(), wide_buf.float().numpy()
    # the pre 1x1 of the first block, read both ways, is the flax (K, K) kernel
    pre = _core_b(wide_buf, L.w_block0, L.ch_pre, L.nt)
    np.testing.assert_array_equal(pre, _dense_b(narrow, L.w_block0, L.ch_pre, L.nt))
    np.testing.assert_array_equal(pre, _bf16(flat[2][0, 0]))
    assert L.nt * tfs.FRAG * 2 == tfs.SLOT_BYTES
    # the branch tiles, read back through their groups
    for i in range(L.n_tiles):
        np.testing.assert_array_equal(_tile_b(wide_buf, L.w_block0, L, i, True),
                                      _tile_b(narrow, L.w_block0, L, i, False))


@pytest.mark.parametrize("name", ["wide", "preset_28x28x1", "preset_14x14x2", "groups3_k12",
                                  "dil5", "odd", "k256_28x28x1"])
def test_wide_schedule_covers_every_stage(name):
    """The wide kernel's ring schedule, one round of each stage (the entry,
    each block's pre 1x1 and branches with the post 1x1, the head): every
    piece at most a slot, a multiple of 16 bytes, inside the packed
    weights; each stage's weights carried once a round and pass (the post
    1x1's chunk by chunk between the branch groups), so that a round's
    bytes add up to the stages' weights."""
    spec = tfs.SubnetSpec(**(LAYOUT_SPECS.get(name) or K256), compute_dtype="bfloat16")
    L = tfs.mma_layout(spec)
    stages = tfs.wide_schedule(spec)
    sched = [piece for st in stages for piece in st]
    assert len(stages) == 2 + 2 * spec.res_blocks and all(stages)
    assert len(sched) == L.n_pieces
    for src, nbytes in sched:
        assert 0 < nbytes <= tfs.SLOT_BYTES and nbytes % 16 == 0 and src % 8 == 0
        assert src + nbytes // 2 <= L.w_total
    passes = -(-L.nt // tfs.PASS_TILES)
    # a pass splits the trunk-wide stages' tiles and walks every branch again
    branches = L.w_post - L.ch_pre * L.nt * tfs.FRAG
    stage_bytes = 2 * (L.w_block0 + (L.w_total - L.w_head)
                       + spec.res_blocks * (L.w_block + (passes - 1) * branches))
    assert sum(b for _, b in sched) == stage_bytes
    # the device's copy of the table: the same head, then every piece of the
    # chain, each stage's round once a round
    rounds = -(-L.n_mt // (4 * tfs.WIDE_GROUPS))
    head = len(tfs.TABLE_FIELDS) + 2 * tfs.MAX_BRANCHES + len(tfs.TILE_FIELDS) * L.n_tiles
    on_device = tfs._layout_table_on(spec, torch.device("cpu")).tolist()
    assert on_device[:head] == list(tfs.layout_table(spec))[:head]
    assert len(on_device) == head + 2 * rounds * L.n_pieces
    assert sum(on_device[head + 1::2]) == rounds * stage_bytes
    if name == "preset_28x28x1":  # 13 64-pixel tiles: 4 rounds of 4 warpgroups, 484 pieces
        assert -(-L.n_mt // (4 * tfs.WIDE_GROUPS)) == 4 and 4 * L.n_pieces == 484


# ---------------------------------------------------------------------------
# float32: the narrow kernel's tf32 products
# ---------------------------------------------------------------------------


def _f32_spec(name):
    return tfs.SubnetSpec(**LAYOUT_SPECS[name], compute_dtype="float32")


#: the specs of LAYOUT_SPECS that the float32 narrow kernel takes (the rest,
#: five dilations or a trunk of 128, take the wide variant's tf32 build)
TF32_SPECS = [n for n in LAYOUT_SPECS if n not in ("dil5", "wide", "preset_28x28x1",
                                                    "preset_14x14x2")]
TF32_SMALL_SPECS = [n for n in TF32_SPECS if n in SMALL_LAYOUT_SPECS]
#: the emulated tf32 chain against JAX's float32 subnet_apply_ref. Each
#: product keeps ~20 bits of its operands (an error of order 2**-19 ~ 2e-6
#: relative at worst), and the sums run in another order: measured over
#: TF32_SMALL_SPECS, at most 3.8e-6 on outputs up to 3.5 (the port's plain
#: float32 chain is 2.5e-6 from JAX's); one TF32 product alone is 9.1e-4 to
#: 5.9e-3 off. 1e-5 leaves room and stays ten times inside the 1e-4 that
#: the card holds the kernel to
TF32_TOL = 1e-5


@pytest.mark.parametrize("name", TF32_SPECS)
def test_tf32_unpack_of_pack_gives_the_weights(name):
    """The float32 fragment layout holds every flax value once: unpack
    gives back the weights and biases exactly, and the rest is padding."""
    spec = _f32_spec(name)
    assert not tfs.wide(spec)
    flat = [torch.from_numpy(w) for w in weights(spec)]
    packed = tfs.pack(spec, flat)
    L = tfs.mma_layout(spec)
    assert tuple(t.numel() for t in packed) == tfs.packed_sizes(spec) == (L.w_total, L.b_total)
    assert packed[0].dtype == packed[1].dtype == torch.float32
    assert int((packed[0] != 0).sum() + (packed[1] != 0).sum()) == sum(w.numel() for w in flat)
    for (pname, shape), w, back in zip(tfs.flax_param_order(spec), flat, tfs.unpack(spec, packed)):
        assert tuple(back.shape) == shape and torch.equal(back, w), pname


def test_tf32_packing_is_in_fragment_order():
    """At the flagship's largest spec in float32: the pre 1x1, read back
    through the m16n8k8 fragment layout, is the flax (K, K) kernel with each
    k8 chunk's rows in the trunk hand-off's order (A's column t holds
    channel 2t, column t + 4 channel 2t + 1); a branch tile is the grouped
    kernel expanded block-diagonally, one tap a chunk, rows in order; the
    post 1x1's chunk i is branch tile i's 8 outputs, hand-off order again."""
    spec = _f32_spec("flagship_28x28x1")
    L = tfs.mma_layout(spec)
    flat = weights(spec)
    buf = tfs.pack(spec, [torch.from_numpy(w) for w in flat])[0].numpy()
    assert list(tfs.HANDOFF_ROWS) == [0, 2, 4, 6, 1, 3, 5, 7]
    assert L.ch_pre == L.nt == 8 and L.ch_post == L.n_tiles == 14
    pre = _tf32_b(buf, L.w_block0, L.ch_pre, L.nt)
    kern = flat[2][0, 0]
    np.testing.assert_array_equal(pre, kern.reshape(8, 8, 64)[:, tfs.HANDOFF_ROWS].reshape(64, 64))
    np.testing.assert_array_equal(pre[8 + 1], kern[8 + 2])  # chunk 1, column 1: channel 2
    np.testing.assert_array_equal(pre[8 + 4], kern[8 + 1])  # chunk 1, column 4: channel 1
    # the third tile of the dilation-1 branch: columns 16..23, groups of 8
    t = L.tiles[2]
    assert (t.branch, t.c0, t.lo8, t.q, t.chunks) == (0, 16, 16, 1, 9)
    b = _tf32_b(buf, L.w_block0 + t.w_off, t.chunks, 1)
    for tap in range(9):
        np.testing.assert_array_equal(b[8 * tap: 8 * tap + 8], flat[4][tap // 3, tap % 3, :, 16:24])
    # the dilation-4 branch (16 wide, groups of 2): block-diagonal in its tile
    t = L.tiles[12]
    assert (t.branch, t.c0, t.lo8, t.q, t.chunks) == (2, 0, 0, 1, 9)
    b = _tf32_b(buf, L.w_block0 + t.w_off, t.chunks, 1)
    for col in range(8):
        g0 = col // 2 * 2
        rows = b[:, col].reshape(9, 8)
        np.testing.assert_array_equal(rows[:, g0: g0 + 2], flat[8][:, :, :, col].reshape(9, 2))
        assert not np.delete(rows, [g0, g0 + 1], axis=1).any()
    post = _tf32_b(buf, L.w_block0 + L.w_post, L.ch_post, L.nt)
    np.testing.assert_array_equal(
        post, flat[10][0, 0].reshape(14, 8, 64)[:, tfs.HANDOFF_ROWS].reshape(112, 64))


@pytest.mark.parametrize("name", TF32_SMALL_SPECS)
def test_tf32_layout_computes_the_chain(name):
    """What the float32 kernel computes from its packing — k8 chunks, input
    windows, padding, offsets, the hand-off's permutation and three TF32
    products a chunk on split operands, emulated at matrix level — is JAX's
    float32 subnet_apply_ref within TF32_TOL; one TF32 product alone is
    not within the card's 1e-4."""
    spec = _f32_spec(name)
    jspec = jfs.SubnetSpec(batch_tile=2, **LAYOUT_SPECS[name], compute_dtype="float32")
    x, flat = x_for(spec, batch=2), weights(spec)
    packed = tfs.pack(spec, [torch.from_numpy(w) for w in flat])
    out = _mma_chain(spec, x, packed)
    ref = np.asarray(jfs.subnet_apply_ref(jspec, jnp.asarray(x), [jnp.asarray(w) for w in flat]))
    np.testing.assert_allclose(out, ref, rtol=TF32_TOL, atol=TF32_TOL)
    one = _mma_chain(spec, x, packed, lo_products=False)
    assert np.abs(one - ref).max() > 1e-4


#: (threads, shared bytes a block, scratch bytes a sample) of the float32
#: narrow kernel's plans at the flagship's four specs and the preset's two
#: of K 64
TF32_PLANS = {
    # on chip: the barriers and tap table (672), the biases, the whole
    # packing, two stage inputs of 197 rows of 36 floats
    (14, 14, 4, 32, 8, (1, 2, 4), 8): ("tf32 on chip", 416, 672 + 4 * 400 + 4 * 25152 + 2 * 28368,
                                       0),
    # the scratch plan: the ring's barriers (64), the plan head (672), 785
    # rows of 68 floats (213,520 bytes), four slots of 4,096; its scratch
    # the trunk (200,704 bytes), a float32 copy of the stage input and the
    # 49th tile's 14 shares of the post 1x1 (8 n8 tiles of 512 bytes each)
    (28, 28, 1, 64, 8, (1, 2, 4), 2): ("tf32 scratch", 512, 64 + 672 + 213520 + 16384,
                                       200704 + 784 * 68 * 4 + 14 * 8 * 512),
    (7, 7, 8, 16, 4, (1, 2), 16): ("tf32 on chip", 128, 672 + 4 * 200 + 4 * 10560 + 2 * 4000, 0),
    (14, 14, 2, 32, 4, (1, 2), 4): ("tf32 on chip", 416, 672 + 4 * 376 + 4 * 22656 + 2 * 28368,
                                    0),
    # the preset's: their packing (67,200 and 65,280 floats) does not fit
    # on chip beside two stage inputs
    (14, 14, 4, 64, 8, (1, 2, 4), 8): ("tf32 scratch", 512, 64 + 672 + 53584 + 16384,
                                       13 * 16 * 64 * 4 + 196 * 68 * 4),
    (7, 7, 8, 64, 8, (1, 2), 16): ("tf32 scratch", 512, 64 + 672 + 13600 + 16384,
                                   4 * 16 * 64 * 4 + 49 * 68 * 4),
}


def test_tf32_plan_at_the_flagship_and_the_preset():
    """The float32 narrow kernel's plans: the flagship's three small specs on
    chip (159,616, 51,712 and 149,536 bytes a block), its 28 x 28 on
    the scratch plan in 230,640 bytes; the preset's two K 64 specs on the
    scratch plan; the preset's two K 128 specs, and only they, on the
    wide variant's tf32 build."""
    for (h, w, cin, k, card, dil, out), (build, threads, shared, scratch) in TF32_PLANS.items():
        spec = tfs.SubnetSpec(h, w, cin, k, 3, card, 3, dil, out, compute_dtype="float32")
        plan = tfs.narrow_plan(spec)
        assert tfs.kernel_build(spec) == build and not tfs.wide(spec)
        split = 1 if (h, w) == (28, 28) else 0  # the 49th tile; 13 and 4 tiles fill one round
        assert (plan.threads, plan.shared, plan.split_tiles) == (threads, shared, split)
        assert 4 * tfs.scratch_per_sample(spec, False) == scratch
    assert [TF32_PLANS[s][2] for s in list(TF32_PLANS)[:4]] == [159616, 230640, 51712, 149536]
    cfg = arch.perf_arch_config(experimental_lowering="pallas_subnet", compute_dtype="float32")
    specs = {m.spec for m in ConvCFlow(cfg, device="cpu", seed=0).modules()
             if isinstance(m, tsubnets.FusedChainCouplingNet)}
    cores = {(s.h, s.w, s.cin, s.kernels) for s in specs if tfs.wide(s)}
    assert cores == {(28, 28, 1, 128), (14, 14, 2, 128)}
    assert all(tfs.kernel_build(s) == "tf32 wide" for s in specs if tfs.wide(s))


@pytest.mark.parametrize("name", sorted(LAYOUT_SPECS))
def test_tf32_plan_follows_the_spec(name):
    """narrow_plan in float32: on chip where a warp a 16-pixel tile fits a
    block and the tap table, the biases, the packing and two stage inputs
    of float32 fit shared memory; else the scratch plan of 512 threads with
    the stage input and the ring, its last round's one or two tiles split
    across warps where their branch tiles are at most one a warp; past the
    kernel's tiles or shared memory the wide variant's tf32 build. The table
    carries on_chip to the C entry."""
    spec = _f32_spec(name)
    L, plan = tfs.mma_layout(spec), tfs.narrow_plan(spec)
    chip = tfs.PLAN_HEAD + 4 * L.b_total + 4 * L.w_total + 2 * L.act_bytes
    on_chip = L.n_mt <= tfs.THREADS // 32 and chip <= tfs.MAX_SHARED_BYTES
    ring = tfs.BARRIER_BYTES + tfs.PLAN_HEAD + L.act_bytes + tfs.SLOTS * tfs.SLOT_BYTES
    tail = L.n_mt % 16
    split = 0 if on_chip or not (tail <= 2 and tail * L.n_tiles <= 16) else tail
    assert L.ch_post == L.n_tiles  # a k8 chunk of the post 1x1 a branch tile
    assert plan == tfs.NarrowPlan(on_chip, 32 * L.n_mt if on_chip else tfs.THREADS,
                                  chip if on_chip else ring, split)
    assert L.on_chip == list(tfs.layout_table(spec))[tfs.TABLE_FIELDS.index("on_chip")]
    # rows of an odd number of 16-byte units, the stage input and its zero row
    assert L.xs == 8 * L.qx + 4 and L.ts == L.kp + 4
    assert L.act_bytes == -(-(spec.h * spec.w + 1) * max(L.xs, L.ts) * 4 // 16) * 16
    is_wide = (len(spec.dilations) > tfs.NARROW_BRANCHES or L.nt > tfs.MAX_TRUNK_TILES
               or L.no > tfs.MAX_HEAD_TILES or plan.shared > tfs.MAX_SHARED_BYTES)
    assert tfs.wide(spec) == is_wide and (name in TF32_SPECS) == (not is_wide)
    if not is_wide:
        hw = spec.h * spec.w
        want = 0 if on_chip else L.trunk_per_sample + hw * L.ts + split * L.n_tiles * L.nt * 128
        assert tfs.trunk_elements(spec, 3) == 3 * want
        assert tfs.kernel_build(spec) == f"tf32 {'on chip' if on_chip else 'scratch'}"


@pytest.mark.parametrize("name", TF32_SPECS)
def test_tf32_ring_schedule_carries_every_weight_once_a_round(name):
    """The float32 scratch plan's ring (wide_schedule in float32): one stage
    a phase (the entry with block 0's pre 1x1, each residual block with the
    next block's pre 1x1, the head), every piece a multiple of 16 bytes, at
    most a slot, inside the packing; a round carries every weight once; the
    device's table repeats each phase's round once a round."""
    spec = _f32_spec(name)
    L, stages = tfs.mma_layout(spec), tfs.wide_schedule(spec)
    assert len(stages) == 2 + spec.res_blocks and all(stages)
    pieces = [piece for st in stages for piece in st]
    assert len(pieces) == L.n_pieces
    for src, nbytes in pieces:
        assert 0 < nbytes <= tfs.SLOT_BYTES and nbytes % 16 == 0 and src % 4 == 0
        assert src + nbytes // 4 <= L.w_total
    covered = np.zeros(L.w_total, int)
    for src, nbytes in pieces:
        covered[src: src + nbytes // 4] += 1
    assert (covered == 1).all()
    rounds = -(-L.n_mt // (tfs.THREADS // 32))
    head = len(tfs.TABLE_FIELDS) + 2 * tfs.MAX_BRANCHES + len(tfs.TILE_FIELDS) * L.n_tiles
    on_device = tfs._layout_table_on(spec, torch.device("cpu")).tolist()
    assert len(on_device) == head + 2 * rounds * L.n_pieces
    assert sum(on_device[head + 1::2]) == rounds * 4 * L.w_total


# ---------------------------------------------------------------------------
# float32: the wide variant's tf32 build
# ---------------------------------------------------------------------------

#: the specs of LAYOUT_SPECS that take the float32 wide build: five
#: dilations, a trunk of 128 (the capacity preset's two K 128 specs)
TF32_WIDE_SPECS = [n for n in LAYOUT_SPECS if n not in TF32_SPECS]


@pytest.mark.parametrize("name", sorted(LAYOUT_SPECS))
def test_tf32_wide_unpack_of_pack_gives_the_weights(name):
    """The float32 wide variant's packing (each fragment in core matrices,
    each branch group chunk by chunk) holds every flax value once, at the
    specs that take it and, launched by hand, at the narrow ones: unpack
    gives back the weights and biases exactly, the rest is padding, and it
    holds the narrow packing's values, reordered. The spec picks the wide
    build exactly at TF32_WIDE_SPECS."""
    assert TF32_WIDE_SPECS == ["dil5", "wide", "preset_28x28x1", "preset_14x14x2"]
    spec = _f32_spec(name)
    assert tfs.wide(spec) == (name in TF32_WIDE_SPECS)
    assert (tfs.kernel_build(spec) == "tf32 wide") == tfs.wide(spec)
    flat = [torch.from_numpy(w) for w in weights(spec)]
    packed = tfs.pack(spec, flat, wide_variant=True)
    L = tfs.mma_layout(spec)
    assert tuple(t.numel() for t in packed) == tfs.packed_sizes(spec) == (L.w_total, L.b_total)
    assert packed[0].dtype == packed[1].dtype == torch.float32
    assert int((packed[0] != 0).sum() + (packed[1] != 0).sum()) == sum(w.numel() for w in flat)
    for (pname, shape), w, back in zip(tfs.flax_param_order(spec), flat,
                                       tfs.unpack(spec, packed, wide_variant=True)):
        assert tuple(back.shape) == shape and torch.equal(back, w), pname
    narrow = tfs.pack(spec, flat, wide_variant=False)
    assert torch.equal(packed[0].sort().values, narrow[0].sort().values)
    assert torch.equal(packed[1], narrow[1])


def _chunk_rows(b):
    """b's rows permuted in each k8 chunk as HANDOFF_ROWS says"""
    return b.reshape(-1, 8, b.shape[1])[:, tfs.HANDOFF_ROWS].reshape(b.shape)


def test_tf32_wide_packing_is_in_fragment_order():
    """At the preset's (28, 28, 1) K 128 in float32: each fragment two core
    matrices of 8 n rows of 4 floats (TF32_CORE_ORDER: what tf32 wgmma
    reads, K-major, and what ldmatrix gives as m16n8k8's B registers, lane
    l's values e at row l // 4, column l % 4 of matrix e); the pre 1x1 read
    back so is the flax (K, K) kernel in the hand-off's row order, as the
    narrow packing holds it; the post 1x1's chunk i is branch tile i's 8
    outputs; its stage input in scratch, read as channel pairs
    (scratch_pairs), so a branch tile read back through its group, chunk by
    chunk, and the entry and the head are the narrow packing's with each
    chunk's rows in the hand-off's order too (at 14 x 14, in shared memory,
    as they stand); a slot holds one k8 chunk of a 128-wide stage."""
    spec = _f32_spec("preset_28x28x1")
    L = tfs.mma_layout(spec)
    assert tfs.scratch_pairs(spec) and not tfs.scratch_pairs(_f32_spec("preset_14x14x2"))
    assert sorted(tfs.TF32_CORE_ORDER) == list(range(tfs.TF32_FRAG))
    lane = np.arange(32)
    for e in range(2):
        np.testing.assert_array_equal(tfs.TF32_CORE_ORDER[32 * e + 4 * (lane // 4) + lane % 4],
                                      2 * lane + e)
    assert tfs.branch_groups(L) == ((0, 8), (8, 8), (16, 8), (24, 4))
    assert L.ch_pre == L.nt == 16 and L.ch_post == L.n_tiles == 28
    assert L.nt * tfs.TF32_FRAG * 4 == tfs.SLOT_BYTES
    flat = weights(spec)
    torch_flat = [torch.from_numpy(w) for w in flat]
    narrow = tfs.pack(spec, torch_flat, wide_variant=False)[0].numpy()
    wide_buf = tfs.pack(spec, torch_flat, wide_variant=True)[0].numpy()
    pre = _tf32_core_b(wide_buf, L.w_block0, L.ch_pre, L.nt)
    np.testing.assert_array_equal(pre, _tf32_b(narrow, L.w_block0, L.ch_pre, L.nt))
    np.testing.assert_array_equal(
        pre, flat[2][0, 0].reshape(16, 8, 128)[:, tfs.HANDOFF_ROWS].reshape(128, 128))
    post = _tf32_core_b(wide_buf, L.w_block0 + L.w_post, L.ch_post, L.nt)
    np.testing.assert_array_equal(
        post, flat[10][0, 0].reshape(28, 8, 128)[:, tfs.HANDOFF_ROWS].reshape(224, 128))
    for i in range(L.n_tiles):
        np.testing.assert_array_equal(
            _tile_b(wide_buf, L.w_block0, L, i, True, tf32=True),
            _chunk_rows(_tile_b(narrow, L.w_block0, L, i, False, tf32=True)))
    for off, ch, nts in ((0, L.ch_entry, L.nt), (L.w_head, L.ch_head, L.no)):
        np.testing.assert_array_equal(_tf32_core_b(wide_buf, off, ch, nts),
                                      _chunk_rows(_tf32_b(narrow, off, ch, nts)))
    small = _f32_spec("preset_14x14x2")
    Ls = tfs.mma_layout(small)
    flat_s = [torch.from_numpy(w) for w in weights(small)]
    np.testing.assert_array_equal(
        _tf32_core_b(tfs.pack(small, flat_s, wide_variant=True)[0].numpy(), 0, Ls.ch_entry, Ls.nt),
        _tf32_b(tfs.pack(small, flat_s, wide_variant=False)[0].numpy(), 0, Ls.ch_entry, Ls.nt))


@pytest.mark.parametrize("name", ["dil5", "wide", "odd", "groups3_k24", "tiles_5x3x3",
                                  "flagship_28x28x1"])
def test_tf32_wide_layout_computes_the_chain(name):
    """What the float32 wide build computes from its packing — k8 chunks
    read through core matrices and branch groups, the hand-off's
    permutation, three TF32 products a chunk on split operands — emulated
    at matrix level, is JAX's float32 subnet_apply_ref within TF32_TOL, at
    the small specs that take it and, launched by hand, at small narrow
    ones and at 28 x 28 K 64, whose stage input is read from scratch as
    channel pairs; one TF32 product alone is not within the card's 1e-4."""
    assert tfs.scratch_pairs(_f32_spec(name)) == (name == "flagship_28x28x1")
    spec = _f32_spec(name)
    jspec = jfs.SubnetSpec(batch_tile=2, **LAYOUT_SPECS[name], compute_dtype="float32")
    x, flat = x_for(spec, batch=2), weights(spec)
    packed = tfs.pack(spec, [torch.from_numpy(w) for w in flat], wide_variant=True)
    out = _mma_chain(spec, x, packed, wide_variant=True)
    ref = np.asarray(jfs.subnet_apply_ref(jspec, jnp.asarray(x), [jnp.asarray(w) for w in flat]))
    np.testing.assert_allclose(out, ref, rtol=TF32_TOL, atol=TF32_TOL)
    one = _mma_chain(spec, x, packed, wide_variant=True, lo_products=False)
    assert np.abs(one - ref).max() > 1e-4


#: (shared bytes a block, scratch bytes a sample) of the float32 wide build
#: at the preset's two K 128 specs
TF32_WIDE_PLANS = {
    # the stage input past shared memory (785 rows of 132 floats, 414,480
    # bytes): the ring's barriers (64), its 4 slots of 8,192 bytes, the 4
    # warpgroups' two lo planes of a slot each and the slack; its scratch
    # the trunk (49 tiles of 16 pixels of 128 floats) and the stage input
    (28, 28, 1, 128, (1, 2, 4), 2): (64 + 32768 + 65536 + 2048, 401408 + 414480),
    # 197 rows of 132 floats in shared memory beside them; the trunk alone
    (14, 14, 2, 128, (1, 2), 4): (64 + 32768 + 65536 + 104016, 13 * 16 * 128 * 4),
}


def test_tf32_wide_plan_at_the_preset():
    """The float32 wide build's plans at the preset's two K 128 specs: at
    14 x 14 the stage input in shared memory beside the ring and the lo
    planes (202,384 bytes a block), at 28 x 28 in scratch after the trunk
    (100,416 bytes a block); the table carries the plan to the C entry,
    which checks it against its own (wide_plan_ok)."""
    for (h, w, cin, k, dil, out), (shared, scratch) in TF32_WIDE_PLANS.items():
        spec = tfs.SubnetSpec(h, w, cin, k, 3, 8, 3, dil, out, compute_dtype="float32")
        L = tfs.mma_layout(spec)
        assert tfs.kernel_build(spec) == "tf32 wide" and tfs.wide(spec)
        assert tfs.wide_shared_bytes(spec) == shared <= tfs.MAX_SHARED_BYTES
        assert bool(L.act_in_shared) == ((h, w) == (14, 14))
        assert 4 * tfs.scratch_per_sample(spec, True) == scratch
        assert tfs.trunk_elements(spec, 128) == 128 * scratch // 4
        table = list(tfs.layout_table(spec))
        assert [table[tfs.TABLE_FIELDS.index(f)] for f in ("act_in_shared", "wide_shared")] == \
            [L.act_in_shared, shared]
    assert [v[0] for v in TF32_WIDE_PLANS.values()] == [100416, 202384]


def rounds_of(L):
    """rounds of the wide kernel's four warpgroups over a sample's 64-pixel tiles"""
    return -(-L.n_mt // (4 * tfs.WIDE_GROUPS))


@pytest.mark.parametrize("name", ["wide", "preset_28x28x1", "preset_14x14x2", "groups3_k12",
                                  "dil5", "odd", "k256_28x28x1"])
def test_tf32_wide_schedule_covers_every_stage(name):
    """The float32 wide build's ring schedule, as the bf16 one's: one round
    of each stage, every piece at most a slot (TF32_SLOT_BYTES), a multiple
    of 16 bytes, inside the packing, each stage's weights carried once a
    round and pass; its trunk-wide pieces k8 chunks, two a piece of a
    128-wide pass, and the post 1x1 a pair of branch tiles' two chunks a
    piece where a pass takes every tile, else a tile's. The table of the
    wide variant carries it (at a narrow spec too, launched by hand); the
    device's copy repeats each stage's round once a round."""
    spec = tfs.SubnetSpec(**(LAYOUT_SPECS.get(name) or K256), compute_dtype="float32")
    L = tfs.mma_layout(spec)
    stages = tfs.wide_schedule(spec, wide_variant=True)
    sched = [piece for st in stages for piece in st]
    assert len(stages) == 2 + 2 * spec.res_blocks and all(stages)
    table = list(tfs.layout_table(spec, wide_variant=True))
    n_pieces = table[tfs.TABLE_FIELDS.index("n_pieces")]
    assert len(sched) == n_pieces and (not tfs.wide(spec) or L.n_pieces == n_pieces)
    for src, nbytes in sched:
        assert 0 < nbytes <= tfs.TF32_SLOT_BYTES and nbytes % 16 == 0 and src % 4 == 0
        assert src + nbytes // 4 <= L.w_total
    passes = -(-L.nt // tfs.PASS_TILES)
    branches = L.w_post - L.ch_pre * L.nt * tfs.TF32_FRAG
    stage_bytes = 4 * (L.w_block0 + (L.w_total - L.w_head)
                       + spec.res_blocks * (L.w_block + (passes - 1) * branches))
    assert sum(b for _, b in sched) == stage_bytes
    # a branch stage: each pass, each group's chunks a slot at a time, then
    # its tiles' post 1x1 chunks, a pair a piece in one pass, else one
    slot = tfs.TF32_SLOT_BYTES // (4 * tfs.TF32_FRAG)
    groups = sum(-(-L.tiles[g0].chunks // (slot // ng)) for g0, ng in tfs.branch_groups(L))
    posts = -(-L.n_tiles // 2) if passes == 1 else L.n_tiles
    assert all(len(st) == passes * (groups + posts) for st in stages[2:-1:2])
    if name == "preset_28x28x1":  # 13 64-pixel tiles: 4 rounds, 121 pieces each
        assert rounds_of(L) == 4 and n_pieces == 121
    rounds = rounds_of(L)
    head = len(tfs.TABLE_FIELDS) + 2 * tfs.MAX_BRANCHES + len(tfs.TILE_FIELDS) * L.n_tiles
    on_device = tfs._layout_table_on(spec, torch.device("cpu"), wide_variant=True).tolist()
    assert on_device[:head] == table[:head]
    assert len(on_device) == head + 2 * rounds * n_pieces
    assert sum(on_device[head + 1::2]) == rounds * stage_bytes
