"""The port's serving entries and artifacts against the JAX package's
``serve/export.py`` on the CPU, at the small arch of ``tests/test_serve.py``
with the flax weights carried across by ``convert/from_jax.py``: the
single-draw and multidraw entries for the same z, the residual
reconstruction, the uint8 cast, the seeded entry, the saved and loaded
artifact with its sidecar, any batch size, the fixed batch, and
``PipelinedSampler``. On the CPU an artifact's entry runs eagerly; its CUDA
graph is held on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` ``[serve]``)."""

import functools
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.serve import export as jexport  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.serve import export  # noqa: E402

# tests/test_serve.py:40-47
ARCH = dict(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
            num_kernels=(8, 8), cardinality=(2, 2), ksize=3)
D, B = 3, 4
Z_SHAPE = Y_SHAPE = (8, 8, 1)
SIDECAR_KEYS = {"format", "fun_name", "platforms", "in_avals", "out_avals", "nr_bytes",
                "metadata"}


def _perturb(tree, rng):
    """Non-trivial biases and tanh scales, so that each is compared."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    tree = np.asarray(tree)
    if tree.ndim == 0:
        return np.asarray(1.2, np.float32)
    if tree.ndim == 1:
        return (tree + 0.05 * rng.normal(size=tree.shape)).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def models(lowering=None):
    """(jax model, flax params as numpy, port model on the CPU) sharing
    weights: the port's seeded init carried to flax's tree
    (``flax_from_state_dict``; flax's own init takes longer here than the
    tests), perturbed, and carried back."""
    kw = dict(ARCH, experimental_lowering=lowering)
    tm = ConvCFlow(ConvFlowConfig(**kw), device="cpu", seed=3)
    params = _perturb(flax_from_state_dict(tm.state_dict(), tm), np.random.default_rng(1))
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return JConvCFlow(JConfig(**kw)), params, tm


def inputs(seed=0):
    """z (D, B, 8, 8, 1) and class planes y (B, 8, 8, 1)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(D, B) + Z_SHAPE).astype(np.float32)
    y = np.broadcast_to(np.linspace(0, 1, B, dtype=np.float32).reshape(B, 1, 1, 1),
                        (B,) + Y_SHAPE).copy()
    return z, y


def serving_fn(residual=False, quantize=False, lowering=None):
    _, _, tm = models(lowering)
    return export.make_image_serving_fn(tm, 1, de_logit=not residual, residual=residual,
                                        quantize_uint8=quantize)


@pytest.mark.parametrize("residual", [False, True])
def test_single_and_multidraw_entries_match_jax(residual):
    """The same z and y through JAX's entries and the port's, de-logit or
    the SR residual reconstruction (x + y), the multidraw entry as one pass
    of D*B and through its artifact. (The kernel lowerings' serving
    functions are held to JAX's in ``tests/test_torch_flow.py``.)"""
    lowering = None
    jm, params, _ = models(lowering)
    j_fn = jexport.make_image_serving_fn(jm, {"params": params}, 1, de_logit=not residual,
                                         residual=residual)
    z, y = inputs()
    want_one = np.asarray(jax.jit(j_fn)(z[0], y))
    want_multi = np.asarray(jax.jit(jexport.make_multidraw_fn(j_fn))(z, y))
    fn = serving_fn(residual, lowering=lowering)
    one = fn(torch.from_numpy(z[0]), torch.from_numpy(y))
    multi = export.make_multidraw_fn(fn)(torch.from_numpy(z), torch.from_numpy(y))
    assert one.shape == (B,) + Z_SHAPE and multi.shape == (D, B) + Z_SHAPE
    np.testing.assert_allclose(one.numpy(), want_one, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(multi.numpy(), want_multi, rtol=3e-5, atol=3e-5)
    art = export.export_multidraw_sampler(fn, Z_SHAPE, Y_SHAPE)
    assert torch.equal(art.call(z, y), multi)


def test_uint8_is_the_quantized_float_entry():
    z, y = (torch.from_numpy(a) for a in inputs(1))
    x = serving_fn()(z[0], y).numpy()
    q = serving_fn(quantize=True)(z[0], y)
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(q.numpy(), np.round(np.clip(x, 0.0, 1.0) * 255.0)
                                  .astype(np.uint8))


def test_seeded_entry_is_the_multidraw_entry_on_a_seeded_latent():
    """Same seed, same samples whatever came before; another seed, others;
    equal to the multidraw entry on z from a generator seeded the same."""
    fn = serving_fn(quantize=True)
    art = export.export_seeded_multidraw_sampler(fn, D, Z_SHAPE, Y_SHAPE)
    _, y = inputs()
    first = art.call(5, y)
    other = art.call(6, y)
    assert first.shape == (D, B) + Z_SHAPE and first.dtype == torch.uint8
    assert not torch.equal(first, other)
    assert torch.equal(art.call(5, y), first)
    z = torch.randn((D, B) + Z_SHAPE, generator=torch.Generator().manual_seed(5))
    assert torch.equal(first, export.make_multidraw_fn(fn)(z, torch.from_numpy(y)))
    assert torch.equal(first, export.make_seeded_multidraw_fn(fn, D, Z_SHAPE)(
        5, torch.from_numpy(y)))


def test_artifact_round_trip_and_sidecar(tmp_path):
    """Each kind saved and loaded gives the same values; the file loads with
    ``weights_only``; the sidecar has JAX's keys (less its calling-convention
    version) and, for the sampler, JAX's avals."""
    fn = serving_fn()
    z, y = inputs(2)
    arts = {
        "sampler": (export.export_sampler(fn, [Z_SHAPE, Y_SHAPE]), (z[0], y)),
        "multidraw": (export.export_multidraw_sampler(fn, Z_SHAPE, Y_SHAPE), (z, y)),
        "seeded_multidraw": (export.export_seeded_multidraw_sampler(fn, D, Z_SHAPE, Y_SHAPE),
                             (9, y)),
    }
    for kind, (art, args) in arts.items():
        path = str(tmp_path / f"{kind}.pt")
        side = export.save_artifact(path, art, metadata={"kind": kind})
        assert set(side) == SIDECAR_KEYS and side["metadata"] == {"kind": kind}
        with open(path + ".json") as f:
            assert json.load(f) == side
        assert side["platforms"] == ["cpu"] and side["nr_bytes"] > 0
        assert torch.load(path, weights_only=True)["entry"]["kind"] == kind
        loaded = export.load_artifact(path, device="cpu")
        assert torch.equal(loaded.call(*args), art.call(*args))
    jm, params, _ = models()
    j_side = jexport.save_artifact(
        str(tmp_path / "jax.shlo"),
        jexport.export_sampler(jexport.make_image_serving_fn(jm, {"params": params}, 1,
                                                             de_logit=True),
                               [Z_SHAPE, Y_SHAPE]))
    assert set(j_side) - {"calling_convention_version"} == SIDECAR_KEYS
    port_side = export.save_artifact(str(tmp_path / "s.pt"), arts["sampler"][0])
    for key in ("in_avals", "out_avals", "fun_name"):
        assert port_side[key] == j_side[key], key
    assert arts["multidraw"][0].in_avals == ["float32[d,b,8,8,1]", "float32[b,8,8,1]"]
    assert arts["seeded_multidraw"][0].out_avals == ["float32[3,b,8,8,1]"]


def test_any_batch_and_the_fixed_batch():
    fn = serving_fn()
    art = export.export_sampler(fn, [Z_SHAPE, Y_SHAPE])
    for b in (1, 3, 6):
        rng = np.random.default_rng(b)
        z = rng.normal(size=(b,) + Z_SHAPE).astype(np.float32)
        y = np.full((b,) + Y_SHAPE, 0.5, np.float32)
        out = art.call(z, y)
        assert out.shape == (b,) + Z_SHAPE
        assert torch.equal(out, fn(torch.from_numpy(z), torch.from_numpy(y)))
    fixed = export.export_sampler(fn, [Z_SHAPE, Y_SHAPE], symbolic_batch=False)
    assert fixed.in_avals == ["float32[1,8,8,1]", "float32[1,8,8,1]"]
    z, y = inputs()
    assert fixed.call(z[0, :1], y[:1]).shape == (1,) + Z_SHAPE
    with pytest.raises(ValueError, match="fixed batch of 1"):
        fixed.call(z[0, :2], y[:2])
    with pytest.raises(ValueError, match="batches differ"):
        art.call(z[0, :2], y[:3])
    with pytest.raises(ValueError, match="platforms"):
        export.export_sampler(fn, [Z_SHAPE, Y_SHAPE], platforms=["tpu"])


def test_artifact_keeps_the_weights_it_was_exported_with():
    """JAX bakes the parameters into the artifact; the port's keeps a copy
    of the model, which later changes to the caller's model do not reach."""
    kw = dict(ARCH)
    model = ConvCFlow(ConvFlowConfig(**kw), device="cpu", seed=4)
    fn = export.make_image_serving_fn(model, 1)
    art = export.export_seeded_multidraw_sampler(fn, D, Z_SHAPE, Y_SHAPE)
    _, y = inputs()
    before = art.call(1, y)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1)
    assert torch.equal(art.call(1, y), before)
    assert not torch.equal(export.export_seeded_multidraw_sampler(
        fn, D, Z_SHAPE, Y_SHAPE).call(1, y), before)


def test_pipelined_sampler_equals_sequential_calls():
    fn = serving_fn(quantize=True)
    art = export.export_seeded_multidraw_sampler(fn, D, Z_SHAPE, Y_SHAPE)
    _, y = inputs()
    got = export.PipelinedSampler(art, D, n_in_flight=2).sample(y, 7, start_seed=10)
    want = np.concatenate([art.call(10 + k, y).numpy() for k in range(3)])
    assert got.shape == (9, B) + Z_SHAPE
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="total_draws"):
        export.PipelinedSampler(art, D).sample(y, 0)
    with pytest.raises(ValueError, match="draws_per_call"):
        export.PipelinedSampler(art, D + 1)
    with pytest.raises(ValueError, match="seeded multidraw"):
        export.PipelinedSampler(export.export_multidraw_sampler(fn, Z_SHAPE, Y_SHAPE), D)


def test_load_artifact_without_a_card_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "a.pt")
    export.save_artifact(path, export.export_sampler(serving_fn(), [Z_SHAPE, Y_SHAPE]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_artifact(path)
    with pytest.raises(ValueError, match="exported for"):
        export.load_artifact(path, device="cuda")
