"""The port's toy cINN against the JAX package's on the CPU: the 6-mask
system, ``shuffle_mask_indices``, ``DenseCouplingNet`` and ``ToyCINN``
(forward, inverse, ``log_loss``, its gradients, three Adam steps) on weights
carried across by ``convert/from_jax.py``, at a small width and at the
reference's (24 layers, width 32, 6 dense layers); the glorot init; the toy
sampling and serving functions; and toy artifacts saved and loaded.

Inputs come from numpy seeds. Tolerances (float32, sums in another order):
zy and xy 1e-5 absolute, log-det and losses 1e-4; the readings are beside
each test."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import few_threads  # noqa: E402,F401  (two torch threads, autouse)
from arl_conditional_normalizing_flows_tpu.models import ToyCINN as JToyCINN  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ToyConfig as JToyConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import arch as jarch  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import subnets as jsubnets  # noqa: E402
from arl_conditional_normalizing_flows_tpu.ops import masks as jmasks  # noqa: E402
from arl_conditional_normalizing_flows_tpu.sample import sampler as jsampler  # noqa: E402
from arl_conditional_normalizing_flows_tpu.serve import export as jexport  # noqa: E402
from arl_conditional_normalizing_flows_tpu.train import loop as jloop  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.models import arch  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.subnets import (  # noqa: E402
    DenseCouplingNet,
)
from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.ops import masks  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.sample import sampler  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.serve import export  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_step_fns,
)

#: (num_coupling_layers, intermediate_dims, num_layers) of the two widths
WIDTHS = {"small": (6, 8, 1), "reference": (24, 32, 6)}
B = 64


def config_kw(width):
    n, dims, layers = WIDTHS[width]
    return dict(num_coupling_layers=n, intermediate_dims=dims, num_layers=layers,
                mask_indices=arch.shuffle_mask_indices(np.random.default_rng(7), n))


def _perturb_biases(tree, rng):
    if isinstance(tree, dict):
        return {k: _perturb_biases(v, rng) for k, v in tree.items()}
    tree = np.asarray(tree)
    if tree.ndim == 1:  # zero at init: make each bias count
        return (tree + 0.1 * rng.normal(size=tree.shape)).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def models(width):
    """(jax model, flax params as numpy, port model on the CPU) sharing
    weights: the port's seeded glorot init carried to flax's tree, biases
    perturbed, carried back."""
    kw = config_kw(width)
    tm = ToyCINN(arch.ToyConfig(**kw), device="cpu", seed=3)
    params = _perturb_biases(flax_from_state_dict(tm.state_dict(), tm),
                             np.random.default_rng(1))
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return JToyCINN(JToyConfig(**kw)), params, tm


def xy_batch(seed=0, n=B):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# masks and the layer order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_id", range(6))
def test_toy_masks_match_jax(mask_id):
    u1, u2 = masks.toy_partition(3, mask_id)
    ju1, ju2 = jmasks.toy_partition(3, mask_id)
    np.testing.assert_array_equal(u1, ju1)
    np.testing.assert_array_equal(u2, ju2)
    assert masks.TOY_MASK_U1[mask_id] == jmasks.TOY_MASK_U1[mask_id]
    assert masks.TOY_MASK_U2[mask_id] == jmasks.TOY_MASK_U2[mask_id]
    x = xy_batch(mask_id, n=5)
    t1 = masks.toy_gather(torch.from_numpy(x), u1)
    t2 = masks.toy_gather(torch.from_numpy(x), torch.as_tensor(u2))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(jmasks.toy_gather(x, ju1)))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jmasks.toy_gather(x, ju2)))
    back = masks.toy_scatter_combine(t1, t2, u1, u2, 3)
    want = jmasks.toy_scatter_combine(jnp.asarray(t1.numpy()), jnp.asarray(t2.numpy()),
                                      ju1, ju2, 3)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("io_shape", [2, 4, 5])
def test_toy_partition_of_other_widths_matches_jax(io_shape):
    for mask_id in range(4):
        for mine, theirs in zip(masks.toy_partition(io_shape, mask_id),
                                jmasks.toy_partition(io_shape, mask_id)):
            np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("seed", range(5))
def test_shuffle_mask_indices_matches_jax(seed):
    for n in (6, 24):
        got = arch.shuffle_mask_indices(np.random.default_rng(seed), n)
        assert got == jarch.shuffle_mask_indices(np.random.default_rng(seed), n)
        assert sorted(got) == list(range(n))
        assert all(set(got[g:g + 6]) == set(range(g, g + 6)) for g in range(0, n, 6))


# ---------------------------------------------------------------------------
# the model against JAX's
# ---------------------------------------------------------------------------


def test_dense_coupling_net_matches_jax():
    """One coupling's A and b on a 2-feature u1, within 1e-6."""
    net = DenseCouplingNet(2, 1, 32, 6, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    params = {f"Dense_{i}": {"kernel": lin.weight.detach().numpy().T,
                             "bias": rng.normal(size=lin.bias.shape).astype(np.float32)}
              for i, lin in enumerate(net.dense)}
    with torch.no_grad():
        for i, lin in enumerate(net.dense):
            lin.bias.copy_(torch.from_numpy(params[f"Dense_{i}"]["bias"]))
    jnet = jsubnets.DenseCouplingNet(u2_size=1, intermediate_dims=32, num_layers=6)
    u1 = xy_batch(3)[:, :2]
    ja, jb = jnet.apply({"params": params}, jnp.asarray(u1))
    a, b = net(torch.from_numpy(u1))
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), rtol=0, atol=1e-6)


X_SEED, Z_SEED = 4, 5


@functools.lru_cache(maxsize=None)
def jax_reference(width):
    """JAX's forward, inverse, ``log_loss`` and the loss's gradient on
    :func:`xy_batch` (X_SEED) and (Z_SEED), from one compiled function (a
    compile of the reference width costs seconds each)."""
    jm, params, _ = models(width)

    def run(p, x, z):
        v = {"params": p}
        loss_fn = lambda q: jm.apply({"params": q}, x, method="log_loss")["loss"]  # noqa: E731
        return (jm.apply(v, x), jm.apply(v, z, method="inverse"),
                jm.apply(v, x, method="log_loss"), jax.grad(loss_fn)(p))

    out = jax.jit(run)(params, jnp.asarray(xy_batch(X_SEED)), jnp.asarray(xy_batch(Z_SEED)))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_toy_cinn_matches_jax(width):
    """forward, inverse and log_loss on the same weights and inputs.
    Measured: zy within 2.9e-6 (small, |zy| up to 12.1) and 1.2e-6
    (reference), log-det within 4.8e-7 / 6.0e-7, xy within 9.5e-7 / 3.3e-6,
    losses within 2.3e-5 / 3.8e-6 absolute (values up to 102)."""
    _, _, tm = models(width)
    (jzy, jld), jx, jl, _ = jax_reference(width)
    x, z = xy_batch(X_SEED), xy_batch(Z_SEED)
    with torch.no_grad():
        zy, ld = tm(torch.from_numpy(x))
        xt = tm.inverse(torch.from_numpy(z))
        back, _ = tm(xt)
        tl = tm.log_loss(torch.from_numpy(x))
    assert zy.shape == (B, 3) and ld.shape == (B,)
    np.testing.assert_allclose(zy.numpy(), jzy, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), jld, rtol=0, atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), jx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), z, rtol=0, atol=1e-5)
    assert set(tl) == set(jl) == {"loss", "z_loss", "y_loss", "detJ_loss"}
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, atol=1e-4)


def test_toy_cinn_refuses_another_width():
    _, _, tm = models("small")
    with pytest.raises(ValueError, match="io_shape=3"):
        tm(torch.zeros(2, 4))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_log_loss_gradients_match_jax(width):
    """Every parameter's gradient within 1e-4 of its largest value (measured:
    9.4e-7 small, 1.4e-5 reference)."""
    _, _, tm = models(width)
    want = state_dict_from_flax(jax_reference(width)[3], tm)
    named = dict(tm.named_parameters())
    got = torch.autograd.grad(tm.log_loss(torch.from_numpy(xy_batch(X_SEED)))["loss"],
                              list(named.values()))
    assert len(got) == len(want) == 2 * WIDTHS[width][0] * (2 * WIDTHS[width][2] + 4)
    worst = max((g - want[n]).abs().max().item() / want[n].abs().max().clamp_min(1e-30).item()
                for n, g in zip(named, got))
    assert worst < 1e-4, worst


LR = 1e-4
STEPS = 3


def test_adam_steps_match_optax():
    """Three x-only-noise steps at alpha 1 (the noise term vanishes, so both
    frameworks see the same data) with Adam at lr 1e-4, at the small width
    (the reference width's gradients are held above). Adam's first update is about lr * sign(g) an element, so an
    element with a gradient near 0 may move the other way in the other
    framework: every element within 2 * lr * steps, and 99.9% within 1e-7
    (measured: losses within 9.3e-8 relative, every element within 6.0e-8)."""
    jm, params, _ = models("small")
    tm = ToyCINN(arch.ToyConfig(**config_kw("small")), device="cpu")
    tm.load_state_dict(state_dict_from_flax(params, tm))
    jstate = jloop.TrainState.create(apply_fn=jm.apply,
                                     params={"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                     tx=optax.adam(LR))
    jstep, _ = jloop.make_step_fns(jm, noise_mode="x_only", x_d=2)
    state = create_train_state(tm, LR)
    step, _ = make_step_fns(tm, noise_mode="x_only", x_d=2)
    g = torch.Generator().manual_seed(0)
    for i in range(STEPS):
        x = xy_batch(10 + i, n=256)
        jstate, jout = jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(i), jnp.float32(1.0))
        state, out = step(state, torch.from_numpy(x), g, 1.0)
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-5)
    assert state.step == STEPS
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params["params"]), tm)
    err = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy()).ravel()
                          for n, p in tm.named_parameters()])
    assert np.mean(err <= 1e-7) >= 0.999, np.quantile(err, [0.9, 0.99, 0.999])
    assert err.max() <= 2 * LR * STEPS, err.max()


def test_init_is_glorot_with_zero_biases():
    """Every weight within flax's glorot bound sqrt(6 / (fan_in + fan_out))
    and spread over it (variance 2 / (fan_in + fan_out)); every bias 0."""
    tm = ToyCINN(arch.ToyConfig(), device="cpu", seed=0)
    pooled = []
    for name, p in tm.named_parameters():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0, name
            continue
        fan_out, fan_in = p.shape
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        assert p.abs().max().item() <= limit, name
        pooled.append((p / limit).detach().flatten())
    u = torch.cat(pooled)  # uniform on (-1, 1): mean 0, variance 1/3
    assert abs(u.mean().item()) < 0.01 and abs(u.var().item() - 1 / 3) < 0.01
    assert ToyCINN(arch.ToyConfig(), device="cpu", seed=0).state_dict().keys() == \
        tm.state_dict().keys()
    other = ToyCINN(arch.ToyConfig(), device="cpu", seed=1)
    assert not torch.equal(other.couplings[0].dense[0].weight, tm.couplings[0].dense[0].weight)


# ---------------------------------------------------------------------------
# sampling and serving
# ---------------------------------------------------------------------------


def test_serving_fn_and_sample_conditional_are_the_inverse():
    """``make_toy_serving_fn`` and ``sample_conditional`` are ``inverse`` of
    concat(z, y) (bit for bit), and the serving function equals JAX's for
    the same z and y within 1e-5; ``sweep_conditions`` stacks
    ``sample_conditional``'s draws for each condition."""
    jm, params, tm = models("small")
    rng = np.random.default_rng(8)
    z = rng.normal(size=(B, 2)).astype(np.float32)
    y = rng.normal(size=(B, 1)).astype(np.float32)
    fn = export.make_toy_serving_fn(tm, 2)
    got = fn(torch.from_numpy(z), torch.from_numpy(y))
    with torch.no_grad():
        want = tm.inverse(torch.cat([torch.from_numpy(z), torch.from_numpy(y)], -1))
    assert torch.equal(got, want)
    j_fn = jexport.make_toy_serving_fn(jm, {"params": params}, x_d=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_fn(z, y)), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="x_d"):
        fn(torch.from_numpy(y), torch.from_numpy(y))

    s = sampler.sample_conditional(tm, -0.3, 16, 2, generator=torch.Generator().manual_seed(4))
    z4 = torch.randn((16, 2), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = tm.inverse(torch.cat([z4, torch.full((16, 1), -0.3)], -1))
    assert s.shape == (16, 3) and torch.equal(s, want)
    # JAX's sampler draws its z with jax.random: the same shape, other values
    js = jsampler.sample_conditional(jm, {"params": params}, jax.random.PRNGKey(0), -0.3, 16, 2)
    assert np.asarray(js).shape == tuple(s.shape)

    sweep = sampler.sweep_conditions(tm, [-1.0, 0.5], 16, 2,
                                     generator=torch.Generator().manual_seed(5))
    zs = torch.randn((2, 16, 2), generator=torch.Generator().manual_seed(5))
    for i, v in enumerate((-1.0, 0.5)):
        with torch.no_grad():
            want = tm.inverse(torch.cat([zs[i], torch.full((16, 1), v)], -1))
        torch.testing.assert_close(sweep[i], want, rtol=0, atol=0)


D = 3
Z_SHAPE, Y_SHAPE = (2,), (1,)


def test_toy_artifact_round_trip(tmp_path):
    """The three entry kinds of a toy artifact saved and loaded give the same
    values (JAX ``tests/test_serve.py:50-190``), any batch size; the
    multidraw entry equals D single draws within 1e-6 (JAX's bound); the file records the toy family;
    the sidecar's avals are JAX's for the toy sampler."""
    _, params, tm = models("small")
    fn = export.make_toy_serving_fn(tm, 2)
    rng = np.random.default_rng(9)
    z = rng.normal(size=(D, 8, 2)).astype(np.float32)
    y = np.full((8, 1), -0.3, np.float32)
    arts = {
        "sampler": (export.export_sampler(fn, [Z_SHAPE, Y_SHAPE]), (z[0], y)),
        "multidraw": (export.export_multidraw_sampler(fn, Z_SHAPE, Y_SHAPE), (z, y)),
        "seeded_multidraw": (export.export_seeded_multidraw_sampler(fn, D, Z_SHAPE, Y_SHAPE),
                             (9, y)),
    }
    multi = arts["multidraw"][0].call(z, y)
    assert multi.shape == (D, 8, 3)
    for i in range(D):  # one pass of D*8 rows against D of 8: other blockings
        torch.testing.assert_close(multi[i], fn(torch.from_numpy(z[i]), torch.from_numpy(y)),
                                   rtol=1e-6, atol=1e-6)
    for kind, (art, args) in arts.items():
        path = str(tmp_path / f"{kind}.pt")
        side = export.save_artifact(path, art, metadata={"kind": "toy"})
        with open(path + ".json") as f:
            assert json.load(f) == side
        payload = torch.load(path, weights_only=True)
        assert payload["family"] == "toy" and payload["entry"]["x_d"] == 2
        loaded = export.load_artifact(path, device="cpu")
        assert isinstance(loaded.fn, export.ToyServingFn)
        assert loaded.fn.model.cfg == tm.cfg
        assert torch.equal(loaded.call(*args), art.call(*args))
    for b in (1, 5, 32):
        out = arts["sampler"][0].call(rng.normal(size=(b, 2)).astype(np.float32),
                                      np.zeros((b, 1), np.float32))
        assert out.shape == (b, 3)
    jm = JToyCINN(JToyConfig(**config_kw("small")))
    j_side = jexport.save_artifact(
        str(tmp_path / "jax.shlo"),
        jexport.export_sampler(jexport.make_toy_serving_fn(jm, {"params": params}, x_d=2),
                               [Z_SHAPE, Y_SHAPE]))
    port_side = export.save_artifact(str(tmp_path / "s.pt"), arts["sampler"][0])
    for key in ("in_avals", "out_avals", "fun_name"):
        assert port_side[key] == j_side[key], key
    assert arts["multidraw"][0].out_avals == ["float32[d,b,3]"]


def test_conv_artifacts_without_a_family_still_load(tmp_path):
    """A conv artifact file written before the family was recorded (no
    ``family`` key) loads as a ConvCFlow and serves the same values."""
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow

    cfg = ConvFlowConfig(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1),
                         res_blocks=(1, 1), num_kernels=(8, 8), cardinality=(2, 2))
    fn = export.make_image_serving_fn(ConvCFlow(cfg, device="cpu"), 1, de_logit=True)
    art = export.export_multidraw_sampler(fn, (8, 8, 1), (8, 8, 1))
    path = str(tmp_path / "old.pt")
    export.save_artifact(path, art)
    payload = torch.load(path, weights_only=True)
    assert payload.pop("family") == "conv"
    torch.save(payload, path)
    loaded = export.load_artifact(path, device="cpu")
    assert isinstance(loaded.fn, export.ImageServingFn) and loaded.fn.model.cfg == cfg
    z = np.random.default_rng(0).normal(size=(2, 3, 8, 8, 1)).astype(np.float32)
    y = np.full((3, 8, 8, 1), 0.5, np.float32)
    assert torch.equal(loaded.call(z, y), art.call(z, y))
