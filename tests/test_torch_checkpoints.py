"""The port's checkpoints and weight files on the CPU: the cases of
``tests/test_checkpoints.py`` for its ``CheckpointManager`` (on the small
conv model: the port has no toy model yet), and ``.npz`` weight files that
cross between the two packages in both directions with the same key set,
the same ``log_loss`` and the ``__extra__arch`` string; and
``convert/from_jax.py``'s two directions as exact inverses."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import subnets as jsubnets  # noqa: E402
from arl_conditional_normalizing_flows_tpu.train import checkpoints as jckpt  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.models import subnets as tsubnets  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.arch import (  # noqa: E402
    ConvFlowConfig,
    arch_string,
)
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.train import (  # noqa: E402
    CheckpointManager,
    create_train_state,
    load_npz_extras,
    load_params_npz,
    make_step_fns,
    save_params_npz,
)

SMALL = dict(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
             num_kernels=(8, 8), cardinality=(2, 2), ksize=3)
CFG = ConvFlowConfig(**SMALL)


def _flax_tree(init, *args, seed=0):
    """The tree ``init(key, *args)`` returns, traced for its keys and shapes
    only (compiling flax's init costs seconds a model here), filled with
    normal values from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)


def _state(seed=0, steps=1):
    """A train state of :data:`CFG` with ``steps`` Adam steps taken (so that
    the optimizer has state to save)."""
    state = create_train_state(ConvCFlow(CFG, device="cpu", seed=seed), 1e-3)
    step, _ = make_step_fns(state.model, noise_mode="none")
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        step(state, torch.from_numpy(rng.normal(size=(2, 8, 8, 2)).astype(np.float32)))
    return state


def _assert_same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.step == b.step


@pytest.mark.parametrize("case", ["same_epoch_overwrites", "older_epoch_persists"])
def test_save_is_unconditional(tmp_path, case):
    """A save at an epoch already written replaces it (the final
    best-params save after early stopping may land on a cadence
    checkpoint's epoch), and a save below the latest epoch is kept."""
    mgr = CheckpointManager(str(tmp_path / "ck"), config=CFG)
    if case == "same_epoch_overwrites":
        mgr.save(5, _state(0))
        want, epoch = _state(1, steps=2), 5
        mgr.save(5, want)
    else:
        mgr.save(7, _state(0))
        want, epoch = _state(3), 4
        mgr.save(4, want)
    ep, restored = mgr.restore(_state(2, steps=0), epoch=None if case.startswith("same") else 4)
    assert ep == epoch
    _assert_same_state(restored, want)


@pytest.mark.parametrize("case", ["missing", "empty"])
def test_restore_only_mode_raises_and_creates_nothing(tmp_path, case):
    d = tmp_path / case
    if case == "empty":
        d.mkdir()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(d), config=CFG, create=False)
    # a missing directory is not minted, an empty one gets no arch.json
    assert d.exists() == (case == "empty") and not (d / "arch.json").exists()


def test_arch_contract_enforced(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, config=CFG)
    mgr.save(0, _state(0))
    with open(tmp_path / "ck" / "arch.json") as f:
        assert f.read() == jckpt._config_to_json(JConfig(**SMALL))  # JAX's arch.json, byte for byte
    with pytest.raises(ValueError, match="different"):
        CheckpointManager(d, config=dataclasses.replace(CFG, num_kernels=(16, 16)))


def test_legacy_lowering_keys_restore(tmp_path):
    """An arch.json written before the four lowering booleans became
    ``experimental_lowering`` and before later fields existed restores."""
    cfg = ConvFlowConfig(io_shape=(4, 4, 2), x_d=1, squeeze_factor_blocks=(0,),
                         res_blocks=(1,), num_kernels=(8,), cardinality=(2,))
    d = tmp_path / "ck"
    d.mkdir()
    legacy = dataclasses.asdict(cfg)
    del legacy["experimental_lowering"]
    del legacy["late_head_cast"]
    legacy.update(use_pallas_coupling=False, fuse_dilated_conv=False,
                  dense_masked_groups=False, fused_pallas_subnet=False)
    (d / "arch.json").write_text(json.dumps(legacy, sort_keys=True))
    CheckpointManager(str(d), config=cfg)
    legacy["use_pallas_coupling"] = True
    (d / "arch.json").write_text(json.dumps(legacy, sort_keys=True))
    CheckpointManager(str(d), config=dataclasses.replace(
        cfg, experimental_lowering="pallas_coupling"))
    with pytest.raises(ValueError, match="different"):
        CheckpointManager(str(d), config=cfg)


def test_restore_continues_training_and_keeps_the_newest(tmp_path):
    """A restored state takes the same next step as the saved one; only the
    ``max_to_keep`` highest epochs stay."""
    mgr = CheckpointManager(str(tmp_path / "ck"), config=CFG, max_to_keep=2)
    state = _state(0, steps=2)
    for epoch in range(4):
        mgr.save(epoch, state)
    assert mgr.all_epochs() == [2, 3]
    restored = mgr.restore(_state(5, steps=0))[1]
    assert restored.step == 2
    xy = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 8, 8, 2)).astype(np.float32))
    for s in (state, restored):
        make_step_fns(s.model, noise_mode="none")[0](s, xy)
    _assert_same_state(restored, state)


# ---------------------------------------------------------------------------
# .npz weights across the two packages
# ---------------------------------------------------------------------------


def _perturbed_flax(model, seed):
    """``model``'s weights as a flax tree with non-trivial biases/scales."""
    rng = np.random.default_rng(seed)
    tree = flax_from_state_dict(model.state_dict(), model)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if t.ndim == 0:
            return np.asarray(1.3, np.float32)
        return (t + 0.05 * rng.normal(size=t.shape)).astype(np.float32)

    return go(tree)


def _xy():
    rng = np.random.default_rng(4)
    return np.concatenate([rng.uniform(size=(3, 8, 8, 1)),
                           np.full((3, 8, 8, 1), 0.5)], axis=-1).astype(np.float32)


def _jax_loss(cfg_kw, params, xy):
    jm = JConvCFlow(JConfig(**cfg_kw))
    out = jax.jit(lambda p, x: jm.apply({"params": p}, x, method="log_loss"))(params, xy)
    return {k: float(v) for k, v in out.items()}


def _port_loss(model, xy):
    with torch.no_grad():
        return {k: float(v) for k, v in model.log_loss(torch.from_numpy(xy)).items()}


def test_jax_npz_loads_into_the_port(tmp_path):
    """JAX's save_params_npz file: the port loads it (with its arch extra),
    computes JAX's log_loss at 1e-5, and writes the same keys and values."""
    src = ConvCFlow(CFG, device="cpu", seed=1)
    params = _perturbed_flax(src, 2)
    path = str(tmp_path / "jax.npz")
    jckpt.save_params_npz(path, {"params": jax.tree_util.tree_map(jnp.asarray, params)},
                          extra={"arch": np.asarray(arch_string(CFG))})
    model = load_params_npz(path, ConvCFlow(CFG, device="cpu", seed=7))
    assert str(load_npz_extras(path)["arch"]) == arch_string(CFG)
    xy = _xy()
    want, got = _jax_loss(SMALL, params, xy), _port_loss(model, xy)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    mine = str(tmp_path / "port.npz")
    save_params_npz(mine, model, extra={"arch": arch_string(CFG)})
    with np.load(path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_npz_loads_into_jax(tmp_path):
    """The port's file loads into JAX's load_params_npz (its template from
    flax's init) and gives the port's log_loss at 1e-5; JAX reads the arch
    extra."""
    model = ConvCFlow(CFG, device="cpu", seed=5)
    model.load_state_dict(state_dict_from_flax(_perturbed_flax(model, 6), model))
    path = str(tmp_path / "port.npz")
    save_params_npz(path, model, extra={"arch": arch_string(CFG)})
    template = _flax_tree(JConvCFlow(JConfig(**SMALL)).init, jnp.zeros((1, 8, 8, 2)))
    loaded = jckpt.load_params_npz(path, template)
    assert str(jckpt.load_npz_extras(path)["arch"]) == arch_string(CFG)
    xy = _xy()
    want, got = _port_loss(model, xy), _jax_loss(SMALL, loaded["params"], xy)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("kw", [
    dict(fused_subnet=True),
    dict(fused_subnet=False, layer_norm=True),
    dict(fused_subnet=False, experimental_lowering="pallas_subnet"),
    dict(fused_subnet=True, experimental_lowering="pallas_subnet", compute_dtype="bfloat16"),
], ids=["fused", "layer_norm", "pallas_subnet", "pallas_subnet_fused_bf16"])
def test_flax_from_state_dict_inverts_state_dict_from_flax(kw):
    """flax's own tree (its init's keys and shapes) -> state_dict -> flax
    tree gives every key and value back exactly, with flax's dotted leaf
    names under pallas_subnet."""
    cfg = dict(SMALL, num_kernels=(16, 16), **kw)
    params = _flax_tree(JConvCFlow(JConfig(**cfg)).init, jnp.zeros((1, 8, 8, 2)))["params"]
    model = ConvCFlow(ConvFlowConfig(**cfg), device="cpu")
    back = flax_from_state_dict(state_dict_from_flax(params, model), model)
    want, got = dict(_flat(params)), dict(_flat(back))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))


def test_flax_from_state_dict_inverts_cardinality1_subnets():
    """A cardinality-1 subnet's dense (k, k, K, K/d) branch kernels, carried
    through a holder that gives the converter its ``couplings.0.<net>``
    prefix (as ``tests/test_torch_subnets.py`` does)."""
    kw = dict(out_channels=2, num_kernels=16, num_res_blocks=2, cardinality=1, ksize=3,
              dilations=(1, 2))
    jnet = jsubnets.ConvCouplingNet(n_heads=2, layer_norm=False, **kw)
    pf = _flax_tree(jnet.init, jnp.zeros((1, 8, 8, 2)))["params"]
    holder = torch.nn.Module()
    holder.couplings = torch.nn.ModuleList([torch.nn.Module()])
    holder.couplings[0].net_ab = tsubnets.ConvCouplingNet(
        (8, 8, 2), n_heads=2, layer_norm=False, generator=torch.Generator().manual_seed(0), **kw)
    tree = {"couplings_0": {"net_ab": pf}}
    back = flax_from_state_dict(state_dict_from_flax(tree, holder), holder)
    want, got = dict(_flat(tree)), dict(_flat(back))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
