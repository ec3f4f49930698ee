"""The port's reference-checkpoint importer (``convert/reference_import.py``,
``cnf-import-reference``) against the JAX package's, on the CPU.

The reference's files are written here without TensorFlow: Keras 3 and
Keras 2 ``.h5`` layouts with h5py, as ``tests/test_import_reference.py``
writes them from a live reference model, but holding a seeded numpy draw at
the small arch's shapes in the reference's layer creation order (grouped
branches as one Conv2D a group); the toy's object-array ``.npy`` pair in
Keras's graph-depth order. Both importers read the same file: their trees
are equal leaf for leaf, and the port model loaded from the port's gives
JAX's ``log_loss`` within ``tests/test_torch_flow.py``'s tolerance."""

import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from arl_conditional_normalizing_flows_tpu.convert import reference_import as jri  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ToyCINN as JToyCINN  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ToyConfig as JToyConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.train import checkpoints as jckpt  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert import reference_import as ri  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from arl_conditional_normalizing_flows_tpu_torch.drivers import import_reference  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.drivers import toy as cnf_toy  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.arch import (  # noqa: E402
    ConvFlowConfig,
    ToyConfig,
    arch_string,
)
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.train import load_npz_extras  # noqa: E402

#: the small arch of tests/test_import_reference.py::_small_cfg
SMALL = dict(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1), res_blocks=(1, 1),
             num_kernels=(16, 16), cardinality=(2, 2), ksize=3, ref_compat_group_slice=True)
#: its reference filename (tests/test_import_reference.py::test_import_cli_conv_and_load)
SMALL_NAME = "weights_class_mnist_8x8x2_SqFa01_NRB11_C22_NK1616_KS3_D12_LN{}.weights.h5"
#: log_loss against JAX: tests/test_torch_flow.py's small-arch tolerance
LOSS_RTOL, LOSS_ATOL = 1e-5, 3e-4


def _index(name):
    m = re.search(r"_(\d+)$", name)
    return int(m.group(1)) if m else 0


def _sorted(keys, stem):
    return sorted((k for k in keys if k.startswith(stem)), key=_index)


def reference_layers(template, seed=0, scale=True):
    """The reference model's layers, per coupling and sub-model, in its
    creation order (conv_cINN_base_functions.py:573-627): ``{"model_b":
    [(kind, arrays)], "model_A": [...]}``, kinds ``conv`` (kernel, bias; a
    grouped branch as one conv a group), ``ln`` (gamma, beta) and ``scale``
    (A only, unless ``scale`` is False), drawn from numpy ``seed`` at the
    shapes of ``template`` (a flax-layout params tree)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, loc=0.0):
        return (loc + 0.1 * rng.normal(size=shape)).astype(np.float32)

    out = []
    for key in _sorted(template, "couplings_"):
        sides = {}
        for side, net in (("model_b", "net_b"), ("model_A", "net_a")):
            sub, layers = template[key][net], []

            def conv(slot, groups=1):
                kh, kw, cin, cout = slot["kernel"].shape
                for _ in range(groups):
                    layers.append(("conv", [normal(kh, kw, cin, cout // groups),
                                            normal(cout // groups)]))

            def ln(slot):
                n = slot["LayerNorm_0"]["scale"].shape[0]
                layers.append(("ln", [normal(n, loc=1.0), normal(n)]))

            conv(sub["Conv_0"])
            for bkey in _sorted(sub, "DilatedResidualBlock"):
                block = sub[bkey]
                convs, lns = _sorted(block, "Conv_"), _sorted(block, "FlatLayerNorm")
                width = block[convs[0]]["kernel"].shape[3]
                if lns:
                    ln(block[lns[0]])
                conv(block[convs[0]])
                if lns:
                    ln(block[lns[1]])
                for ck in convs[1:-1]:
                    conv(block[ck], groups=width // block[ck]["kernel"].shape[2])
                if lns:
                    ln(block[lns[2]])
                conv(block[convs[-1]])
            if "FlatLayerNorm_0" in sub:
                ln(sub["FlatLayerNorm_0"])
            conv(sub["Conv_1"])
            if "tanh_scale" in sub and scale:
                layers.append(("scale", [np.float32(1.0 + rng.normal())]))
            sides[side] = layers
        out.append(sides)
    return out


_KERAS = {"conv": ("conv2d", ("kernel", "bias")),
          "ln": ("layer_normalization", ("gamma", "beta")),
          "scale": ("tanh_scaling_layer", ("scale",))}


def _layer_names(couplings):
    """Keras's auto-names, numbered over the whole model in creation
    order: per coupling, [(side, name, kind, arrays)]."""
    counts = dict.fromkeys(_KERAS, 0)
    named = []
    for sides in couplings:
        rows = []
        for side in ("model_b", "model_A"):
            for kind, arrs in sides[side]:
                base, i = _KERAS[kind][0], counts[kind]
                counts[kind] += 1
                rows.append((side, base if i == 0 else f"{base}_{i}", kind, arrs))
        named.append(rows)
    return named


def write_keras3(path, couplings):
    """``layers/coupling_layer_{j}/model_{A,b}/layers/<layer>/vars/{i}``."""
    with h5py.File(path, "w") as f:
        layers = f.create_group("layers")
        for ci, rows in enumerate(_layer_names(couplings)):
            cg = layers.create_group("coupling_layer" if ci == 0 else f"coupling_layer_{ci}")
            for side, name, _, arrs in rows:
                sub = cg.require_group(side).require_group("layers")
                v = sub.create_group(name).create_group("vars")
                for i, a in enumerate(arrs):
                    v.create_dataset(str(i), data=a)


def write_keras2(path, couplings):
    """Root attr ``layer_names``, a group a coupling whose ``weight_names``
    are the full variable paths in creation order
    (tests/test_import_reference.py:141-226)."""
    with h5py.File(path, "w") as f:
        names = []
        for ci, rows in enumerate(_layer_names(couplings)):
            lname = "coupling_layer" if ci == 0 else f"coupling_layer_{ci}"
            names.append(lname)
            g = f.create_group(lname)
            wnames = []
            for side, name, kind, arrs in rows:
                for a, var in zip(arrs, _KERAS[kind][1]):
                    full = f"{lname}/{side}/{name}/{var}:0"
                    g.create_dataset(full, data=a)
                    wnames.append(full.encode())
            g.attrs["weight_names"] = wnames
        f.attrs["layer_names"] = [n.encode() for n in names]


def port_template(cfg):
    model = ConvCFlow(cfg, device="cpu")
    return flax_from_state_dict(model.state_dict(), model)


def reference_file(tmp_path, layout, layer_norm, name=None, scale=True):
    cfg = ConvFlowConfig(**SMALL, layer_norm=layer_norm)
    path = str(tmp_path / (name or f"ref_{layout}.h5"))
    {"keras3": write_keras3, "keras2": write_keras2}[layout](
        path, reference_layers(port_template(cfg), scale=scale))
    return path, cfg


def assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == np.float32 and a.shape == b.shape, (path, k, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")


def jax_loss(cfg_kw, params, xy):
    jm = JConvCFlow(JConfig(**cfg_kw))
    out = jax.jit(lambda p, x: jm.apply({"params": p}, x, method="log_loss"))(params, xy)
    return {k: float(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# filename-convention parsing (tests/test_import_reference.py:44-100)
# ---------------------------------------------------------------------------


def test_parse_conv_filename_flagship():
    kw = ri.parse_conv_filename(
        "weights_class_mnist_28x28x2_SqFa0100_NRB3333_C8844_NK64643232"
        "_KS3_D124_LNTrue.h5")
    assert kw["io_shape"] == (28, 28, 2)
    assert kw["squeeze_factor_blocks"] == (0, 1, 0, 0)
    assert kw["res_blocks"] == (3, 3, 3, 3)
    assert kw["cardinality"] == (8, 8, 4, 4)
    assert kw["num_kernels"] == (64, 64, 32, 32)
    assert kw["ksize"] == 3 and kw["dilations"] is True
    assert kw["layer_norm"] is True
    assert ConvFlowConfig(x_d=1, **kw) == ConvFlowConfig(io_shape=(28, 28, 2), x_d=1,
                                                         layer_norm=True)


def test_parse_conv_filename_checkpoint_variant():
    name = ("checkpoint_SR2,1_fashion_mnist_28x28x2_SqFa0100_NRB3333_C8844"
            "_NK64643232_KS3_D124_LNFalse.e40.hdf5")
    kw = ri.parse_conv_filename(name)
    assert kw["layer_norm"] is False
    assert kw["num_kernels"] == (64, 64, 32, 32)
    assert kw == jri.parse_conv_filename(name)


def test_parse_toy_filename():
    kw = ri.parse_toy_filename("weights_crescents_NCL24_ID32_NL6.npy")
    assert kw == dict(num_coupling_layers=24, intermediate_dims=32, num_layers=6)
    with pytest.raises(ValueError, match="toy convention"):
        ri.parse_toy_filename("weights.npy")
    with pytest.raises(ValueError, match="arch convention"):
        ri.parse_conv_filename("weights.h5")


# ---------------------------------------------------------------------------
# conv .h5 import
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,layer_norm", [("keras3", True), ("keras2", True),
                                               ("keras3", False), ("keras2", False)])
def test_conv_h5_import_equals_jax_and_gives_its_log_loss(tmp_path, layout, layer_norm):
    path, cfg = reference_file(tmp_path, layout, layer_norm)
    jcfg_kw = {**SMALL, "layer_norm": layer_norm}
    mine = ri.import_conv_h5(path, cfg)
    theirs = jax.tree_util.tree_map(np.asarray, jri.import_conv_h5(path, JConfig(**jcfg_kw)))
    assert_trees_equal(mine, theirs)

    model = ConvCFlow(cfg, device="cpu", seed=5)
    model.load_state_dict(state_dict_from_flax(mine["params"], model))
    rng = np.random.default_rng(42)
    xy = np.concatenate([rng.normal(size=(4, 8, 8, 1)), np.full((4, 8, 8, 1), 0.5)],
                        -1).astype(np.float32)
    with torch.no_grad():
        got = {k: float(v) for k, v in model.log_loss(torch.from_numpy(xy)).items()}
    want = jax_loss(jcfg_kw, theirs["params"], xy)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


def test_keras2_and_keras3_files_import_to_one_tree(tmp_path):
    k3, cfg = reference_file(tmp_path, "keras3", True)
    k2, _ = reference_file(tmp_path, "keras2", True)
    assert_trees_equal(ri.import_conv_h5(k2, cfg), ri.import_conv_h5(k3, cfg))


def test_conv_h5_import_wrong_arch_fails_loudly(tmp_path):
    """Another width, another depth, or a file whose A nets lack the tanh
    scale (a leaf the import would leave at the port's init) raise."""
    path, cfg = reference_file(tmp_path, "keras3", True)
    with pytest.raises(ValueError, match="does not fit"):
        ri.import_conv_h5(path, dataclasses.replace(cfg, num_kernels=(8, 8)))
    with pytest.raises(ValueError, match="coupling layers"):
        ri.import_conv_h5(path, dataclasses.replace(cfg, squeeze_factor_blocks=(0,),
                                                    res_blocks=(1,), num_kernels=(16,),
                                                    cardinality=(2,)))
    with pytest.raises(ValueError, match="LayerNorm"):
        ri.import_conv_h5(path, dataclasses.replace(cfg, layer_norm=False))
    no_scale, _ = reference_file(tmp_path, "keras3", True, name="no_scale.h5", scale=False)
    with pytest.raises(ValueError, match="unfilled"):
        ri.import_conv_h5(no_scale, cfg)
    with pytest.raises(ValueError, match="fused_subnet"):
        ri.import_conv_h5(path, dataclasses.replace(cfg, fused_subnet=True))


def test_conv_import_without_h5py_names_it(tmp_path, monkeypatch):
    path, cfg = reference_file(tmp_path, "keras3", False)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        ri.import_conv_h5(path, cfg)


# ---------------------------------------------------------------------------
# toy .npy import
# ---------------------------------------------------------------------------

TOY = dict(num_coupling_layers=6, intermediate_dims=8, num_layers=1)


def write_toy_reference(tmp_path, order, seed=0, name="weights_crescents_NCL6_ID8_NL1.npy"):
    """The reference's pair: per coupling, ``get_weights()`` in Keras's
    graph-depth order [A_dense0, b_dense0, ..., A_head, b_head] at the
    template's shapes, from numpy ``seed``; and the layer order."""
    rng = np.random.default_rng(seed)
    model = ToyCINN(ToyConfig(**TOY), device="cpu")
    template = flax_from_state_dict(model.state_dict(), model)
    arr = np.empty(TOY["num_coupling_layers"], dtype=object)
    nl1 = TOY["num_layers"] + 1
    for j in range(len(arr)):
        dense = template[f"couplings_{j}"]
        b_stack = [dense[f"Dense_{i}"] for i in range(nl1 + 1)]
        a_stack = [dense[f"Dense_{i}"] for i in range(nl1 + 1, 2 * nl1 + 2)]
        weights = []
        for a, b in zip(a_stack, b_stack):
            for d in (a, b):
                weights += [rng.normal(size=d["kernel"].shape).astype(np.float32),
                            rng.normal(size=d["bias"].shape).astype(np.float32)]
        arr[j] = weights
    wpath, mpath = str(tmp_path / name), str(tmp_path / name.replace("weights_", "mask_indices_"))
    np.save(wpath, arr, allow_pickle=True)
    np.save(mpath, np.asarray(order))
    return wpath, mpath


def test_toy_npy_import_equals_jax(tmp_path):
    order = (5, 1, 4, 0, 3, 2)
    wpath, mpath = write_toy_reference(tmp_path, order)
    tree, mask, cfg = ri.import_toy_npy(wpath, mpath)
    jtree, jmask, jcfg = jri.import_toy_npy(wpath, mpath)
    assert mask == jmask == order
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(tree, jax.tree_util.tree_map(np.asarray, jtree))
    with pytest.raises(ValueError, match="Dense layers"):
        ri.import_toy_npy(wpath, mpath, cfg=dataclasses.replace(cfg, num_layers=2))


# ---------------------------------------------------------------------------
# cnf-import-reference
# ---------------------------------------------------------------------------


def test_import_cli_conv_writes_an_npz_jax_loads(tmp_path):
    """The conv subcommand parses the arch from the reference filename and
    writes an npz with its arch string that JAX's load_params_npz reads as
    JAX's own importer's tree."""
    path, cfg = reference_file(tmp_path, "keras2", False, name=SMALL_NAME.format("False"))
    out = import_reference.main(["conv", "--weights", path,
                                 "--output", str(tmp_path / "imported.npz")])
    assert str(load_npz_extras(out)["arch"]) == arch_string(cfg)
    jcfg = JConfig(**SMALL)
    template = jax.eval_shape(JConvCFlow(jcfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 8, 8, 2)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    loaded = jckpt.load_params_npz(out, template)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, loaded),
                       jax.tree_util.tree_map(np.asarray, jri.import_conv_h5(path, jcfg)))
    assert str(jckpt.load_npz_extras(out)["arch"]) == arch_string(cfg)


def test_import_cli_toy_writes_an_npz_that_both_packages_load(tmp_path):
    """The toy subcommand's npz carries the layer order; JAX's
    load_params_npz reads JAX's importer's tree from it, and cnf-toy --load
    restores the order and (at lr 0) keeps the weights."""
    order = (2, 0, 1, 5, 3, 4)
    wpath, mpath = write_toy_reference(tmp_path, order, seed=3)
    out = import_reference.main(["toy", "--weights", wpath, "--mask-indices", mpath])
    assert out == wpath[:-4] + ".npz"
    assert tuple(int(i) for i in load_npz_extras(out)["mask_indices"]) == order
    jtree, _, jcfg = jri.import_toy_npy(wpath, mpath)
    template = jax.eval_shape(JToyCINN(JToyConfig(**dataclasses.asdict(jcfg))).init,
                              jax.random.PRNGKey(0), jnp.zeros((2, 3)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jckpt.load_params_npz(out, template)),
                       jax.tree_util.tree_map(np.asarray, jtree))
    run = str(tmp_path / "toy")
    cnf_toy.main(["--cpu", "--coupling-blocks", "1", "--intermediate-dims", "8",
                  "--num-layers", "1", "--batch-size", "64", "--batches-per-class", "2",
                  "--eval-samples", "64", "--epochs", "1", "--annealing-epochs", "0",
                  "--lr", "0", "--load", out, "--outdir", run])
    mine = f"{run}/weights.npz"
    assert tuple(int(i) for i in load_npz_extras(mine)["mask_indices"]) == order
    with np.load(out) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
