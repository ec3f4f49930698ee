"""The port's drivers on the CPU (``--cpu``), at a tiny arch on synthetic
digits: ``cnf-conv`` on the class workload through ``--scan-steps`` with
checkpoints, resuming from them, both SR workloads, ``--load`` of a weights
``.npz`` written by the JAX package (loaded as is, and refused under another
arch); ``cnf-eval`` of the class checkpoint with ``--export-multidraw``,
whose artifact loads and serves; ``cnf-pretrain-noise`` and ``cnf-conv``
starting from its weights; ``cnf-toy`` on the three datasets, with
``--scan-steps``, a sweep and ``--load`` restoring the layer order; both new
drivers' ``.npz`` files crossing between the packages, and one toy
evaluation of the same weights in both; every flag of a path not ported yet
exiting with its ROADMAP item; and no driver running without a card unless
asked for the CPU. ``--records-dir`` is held by ``tests/test_torch_records.py``."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_checkpoints as ckpt  # noqa: E402
from test_torch_train import few_threads  # noqa: E402,F401  (two torch threads, autouse)
from arl_conditional_normalizing_flows_tpu.models import ConvCFlow as JConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ConvFlowConfig as JConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ToyCINN as JToyCINN  # noqa: E402
from arl_conditional_normalizing_flows_tpu.models import ToyConfig as JToyConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu.drivers import toy as jtoy  # noqa: E402
from arl_conditional_normalizing_flows_tpu.train import checkpoints as jckpt  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    flax_from_state_dict,
)
from arl_conditional_normalizing_flows_tpu_torch.drivers import (  # noqa: E402
    conv,
    evaluate,
    pretrain_noise,
    toy,
)
from arl_conditional_normalizing_flows_tpu_torch.models.arch import (  # noqa: E402
    ConvFlowConfig,
    ToyConfig,
    arch_string,
    shuffle_mask_indices,
)
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.serve import load_artifact  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.train import (  # noqa: E402
    CheckpointManager,
    load_npz_extras,
    load_params_npz,
)

#: a tiny arch at the data's 28 x 28: one residual block a level, 8 kernels,
#: no dilations (8 kernels cannot split into the dilated branches)
ARCH = ["--squeeze-factor", "0", "1", "--res-blocks", "1", "1", "--kernels", "8", "8",
        "--cardinality", "2", "2", "--no-dilations"]
DATA = ["--dataset", "synthetic", "--synthetic-per-class", "16", "--data-classes", "0", "1",
        "--batch-size", "8", "--eval-samples", "4"]
CLASS = ["--cpu", "--model-type", "class", *DATA, *ARCH, "--annealing-epochs", "1",
         "--checkpoint-every", "1"]
CFG = ConvFlowConfig(io_shape=(28, 28, 2), x_d=1, squeeze_factor_blocks=(0, 1),
                     res_blocks=(1, 1), num_kernels=(8, 8), cardinality=(2, 2), dilations=False,
                     ref_compat_shared_init=True)


def history(outdir):
    with open(os.path.join(outdir, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def class_run(tmp_path_factory):
    """cnf-conv class: 1 annealing and 1 clean epoch of stacks of 2 steps."""
    out = str(tmp_path_factory.mktemp("class"))
    res = conv.main(CLASS + ["--epochs", "1", "--scan-steps", "2", "--outdir", out])
    return out, res


def test_cnf_conv_class_with_scan_steps(class_run):
    out, res = class_run
    rows = history(out)
    assert [r["epoch"] for r in rows] == [0, 1] and [r["alpha"] for r in rows] == [0.0, 1.0]
    assert all(np.isfinite(r[k]) for r in rows for k in ("loss", "val_loss"))
    with open(os.path.join(out, "eval.json")) as f:
        final = json.load(f)
    assert np.isfinite(final["val_bits_per_dim"]) and set(final["sampling"]["per_class"]) == {
        "0", "1"}
    with open(os.path.join(out, "run.json")) as f:
        run = json.load(f)
    assert run["backend"] == "cpu" and run["arch"] == arch_string(CFG)
    assert CheckpointManager(os.path.join(out, "checkpoints"), create=False).all_epochs() == [0, 1]
    assert res.completed_epochs == 2


def test_cnf_conv_resumes_from_its_checkpoints(class_run, tmp_path):
    out = str(tmp_path / "resumed")
    shutil.copytree(class_run[0], out)
    res = conv.main(CLASS + ["--epochs", "2", "--outdir", out])
    assert [r["epoch"] for r in res.history.rows] == [2]
    assert [r["epoch"] for r in history(out)] == [0, 1, 2]
    assert CheckpointManager(os.path.join(out, "checkpoints"), create=False).latest_epoch() == 2


def test_a_resumed_run_equals_an_uninterrupted_one(class_run, tmp_path):
    """2 epochs, then a resumed third, give the losses and the weights of 3
    epochs in one run, bit for bit: the checkpoint carries the generator's
    state, so the resumed epoch draws the data order and noise that the
    uninterrupted run's third epoch drew."""
    resumed, whole = str(tmp_path / "resumed"), str(tmp_path / "whole")
    shutil.copytree(class_run[0], resumed)
    for out in (resumed, whole):
        conv.main(CLASS + ["--epochs", "2", "--scan-steps", "2", "--outdir", out])
    rows = [[{k: v for k, v in r.items() if k != "seconds"} for r in history(out)]
            for out in (resumed, whole)]
    assert [r["epoch"] for r in rows[0]] == [0, 1, 2] and rows[0] == rows[1]
    params = [torch.load(os.path.join(out, "checkpoints", "2", "state.pt"),
                         weights_only=True)["params"] for out in (resumed, whole)]
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[1])


def test_cnf_eval_exports_a_multidraw_artifact(class_run, tmp_path):
    out, _ = class_run
    artifact = str(tmp_path / "multi.pt")
    report = evaluate.main(["--cpu", "--checkpoint-dir", os.path.join(out, "checkpoints"),
                            *DATA, "--export-multidraw", artifact])
    assert report["epoch"] == 1 and np.isfinite(report["bits_per_dim"])
    assert set(report["latent_normality"]) == {"mean_abs_mean", "mean_abs_std_err",
                                               "mean_abs_excess_kurtosis"}
    assert os.path.exists(os.path.join(out, "checkpoint_eval.json"))
    with open(artifact + ".json") as f:
        side = json.load(f)
    assert side["metadata"]["entry"] == "multidraw" and side["metadata"]["de_logit"]
    multi = load_artifact(artifact, device="cpu")
    x = multi.call(np.zeros((2, 3, 28, 28, 1), np.float32), np.full((3, 28, 28, 1), 0.5,
                                                                    np.float32))
    assert x.shape == (2, 3, 28, 28, 1) and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("model_type,squeeze", [("SR2,1", ["0", "1"]), ("SR4,2", ["0", "0"])])
def test_cnf_conv_sr(tmp_path, model_type, squeeze):
    """Both SR stages (SR4,2's 14 x 14 xy takes no squeeze: a squeezed block
    would need 14 divisible by 4)."""
    out = str(tmp_path / "sr")
    arch = ARCH[:1] + squeeze + ARCH[3:]
    conv.main(["--cpu", "--model-type", model_type, "--dataset", "synthetic",
               "--synthetic-per-class", "2", "--batch-size", "8", "--eval-samples", "4", *arch,
               "--epochs", "1", "--annealing-epochs", "0", "--checkpoint-every", "0",
               "--outdir", out])
    with open(os.path.join(out, "eval.json")) as f:
        final = json.load(f)
    assert np.isfinite(final["val_bits_per_dim"]) and np.isfinite(final["loss"])
    assert set(final["sampling"]) == {"residual_block_sums", "recon_pixel_mean",
                                      "recon_pixel_std", "recon_mean_vs_truth_mean"}
    assert len(history(out)) == 1


def test_cnf_conv_loads_a_jax_npz_and_refuses_another_arch(tmp_path):
    """A weights .npz from the JAX package's save_params_npz: loaded as is
    (at lr 0 the checkpoint keeps exactly its weights); with an
    ``__extra__arch`` of another arch (same shapes, other io) it raises."""
    model = ConvCFlow(CFG, device="cpu", seed=11)
    params = flax_from_state_dict(model.state_dict(), model)
    path = str(tmp_path / "w.npz")
    jckpt.save_params_npz(path, {"params": params}, extra={"arch": np.asarray(arch_string(CFG))})
    out = str(tmp_path / "loaded")
    conv.main(CLASS + ["--epochs", "1", "--annealing-epochs", "0", "--lr", "0", "--load", path,
                       "--outdir", out])
    state = torch.load(os.path.join(out, "checkpoints", "0", "state.pt"), weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(state["params"][k], v), k
    other = str(tmp_path / "other.npz")
    jckpt.save_params_npz(other, {"params": params}, extra={
        "arch": np.asarray(arch_string(ConvFlowConfig(**{**CFG.__dict__,
                                                         "io_shape": (14, 14, 2)})))})
    with pytest.raises(ValueError, match="arch"):
        conv.main(CLASS + ["--epochs", "1", "--load", other, "--outdir", str(tmp_path / "x")])
    jax_dir = tmp_path / "orbax"
    (jax_dir / "0").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="save_params_npz"):
        conv.main(CLASS + ["--epochs", "1", "--load", str(jax_dir),
                           "--outdir", str(tmp_path / "y")])


@pytest.mark.parametrize("flags,item", [
    (["--data-parallel"], "A.10"),
    (["--coordinator", "localhost:1234"], "A.10"),
    (["--num-processes", "2"], "A.10"),
    (["--process-id", "0"], "A.10"),
    (["--plot"], "A.9"),
    (["--experimental-lowering", "fused_dilated"], "A.12"),
    (["--experimental-lowering", "dense_groups"], "A.12"),
])
def test_unported_flags_exit_with_their_roadmap_item(tmp_path, flags, item):
    with pytest.raises(SystemExit, match=item):
        conv.main(CLASS + ["--epochs", "1", "--outdir", str(tmp_path), *flags])


def test_cnf_eval_refuses_unported_flags_and_platforms(class_run):
    ck = os.path.join(class_run[0], "checkpoints")
    with pytest.raises(SystemExit, match="A.9"):
        evaluate.main(["--cpu", "--checkpoint-dir", ck, *DATA, "--plot"])
    with pytest.raises(SystemExit):  # argparse: tpu is not a port platform
        evaluate.main(["--cpu", "--checkpoint-dir", ck, *DATA, "--export-multidraw", "a.pt",
                       "--export-platforms", "tpu"])


def test_drivers_raise_without_a_card_unless_asked_for_the_cpu(class_run, tmp_path,
                                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conv.main(CLASS[1:] + ["--epochs", "1", "--outdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.main(["--checkpoint-dir", os.path.join(class_run[0], "checkpoints"), *DATA])


# ---------------------------------------------------------------------------
# cnf-pretrain-noise and cnf-toy (JAX tests/test_drivers.py:24-170, 201-330,
# 464-490)
# ---------------------------------------------------------------------------

#: SMALL of tests/test_torch_checkpoints.py as pretrain flags (8 x 8)
NOISE_SMALL = ["--height", "8", "--width", "8", "--squeeze-factor", "0", "1", "--res-blocks",
               "1", "1", "--kernels", "8", "8", "--cardinality", "2", "2"]
NOISE = ["--cpu", "--num-batches", "2", "--batch-size", "8", "--epochs", "1"]
TOY = ["--cpu", "--coupling-blocks", "1", "--intermediate-dims", "8", "--num-layers", "1",
       "--batch-size", "64", "--batches-per-class", "2", "--eval-samples", "64"]
#: samples a class in the evaluation compared across the packages
EVAL_N = 4000


@pytest.fixture(scope="module")
def noise_run(tmp_path_factory):
    """cnf-pretrain-noise at cnf-conv's tiny ARCH (28 x 28), 2 epochs of
    stacks of 2 steps."""
    out = str(tmp_path_factory.mktemp("noise"))
    res = pretrain_noise.main(NOISE + ARCH + ["--epochs", "2", "--num-batches", "4",
                                              "--scan-steps", "2", "--outdir", out])
    return out, res


def test_cnf_pretrain_noise_tiny(noise_run):
    out, res = noise_run
    rows = history(out)
    assert [r["epoch"] for r in rows] == [0, 1] and all(r["alpha"] == 1.0 for r in rows)
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert res.completed_epochs == 2 and res.train_step is not None
    with open(os.path.join(out, "run.json")) as f:
        assert json.load(f)["arch"] == arch_string(CFG)
    assert str(load_npz_extras(os.path.join(out, "conditioned_weights.npz"))["arch"]) == \
        arch_string(CFG)
    assert CheckpointManager(os.path.join(out, "checkpoints"), create=False).all_epochs() == [1]
    for name in ("history.csv", "history.jsonl"):
        assert os.path.exists(os.path.join(out, name))


def test_cnf_conv_starts_from_the_pretrained_weights(noise_run, tmp_path):
    """cnf-conv --load of the pre-training's npz at lr 0: the trained model
    is the loaded one, so its log_loss on a fixed batch equals that of a
    fresh model loaded from the npz, exactly; the same npz under a 14 x 14
    arch (identical parameter shapes) raises on the arch string."""
    npz = os.path.join(noise_run[0], "conditioned_weights.npz")
    out = str(tmp_path / "conv")
    conv.main(CLASS + ["--epochs", "1", "--annealing-epochs", "0", "--lr", "0", "--load", npz,
                       "--checkpoint-every", "0", "--outdir", out])
    trained = ConvCFlow(CFG, device="cpu", seed=3)
    trained.load_state_dict(torch.load(os.path.join(out, "checkpoints", "0", "state.pt"),
                                       weights_only=True)["params"])
    fresh = load_params_npz(npz, ConvCFlow(CFG, device="cpu", seed=4))
    rng = np.random.default_rng(0)
    xy = torch.from_numpy(np.concatenate([rng.normal(size=(4, 28, 28, 1)),
                                          np.full((4, 28, 28, 1), 0.5)], -1).astype(np.float32))
    with torch.no_grad():
        got, want = trained.log_loss(xy), fresh.log_loss(xy)
    assert all(torch.equal(got[k], want[k]) for k in want)
    noise14 = str(tmp_path / "noise14")
    pretrain_noise.main(NOISE + ARCH + ["--height", "14", "--width", "14", "--outdir", noise14])
    with pytest.raises(ValueError, match="arch"):
        conv.main(CLASS + ["--epochs", "1", "--load",
                           os.path.join(noise14, "conditioned_weights.npz"),
                           "--outdir", str(tmp_path / "mismatch")])


def test_pretrained_npz_loads_into_jax(tmp_path):
    """The port's conditioned_weights.npz loads into JAX's load_params_npz
    and gives the port's log_loss within 1e-5 (JAX's own npz into the port
    is held by ``test_cnf_conv_loads_a_jax_npz_and_refuses_another_arch``)."""
    out = str(tmp_path / "noise")
    pretrain_noise.main(NOISE + NOISE_SMALL + ["--outdir", out])
    path = os.path.join(out, "conditioned_weights.npz")
    template = ckpt._flax_tree(JConvCFlow(JConfig(**ckpt.SMALL)).init, jnp.zeros((1, 8, 8, 2)))
    loaded = jckpt.load_params_npz(path, template)
    assert str(jckpt.load_npz_extras(path)["arch"]) == arch_string(ckpt.CFG)
    model = load_params_npz(path, ConvCFlow(ckpt.CFG, device="cpu"))
    xy = ckpt._xy()
    want, got = ckpt._port_loss(model, xy), ckpt._jax_loss(ckpt.SMALL, loaded["params"], xy)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """cnf-toy on crescents: 1 annealing and 1 clean epoch, seed 0."""
    out = str(tmp_path_factory.mktemp("toy"))
    res = toy.main(TOY + ["--epochs", "1", "--annealing-epochs", "1", "--outdir", out])
    return out, res


def test_cnf_toy_tiny(toy_run):
    out, res = toy_run
    rows = history(out)
    assert [r["alpha"] for r in rows] == [0.0, 1.0] and res.completed_epochs == 2
    for name in ("weights.npz", "history.csv", "run.json"):
        assert os.path.exists(os.path.join(out, name))
    with open(os.path.join(out, "eval.json")) as f:
        report = json.load(f)
    assert np.isfinite(report["final"]["loss"])
    assert set(report["per_class_moments"]) == {"0.0", "1.0"}
    for v in report["per_class_moments"].values():
        assert len(v["sample_mean"]) == len(v["true_std"]) == 2
        assert np.isfinite(v["y_identity_mean"])


def test_cnf_toy_load_restores_the_mask_order(toy_run, tmp_path):
    """--load restores the layer order saved with the weights, under another
    --seed (whose fresh shuffle differs), and starts from those weights: at
    lr 0 the written weights are the loaded ones."""
    path = os.path.join(toy_run[0], "weights.npz")
    order = load_npz_extras(path)["mask_indices"]
    out = str(tmp_path / "loaded")
    toy.main(TOY + ["--epochs", "1", "--annealing-epochs", "0", "--seed", "1", "--lr", "0",
                    "--load", path, "--outdir", out])
    mine = os.path.join(out, "weights.npz")
    np.testing.assert_array_equal(load_npz_extras(mine)["mask_indices"], order)
    assert shuffle_mask_indices(np.random.default_rng(1), 6) != tuple(order)
    with np.load(path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="coupling-blocks"):
        toy.main(TOY + ["--coupling-blocks", "2", "--epochs", "1", "--load", path,
                        "--outdir", str(tmp_path / "x")])


def test_cnf_toy_scan_steps_and_a_sweep(tmp_path):
    out = str(tmp_path / "scan")
    res = toy.main(TOY + ["--batches-per-class", "4", "--epochs", "1", "--annealing-epochs", "1",
                          "--scan-steps", "2", "--sweep", "-1.5", "2.0", "--outdir", out])
    with open(os.path.join(out, "eval.json")) as f:
        report = json.load(f)
    assert np.isfinite(report["final"]["loss"]) and len(res.history.rows) == 2
    assert set(report["sweep"]) == {"-1.5", "2.0"}


@pytest.mark.parametrize("dataset,key", [("continuous_sectors", "per_sector"),
                                         ("mixed", "per_class_moments")])
def test_cnf_toy_sectors_and_mixed(tmp_path, dataset, key):
    out = str(tmp_path / dataset)
    toy.main(TOY + ["--dataset", dataset, "--epochs", "1", "--annealing-epochs", "0",
                    "--outdir", out])
    with open(os.path.join(out, "eval.json")) as f:
        report = json.load(f)
    assert np.isfinite(report["final"]["loss"])
    if dataset == "mixed":
        assert set(report[key]) == {"0.0", "1.0", "2.0"}
        return
    assert "per_class_moments" not in report and len(report[key]) == 8
    agg = report["sector_aggregate"]
    assert 0.0 <= agg["frac_in_sector"] <= 1.0 and np.isfinite(agg["mean_abs_angular_error"])


def test_toy_npz_crosses_between_the_packages(toy_run, tmp_path):
    """The port's weights.npz loads into JAX's ToyCINN with the same
    log_loss (1e-5); a JAX-written one, with its mask order, is loaded by
    cnf-toy --load, which keeps the order and (at lr 0) the weights; and
    both packages' cnf-toy evaluate those weights alike: eval.json's
    per-class moments of 4,000 samples and 4,000 data points, which each
    package draws from its own RNG, agree within 5 standard errors for the
    means and 10% for the stds (5 standard errors of the difference of two
    stds at 4,000 samples, for an excess kurtosis up to about 2), under the
    same standardization (the pinned statistics, ROADMAP C.4)."""
    path = os.path.join(toy_run[0], "weights.npz")
    order = tuple(int(i) for i in load_npz_extras(path)["mask_indices"])
    cfg = ToyConfig(num_coupling_layers=6, intermediate_dims=8, num_layers=1,
                    mask_indices=order)
    jm = JToyCINN(JToyConfig(**dataclasses.asdict(cfg)))
    template = ckpt._flax_tree(jm.init, jnp.zeros((2, 3)))
    loaded = jckpt.load_params_npz(path, template)
    model = load_params_npz(path, ToyCINN(cfg, device="cpu"))
    xy = np.random.default_rng(0).normal(size=(32, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply(p, x, method="log_loss"))(loaded, xy)
    with torch.no_grad():
        got = model.log_loss(torch.from_numpy(xy))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-5)

    jax_path = str(tmp_path / "jax.npz")
    jax_order = (5, 4, 3, 2, 1, 0)
    params = ckpt._flax_tree(jm.init, jnp.zeros((2, 3)), seed=3)
    jckpt.save_params_npz(jax_path, params, extra={"mask_indices": np.asarray(jax_order)})
    out, jax_out = str(tmp_path / "from_jax"), str(tmp_path / "jax_run")
    flags = TOY + ["--epochs", "1", "--annealing-epochs", "0", "--lr", "0", "--load", jax_path,
                   "--eval-samples", str(EVAL_N)]
    toy.main(flags + ["--outdir", out])
    mine = os.path.join(out, "weights.npz")
    assert tuple(load_npz_extras(mine)["mask_indices"]) == jax_order
    with np.load(jax_path) as a, np.load(mine) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=0, err_msg=k)

    jtoy.main(flags + ["--outdir", jax_out])
    with open(os.path.join(out, "eval.json")) as f, \
            open(os.path.join(jax_out, "eval.json")) as g:
        got, want = json.load(f)["per_class_moments"], json.load(g)["per_class_moments"]
    assert set(got) == set(want) == {"0.0", "1.0"}
    for c in want:
        for kind in ("sample", "true"):
            m1, m2 = np.asarray(got[c][f"{kind}_mean"]), np.asarray(want[c][f"{kind}_mean"])
            s1, s2 = np.asarray(got[c][f"{kind}_std"]), np.asarray(want[c][f"{kind}_std"])
            se = np.sqrt((s1**2 + s2**2) / EVAL_N)
            assert (np.abs(m1 - m2) <= 5 * se).all(), (c, kind, m1, m2, 5 * se)
            np.testing.assert_allclose(s1, s2, rtol=0.1, err_msg=f"{c} {kind}_std")


@pytest.mark.parametrize("driver,flags,item", [
    ("pretrain", ["--data-parallel"], "A.10"),
    ("pretrain", ["--coordinator", "localhost:1234"], "A.10"),
    ("pretrain", ["--num-processes", "2"], "A.10"),
    ("pretrain", ["--process-id", "0"], "A.10"),
    ("pretrain", ["--experimental-lowering", "fused_dilated"], "A.12"),
    ("pretrain", ["--experimental-lowering", "dense_groups"], "A.12"),
    ("toy", ["--plot"], "A.9"),
    ("toy", ["--data-parallel"], "A.10"),
    ("toy", ["--coordinator", "localhost:1234"], "A.10"),
    ("toy", ["--num-processes", "2"], "A.10"),
    ("toy", ["--process-id", "0"], "A.10"),
])
def test_new_drivers_exit_with_their_roadmap_item(tmp_path, driver, flags, item):
    main, base = {"pretrain": (pretrain_noise.main, NOISE + NOISE_SMALL),
                  "toy": (toy.main, TOY + ["--epochs", "1"])}[driver]
    with pytest.raises(SystemExit, match=item):
        main(base + ["--outdir", str(tmp_path), *flags])


def test_new_drivers_raise_without_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain_noise.main(NOISE[1:] + NOISE_SMALL + ["--outdir", str(tmp_path / "n")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        toy.main(TOY[1:] + ["--epochs", "1", "--outdir", str(tmp_path / "t")])
