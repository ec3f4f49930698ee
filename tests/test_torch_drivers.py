"""The port's drivers on the CPU (``--cpu``), at a tiny arch on synthetic
digits: ``cnf-conv`` on the class workload through ``--scan-steps`` with
checkpoints, resuming from them, both SR workloads, ``--load`` of a weights
``.npz`` written by the JAX package (loaded as is, and refused under another
arch); ``cnf-eval`` of the class checkpoint with ``--export-multidraw``,
whose artifact loads and serves; every flag of a path not ported yet exiting
with its ROADMAP item; and no driver running without a card unless asked
for the CPU."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import few_threads  # noqa: E402,F401  (two torch threads, autouse)
from arl_conditional_normalizing_flows_tpu.train import checkpoints as jckpt  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (  # noqa: E402
    flax_from_state_dict,
)
from arl_conditional_normalizing_flows_tpu_torch.drivers import conv, evaluate  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.arch import (  # noqa: E402
    ConvFlowConfig,
    arch_string,
)
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.serve import load_artifact  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.train import CheckpointManager  # noqa: E402

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
    (["--records-dir", "recs"], "A.4"),
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
    for flags, item in ((["--plot"], "A.9"), (["--records-dir", "recs"], "A.4")):
        with pytest.raises(SystemExit, match=item):
            evaluate.main(["--cpu", "--checkpoint-dir", ck, *DATA, *flags])
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
