"""The port's ``evaluation/plots.py`` and the drivers' ``--plot``, on the
CPU: every plot function writes a non-empty PNG (JAX's
``tests/test_evaluation.py::test_plots_smoke`` and
``test_new_plot_families_smoke`` on the port's module), the interpolation
grid is JAX's; ``cnf-conv`` (class and SR), ``cnf-eval`` (through
``cnf-conv``'s sampling eval, as JAX's), ``cnf-toy`` and
``cnf-build-records`` write the files JAX's drivers write; and ``--plot``
without matplotlib exits before any work, naming it."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

import test_torch_drivers as drv  # noqa: E402
from test_torch_train import few_threads  # noqa: E402,F401  (two torch threads, autouse)
from arl_conditional_normalizing_flows_tpu.drivers import build_records as jbuild  # noqa: E402
from arl_conditional_normalizing_flows_tpu.evaluation import plots as jplots  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.drivers import (  # noqa: E402
    build_records,
    conv,
    evaluate,
    toy,
)
from arl_conditional_normalizing_flows_tpu_torch.evaluation import plots  # noqa: E402

#: the files JAX's drivers write with --plot (drivers/conv.py:480-516,
#: drivers/toy.py:306-390)
CONV_FILES = {"class": {"class_samples.png"}, "SR2,1": {"sr_panel.png"}}
TOY_FILES = {"loss.png", "annealing.png", "data.png", "latent.png", "conditional.png",
             "interpolation.png", "y_identity.png", "forward_backward.png"}


def pngs(directory):
    return {f for f in os.listdir(directory) if f.endswith(".png")}


def assert_nonempty(directory, names):
    for name in names:
        assert os.path.getsize(os.path.join(directory, name)) > 0, name


def test_plots_smoke(tmp_path):
    rng = np.random.default_rng(0)
    xy = rng.normal(size=(200, 3)).astype(np.float32)
    plots.plot_toy_joint(xy, tmp_path / "joint.png")
    plots.plot_toy_conditional_grid([rng.normal(size=(50, 2)) for _ in range(3)],
                                    [0.0, 1.0, 2.0], tmp_path / "grid.png")
    plots.plot_latent(rng.normal(size=(200, 2)), tmp_path / "latent.png")
    plots.plot_loss_curves([{"epoch": i, "loss": 1.0 / (i + 1), "z_loss": 0.5} for i in range(5)],
                           tmp_path / "loss.png", keys=("loss", "z_loss"))
    plots.plot_image_grid(rng.uniform(size=(6, 8, 8, 1)), tmp_path / "imgs.png")
    plots.plot_sr_comparison(rng.uniform(size=(6, 8, 8, 1)), rng.uniform(size=(6, 8, 8, 1)),
                             rng.uniform(size=(6, 8, 8, 1)), tmp_path / "sr.png")
    assert_nonempty(tmp_path, ["joint.png", "grid.png", "latent.png", "loss.png", "imgs.png",
                               "sr.png"])


def test_new_plot_families_smoke(tmp_path):
    rng = np.random.default_rng(1)
    n = 120
    y = rng.integers(0, 2, n).astype(np.float32)
    plots.plot_y_identity(y, y + rng.normal(0, 1e-3, n), y, y, tmp_path / "yid.png")
    data = np.concatenate([rng.normal(size=(n, 2)), y[:, None]], axis=1)
    plots.plot_forward_backward_grid(data, rng.normal(size=(n, 3)), data, tmp_path / "fb.png")
    rows = [{"epoch": e, "loss": 1.0 / (e + 1), "z_loss": 1.0, "y_loss": 0.1,
             "detJ_loss": -0.5, "alpha": min(e / 3.0, 1.0)} for e in range(8)]
    plots.plot_annealing_history(rows, tmp_path / "ann.png")
    assert_nonempty(tmp_path, ["yid.png", "fb.png", "ann.png"])


def test_default_interpolation_conditions_are_jaxs():
    for args in (([0.0, 1.0], 0.5, 0.5), ([0.0, 1.0, 4.0], 1.7, 1.6)):
        assert plots.default_interpolation_conditions(*args) == \
            jplots.default_interpolation_conditions(*args)
    np.testing.assert_allclose(plots.default_interpolation_conditions([0.0, 1.0], 0.5, 0.5),
                               np.arange(-2, 2.01, 0.5), atol=1e-6)


@pytest.mark.parametrize("model_type", sorted(CONV_FILES))
def test_cnf_conv_plot_writes_jaxs_files(tmp_path, model_type):
    out = str(tmp_path / "run")
    argv = drv.CLASS if model_type == "class" else [
        "--cpu", "--model-type", model_type, "--dataset", "synthetic", "--synthetic-per-class",
        "2", "--batch-size", "8", "--eval-samples", "4", *drv.ARCH]
    conv.main(argv + ["--epochs", "1", "--annealing-epochs", "0", "--checkpoint-every", "0",
                      "--plot", "--outdir", out])
    assert pngs(out) == CONV_FILES[model_type]
    assert_nonempty(out, CONV_FILES[model_type])


def test_cnf_eval_plot_writes_jaxs_files(drv_class_run, tmp_path):
    """JAX's cnf-eval hands its arguments, --plot included, to cnf-conv's
    sampling eval (drivers/evaluate.py:175-180), which plots into the eval's
    output directory."""
    out = str(tmp_path / "eval")
    report = evaluate.main(["--cpu", "--checkpoint-dir",
                            os.path.join(drv_class_run, "checkpoints"), *drv.DATA, "--plot",
                            "--outdir", out])
    assert np.isfinite(report["bits_per_dim"])
    assert os.path.exists(os.path.join(out, "checkpoint_eval.json"))
    assert pngs(out) == CONV_FILES["class"]
    # without --outdir: beside the checkpoint directory
    evaluate.main(["--cpu", "--checkpoint-dir", os.path.join(drv_class_run, "checkpoints"),
                   *drv.DATA, "--plot"])
    assert pngs(drv_class_run) == CONV_FILES["class"]


@pytest.fixture(scope="module")
def drv_class_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("class"))
    conv.main(drv.CLASS + ["--epochs", "1", "--outdir", out])
    return out


@pytest.mark.parametrize("dataset,sweep", [("crescents", ["--sweep", "-1.5", "2.0"]),
                                           ("continuous_sectors", [])])
def test_cnf_toy_plot_writes_jaxs_files(tmp_path, dataset, sweep):
    out = str(tmp_path / dataset)
    toy.main(drv.TOY + ["--dataset", dataset, "--epochs", "1", "--annealing-epochs", "1",
                        "--plot", "--outdir", out, *sweep])
    assert pngs(out) == TOY_FILES
    assert_nonempty(out, TOY_FILES)


def test_cnf_toy_plot_feeds_the_sweep_to_the_conditional_grid(tmp_path, monkeypatch):
    """--sweep's values join the class labels in conditional.png, as in JAX
    (drivers/toy.py:330-350), besides their moments in eval.json."""
    grids = {}
    real = plots.plot_toy_conditional_grid

    def spy(samples, conditions, path):
        grids[os.path.basename(path)] = list(conditions)
        real(samples, conditions, path)

    monkeypatch.setattr(plots, "plot_toy_conditional_grid", spy)
    toy.main(drv.TOY + ["--epochs", "1", "--annealing-epochs", "0", "--plot",
                        "--sweep", "-1.5", "2.0", "--outdir", str(tmp_path)])
    assert len(grids["conditional.png"]) == 4 and grids["conditional.png"][2:] == [-1.5, 2.0]
    assert len(grids["interpolation.png"]) == 9


@pytest.mark.parametrize("flags", [[], ["--combined"]], ids=["classes", "combined"])
def test_cnf_build_records_plot_writes_jaxs_files(tmp_path, flags):
    args = ["--dataset", "synthetic", "--which-classes", "1", "3", "--plot", *flags]
    mine = build_records.main(args + ["--outdir", str(tmp_path / "mine")])
    jbuild.main(args + ["--outdir", str(tmp_path / "theirs")])
    assert pngs(tmp_path / "mine") == pngs(tmp_path / "theirs") == {
        os.path.basename(p) + ".png" for p in mine}
    assert_nonempty(tmp_path / "mine", pngs(tmp_path / "mine"))


@pytest.mark.parametrize("driver", ["conv", "eval", "toy", "build_records"])
def test_plot_without_matplotlib_exits_before_any_work(tmp_path, monkeypatch, driver):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "out"
    main, argv = {
        "conv": (conv.main, drv.CLASS + ["--epochs", "1"]),
        "eval": (evaluate.main, ["--cpu", "--checkpoint-dir", str(tmp_path / "none"), *drv.DATA]),
        "toy": (toy.main, drv.TOY + ["--epochs", "1"]),
        "build_records": (build_records.main, ["--dataset", "synthetic"]),
    }[driver]
    with pytest.raises(SystemExit, match="matplotlib"):
        main(argv + ["--plot", "--outdir", str(out)])
    assert not out.exists()
