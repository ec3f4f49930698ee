"""The port stands alone: importing all of it, ``chip_smoke`` and
``chain_ablation`` loads no jax, flax or JAX-package module (nor, for the
record path and the reference importer, h5py); and an entry point with no
``device`` does not quietly run on the CPU when there is no card."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import arl_conditional_normalizing_flows_tpu_torch as port  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig  # noqa: E402
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

CHECK = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "arl_conditional_normalizing_flows_tpu"))
assert not bad, bad
print("ok", len(sys.argv) - 1)
"""


def port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_no_jax():
    names = port_modules() + ["chip_smoke", "chain_ablation"]
    assert len(names) > 15
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", CHECK, *names], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"ok {len(names)}"


def test_the_isolation_check_imports_the_drivers_serving_and_checkpoints():
    """The fresh process of the check above imports every port module,
    among them cnf-conv, cnf-eval, serving, checkpoints and evaluation."""
    names = set(port_modules())
    for name in ("drivers.conv", "drivers.evaluate", "serve.export", "train.checkpoints",
                 "evaluation.stats", "ops.resample", "utils.run_metadata"):
        assert f"{port.__name__}.{name}" in names, name


def test_the_isolation_check_imports_the_toy_path_and_both_new_drivers():
    """... and the toy model, its datasets, cnf-toy and cnf-pretrain-noise,
    each of which also loads alone in a fresh process with no jax, flax or
    JAX-package module."""
    names = [f"{port.__name__}.{name}" for name in (
        "drivers.pretrain_noise", "drivers.toy", "models.toy", "data.toy_datasets")]
    assert set(names) <= set(port_modules())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for name in names:
        out = subprocess.run([sys.executable, "-c", CHECK, name], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, (name, out.stderr)


RECORD_PATH = ("data.records", "data.tfrecord_compat", "data.native_loader",
               "drivers.build_records", "convert.reference_import", "drivers.import_reference")

NO_H5PY = CHECK + """
assert "h5py" not in sys.modules, "h5py imported at module import"
"""


@pytest.mark.parametrize("name", RECORD_PATH)
def test_the_record_path_and_the_importer_import_alone_without_jax(name):
    """Each module of the record path and the reference importer is in the
    isolation check above and loads alone in a fresh process with no jax,
    flax, JAX-package or h5py module (h5py is imported only to read a conv
    checkpoint)."""
    name = f"{port.__name__}.{name}"
    assert name in set(port_modules())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", NO_H5PY, name], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (name, out.stderr)


def test_toy_model_without_device_raises_without_a_card(monkeypatch):
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import ToyConfig
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ToyCINN(ToyConfig())
    assert ToyCINN(ToyConfig(), device="cpu").device.type == "cpu"


def test_entry_point_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ConvFlowConfig(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1),
                         res_blocks=(1, 1), num_kernels=(16, 16), cardinality=(2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConvCFlow(cfg)
    assert ConvCFlow(cfg, device="cpu").device.type == "cpu"


def test_training_entry_points_without_device_raise_without_a_card(monkeypatch):
    """Training takes its device from the model, and a model lands on the
    CPU only when asked to: with no card, ``create_train_state`` and
    ``make_scan_train_step`` of a model built without a device raise; a
    model built for the CPU gets the CPU's plain loop and a non-capturable
    Adam, and the CUDA-graph path refuses CPU tensors rather than running
    eager steps."""
    from arl_conditional_normalizing_flows_tpu_torch.train import loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ConvFlowConfig(io_shape=(8, 8, 2), x_d=1, squeeze_factor_blocks=(0, 1),
                         res_blocks=(1, 1), num_kernels=(16, 16), cardinality=(2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.create_train_state(ConvCFlow(cfg), 3e-4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.make_scan_train_step(ConvCFlow(cfg), 4)

    model = ConvCFlow(cfg, device="cpu")
    state = loop.create_train_state(model, 3e-4)
    assert not state.optimizer.param_groups[0]["capturable"]
    assert not isinstance(loop.make_scan_train_step(model, 4), loop._GraphedSteps)
    graphed = loop._GraphedSteps(model, 4, None)
    with pytest.raises(ValueError, match="on the card"):
        graphed(state, torch.zeros((4, 2, 8, 8, 2)))
    assert state.step == 0
