"""What runs on the card loads no JAX: importing the harness and the
program's entries that it drives, in a fresh process, loads no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or the JAX package's
(compared whole: the program's own name begins with the JAX package's).
And a run on a machine without a card exits non-zero, with no result line,
instead of running on the CPU."""

import json
import subprocess
import sys

from cnfbench.tests.conftest import ROOT

MODULES = [
    "cnfbench.run", "cnfbench.cells", "cnfbench.checks", "cnfbench.counts", "cnfbench.trace",
    "cnfbench.program", "cnfbench.weights", "cnfbench.train_cell", "cnfbench.serve_cell",
    "cnfbench.faults", "cnfbench.calibrate", "cnfbench.reference.flow",
    "arl_conditional_normalizing_flows_tpu_torch.models.conv",
    "arl_conditional_normalizing_flows_tpu_torch.train.loop",
    "arl_conditional_normalizing_flows_tpu_torch.serve.export",
    "arl_conditional_normalizing_flows_tpu_torch.parallel.launch",
]

CHECK = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
from cnfbench import cells, run
for m in cells.benchmark()["per_layer"]:
    cells.reader(m["name"])
print(json.dumps(run.forbidden_modules()))
"""


def test_the_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CHECK, *MODULES], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_check_compares_whole_top_level_names():
    from cnfbench import run

    before = set(sys.modules)
    try:
        sys.modules.setdefault("arl_conditional_normalizing_flows_tpu.models", object())
        assert "arl_conditional_normalizing_flows_tpu.models" in run.forbidden_modules()
        assert not any(m.startswith("arl_conditional_normalizing_flows_tpu_torch")
                       for m in run.forbidden_modules())
    finally:
        for name in set(sys.modules) - before:
            del sys.modules[name]


def test_a_run_without_a_card_exits_without_a_result():
    out = subprocess.run([sys.executable, "-m", "cnfbench.run", "--workload",
                          "flagship-bf16.train", "--seed", str(2**33 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
