"""Two processes of each of the port's training drivers on the CPU
(``cnf-conv``, ``cnf-pretrain-noise``, ``cnf-toy``), as
``tests/test_driver_multiprocess.py`` runs the JAX package's ``cnf-conv``:
``--cpu --coordinator 127.0.0.1:<free port> --num-processes 2
--process-id i`` over gloo. Both ranks must log identical per-epoch losses,
only rank 0 writes the run's files, and its history has each epoch once."""

import json
import os
import re
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "arl_conditional_normalizing_flows_tpu_torch"
#: seconds both ranks of a run may take
TIMEOUT = 240

SMALL_CONV = ["--squeeze-factor", "0", "1", "--res-blocks", "1", "1", "--kernels", "8", "8",
              "--cardinality", "2", "2"]
RUNS = {
    "conv": ["--dataset", "synthetic", "--synthetic-per-class", "32", "--data-classes", "0", "1",
             "--batch-size", "8", "--epochs", "1", "--annealing-epochs", "1", "--no-dilations",
             "--eval-samples", "4", "--checkpoint-every", "0", "--scan-steps", "2", *SMALL_CONV],
    "pretrain_noise": ["--height", "8", "--width", "8", "--num-batches", "2", "--batch-size", "8",
                       "--epochs", "2", *SMALL_CONV],
    "toy": ["--coupling-blocks", "1", "--intermediate-dims", "8", "--num-layers", "1",
            "--batch-size", "64", "--batches-per-class", "2", "--eval-samples", "64",
            "--epochs", "1", "--annealing-epochs", "1"],
}
#: each driver's files, all written by rank 0
WRITTEN = {
    "conv": {"run.json", "history.csv", "history.jsonl", "eval.json", "weights.npz"},
    "pretrain_noise": {"run.json", "history.csv", "history.jsonl", "conditioned_weights.npz"},
    "toy": {"run.json", "history.csv", "history.jsonl", "eval.json", "weights.npz"},
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(driver, extra_args, outdir):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.drivers.{driver}", "--cpu", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i),
         "--outdir", str(outdir), *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True, cwd=REPO)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f"a rank outlived {TIMEOUT} s; output:\n{out[-3000:]}")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def epoch_losses(out):
    """fit's rows, "epoch N: loss=... seconds=... alpha=... val_loss=...":
    {N: the row's text without its seconds}."""
    return {int(m.group(1)): re.sub(r"seconds=\S+ ", "", m.group(2))
            for m in re.finditer(r"^epoch (\d+): (loss=.*)$", out, re.MULTILINE)}


@pytest.mark.parametrize("driver", sorted(RUNS))
def test_two_processes_log_identical_losses_and_rank_0_writes(tmp_path, driver):
    outdir = tmp_path / "out"
    outs = run_ranks(driver, RUNS[driver], outdir)
    l0, l1 = epoch_losses(outs[0]), epoch_losses(outs[1])
    assert len(l0) >= 2 and l0 == l1, (l0, l1, outs[0][-1500:])
    assert "process 0 of 2" in outs[0] and "process 1 of 2" in outs[1]
    assert set(os.listdir(outdir)) == WRITTEN[driver]
    with open(outdir / "run.json") as f:
        assert json.load(f)["processes"] == 2
    lines = (outdir / "history.jsonl").read_text().splitlines()
    eps = [json.loads(line)["epoch"] for line in lines]
    assert eps == sorted(set(eps)) and len(eps) == len(l0)
