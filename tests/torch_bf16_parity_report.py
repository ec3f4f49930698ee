"""How far the port's bf16 flagship is from the JAX model's, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_bf16_parity_report.py

Takes the bench-arch case of ``tests/test_torch_flow.py`` as it is (the JAX
bench's flagship in bf16 on the default lowering, batch 2, its weights and
inputs) and prints one JSON line for each pair of: the port, the JAX model
run op by op (as flax rounds each bf16 op; what the test holds the port to)
and the JAX model jitted (XLA's CPU compiler fuses bf16 ops and drops
roundings between them). Each line holds the largest differences of zy, the
log-det, the inverse and every loss component. Not a test (pytest does not
collect it).
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import numpy as np  # noqa: E402
import test_torch_flow as flow  # noqa: E402
import torch  # noqa: E402

CASE = (True, None, "bench_bf16")


def main():
    _, _, tm = flow.models(*CASE)
    xy = torch.from_numpy(flow.inputs(CASE[2])[0])
    with torch.no_grad():
        zy, ld = tm(xy)
        runs = {"port": dict(zy=zy.numpy(), ld=ld.numpy(), back=tm.inverse(zy).numpy(),
                             loss={k: float(v) for k, v in tm.log_loss(xy).items()})}
    runs["jax_op_by_op"] = flow.jax_results(*CASE, jit=False)
    runs["jax_jit"] = flow.jax_results(*CASE, jit=True)
    for a, b in (("port", "jax_op_by_op"), ("port", "jax_jit"), ("jax_jit", "jax_op_by_op")):
        diff = {k: float(np.abs(runs[a][k] - runs[b][k]).max()) for k in ("zy", "ld", "back")}
        diff.update({k: abs(runs[a]["loss"][k] - v) for k, v in runs[b]["loss"].items()})
        print(json.dumps({"pair": [a, b], "max_abs_diff": diff, "loss": runs[b]["loss"]["loss"],
                          "log_det": runs[b]["ld"].tolist()}))


if __name__ == "__main__":
    main()
