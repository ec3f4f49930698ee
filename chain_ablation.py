"""Where the bf16 conv-chain kernel (K3) spends its time, on one CUDA card.

    python3 chain_ablation.py

Builds the kernel of ``csrc/fused_subnet.cu`` as it is and in altered
copies, each with one part of the work cut out (so their outputs are wrong
on purpose), and times every build at each conv-chain spec of the flagship
that ``chip_smoke.py`` drives, batch 128, on its weights. A part's cost is
the time the full kernel loses over the copy without it. The parts: the
branch convs, the head conv, the post 1x1 and the copies of the weights
into shared memory; and, as a check of the L2's hold on the float32 trunk,
a copy in which every sample shares one trunk. Each edit is a line of the
kernel's text and raises if the text has changed. Times are
``chip_smoke.device_time_ms``. Needs a card; exits 1 without one.

    python3 chain_ablation.py --against OTHER_TREE

K3 in this checkout against K3 in ``OTHER_TREE``, another checkout of the
repository (for example a commit unpacked with ``git archive`` into a
directory git ignores), in turns: other, this, this, other. Each turn is a
fresh process whose working directory and import path are its tree, so
that it builds and launches that tree's own K3 (its source, its packing,
the variant its ``wide`` picks) through ``subnet_apply``, and times it
with that tree's ``chip_smoke.device_time_ms`` at :data:`AB_SPECS`, batch
128, on the same seeded weights and inputs, held against the tree's plain
chain. Prints one line a turn and spec, then each tree's times side by
side and as JSON.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import fused_subnet as chain

#: each altered copy: (text of the bf16 kernel, what replaces it)
VARIANTS = {
    "full": [],
    "no branch convs": [("for (int c = 0; c < L.tile[t0].chunks; ++c) {",
                         "for (int c = 0; c < 0; ++c) {")],
    "no head conv": [("L.ch_head, wsm, L.NO, acc);", "0, wsm, L.NO, acc);")],
    "no post 1x1": [("post_chunk(u, a, wb + L.w_post, gt / 2, NT);", "u[0][0] += a[0];")],
    "no weight copies": [("stage_weights(wts", "if (false) stage_weights(wts")],
    "one trunk for all samples": [("float4* y = trunk + n * (L.trunk_per_sample / 4);",
                                   "float4* y = trunk;")],
}


def build_variant(name: str) -> ctypes.CDLL:
    """The kernel source with the variant's edits, built into ``_build/``."""
    src = (build.CSRC_DIR / "fused_subnet.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in csrc/fused_subnet.cu")
        src = src.replace(old, new)
    stem = "ablation_" + "".join(c if c.isalnum() else "_" for c in name)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, lib = build.BUILD_DIR / f"{stem}.cu", build.BUILD_DIR / f"lib{stem}.so"
    cu.write_text(src)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                   capture_output=True, text=True, timeout=build.BUILD_TIMEOUT_S, check=True)
    return chain.bind_library(ctypes.CDLL(str(lib)))


#: --against: (h, w, cin, K, dilations, out_total) of the capacity preset's
#: wide specs and the flagship's largest (res_blocks 3, cardinality 8,
#: ksize 3 each)
AB_SPECS = {"preset_28x28x1_k128": (28, 28, 1, 128, (1, 2, 4), 2),
            "preset_14x14x2_k128": (14, 14, 2, 128, (1, 2), 4),
            "flagship_28x28x1_k64": (28, 28, 1, 64, (1, 2, 4), 2)}

#: --against: one turn, run in a tree with AB_SPECS as its argument
AB_TURN = """
import json, math, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import fused_subnet as fs
out = {}
for name, (h, w, cin, k, dil, o) in json.loads(sys.argv[1]).items():
    spec = fs.SubnetSpec(h, w, cin, k, 3, 8, 3, tuple(dil), o, compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    flat = [torch.from_numpy((rng.normal(size=shape) * (0.1 if len(shape) == 1 else
                              1 / math.sqrt(math.prod(shape[:-1])))).astype(np.float32)).cuda()
            for _, shape in fs.flax_param_order(spec)]
    x = torch.from_numpy(rng.normal(size=(128, h, w, cin)).astype(np.float32)).cuda()
    with torch.no_grad():
        packed = fs.pack(spec, flat)
        err = (fs.subnet_apply(spec, x, packed) - fs.chain_math(spec, x, flat)).abs().max().item()
        ms = chip_smoke.device_time_ms(lambda: fs.subnet_apply(spec, x, packed), iters=20, reps=7)
    out[name] = dict(us=ms * 1e3, max_abs_err=err, wide=fs.wide(spec))
print(json.dumps(out))
"""


def ab_turn(tree: Path) -> dict:
    """One turn of --against in ``tree``: its K3's times at AB_SPECS."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    done = subprocess.run([sys.executable, "-c", AB_TURN, json.dumps(AB_SPECS)], cwd=tree,
                          env=env, capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise RuntimeError(f"turn in {tree} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def against(other: Path) -> int:
    """K3 here against K3 in ``other``, in turns (other, this, this, other)."""
    trees = {"this": Path(__file__).resolve().parent, "other": other.resolve()}
    times = {name: {tree: [] for tree in trees} for name in AB_SPECS}
    for i, which in enumerate(("other", "this", "this", "other")):
        for name, row in ab_turn(trees[which]).items():
            times[name][which].append(row["us"])
            print(f"[ab] turn {i} {which}: {name} {row['us']:.1f} us (max_abs_err "
                  f"{row['max_abs_err']:.3g}, wide {row['wide']})", flush=True)
    for name, by_tree in times.items():
        print(f"[ab] {name}: other {by_tree['other']} us, this {by_tree['this']} us", flush=True)
    print(json.dumps({"ab": times}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    if sys.argv[1:2] == ["--against"]:
        if len(sys.argv) != 3 or not (Path(sys.argv[2]) / "chip_smoke.py").is_file():
            print(__doc__, file=sys.stderr)
            return 2
        return against(Path(sys.argv[2]))
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    batch = chip_smoke.BATCH
    specs = chip_smoke.chain_specs(ConvCFlow(chip_smoke.FLAGSHIP_SUBNET, seed=0))
    for i, spec in enumerate(specs):
        net, _ = chip_smoke.chain_nets(spec, seed=10 + i)
        g = torch.Generator(device="cuda").manual_seed(10 + i)
        x = torch.randn(batch, spec.h, spec.w, spec.cin, generator=g, device="cuda")
        packed = net.packed()
        trunk = torch.empty(chain.trunk_elements(spec, batch), device="cuda")
        out = torch.empty(batch, spec.h, spec.w, spec.out_total, device="cuda")
        times = {name: 1e3 * chip_smoke.device_time_ms(
            lambda lib=lib: chain.launch_library(lib, spec, x, packed, trunk, out), iters=20)
            for name, lib in libs.items()}
        full = times["full"]
        parts = ", ".join(f"{name} {t:.1f} us ({full - t:+.1f})"
                          for name, t in times.items() if name != "full")
        print(f"[ablation] {batch}x{spec.h}x{spec.w}x{spec.cin} bf16: full {full:.1f} us; "
              f"{parts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
