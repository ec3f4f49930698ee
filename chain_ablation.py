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
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
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
