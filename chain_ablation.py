"""Where the conv-chain kernel (K3) spends its time, on one CUDA card.

    python3 chain_ablation.py [--dtype float32]

Builds the kernel of ``csrc/fused_subnet.cu`` as it is and in altered
copies, each with one part of the kernel's work cut out (so their
outputs are wrong on purpose), and times every build at each conv-chain
spec of the flagship that ``chip_smoke.py`` drives (the narrow kernel),
at batch 128 and at the serving call's 2,048 (:data:`BATCHES`), on its
weights, in bf16 (the default) or float32 (the tf32 products); in
float32 also at the capacity preset's two K 128 specs, which take the
wide variant's tf32 build, with the copies that alter it
(:data:`WIDE_PARTS`). A part's cost is the time the full kernel loses
over the copy without it. The parts (:data:`VARIANTS`),
of the skeleton both products share: the branch convs, the head conv, the
post 1x1, the entry conv, the pre 1x1, and a copy in which every sample
shares one scratch (trunk and stage-input copy), which on a scratch plan
also makes the samples contend for the same L2 lines; of the bf16 scratch
plan: the overlap of the weights' bulk copies (TMA) with the stage before
them; of both scratch plans: the split of the last round's tiles across
warps (every tile whole instead); of the tf32 products: the two ``lo`` products (one TF32 product a
chunk, which prices the split; in the wide build the trunk-wide stages'
two ``lo`` wgmma too), and B loaded as a ``hi`` and a ``lo`` plane
(16 bytes a lane and no split in registers, which prices the other packing;
its values are wrong); of the wide tf32 build alone: its B lo planes (each
warpgroup's split of a trunk-wide piece in shared memory and its
warpgroup barrier cut, so that wgmma reads a stale plane: the price of
the route that B takes there), its stage input's loads from scratch
(the 28 x 28 route: two 8-byte loads a lane a chunk, from L1 or L2; cut,
A is a constant: the most that holding it in shared memory could save),
and each of its stages' products and loads (entry, pre 1x1, branch convs,
post 1x1, head: the warps still walk the ring). Each
edit is a piece of the kernel's text and raises if that text has changed.
Times are ``chip_smoke.device_time_ms``. Needs a card; exits 1 without
one.

    python3 chain_ablation.py --against OTHER_TREE [--dtype float32]

K3 in this checkout against K3 in ``OTHER_TREE``, another checkout of the
repository (for example a commit unpacked with ``git archive`` into a
directory git ignores), in turns: other, this, this, other. Each turn is a
fresh process whose working directory and import path are its tree, so
that it builds and launches that tree's own K3 (its source, its packing,
the variant its ``wide`` picks) through ``subnet_apply``, and times it
with that tree's ``chip_smoke.device_time_ms`` at :data:`AB_SPECS`, at
each of :data:`BATCHES`, on the same seeded weights and inputs, held
against the tree's plain chain; in either dtype every spec of
:data:`AB_SPECS`, the preset's two of K 128 on the wide variant (in
float32 its tf32 build, in a tree before it the CUDA-core kernel). Prints
one line a turn, spec and batch, then each tree's times side by side and as
JSON.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
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

#: each altered copy: (text of the narrow kernels, what replaces it)
VARIANTS = {
    "full": [],
    "no branch convs": [("    const int chunks = L.tile[t0].chunks;\n",
                         "    const int chunks = 0;\n"),
                        ("  const int chunks = L.tile[gt].chunks;\n  const uint32_t lo",
                         "  const int chunks = 0;\n  const uint32_t lo")],
    "no head conv": [("  float odd[kP][kMaxHeadTiles][4] = {};\n",
                      "  float odd[kP][kMaxHeadTiles][4] = {};\n  chunks = 0;\n"),
                     ("ring_head(d, ring, slot0, mine, taps_at<Tf32>(d, mt, act_s, zero, L.ts",
                      "ring_head(d, ring, slot0, false, taps_at<Tf32>(d, mt, act_s, zero, L.ts")],
    "no post 1x1": [("for (int i = 0; i < kP; ++i) Prod::product(u[i][j], a[i], b);",
                     "for (int i = 0; i < kP; ++i) u[i][j][0] += "
                     "__uint_as_float(reinterpret_cast<const uint32_t&>(a[i]));"),
                    ("              Tf32::product(v[0][j], a, Tf32::load_b(w, (gt % 2) * NT + j));",
                     "              v[0][j][0] += __uint_as_float(a.hi[0]);"),
                    ("              Tf32::product(v[0][j], pend, Tf32::load_b(w, j));",
                     "              v[0][j][0] += __uint_as_float(pend.hi[0]);")],
    "no entry conv": [("float (&acc)[kP][kT][4]) {\n  for (int c = 0; c < chunks; ++c) {",
                       "float (&acc)[kP][kT][4]) {\n  chunks = 0;\n"
                       "  for (int c = 0; c < chunks; ++c) {"),
                      ("ring_conv(d, ring, slot0, mine, taps_at<Tf32>(d, mt, act_s, zero, L.xs",
                       "ring_conv(d, ring, slot0, false, taps_at<Tf32>(d, mt, act_s, zero, L.xs")],
    "no pre 1x1": [("      if (2 * c >= NT) break;\n#pragma unroll\n      for (int j",
                    "      if (2 * c >= 0) break;\n#pragma unroll\n      for (int j"),
                   ("      if (c >= NT) break;\n      typename Prod::A a[kP];",
                    "      if (c >= 0) break;\n      typename Prod::A a[kP];"),
                   ("    if (mine) {\n      const float* w = ring_slot(ring, slot0);\n"
                    "      const Tf32::A a =",
                    "    if (false) {\n      const float* w = ring_slot(ring, slot0);\n"
                    "      const Tf32::A a =")],
    "no weight prefetch": [
        ("auto wait_stage = [&](int s) { barrier_wait(",
         "auto wait_stage = [&](int s) { if (s >= 2 && threadIdx.x == 0) fetch(s);\n"
         "    barrier_wait("),
        ("  if (threadIdx.x == 0 && 2 <= R + 1) fetch(2);\n", ""),
        ("      if (s + 2 <= R + 1) fetch(s + 2);\n", ""),
        ("  // a row of zeros after x's rows: what a padding pixel reads, in any stage\n",
         "  __syncthreads();\n  barrier_wait(bar, 0);\n")],
    "one scratch for all samples": [("float4* y = trunk + n * (narrow_scratch<Bf16>(d, L) / 4);",
                                     "float4* y = trunk;"),
                                    ("float4* y = trunk + n * (narrow_scratch<Tf32>(d, L) / 4);",
                                     "float4* y = trunk;")],
    "no split tiles": [("const int split = split_tiles(L), n_shares",
                        "const int split = 0, n_shares"),
                       ("const int split = split_tiles(L), whole",
                        "const int split = 0, whole")],
    "no lo products": [("    mma_tf32(c, a.lo, b.hi);\n    mma_tf32(c, a.hi, b.lo);\n", ""),
                       ("    mma_tf32(x, a.lo, b.hi);\n    mma_tf32(x, a.hi, b.lo);\n", ""),
                       ("  wgmma_tf32_n(nt, d, a.lo, b);\n  wgmma_tf32_n(nt, d, a.hi, lo);\n", "")],
    "B in hi and lo planes": [
        ("    const float2 v = reinterpret_cast<const float2*>(w + frag * kFrag)"
         "[threadIdx.x & 31];\n    B b;\n    split(v.x, b.hi[0], b.lo[0]);\n    split(v.y, b.hi[1], b.lo[1]);\n"
         "    return b;",
         "    const uint4 v = reinterpret_cast<const uint4*>(w + (frag & ~1) * kFrag)"
         "[threadIdx.x & 31];\n    return B{{v.x, v.y}, {v.z, v.w}};")],
    "no B lo planes": [("    const float4* b = reinterpret_cast<const float4*>(smem + (slot - smem_s));\n",
                        "    return plane;\n"
                        "    const float4* b = reinterpret_cast<const float4*>(smem + (slot - smem_s));\n")],
    "no scratch A loads": [(": *reinterpret_cast<const float2*>(act + off[i] + lo8);",
                            ": make_float2(0.5f, 0.5f);")],
    "no wide entry conv": [("L.qx, L.ch_entry, NT, j0, nt, active, ring, plane,",
                            "L.qx, L.ch_entry, NT, j0, nt, false, ring, plane,")],
    "no wide pre 1x1": [
        ("              if (active) lo = plane.split(ring.slot(), min(per, L.ch_pre - cc) * nt * "
         "kFragBytes);\n            }\n            if (active) {",
         "              if (false) lo = plane.split(ring.slot(), min(per, L.ch_pre - cc) * nt * "
         "kFragBytes);\n            }\n            if (false) {"),
        ("              if (active) wgmma_wait_all(acc);\n              ring.release();",
         "              if (false) wgmma_wait_all(acc);\n              ring.release();")],
    "no wide branch convs": [
        ("            if (active) A.start(d, in, mt, L.ts, q, d.dil[br]);\n"
         "            for (int c0 = 0; c0 < chunks; c0 += per) {\n              ring.wait();\n"
         "              if (active) {",
         "            if (false) A.start(d, in, mt, L.ts, q, d.dil[br]);\n"
         "            for (int c0 = 0; c0 < chunks; c0 += per) {\n              ring.wait();\n"
         "              if (false) {")],
    "no wide post 1x1": [("  ring.wait();\n  if (active) {\n    const uint32_t plane = lo.split(ring.slot(), "
                          "n * nt * kFragBytes);",
                          "  ring.wait();\n  if (false) {\n    const uint32_t plane = lo.split(ring.slot(), "
                          "n * nt * kFragBytes);")],
    "no wide head conv": [("L.ch_head, L.NO, j0, nt, active, ring, plane,",
                           "L.ch_head, L.NO, j0, nt, false, ring, plane,")],
}
#: the variants that alter one dtype's build alone
#: the variants timed at the preset's wide specs (float32): those that alter
#: the wide tf32 build; all but the first two alter it alone
WIDE_PARTS = ("full", "no lo products", "no B lo planes", "no scratch A loads",
              "no wide entry conv", "no wide pre 1x1", "no wide branch convs", "no wide post 1x1",
              "no wide head conv")
ONLY = {"no weight prefetch": "bfloat16", "no lo products": "float32",
        "B in hi and lo planes": "float32", **{n: "float32" for n in WIDE_PARTS[2:]}}


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


#: the batches of the ablation: the main path's and the serving call's
BATCHES = (chip_smoke.BATCH, chip_smoke.SERVE_BATCH)

#: --against: (h, w, cin, K, cardinality, dilations, out_total) of the
#: capacity preset's wide specs and the flagship's four (res_blocks 3 and
#: ksize 3 each)
AB_SPECS = {"preset_28x28x1_k128": (28, 28, 1, 128, 8, (1, 2, 4), 2),
            "preset_14x14x2_k128": (14, 14, 2, 128, 8, (1, 2), 4),
            "flagship_28x28x1_k64": (28, 28, 1, 64, 8, (1, 2, 4), 2),
            "flagship_14x14x4_k32": (14, 14, 4, 32, 8, (1, 2, 4), 8),
            "flagship_7x7x8_k16": (7, 7, 8, 16, 4, (1, 2), 16),
            "flagship_14x14x2_k32": (14, 14, 2, 32, 4, (1, 2), 4)}

#: --against: one turn, run in a tree with AB_SPECS as its argument
AB_TURN = """
import json, math, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import fused_subnet as fs
out = {}
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
for batch in json.loads(sys.argv[2]):
    for name, (h, w, cin, k, card, dil, o) in json.loads(sys.argv[1]).items():
        spec = fs.SubnetSpec(h, w, cin, k, 3, card, 3, tuple(dil), o, compute_dtype=sys.argv[3])
        rng = np.random.default_rng(0)
        flat = [torch.from_numpy((rng.normal(size=shape) * (0.1 if len(shape) == 1 else
                                  1 / math.sqrt(math.prod(shape[:-1])))).astype(np.float32)).cuda()
                for _, shape in fs.flax_param_order(spec)]
        x = torch.from_numpy(rng.normal(size=(batch, h, w, cin)).astype(np.float32)).cuda()
        with torch.no_grad():
            packed = fs.pack(spec, flat)
            err = (fs.subnet_apply(spec, x, packed)
                   - fs.chain_math(spec, x, flat)).abs().max().item()
            ms = chip_smoke.device_time_ms(lambda: fs.subnet_apply(spec, x, packed), iters=20,
                                           reps=7)
        out[f"{name} x{batch}"] = dict(us=ms * 1e3, max_abs_err=err, wide=fs.wide(spec))
print(json.dumps(out))
"""


def ab_turn(tree: Path, dtype: str) -> dict:
    """One turn of --against in ``tree``: its K3's times at AB_SPECS and
    BATCHES."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    done = subprocess.run([sys.executable, "-c", AB_TURN, json.dumps(AB_SPECS),
                           json.dumps(BATCHES), dtype], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=600)
    if done.returncode:
        raise RuntimeError(f"turn in {tree} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def against(other: Path, dtype: str) -> int:
    """K3 here against K3 in ``other``, in turns (other, this, this, other)."""
    trees = {"this": Path(__file__).resolve().parent, "other": other.resolve()}
    times = {}
    for i, which in enumerate(("other", "this", "this", "other")):
        for name, row in ab_turn(trees[which], dtype).items():
            times.setdefault(name, {tree: [] for tree in trees})[which].append(row["us"])
            print(f"[ab] turn {i} {which}: {name} {row['us']:.1f} us (max_abs_err "
                  f"{row['max_abs_err']:.3g}, wide {row['wide']})", flush=True)
    for name, by_tree in times.items():
        print(f"[ab] {name}: other {by_tree['other']} us, this {by_tree['this']} us", flush=True)
    print(json.dumps({"ab": times, "dtype": dtype}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    args, dtype = sys.argv[1:], "bfloat16"
    if args[-2:-1] == ["--dtype"]:
        args, dtype = args[:-2], args[-1]
    if dtype not in ("bfloat16", "float32") or args[:1] not in ([], ["--against"]):
        print(__doc__, file=sys.stderr)
        return 2
    if args[:1] == ["--against"]:
        if len(args) != 2 or not (Path(args[1]) / "chip_smoke.py").is_file():
            print(__doc__, file=sys.stderr)
            return 2
        return against(Path(args[1]), dtype)
    # the plain version's float32 convs in full float32 (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    names = [n for n in VARIANTS if ONLY.get(n, dtype) == dtype]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = dict(zip(names, pool.map(build_variant, names)))
    specs = list(chip_smoke.chain_specs(ConvCFlow(chip_smoke.FLAGSHIP_SUBNET, seed=0)))
    if dtype == "float32":
        specs += [s for s in chip_smoke.chain_specs(ConvCFlow(chip_smoke.PRESET, seed=0))
                  if chain.wide(dataclasses.replace(s, compute_dtype=dtype))]
    for batch, (i, spec) in itertools.product(BATCHES, enumerate(specs)):
        spec = dataclasses.replace(spec, compute_dtype=dtype)
        # a wide spec: the copies that alter the wide build; else all but
        # those that alter the wide build alone
        wide_spec = chain.wide(spec)
        parts = [n for n in libs if (n in WIDE_PARTS if wide_spec else n not in WIDE_PARTS[2:])]
        net, _ = chip_smoke.chain_nets(spec, seed=10 + i)
        g = torch.Generator(device="cuda").manual_seed(10 + i)
        x = torch.randn(batch, spec.h, spec.w, spec.cin, generator=g, device="cuda")
        packed = net.packed()
        trunk = torch.empty(chain.trunk_elements(spec, batch), device="cuda")
        out = torch.empty(batch, spec.h, spec.w, spec.out_total, device="cuda")
        times = {name: 1e3 * chip_smoke.device_time_ms(
            lambda lib=libs[name]: chain.launch_library(lib, spec, x, packed, trunk, out),
            iters=20)
            for name in parts}
        full = times["full"]
        cuts = ", ".join(f"{name} {t:.1f} us ({full - t:+.1f})"
                         for name, t in times.items() if name != "full")
        print(f"[ablation] {batch}x{spec.h}x{spec.w}x{spec.cin} K={spec.kernels} {dtype} "
              f"({chain.kernel_build(spec)}): full {full:.1f} us; {cuts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
