"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``csrc/`` with nvcc (one process per
source, all at once) and holds each kernel against its plain PyTorch version
at the shapes of the main path: the coupling law (K1/K2) and the coupling
subnet's conv chain (K3, first at a small size, synchronised, then at the
flagship's four specs). Then it drives two serving paths of the flagship
conv cINN at full width (batch 128, random weights from a seed), the
``pallas_coupling`` lowering (K1/K2) and the ``pallas_subnet`` lowering (K3):
conditional-sampling requests through ``make_image_serving_fn`` and a
``log_loss`` density evaluation each, with the kernels' launch counts set to
0 just before and read just after. It checks that every output is finite,
that ``forward(inverse(zy))`` gives zy back and that the same weights at
float32 agree with the CPU. Then it trains through both kernel lowerings
(``[grad]``): every parameter's gradient of ``log_loss`` at full width,
against the default lowering on the card and against the CPU, with the
kernels' forward launches counted. ``[floor]`` is the device time of one
launch of a one-element PyTorch op, the yardstick beside K1/K2's times.
``[train]`` takes optimizer steps: the JAX bench's cell (the flagship on the
default lowering, batch 128, Adam 3e-4, no noise) through
``make_scan_train_step``'s CUDA graph of 16 steps against 16 eager steps
from the same state, with wall times, samples/s, device busy time and
launches a step; graphs of 4 steps under ``pallas_coupling`` and
``pallas_subnet``, whose replays must launch K1 or K3 16 times a step;
``fit`` on ``ClassConditionalSource(synthetic_digits)`` (the ``cnf-conv``
class workload: 1 annealing and 2 clean epochs of scanned stacks); and the
structure of the flagship's shared-shape init. ``[serve]`` serves the JAX
bench's serving cell (16 draws of 128 class conditions a call, the latent
drawn on the card from one seed, de-logit and uint8) through
``export_seeded_multidraw_sampler`` under the default, ``pallas_coupling``
and ``pallas_subnet`` lowerings: the call captured as one CUDA graph and
replayed, bit-equal to the eager entry and to the saved and reloaded
artifact, with K2 or K3 launching 16 times a replayed call (counted at the
capture, the profiler's count beside it),
the card memory that graphs of smaller batches reserve besides the 2,048
one (they share its memory pool), a ``PipelinedSampler`` of 8 draws and 16
graphs equal to sequential calls,
and the eager single-draw request beside it; K3 is also held and timed at
the serving batch of 2,048. ``[cli]`` runs the port's ``cnf-conv`` (class
at the flagship arch through graphed stacks of 16 steps, resumed from its
checkpoints; SR4,2 and SR2,1 at one residual block a level) and
``cnf-eval`` with ``--export-multidraw``, whose artifact is loaded and
called. ``[pretrain]`` runs ``cnf-pretrain-noise`` at its defaults (the
flagship arch, batch 512, 20 batches an epoch) through graphed stacks of 4
steps under ``pallas_subnet`` and ``pallas_coupling`` (bf16, fused heads;
K3 or K1 must launch 16 times a step, counted at the capture; both kernels
are also held and timed at batch 512 in the ``[kernel]`` lines) and under
the user's defaults (float32, default lowering), with each run's step
time, busy share and peak memory; then ``cnf-conv`` from the K3 run's
weights, and those weights refused under another arch. ``[toy]`` runs
``cnf-toy`` at the reference defaults (24 layers, width 32, batch 1000) on
crescents eagerly and graphed, the mixed shapes, the continuous sectors and
a ``--load`` that restores the layer order; holds the trained model in
float32 against the CPU, checks ``forward(inverse(zy))`` and a seeded
multidraw toy artifact (graphed == eager == reloaded, bit for bit), and
times eager and graphed steps. ``[records]`` drives the record path:
``cnf-build-records`` per class and ``--combined`` with the reference's
TFRecords beside them (one read back through ``convert_to_cnfrec``,
bit-equal to its ``.cnfrec``); an MNIST-scale class set (4 classes × 6,000
synthetic digits); the streaming sources against the in-RAM ones from one
CUDA generator state (class bit-equal, SR within 1e-6); ``cnf-conv
--records-dir`` at the flagship arch, ``pallas_coupling``, bf16, batch 128,
graphed stacks of 16, streamed through the native loader and in RAM, with
equal losses, each run's samples/s and busy share of a stack fetched and
replayed, K1's launches a step (counted at the capture) and K2's in the
end-of-training sampling; SR4,2 streamed from the combined file; ``cnf-eval
--records-dir``; ``cnf-import-reference toy`` of a reference-layout
checkpoint, then ``cnf-toy --load`` of it. Each phase prints its elapsed
seconds.

Any failed check raises and the script exits non-zero; without a CUDA card
it exits 1 and prints no result. On success the line before the last is a
JSON object with one entry per kernel, and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from arl_conditional_normalizing_flows_tpu_torch.data.images import (
    ClassConditionalSource,
    synthetic_digits,
)
from arl_conditional_normalizing_flows_tpu_torch.models.arch import (
    ConvFlowConfig,
    arch_string,
)
from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow
from arl_conditional_normalizing_flows_tpu_torch.models.init_compat import check_shared_draw
from arl_conditional_normalizing_flows_tpu_torch.models.subnets import (
    ConvCouplingNet,
    FusedChainCouplingNet,
)
from arl_conditional_normalizing_flows_tpu_torch.ops import logit
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (
    affine_coupling as kernels,
)
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import build
from arl_conditional_normalizing_flows_tpu_torch.ops.kernels import (
    fused_subnet as chain,
)
from arl_conditional_normalizing_flows_tpu_torch.serve.export import (
    PipelinedSampler,
    export_seeded_multidraw_sampler,
    load_artifact,
    make_image_serving_fn,
    make_seeded_multidraw_fn,
    make_toy_serving_fn,
    save_artifact,
)
from arl_conditional_normalizing_flows_tpu_torch.train import (
    create_train_state,
    epoch_stacks,
    fit,
    make_scan_train_step,
    make_step_fns,
)

#: the flagship of the JAX bench (bench.py), on the coupling-kernel lowering
FLAGSHIP = ConvFlowConfig(
    io_shape=(28, 28, 2), x_d=1, squeeze_factor_blocks=(0, 1, 0, 0),
    res_blocks=(3, 3, 3, 3), num_kernels=(64, 64, 32, 32),
    cardinality=(8, 8, 4, 4), ksize=3, fused_subnet=True,
    compute_dtype="bfloat16", experimental_lowering="pallas_coupling",
)
#: the same model on the conv-chain kernel's lowering
FLAGSHIP_SUBNET = dataclasses.replace(FLAGSHIP, experimental_lowering="pallas_subnet")
BATCH = 128
#: the seeded serving entry's batch in [serve]: 16 draws of BATCH conditions
SERVE_DRAWS = 16
SERVE_BATCH = SERVE_DRAWS * BATCH
REQUESTS = 4
NUM_CLASSES = 10
#: cnf-pretrain-noise's batch (drivers/pretrain_noise.py), at which
#: [pretrain] trains through K1 and K3
PRETRAIN_BATCH = 512
#: the [records] phase's sampling rows through K2, in float32 (the heads are
#: cast to float32 under bf16 compute): cnf-conv's end-of-training
#: --eval-samples (its default) and cnf-eval --records-dir's
RECORDS_SAMPLES = 64
RECORDS_EVAL_SAMPLES = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores

KERNELS = {
    "affine_forward": dict(
        wrapper=kernels.fused_affine_forward,
        plain=kernels.affine_forward_reference,
        replaces="arl_conditional_normalizing_flows_tpu/ops/pallas/affine_coupling.py:90",
        # reads a, b, u2; writes v2 and 4 bytes of log-det a row
        bytes=lambda rows, n, item: 4 * rows * n * item + 4 * rows,
        # exp, multiply, add, and the log-det add per element
        ops=lambda rows, n: 4 * rows * n,
    ),
    "affine_inverse": dict(
        wrapper=kernels.fused_affine_inverse,
        plain=kernels.affine_inverse_reference,
        replaces="arl_conditional_normalizing_flows_tpu/ops/pallas/affine_coupling.py:190",
        bytes=lambda rows, n, item: 4 * rows * n * item,
        # negate, exp, subtract, multiply per element
        ops=lambda rows, n: 4 * rows * n,
    ),
}
SOURCE = "arl_conditional_normalizing_flows_tpu_torch/csrc/affine_coupling.cu"
CHAIN_SOURCE = "arl_conditional_normalizing_flows_tpu_torch/csrc/fused_subnet.cu"
CHAIN_REPLACES = "arl_conditional_normalizing_flows_tpu/ops/pallas/fused_subnet.py:293"
#: K3's first launch: a small odd size, an even kernel (asymmetric padding)
CHAIN_SMALL = dict(h=6, w=6, cin=2, kernels=8, res_blocks=2, cardinality=2, ksize=4,
                   dilations=(1, 2), out_total=4)
#: then 15 pixels (no full 16-pixel tile of the bf16 kernel), cin 3, groups
#: of 4, 2 and 1 channels
CHAIN_TILES = dict(h=5, w=3, cin=3, kernels=32, res_blocks=2, cardinality=8, ksize=3,
                   dilations=(1, 2, 4), out_total=4)
# K3 against its plain version. float32: sums in another order. bf16: a
# float32 sum in another order can land on the other side of a bf16 rounding
# of an intermediate, which moves outputs of size ~1 by about a bf16 ulp
# (2**-8) and its effect downstream
CHAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# float32: expf against torch.exp, a few ulps; bf16: the same float32 value
# rounded once, at most one bf16 ulp (2**-8 relative) apart; log-det: the
# float32 row sums in another order
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LD_TOL = 1e-4
#: K1/K2's checks: (rows, n, misaligned) — the main path's two shapes, then
#: the same at the seeded serving entry's batch, at noise pre-training's
#: batch and at the records path's two sampling batches, a ragged n, an odd
#: n and
#: misaligned views (both the kernels' scalar path), then the loops: rows
#: wider than K1's 1024-thread block (8200: 2050 float32 or 1025 bf16
#: vectors; 4099: odd, scalar) and a tensor larger than K2's one-wave grid
#: (1024 x 4096), aligned and misaligned
LAW_CASES = ((BATCH, 784, False), (BATCH, 392, False), (SERVE_BATCH, 784, False),
             (SERVE_BATCH, 392, False), (PRETRAIN_BATCH, 784, False),
             (PRETRAIN_BATCH, 392, False), (RECORDS_SAMPLES, 784, False),
             (RECORDS_SAMPLES, 392, False), (RECORDS_EVAL_SAMPLES, 784, False),
             (RECORDS_EVAL_SAMPLES, 392, False), (3, 1000, False), (5, 393, False),
             (BATCH, 784, True), (4, 8200, False), (3, 4099, False), (1024, 4096, False),
             (4, 8200, True), (1024, 4096, True))


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0]


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


class Phases:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0

    def done(self, name, **info):
        now = time.perf_counter()
        extra = "".join(f" {k}={v}" for k, v in info.items())
        print(f"[phase] {name}: {now - self.last:.2f} s (total {now - self.t0:.2f} s){extra}",
              flush=True)
        self.last = now


def device_time_ms(fn, iters=50, reps=11):
    """Median device time of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so host launch
    overhead is not counted. Inputs stay in L2 between calls, as they do on
    the main path (the coupling law reads what the head conv just wrote)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def law_inputs(rows, n, dtype, seed, misaligned=False):
    """a, b, u2 of (rows, n); ``misaligned``: each a contiguous view one
    element past a 16-byte boundary."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for t in (torch.tanh(torch.randn(rows, n, generator=g, device="cuda")),
              torch.randn(rows, n, generator=g, device="cuda"),
              torch.randn(rows, n, generator=g, device="cuda")):
        t = t.to(dtype)
        if misaligned:
            view = torch.empty(t.numel() + 1, dtype=dtype, device="cuda")[1:].view(rows, n)
            t = view.copy_(t)
            check(t.is_contiguous() and t.data_ptr() % 16 != 0, "a misaligned view")
        out.append(t)
    return out


def launch_floor_ms():
    """Device time of one launch of a one-element PyTorch elementwise op,
    timed as the kernels are (:func:`device_time_ms`)."""
    one = torch.ones(1, device="cuda")
    return device_time_ms(lambda: torch.add(one, one))


#: the batches at which K1/K2 are timed, and the key of each one's times
LAW_TIMED = {BATCH: "timings", SERVE_BATCH: "serving_timings",
             PRETRAIN_BATCH: "pretrain_timings"}
#: the batches of the main paths, over which ``max_abs_err`` is taken
LAW_PATH_ROWS = (*LAW_TIMED, RECORDS_SAMPLES, RECORDS_EVAL_SAMPLES)


def check_kernels(phases):
    """K1/K2 against their plain versions at :data:`LAW_CASES` (both
    dtypes); times at the float32 shapes of the main path, the serving
    entry and noise pre-training (:data:`LAW_TIMED`), beside the floor of a
    launch. ``max_abs_err`` is the worst over the float32 shapes of every
    path (:data:`LAW_PATH_ROWS`)."""
    floor_ms = launch_floor_ms()
    print(f"[floor] one launch of a 1-element torch.add: {floor_ms * 1e3:.2f} us on the card "
          "(CUDA-graph replay between CUDA events, as the [kernel] times)", flush=True)
    results = {name: dict(max_abs_err=0.0, **{k: {} for k in LAW_TIMED.values()})
               for name in KERNELS}
    for rows, n, misaligned in LAW_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            a, b, u = law_inputs(rows, n, dtype, seed=rows * n, misaligned=misaligned)
            with torch.no_grad():
                v2, ld = kernels.fused_affine_forward(a, b, u)
                v2_ref, ld_ref = kernels.affine_forward_reference(a, b, u)
                u2 = kernels.fused_affine_inverse(a, b, v2_ref)
                u2_ref = kernels.affine_inverse_reference(a, b, v2_ref)
            torch.cuda.synchronize()
            errs = {
                "affine_forward": max((v2.float() - v2_ref.float()).abs().max().item(),
                                      (ld - ld_ref).abs().max().item()),
                "affine_inverse": (u2.float() - u2_ref.float()).abs().max().item(),
            }
            tol = TOL[dtype]
            check(ld.dtype == torch.float32, "log-det is float32")
            check(torch.allclose(v2.float(), v2_ref.float(), rtol=tol, atol=tol),
                  f"affine_forward v2 {rows}x{n} {dtype}")
            check(torch.allclose(ld, ld_ref, rtol=1e-5, atol=LD_TOL),
                  f"affine_forward log-det {rows}x{n} {dtype}")
            check(torch.allclose(u2.float(), u2_ref.float(), rtol=tol, atol=tol),
                  f"affine_inverse {rows}x{n} {dtype}")
            where = f"{rows}x{n}{' misaligned' if misaligned else ''} {str(dtype)[6:]}"
            for name, err in errs.items():
                print(f"[kernel] {name} {where}: max_abs_err={err:.3g} "
                      f"(tolerance {tol:g} abs + {tol:g} rel; log-det {LD_TOL:g})", flush=True)
                if dtype == torch.float32 and rows in LAW_PATH_ROWS and not misaligned:
                    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            if dtype != torch.float32 or rows not in LAW_TIMED or misaligned:
                continue
            with torch.no_grad():
                for name, k in KERNELS.items():
                    third = u if name == "affine_forward" else v2_ref
                    ms = device_time_ms(lambda: k["wrapper"](a, b, third))
                    plain_ms = device_time_ms(lambda: k["plain"](a, b, third))
                    nbytes = k["bytes"](rows, n, a.element_size())
                    bytes_s = nbytes / HBM_BYTES_PER_S
                    ops_s = k["ops"](rows, n) / F32_FLOPS_PER_S
                    bound_s = max(bytes_s, ops_s)
                    results[name][LAW_TIMED[rows]][n] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                        bound_by="bytes" if bytes_s >= ops_s else "operations")
                    print(f"[kernel] {name} {rows}x{n} float32: {ms * 1e3:.2f} us on the card, "
                          f"{(ms - floor_ms) * 1e3:.2f} us over the floor of "
                          f"{floor_ms * 1e3:.2f} us (bound {bound_s * 1e6:.2f} us for {nbytes} "
                          f"bytes at 3.35 TB/s, {bound_s * 1e3 / ms:.3f} of it), plain version "
                          f"{plain_ms * 1e3:.2f} us", flush=True)
    phases.done("K1/K2 against their plain versions")
    return results, floor_ms


def chain_nets(spec, seed):
    """A ``FusedChainCouplingNet`` at ``spec`` (two heads) with random
    weights from ``seed`` — kernels N(0, 1/fan_in) so that activations stay
    O(1) through the chain, biases N(0, 0.01) — and an eager
    ``ConvCouplingNet`` with the same weights, both on the card."""
    kw = dict(in_shape=(spec.h, spec.w, spec.cin), out_channels=spec.out_total // 2,
              num_kernels=spec.kernels, num_res_blocks=spec.res_blocks,
              cardinality=spec.cardinality, ksize=spec.ksize, dilations=spec.dilations,
              n_heads=2, dtype=getattr(torch, spec.compute_dtype),
              generator=torch.Generator().manual_seed(seed))
    net = FusedChainCouplingNet(**kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.flax_ordered_weights():
            scale = 0.1 if p.dim() == 1 else math.prod(p.shape[:-1]) ** -0.5
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    eager = ConvCouplingNet(layer_norm=False, **kw)
    eager.load_state_dict(net.state_dict())
    check(net.spec == spec, f"net spec {net.spec} == {spec}")
    return net.cuda(), eager.cuda()


def compare_chain(spec, batch, seed):
    """One K3 launch against its plain version on the same inputs, the
    launch synchronised before anything else runs. Returns (max_abs_err,
    x, packed, eager twin)."""
    net, eager = chain_nets(spec, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, spec.h, spec.w, spec.cin, generator=g, device="cuda")
    with torch.no_grad():
        packed = net.packed()
        out = chain.subnet_apply(spec, x, packed)
        torch.cuda.synchronize()
        ref = chain.subnet_apply_reference(spec, x, packed)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = CHAIN_TOL[spec.compute_dtype]
    where = f"{batch}x{spec.h}x{spec.w}x{spec.cin} K={spec.kernels} {spec.compute_dtype}"
    print(f"[kernel] fused_subnet {where}: max_abs_err={err:.3g} (tolerance {tol:g} abs + "
          f"{tol:g} rel; max |ref| {ref.abs().max().item():.3g})", flush=True)
    check(out.shape == ref.shape == (batch, spec.h, spec.w, spec.out_total),
          f"fused_subnet {where} shape")
    check(torch.allclose(out, ref, rtol=tol, atol=tol), f"fused_subnet {where}")
    return err, x, packed, eager


def check_chain_small(phases):
    """K3's first launches, at a small odd size in both dtypes: a fault
    shows here, before any flagship-size launch."""
    for small in (CHAIN_SMALL, CHAIN_TILES):
        for dtype in ("bfloat16", "float32"):
            compare_chain(chain.SubnetSpec(**small, compute_dtype=dtype), 3, seed=1)
    phases.done("K3 first launches at small sizes")


def sass_summary():
    """Per kernel of the built K3 library: its tensor-core instructions
    (HMMA, HGMMA) in ``cuobjdump -sass`` and its registers and spills from
    ``cuobjdump -res-usage``."""
    cuobjdump = build.nvcc_path().removesuffix("nvcc") + "cuobjdump"
    lib = str(build.library_path("fused_subnet"))
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    usage = subprocess.run([cuobjdump, "-res-usage", lib], capture_output=True, text=True,
                           timeout=120, check=True).stdout
    out, name = {}, None
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        lines = part.splitlines()
        out[name] = dict(hmma=sum("HMMA" in ln for ln in lines),
                         hgmma=sum("HGMMA" in ln for ln in lines),
                         ffma=sum("FFMA" in ln for ln in lines))
    for line in usage.splitlines():
        if "Function" in line and ":" in line:
            name = line.split("Function", 1)[1].split(":", 1)[0].strip()
        elif "REG:" in line and name in out:
            out[name]["resources"] = line.strip()
    for name, info in out.items():
        print(f"[sass] {name}: {json.dumps(info)}", flush=True)
    return out


def chain_specs(model):
    """{spec: its launches a pass} of the conv chains a model runs, in order
    of first use: each ``FusedChainCouplingNet`` launches K3 once a pass."""
    counts = {}
    for module in model.modules():
        if isinstance(module, FusedChainCouplingNet):
            counts[module.spec] = counts.get(module.spec, 0) + 1
    return counts


def chain_at_batch(spec, launches, seed, batch):
    """K3 in bf16 at a batch larger than the main path's (the seeded serving
    entry's 16 draws of 128 conditions, noise pre-training's 512): held
    against its plain version, timed beside it, with the bound of that
    batch."""
    s = dataclasses.replace(spec, compute_dtype="bfloat16")
    err, x, packed, _ = compare_chain(s, batch, seed)
    with torch.no_grad():
        ms = device_time_ms(lambda: chain.subnet_apply(s, x, packed), iters=5, reps=7)
        plain_ms = device_time_ms(lambda: chain.subnet_apply_reference(s, x, packed),
                                  iters=2, reps=3)
    flops, nbytes = chain.flops(s, batch), chain.io_bytes(s, batch)
    ops_s, bytes_s = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound_ms = max(ops_s, bytes_s) * 1e3
    trunk_mb = chain.trunk_elements(s, batch) * 4 / 1e6
    row = dict(shape=[batch, s.h, s.w, s.cin], kernels=s.kernels,
               launches_per_pass=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by="operations" if ops_s >= bytes_s else "bytes",
               gflop=flops / 1e9, io_mb=nbytes / 1e6, trunk_scratch_mb=trunk_mb,
               achieved_tflops=flops / ms / 1e9, bound_share=bound_ms / ms)
    print(f"[kernel] fused_subnet {batch}x{s.h}x{s.w}x{s.cin} bf16: {ms * 1e3:.1f} us on "
          f"the card (bound {bound_ms * 1e3:.2f} us, {bound_ms / ms:.3f} of it; "
          f"{flops / ms / 1e9:.1f} TFLOP/s; trunk scratch {trunk_mb:.1f} MB), plain version "
          f"{plain_ms * 1e3:.1f} us", flush=True)
    return row


def check_chain_kernel(specs, phases):
    """K3 against its plain version at each spec of the flagship, batch 128,
    in bf16 and float32, and at the serving and pre-training batches in
    bf16; times at bf16 (the main path's dtype). ``specs``:
    :func:`chain_specs`."""
    results, serving, pretrain = [], [], []
    for i, spec in enumerate(specs):
        for dtype in ("bfloat16", "float32"):
            s = dataclasses.replace(spec, compute_dtype=dtype)
            err, x, packed, eager = compare_chain(s, BATCH, seed=10 + i)
            if dtype == "float32":
                results[-1]["max_abs_err_f32"] = err
                continue
            with torch.no_grad():
                ms = device_time_ms(lambda: chain.subnet_apply(s, x, packed), iters=20)
                plain_ms = device_time_ms(
                    lambda: chain.subnet_apply_reference(s, x, packed), iters=20)
                eager_ms = device_time_ms(lambda: eager(x), iters=20)
            flops, nbytes = chain.flops(s, BATCH), chain.io_bytes(s, BATCH)
            ops_s, bytes_s = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
            bound_ms = max(ops_s, bytes_s) * 1e3
            # grouped work over the time, and the work the tensor cores are
            # given (with the zeros of padded and block-diagonal tiles)
            tflops, issued = flops / ms / 1e9, chain.mma_flops(s, BATCH)
            results.append(dict(
                shape=[BATCH, s.h, s.w, s.cin], kernels=s.kernels, dilations=list(s.dilations),
                launches_per_pass=specs[spec],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, eager_chain_ms=eager_ms,
                bound_ms=bound_ms, bound_by="operations" if ops_s >= bytes_s else "bytes",
                gflop=flops / 1e9, mma_gflop=issued / 1e9, io_mb=nbytes / 1e6,
                achieved_tflops=tflops, bound_share=bound_ms / ms))
            print(f"[kernel] fused_subnet {BATCH}x{s.h}x{s.w}x{s.cin} bf16: {ms * 1e3:.1f} us "
                  f"on the card (bound {bound_ms * 1e3:.2f} us for "
                  f"{flops / 1e9:.2f} GFLOP at 989 TFLOP/s and {nbytes / 1e6:.2f} MB at "
                  f"3.35 TB/s; {tflops:.1f} TFLOP/s achieved, {bound_ms / ms:.3f} of the "
                  f"bound; {issued / 1e9:.2f} GFLOP issued to the tensor cores), plain "
                  f"version {plain_ms * 1e3:.1f} us, eager ConvCouplingNet chain "
                  f"{eager_ms * 1e3:.1f} us (many calls: a yardstick, not a library call)",
                  flush=True)
        serving.append(chain_at_batch(spec, specs[spec], 20 + i, SERVE_BATCH))
        pretrain.append(chain_at_batch(spec, specs[spec], 30 + i, PRETRAIN_BATCH))
    per_pass = {k: sum(r["launches_per_pass"] * r[k] for r in results)
                for k in ("ms", "eager_chain_ms")}
    per_pass["serving_ms"] = sum(r["launches_per_pass"] * r["ms"] for r in serving)
    per_pass["pretrain_ms"] = sum(r["launches_per_pass"] * r["ms"] for r in pretrain)
    print(f"[kernel] fused_subnet a pass's {sum(specs.values())} launches: "
          f"{per_pass['ms'] * 1e3:.1f} us, the eager chains at the same specs "
          f"{per_pass['eager_chain_ms'] * 1e3:.1f} us; at batch {SERVE_BATCH} "
          f"{per_pass['serving_ms'] * 1e3:.1f} us; at batch {PRETRAIN_BATCH} "
          f"{per_pass['pretrain_ms'] * 1e3:.1f} us", flush=True)
    phases.done("K3 against its plain version at the flagship's specs")
    return results, serving, pretrain, per_pass


def class_planes(request):
    """y' planes of BATCH class-conditional requests: evenly spaced class
    labels in [0, 1] (conv_cINN.py:222-228) broadcast over 28 x 28 x 1."""
    labels = torch.arange(NUM_CLASSES, dtype=torch.float32) / (NUM_CLASSES - 1)
    idx = (torch.arange(BATCH) + request) % NUM_CLASSES
    h, w, _ = FLAGSHIP.io_shape
    return labels[idx].view(BATCH, 1, 1, 1).expand(BATCH, h, w, 1).contiguous().cuda()


PORT_KERNELS = ("affine_forward", "affine_inverse", "fused_subnet")


def launch_counts():
    return {**kernels.LAUNCHES, **chain.LAUNCHES}


def reset_launches():
    kernels.reset_launches()
    chain.reset_launches()


def expected_launches(model, cfg, requests, density_passes):
    """Kernel launches of ``requests`` sampling passes and ``density_passes``
    density passes: one coupling-law launch per coupling and pass under
    pallas_coupling, one conv-chain launch per subnet and pass under
    pallas_subnet, and nothing else."""
    n = len(model.couplings)  # 16 at the flagship
    if cfg.use_pallas_coupling:
        return {"affine_forward": n * density_passes, "affine_inverse": n * requests,
                "fused_subnet": 0}
    nets = n * (1 if cfg.fused_subnet else 2)
    return {"affine_forward": 0, "affine_inverse": 0,
            "fused_subnet": nets * (requests + density_passes)}


def run_main_path(model, cfg, phases):
    """The serving path at full width: REQUESTS sampling requests and one
    density evaluation, with the launch counts read around them."""
    h, w, _ = cfg.io_shape
    lowering = cfg.experimental_lowering
    check(model.device.type == "cuda", "the model lies on the card")
    serve = make_image_serving_fn(model, cfg.x_d, de_logit=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    zs = [torch.randn(BATCH, h, w, 1, generator=g, device="cuda") for _ in range(REQUESTS)]
    ys = [class_planes(r) for r in range(REQUESTS)]
    x_data = torch.rand(BATCH, h, w, 1, generator=g, device="cuda")
    xy = torch.cat([logit.logitify(x_data), ys[0]], dim=-1)

    # first calls pick cuDNN algorithms and pack weights; kept out of the
    # counted run
    t = time.perf_counter()
    serve(zs[0], ys[0])
    torch.cuda.synchronize()
    first_request_s = time.perf_counter() - t
    with torch.inference_mode():
        model.log_loss(xy)
    torch.cuda.synchronize()
    phases.done(f"{lowering}: warm-up", first_request_ms=f"{first_request_s * 1e3:.1f}")

    reset_launches()
    latencies, outputs = [], []
    for z, y in zip(zs, ys):
        t = time.perf_counter()
        x = serve(z, y)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
        outputs.append(x)
    after_requests = launch_counts()
    t = time.perf_counter()
    with torch.inference_mode():
        comps = model.log_loss(xy)
    torch.cuda.synchronize()
    density_first_s = time.perf_counter() - t
    launches = launch_counts()

    want = expected_launches(model, cfg, REQUESTS, 0)
    check(after_requests == want, f"{lowering}: launches of {REQUESTS} sampling passes "
          f"{after_requests} == {want}")
    want = expected_launches(model, cfg, REQUESTS, 1)
    check(launches == want, f"{lowering}: launches with one density pass {launches} == {want}")
    for x in outputs:
        check(x.shape == (BATCH, h, w, 1) and bool(torch.isfinite(x).all()),
              "served images are finite and (128, 28, 28, 1)")
    for k, v in comps.items():
        check(v.shape == () and bool(torch.isfinite(v)), f"log_loss {k} is finite")
    phases.done(f"{lowering}: main path", launches=json.dumps(launches),
                loss=f"{comps['loss'].item():.4f}")

    density = []
    with torch.inference_mode():
        for _ in range(5):
            t = time.perf_counter()
            model.log_loss(xy)
            torch.cuda.synchronize()
            density.append(time.perf_counter() - t)
    density.append(density_first_s)
    request_ms = statistics.median(latencies) * 1e3
    serving = dict(
        lowering=lowering,
        request_ms_median=request_ms,
        request_ms_all=[round(s * 1e3, 3) for s in latencies],
        sampling_samples_per_s=BATCH / statistics.median(latencies),
        density_ms_median=statistics.median(density) * 1e3,
        density_samples_per_s=BATCH / statistics.median(density),
        first_request_ms=first_request_s * 1e3,
    )
    print("[serving] " + json.dumps(serving), flush=True)
    phases.done(f"{lowering}: timing")

    # where a request's and a density pass's device time goes; busy share
    # is device-busy time over the unprofiled latency
    for name, fn, wall_ms in (
        ("request", lambda: serve(zs[0], ys[0]), request_ms),
        ("density", lambda: model.log_loss(xy), serving["density_ms_median"]),
    ):
        with torch.inference_mode():
            br = kernel_breakdown(fn)
        br["device_busy_share"] = br["device_busy_ms"] / wall_ms
        print(f"[profile] {lowering} {name} " + json.dumps(br), flush=True)
    phases.done(f"{lowering}: profile")
    check_round_trip_and_cpu(model, cfg, xy, zs, ys, phases)
    return launches


def kernel_breakdown(fn, top=6):
    """Device time of one ``fn()`` by kernel, from torch.profiler: launches,
    busy milliseconds (union of kernel intervals), the shares of the
    coupling-law kernels, the conv-chain kernel and cuDNN/cuBLAS
    convolutions, and the ``top`` kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device events without the ranges of record_function annotations (an
    # eager optimizer step shows one spanning all of its kernels and the
    # host's gaps between them)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e - s, n + 1)
    total = sum(t for t, _ in by_name.values()) or float("nan")

    def share(pred):
        return sum(t for name, (t, _) in by_name.items() if pred(name.lower())) / total

    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    ours = {k: sum(n for name, (_, n) in by_name.items() if k + "_" in name)
            for k in ("affine_forward", "affine_inverse", "fused_subnet")}
    return dict(
        kernel_launches=len(spans),
        port_kernel_launches=ours,
        device_busy_ms=busy_us / 1e3,
        coupling_kernel_share=share(lambda n: "affine_" in n),
        chain_kernel_share=share(lambda n: "fused_subnet" in n),
        conv_share=share(lambda n: "fused_subnet" not in n and any(
            k in n for k in ("conv", "xmma", "gemm", "cutlass", "sm90"))),
        top=[dict(name=name[:80], ms=t / 1e3, count=n) for name, (t, n) in ranked],
    )


def check_round_trip_and_cpu(model, cfg, xy, zs, ys, phases):
    """forward(inverse(zy)) == zy on the card, and the card against the CPU
    at float32 on a sub-batch of 8 with the same weights."""
    lowering = cfg.experimental_lowering
    zy = torch.cat([zs[0], ys[0]], dim=-1)
    with torch.inference_mode():
        back, _ = model(model.inverse(zy))
    err = (back - zy).abs().max().item()
    # bf16 subnets: a float32 perturbation that flips a bf16 rounding in the
    # inverse's subnet input changes A and b by a bf16 ulp of values ~1e-2
    print(f"[check] {lowering} round trip forward(inverse(zy)): max_abs_err={err:.3g} "
          "(tolerance 1e-3)", flush=True)
    check(err <= 1e-3, f"{lowering} round trip forward(inverse(zy)) == zy")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gpu32, cpu32 = twin(model, cfg32), twin(model, cfg32, device="cpu")
    sub, zy8 = xy[:8], zy[:8]
    before = launch_counts()
    with torch.inference_mode():
        zy_g, ld_g = gpu32(sub)
        zy_c, ld_c = cpu32(sub.cpu())
        x_g = gpu32.inverse(zy8)
        x_c = cpu32.inverse(zy8.cpu())
    check(launch_counts() != before, f"{lowering}: the float32 card model ran its kernels")
    # float32 sums in other orders on the two devices (TF32 off), through 16
    # couplings
    errs = dict(zy=(zy_g.cpu() - zy_c).abs().max().item(),
                log_det=(ld_g.cpu() - ld_c).abs().max().item(),
                inverse=(x_g.cpu() - x_c).abs().max().item())
    print(f"[check] {lowering} card vs CPU at float32, batch 8: {json.dumps(errs)} "
          "(tolerance 1e-4 abs + 1e-4 rel; log-det 1e-3 abs + 1e-4 rel)", flush=True)
    check(torch.allclose(zy_g.cpu(), zy_c, rtol=1e-4, atol=1e-4), "card vs CPU zy")
    check(torch.allclose(ld_g.cpu(), ld_c, rtol=1e-4, atol=1e-3), "card vs CPU log-det")
    check(torch.allclose(x_g.cpu(), x_c, rtol=1e-4, atol=1e-4), "card vs CPU inverse")
    phases.done(f"{lowering}: round trip and CPU comparison")


#: [grad] tolerances on the worst relative error of a parameter's gradient
#: (max |diff| / max |reference|), about 5x what an H100 measured (the
#: figures in brackets). pallas_coupling (bf16 subnets): the same eager
#: subnets, K1's float32 law against the plain one, so a float32 ulp now and
#: then flips a bf16 rounding downstream, and cuDNN's bf16 weight gradients
#: sum in an order of their own (1.8e-3). pallas_subnet at float32, TF32
#: off: float32 sums in another order (1.5e-5). pallas_subnet in bf16
#: against the CPU: K3's bf16 output differs from the plain version's by a
#: bf16 ulp here and there (CHAIN_TOL), which moves the next couplings'
#: inputs (5.9e-3)
GRAD_TOL = {"pallas_coupling": 1e-2, "pallas_subnet_f32": 1e-4, "pallas_subnet_cpu": 3e-2}
GRAD_CPU_BATCH = 8


def loss_grads(model, xy):
    """{name: gradient} of ``model.log_loss(xy)["loss"]`` over every
    parameter."""
    named = dict(model.named_parameters())
    loss = model.log_loss(xy)["loss"]
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def worst_rel(got, want):
    """(name, error) of the parameter whose gradient is furthest from
    ``want``'s, relative to its largest value."""
    errs = {k: ((got[k].float().cpu() - want[k].float().cpu()).abs().max()
                / want[k].float().cpu().abs().max().clamp_min(1e-30)).item() for k in want}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def twin(model, cfg, device=None):
    """A model of ``cfg`` with ``model``'s weights."""
    out = ConvCFlow(cfg, device=device)
    out.load_state_dict({k: v.to(out.device) for k, v in model.state_dict().items()})
    return out


def compare_grads(what, model, reference, xy, xy_ref, want_launches, tol):
    """``model``'s gradients against ``reference``'s, with the launches of
    ``model``'s forward and backward counted."""
    reset_launches()
    got = loss_grads(model, xy)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = loss_grads(reference, xy_ref)
    name, err = worst_rel(got, want)
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    print(f"[grad] {what}: worst relative error {err:.3g} at {name} (tolerance {tol:g}), "
          f"{len(got)} parameters, launches {json.dumps(launches)}", flush=True)
    check(finite, f"{what}: finite gradients")
    check(launches == want_launches, f"{what}: launches {launches} == {want_launches}")
    check(err < tol, f"{what}: gradients within {tol:g}")
    return dict(worst_rel_err=err, worst_param=name, tolerance=tol, launches=launches)


def recomputes(model, batch):
    """A function that runs K3's backward recompute
    (``chain.subnet_apply_vjp``) once for each ``FusedChainCouplingNet`` of
    ``model`` at ``batch``, as a backward pass does, on random inputs and
    cotangents (its work does not depend on their values)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    calls = []
    for net in model.modules():
        if isinstance(net, FusedChainCouplingNet):
            s = net.spec
            x = torch.randn(batch, s.h, s.w, s.cin, generator=g, device="cuda")
            cot = torch.randn(batch, s.h, s.w, s.out_total, generator=g, device="cuda")
            with torch.no_grad():
                packed = net.packed()
            calls.append((s, x, packed, cot))
    return lambda: [chain.subnet_apply_vjp(s, x, p, cot) for s, x, p, cot in calls]


def check_grads(coupling_model, subnet_model, phases):
    """[grad]: gradients through K1 and K3 at full width against the same
    weights on paths without them, then a forward+backward's wall and device
    time on both lowerings, and the share of the latter that K3's backward
    recomputes take."""
    h, w, _ = FLAGSHIP.io_shape
    g = torch.Generator(device="cuda").manual_seed(1)
    x_data = torch.rand(BATCH, h, w, 1, generator=g, device="cuda")
    xy = torch.cat([logit.logitify(x_data), class_planes(0)], dim=-1)
    n = len(coupling_model.couplings)
    out = {}

    default = twin(coupling_model, dataclasses.replace(FLAGSHIP, experimental_lowering=None))
    out["pallas_coupling"] = compare_grads(
        f"pallas_coupling bf16, batch {BATCH}, against the default lowering on the card",
        coupling_model, default, xy, xy,
        {"affine_forward": n, "affine_inverse": 0, "fused_subnet": 0},
        GRAD_TOL["pallas_coupling"])
    del default
    phases.done("grad: pallas_coupling")

    f32 = dict(compute_dtype="float32")
    subnet32 = twin(subnet_model, dataclasses.replace(FLAGSHIP_SUBNET, **f32))
    default32 = twin(subnet_model, dataclasses.replace(FLAGSHIP, experimental_lowering=None, **f32))
    out["pallas_subnet_f32"] = compare_grads(
        f"pallas_subnet float32 (TF32 off), batch {BATCH}, against the default lowering on the card",
        subnet32, default32, xy, xy, {"affine_forward": 0, "affine_inverse": 0, "fused_subnet": n},
        GRAD_TOL["pallas_subnet_f32"])
    del subnet32, default32
    phases.done("grad: pallas_subnet float32")

    cpu = twin(subnet_model, FLAGSHIP_SUBNET, device="cpu")
    sub = xy[:GRAD_CPU_BATCH]
    out["pallas_subnet_cpu"] = compare_grads(
        f"pallas_subnet bf16, batch {GRAD_CPU_BATCH}, against the plain versions on the CPU",
        subnet_model, cpu, sub, sub.cpu(),
        {"affine_forward": 0, "affine_inverse": 0, "fused_subnet": n},
        GRAD_TOL["pallas_subnet_cpu"])
    del cpu
    phases.done("grad: pallas_subnet bf16 against the CPU")

    for model, cfg in ((coupling_model, FLAGSHIP), (subnet_model, FLAGSHIP_SUBNET)):
        lowering = cfg.experimental_lowering
        params = list(model.parameters())

        def step():
            return torch.autograd.grad(model.log_loss(xy)["loss"], params)

        step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        reset_launches()
        br = kernel_breakdown(step, top=12)
        launches = launch_counts()
        wall_ms = statistics.median(walls) * 1e3
        br.update(lowering=lowering, wall_ms_median=wall_ms,
                  wall_ms_all=[round(s * 1e3, 3) for s in walls],
                  device_busy_share=br["device_busy_ms"] / wall_ms, forward_launches=launches)
        if cfg.fused_pallas_subnet:
            rec = kernel_breakdown(recomputes(model, BATCH))
            br.update(recompute_launches=rec["kernel_launches"],
                      recompute_device_ms=rec["device_busy_ms"],
                      recompute_share=rec["device_busy_ms"] / br["device_busy_ms"])
        print("[grad] forward+backward " + json.dumps(br), flush=True)
        out[f"step_{lowering}"] = br
    phases.done("grad: forward+backward timing")
    return out


#: [train]: the JAX bench's cell (bench.py:113-146) — the flagship on the
#: default lowering (eager cuDNN subnets, bf16), batch 128, Adam 3e-4, no
#: noise, random-normal xy from numpy seed 0, 16 steps a call
BENCH_CELL = dataclasses.replace(FLAGSHIP, experimental_lowering=None)
TRAIN_LR = 3e-4
TRAIN_INNER = 16
TRAIN_CALLS = 5  # timed calls of the graph and of the eager steps, after the first
LOWERING_INNER = 4  # steps a graph under pallas_coupling and pallas_subnet
#: the cnf-conv class workload (drivers/conv.py defaults): the flagship arch
#: in float32 with unfused subnets and the shared-shape init, classes 0-3,
#: batch 32, fudged-logit pixels, the 2% noise floor, full instance noise
FIT_CFG = ConvFlowConfig(io_shape=(28, 28, 2), x_d=1, ksize=3, ref_compat_shared_init=True)
FIT_CLASSES = (0, 1, 2, 3)
FIT_BATCH = 32
FIT_INNER = 16
#: graph against eager parameters after the same steps from the same state:
#: every element within TRAIN_MAX and at least TRAIN_FRACTION of them within
#: TRAIN_TIGHT. cuDNN's float32 weight gradients in K3's recompute sum with
#: atomics, so pallas_subnet is not bit-equal. Measured on an NVIDIA H100
#: 80GB HBM3 at 700 W in four runs: default and pallas_coupling bit-equal;
#: pallas_subnet max 2.4e-6 to 1.73e-5, 0.999992 to 1.0 of elements within
#: 1e-5. Adam moves an element by about lr a step (3e-4), above TRAIN_MAX,
#: so a skipped or misapplied update shows
TRAIN_MAX = 1e-4
TRAIN_TIGHT = 1e-5
TRAIN_FRACTION = 0.9999


def param_agreement(a, b):
    """(max |a - b|, the fraction of elements within TRAIN_TIGHT) over
    every parameter of two models of one config."""
    diffs = torch.cat([(p.detach().float() - q.detach().float()).abs().flatten()
                       for p, q in zip(a.parameters(), b.parameters())])
    return diffs.max().item(), (diffs <= TRAIN_TIGHT).float().mean().item()


def walls(fn, n):
    """Host seconds of ``n`` calls of ``fn``, each ended by a synchronize."""
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def bench_stack(cfg, inner):
    """(inner, BATCH, 28, 28, 2) random-normal xy from numpy seed 0, as
    bench.py makes its stack, on the card."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.normal(size=(inner, BATCH) + cfg.io_shape).astype(np.float32)).cuda()


def train_graph_and_eager(cfg, inner, phases):
    """One lowering's [train] line: a graph of ``inner`` steps against
    ``inner`` eager steps from the same state, then TRAIN_CALLS timed calls
    of each and a profile of each. Returns the line's dict."""
    lowering = cfg.experimental_lowering or "default"
    stack = bench_stack(cfg, inner)
    graphed = ConvCFlow(cfg, seed=0)
    eager = twin(graphed, cfg)
    state_g = create_train_state(graphed, TRAIN_LR)
    state_e = create_train_state(eager, TRAIN_LR)
    multi = make_scan_train_step(graphed, inner, noise_mode="none")
    train_step, _ = make_step_fns(eager, noise_mode="none")

    reset_launches()
    t = time.perf_counter()
    multi.capture(state_g, stack)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    capture_launches = launch_counts()  # the warm-up steps and the capture
    check(multi.graph is not None and state_g.step == 0,
          f"{lowering}: captured, and the state is as it was before the warm-up")
    step_launches = multi.launches  # what each replay launches, counted at the capture
    state_g, first = multi(state_g, stack)
    eager_losses = torch.stack([train_step(state_e, xy)[1]["loss"] for xy in stack])
    torch.cuda.synchronize()
    max_diff, tight = param_agreement(graphed, eager)
    graph_loss, eager_loss = first["loss"].item(), eager_losses.mean().item()
    print(f"[train] {lowering}: {inner} graph steps against {inner} eager steps from one state: "
          f"parameters max |diff| {max_diff:.3g} (at most {TRAIN_MAX:g}), "
          f"{tight:.6f} of elements within {TRAIN_TIGHT:g} (at least {TRAIN_FRACTION}); mean "
          f"loss {graph_loss:.4f} against {eager_loss:.4f}", flush=True)
    check(state_g.step == state_e.step == inner, f"{lowering}: {inner} optimizer steps each")
    check(all(math.isfinite(v.item()) for v in first.values())
          and bool(torch.isfinite(eager_losses).all()), f"{lowering}: finite losses")
    check(max_diff <= TRAIN_MAX and tight >= TRAIN_FRACTION,
          f"{lowering}: graph and eager parameters agree")
    phases.done(f"train {lowering}: capture and the graph against eager steps")

    def eager_steps():
        for xy in stack:
            train_step(state_e, xy)

    losses = [graph_loss]

    def graph_call():
        losses.append(multi(state_g, stack)[1]["loss"].item())

    graph_walls, eager_walls = walls(graph_call, TRAIN_CALLS), walls(eager_steps, TRAIN_CALLS)
    graph_prof = kernel_breakdown(graph_call, top=8)
    before = launch_counts()
    eager_prof = kernel_breakdown(lambda: train_step(state_e, stack[0]), top=8)
    # the wrappers' counts of that one eager step: torch.profiler's (printed
    # beside them) has dropped a K3 record of an eager step too
    eager_launches = {k: v - before[k] for k, v in launch_counts().items()}
    # the optimizer's share of an eager step: one more Adam update from the
    # last step's gradients (the eager model serves timing only from here)
    adam_prof = kernel_breakdown(state_e.optimizer.step, top=3)
    check(all(math.isfinite(v) for v in losses), f"{lowering}: finite losses in the timed calls")
    graph_ms, eager_ms = (statistics.median(w) * 1e3 for w in (graph_walls, eager_walls))
    out = dict(
        lowering=lowering, steps_a_call=inner, batch=BATCH, couplings=len(graphed.couplings),
        capture_s=capture_s,
        graph_call_ms_median=graph_ms, graph_call_ms_all=[round(w * 1e3, 3) for w in graph_walls],
        graph_step_ms=graph_ms / inner, graph_samples_per_s=BATCH * inner / (graph_ms / 1e3),
        eager_call_ms_median=eager_ms, eager_call_ms_all=[round(w * 1e3, 3) for w in eager_walls],
        eager_step_ms=eager_ms / inner, eager_samples_per_s=BATCH * inner / (eager_ms / 1e3),
        graph_busy_ms_a_step=graph_prof["device_busy_ms"] / inner,
        graph_busy_share=graph_prof["device_busy_ms"] / graph_ms,
        graph_launches_a_step=graph_prof["kernel_launches"] / inner,
        graph_port_kernel_launches_a_step={k: v / inner for k, v in
                                           graph_prof["port_kernel_launches"].items()},
        graph_port_kernel_launches_a_step_at_capture=step_launches,
        eager_busy_ms_a_step=eager_prof["device_busy_ms"],
        eager_busy_share=eager_prof["device_busy_ms"] / (eager_ms / inner),
        eager_launches_a_step=eager_prof["kernel_launches"],
        eager_port_kernel_launches_a_step=eager_launches,
        profiled_eager_port_kernel_launches_a_step=eager_prof["port_kernel_launches"],
        eager_adam_launches=adam_prof["kernel_launches"],
        eager_adam_busy_ms=adam_prof["device_busy_ms"],
        wrapper_launches_warmup_and_capture=capture_launches,
        loss_first=graph_loss, loss_last=losses[-1], max_param_diff=max_diff,
        param_fraction_within_tight=tight, graph_top=graph_prof["top"],
        eager_top=eager_prof["top"],
    )
    print("[train] " + json.dumps(out), flush=True)
    phases.done(f"train {lowering}: timing and profile")
    return out


def train_fit(phases):
    """``fit`` on the cnf-conv class workload with scanned stacks through
    the CUDA graph, after checking the flagship's shared-shape draw."""
    imgs, labels = synthetic_digits()
    src = ClassConditionalSource(imgs, labels, FIT_CLASSES, FIT_BATCH, use_logits=True)
    model = ConvCFlow(FIT_CFG, seed=0)
    state = create_train_state(model, TRAIN_LR, seed=0)
    counts = check_shared_draw(model.state_dict())
    print(f"[train] shared-shape init on the flagship arch: {json.dumps(counts)}", flush=True)
    phases.done("train: the flagship's shared-shape draw")

    multi = make_scan_train_step(model, FIT_INNER, noise_mode="full")
    g = torch.Generator(device="cuda").manual_seed(0)
    t = time.perf_counter()
    res = fit(state, multi, lambda gen, epoch: epoch_stacks(src.epoch(gen), FIT_INNER),
              generator=g, num_epochs=2, num_annealing_epochs=1, verbose=False)
    fit_s = time.perf_counter() - t
    rows = res.history.rows
    print(f"[train] fit, cnf-conv class workload ({len(FIT_CLASSES)} classes, batch "
          f"{FIT_BATCH}, {src.num_batches // FIT_INNER} stacks of {FIT_INNER} an epoch): "
          f"{fit_s:.2f} s, {json.dumps(rows)}", flush=True)
    check([r["alpha"] for r in rows] == [0.0, 1.0, 1.0], "fit: alphas 0, 1, 1")
    check(res.completed_epochs == 3 and not res.stopped_early, "fit: three epochs")
    check(all(math.isfinite(r[k]) for r in rows for k in ("loss", "z_loss", "y_loss", "detJ_loss")),
          "fit: finite losses")
    phases.done("train: fit")
    return dict(seconds=fit_s, rows=rows, shared_init=counts)


def check_train(phases):
    """[train]: the bench's cell, graphs under both kernel lowerings, and
    fit. The kernels' wrappers count at capture only, so the launches inside
    a replay are those counted during the capture, which the graph holds;
    an eager step's are the wrappers' counts around it (the profiler's
    counts of both are printed beside them). A training step runs no
    inverse, so K2 must launch no time in any of them."""
    out = {"default": train_graph_and_eager(BENCH_CELL, TRAIN_INNER, phases)}
    for cfg, kernel in ((FLAGSHIP, "affine_forward"), (FLAGSHIP_SUBNET, "fused_subnet")):
        line = train_graph_and_eager(cfg, LOWERING_INNER, phases)
        n = line["couplings"]  # one launch a coupling and step (16 at the flagship)
        per_step = line["graph_port_kernel_launches_a_step_at_capture"]
        check(per_step[kernel] == n and line["eager_port_kernel_launches_a_step"][kernel] == n,
              f"{cfg.experimental_lowering}: {kernel} launches {n} times a step in the replays "
              f"and eagerly ({per_step})")
        out[cfg.experimental_lowering] = line
        torch.cuda.empty_cache()
    for lowering, line in out.items():
        check(line["graph_port_kernel_launches_a_step_at_capture"]["affine_inverse"] == 0
              and line["eager_port_kernel_launches_a_step"]["affine_inverse"] == 0,
              f"{lowering}: affine_inverse launches no time in a training step")
    out["fit"] = train_fit(phases)
    return out


#: [serve]: the JAX bench's serving cell (bench.py:270-357): the flagship
#: (bf16 subnets, fused heads, weights from seed 0) behind
#: make_image_serving_fn(de_logit, quantize_uint8), 16 draws of 128 class
#: conditions a call with the latent drawn on the card from one seed; and a
#: PipelinedSampler of 8 draws a call with 16 graphs in rotation
SERVE_LOWERINGS = (None, "pallas_coupling", "pallas_subnet")
SERVE_SEED = 7
SERVE_CALLS = 5
PIPE_DRAWS, PIPE_IN_FLIGHT, PIPE_TOTAL = 8, 16, 128
#: conditions of the smaller calls whose graphs join the 2,048 graph's
#: memory pool, and the most card memory they may reserve besides it (a
#: pool of their own would hold the largest one's intermediates alone:
#: 1,024 rows of activations, 100-400 MB)
POOL_CONDITIONS, POOL_GROWTH_MIB = (8, 16, 32, 64), 32


def serve_lowering(lowering, tmp, phases):
    """One lowering's [serve] line: the seeded multidraw artifact's graphed
    call against the eager entry, two seeds, the saved and loaded artifact,
    launches and device time of a replayed call, the pipelined sampler
    against sequential calls, and the eager single-draw request."""
    cfg = dataclasses.replace(FLAGSHIP, experimental_lowering=lowering)
    name = lowering or "default"
    model = ConvCFlow(cfg, seed=0)
    h, w, _ = cfg.io_shape
    fn = make_image_serving_fn(model, cfg.x_d, de_logit=True, quantize_uint8=True)
    art = export_seeded_multidraw_sampler(fn, SERVE_DRAWS, (h, w, 1), (h, w, 1))
    y = class_planes(0)
    n = len(model.couplings)  # K2 or K3 launches a pass (16 at the flagship)
    per_pass = {"affine_forward": 0, "affine_inverse": n if cfg.use_pallas_coupling else 0,
                "fused_subnet": n if cfg.fused_pallas_subnet else 0}

    reset_launches()
    t = time.perf_counter()
    first = art.call(SERVE_SEED, y)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    # the wrappers count in the warm-up call and the capture, not in replays
    wrapper_launches = launch_counts()
    check(wrapper_launches == {k: 2 * v for k, v in per_pass.items()},
          f"serve {name}: the warm-up and the capture launch {wrapper_launches}, "
          f"twice {per_pass}")
    eager = make_seeded_multidraw_fn(art.fn, SERVE_DRAWS, (h, w, 1))(SERVE_SEED, y)
    other = art.call(SERVE_SEED + 1, y)
    torch.cuda.synchronize()
    check(first.shape == (SERVE_DRAWS, BATCH, h, w, 1) and first.dtype == torch.uint8,
          f"serve {name}: uint8 ({SERVE_DRAWS}, {BATCH}, 28, 28, 1)")
    check(torch.equal(first, eager), f"serve {name}: the graphed call is bit-equal to the "
          "eager entry for the same seed")
    check(not torch.equal(first, other), f"serve {name}: two seeds give other samples")
    check(torch.equal(first, art.call(SERVE_SEED, y)),
          f"serve {name}: a call's result stays as it was after later calls")
    path = os.path.join(tmp, f"seeded_{name}.pt")
    side = save_artifact(path, art, metadata={"lowering": name})
    loaded = load_artifact(path)
    check(torch.equal(loaded.call(SERVE_SEED, y), first),
          f"serve {name}: the saved and loaded artifact gives the same bytes")
    del loaded
    phases.done(f"serve {name}: capture and checks", capture_s=f"{capture_s:.2f}")

    call_walls = walls(lambda: art.call(SERVE_SEED, y), SERVE_CALLS)
    prof = kernel_breakdown(lambda: art.call(SERVE_SEED, y), top=8)
    # what a replay launches: the wrappers' counts during the capture; the
    # profiler's count of a replay is printed beside it (it has dropped a
    # record of a replay)
    replay = art.graph(y.shape).launches
    check(replay == per_pass, f"serve {name}: launches a replayed call {replay} == {per_pass}")
    call_ms = statistics.median(call_walls) * 1e3

    # call's graphs share one memory pool: those of smaller batches fit in
    # what the 2,048 graph's intermediates leave free
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # what the warm-ups cached outside the pool
    reserved = torch.cuda.memory_reserved()
    for b in POOL_CONDITIONS:
        check(art.call(SERVE_SEED, y[:b]).shape == (SERVE_DRAWS, b, h, w, 1),
              f"serve {name}: a call of {b} conditions")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool_growth_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    check(pool_growth_mib <= POOL_GROWTH_MIB,
          f"serve {name}: graphs of {POOL_CONDITIONS} conditions reserve {pool_growth_mib} MiB "
          f"besides the 2,048 graph's (at most {POOL_GROWTH_MIB})")

    art8 = export_seeded_multidraw_sampler(fn, PIPE_DRAWS, (h, w, 1), (h, w, 1))
    pipe = PipelinedSampler(art8, PIPE_DRAWS, PIPE_IN_FLIGHT)
    t = time.perf_counter()
    pipe.sample(y, PIPE_TOTAL, start_seed=100)  # captures the graphs in rotation
    pipe_first_s = time.perf_counter() - t
    t = time.perf_counter()
    pipelined = pipe.sample(y, PIPE_TOTAL, start_seed=100)
    pipe_s = time.perf_counter() - t
    calls = -(-PIPE_TOTAL // PIPE_DRAWS)
    t = time.perf_counter()
    sequential = torch.cat([art8.call(100 + k, y) for k in range(calls)]).cpu().numpy()
    sequential_s = time.perf_counter() - t
    check(pipelined.shape == (calls * PIPE_DRAWS, BATCH, h, w, 1)
          and np.array_equal(pipelined, sequential),
          f"serve {name}: the pipelined sampler equals {calls} sequential calls")
    del art8, pipe
    phases.done(f"serve {name}: pipelined sampler", first_s=f"{pipe_first_s:.2f}")

    single = make_image_serving_fn(model, cfg.x_d, de_logit=True, quantize_uint8=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn(BATCH, h, w, 1, generator=g, device="cuda")
    single(z, y)
    eager_walls = walls(lambda: single(z, y), SERVE_CALLS)
    eager_ms = statistics.median(eager_walls) * 1e3
    line = dict(
        lowering=name, draws=SERVE_DRAWS, conditions=BATCH, batch=SERVE_BATCH,
        capture_s=capture_s, call_ms_median=call_ms,
        call_ms_all=[round(x * 1e3, 3) for x in call_walls],
        samples_per_s=SERVE_BATCH / (call_ms / 1e3),
        busy_ms=prof["device_busy_ms"], busy_share=prof["device_busy_ms"] / call_ms,
        port_kernel_launches_a_call=replay,
        profiled_call_launches=prof["kernel_launches"],
        profiled_port_kernel_launches=prof["port_kernel_launches"],
        coupling_kernel_share=prof["coupling_kernel_share"],
        chain_kernel_share=prof["chain_kernel_share"], conv_share=prof["conv_share"],
        wrapper_launches_warmup_and_capture=wrapper_launches,
        artifact_bytes=side["nr_bytes"],
        pool_growth_mib_for_conditions={str(POOL_CONDITIONS): pool_growth_mib},
        pipelined=dict(draws_a_call=PIPE_DRAWS, in_flight=PIPE_IN_FLIGHT, calls=calls,
                       first_s=pipe_first_s, seconds=pipe_s,
                       samples_per_s=calls * PIPE_DRAWS * BATCH / pipe_s,
                       sequential_s=sequential_s,
                       sequential_samples_per_s=calls * PIPE_DRAWS * BATCH / sequential_s),
        eager_request_ms_median=eager_ms,
        eager_request_ms_all=[round(x * 1e3, 3) for x in eager_walls],
        eager_request_samples_per_s=BATCH / (eager_ms / 1e3),
        top=prof["top"],
    )
    print("[serve] " + json.dumps(line), flush=True)
    phases.done(f"serve {name}: timing")
    return line


def check_serve(phases):
    """[serve] under the three lowerings; K2 launches 16 times a replayed
    call under pallas_coupling and K3 16 times under pallas_subnet."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for lowering in SERVE_LOWERINGS:
            out[lowering or "default"] = serve_lowering(lowering, tmp, phases)
            torch.cuda.empty_cache()
    return out


#: [cli]: the port's drivers through main(argv), on synthetic digits
CLI_CLASS = ["--model-type", "class", "--dataset", "synthetic", "--synthetic-per-class", "256",
             "--annealing-epochs", "1", "--scan-steps", "16", "--checkpoint-every", "1",
             "--eval-samples", "16"]
CLI_SR = {"SR4,2": ["--squeeze-factor", "0", "0", "0", "0"], "SR2,1": []}


def history_rows(outdir):
    with open(os.path.join(outdir, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_cli(phases):
    """[cli]: cnf-conv on the class workload at the flagship arch (1
    annealing and 1 clean epoch of graphed stacks of 16 steps, checkpoints
    each epoch), a second cnf-conv that resumes from its checkpoints for one
    more epoch, SR4,2 and SR2,1 at one residual block a level, then cnf-eval
    of the class checkpoint with --export-multidraw, whose artifact is
    loaded and called."""
    from arl_conditional_normalizing_flows_tpu_torch.drivers import conv as cnf_conv
    from arl_conditional_normalizing_flows_tpu_torch.drivers import evaluate as cnf_eval

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cls = os.path.join(tmp, "class")
        t = time.perf_counter()
        cnf_conv.main(CLI_CLASS + ["--epochs", "1", "--outdir", cls])
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        resumed = cnf_conv.main(CLI_CLASS + ["--epochs", "2", "--outdir", cls])
        resume_s = time.perf_counter() - t
        rows = history_rows(cls)
        check([r["epoch"] for r in rows] == [0, 1, 2]
              and [r["epoch"] for r in resumed.history.rows] == [2],
              f"cli: the second cnf-conv resumed at epoch 2 ({[r['epoch'] for r in rows]})")
        with open(os.path.join(cls, "eval.json")) as f:
            final = json.load(f)
        check(math.isfinite(final["val_bits_per_dim"]), "cli: eval.json has val_bits_per_dim")
        out["class"] = dict(first_s=first_s, resume_s=resume_s, rows=rows,
                            val_bits_per_dim=final["val_bits_per_dim"],
                            sampling=final["sampling"])
        phases.done("cli: cnf-conv class, then resumed")
        for model_type, extra in CLI_SR.items():
            outdir = os.path.join(tmp, model_type)
            t = time.perf_counter()
            cnf_conv.main(["--model-type", model_type, "--dataset", "synthetic",
                           "--synthetic-per-class", "64", "--res-blocks", "1", "1", "1", "1",
                           "--epochs", "1", "--annealing-epochs", "0", "--checkpoint-every",
                           "0", "--eval-samples", "16", "--outdir", outdir, *extra])
            with open(os.path.join(outdir, "eval.json")) as f:
                final = json.load(f)
            out[model_type] = dict(seconds=time.perf_counter() - t, rows=history_rows(outdir),
                                   val_bits_per_dim=final["val_bits_per_dim"],
                                   sampling=final["sampling"])
            rows += out[model_type]["rows"]
            phases.done(f"cli: cnf-conv {model_type}")
        check(all(math.isfinite(r[k]) for r in rows for k in ("loss", "val_loss")),
              "cli: finite losses in every history.jsonl")

        artifact = os.path.join(tmp, "multidraw.pt")
        t = time.perf_counter()
        report = cnf_eval.main(["--checkpoint-dir", os.path.join(cls, "checkpoints"),
                                "--dataset", "synthetic", "--synthetic-per-class", "256",
                                "--eval-samples", "16", "--export-multidraw", artifact])
        eval_s = time.perf_counter() - t
        multi = load_artifact(artifact)
        x = multi.call(torch.zeros(2, 3, 28, 28, 1), torch.full((3, 28, 28, 1), 0.5))
        check(report["epoch"] == 2 and math.isfinite(report["bits_per_dim"]),
              "cli: cnf-eval restored epoch 2 with a finite bits/dim")
        check(x.shape == (2, 3, 28, 28, 1) and bool(torch.isfinite(x).all()),
              "cli: the exported multidraw artifact serves (2, 3, 28, 28, 1)")
        out["eval"] = dict(seconds=eval_s, bits_per_dim=report["bits_per_dim"],
                           latent_normality=report["latent_normality"])
    print("[cli] " + json.dumps(out), flush=True)
    phases.done("cli: cnf-eval and its artifact")
    return out


#: [pretrain]: cnf-pretrain-noise at its defaults (the flagship arch, batch
#: 512, 20 batches an epoch, Adam 3e-4, the shared-shape init) under the
#: three lowerings. (name, flags, the port kernel each step launches 16
#: times): the smoke's flagship settings (bf16, fused heads) on K3, whose
#: parameters the shared-shape init does not support (JAX's refuses it too),
#: and on K1; then the user's own defaults, float32 on the default lowering
PRETRAIN_RUNS = (
    ("pallas_subnet", ["--experimental-lowering", "pallas_subnet", "--dtype", "bfloat16",
                       "--fused-subnet", "--no-shared-init", "--scan-steps", "4",
                       "--epochs", "2"], "fused_subnet"),
    ("pallas_coupling", ["--experimental-lowering", "pallas_coupling", "--dtype", "bfloat16",
                         "--fused-subnet", "--scan-steps", "4", "--epochs", "1"],
     "affine_forward"),
    ("default", ["--scan-steps", "4", "--epochs", "1"], None),
)
PRETRAIN_INNER = 4
PRETRAIN_BATCHES = 20  # the driver's --num-batches default


def pretrain_lowering(name, flags, kernel, tmp, phases):
    """One cnf-pretrain-noise run through ``main(argv)``; then the driver's
    own graphed step (``FitResult.train_step``) timed and profiled on a
    fresh noise stack. Returns the run's line."""
    from arl_conditional_normalizing_flows_tpu_torch.drivers import pretrain_noise

    outdir = os.path.join(tmp, name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    res = pretrain_noise.main(flags + ["--outdir", outdir])
    run_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = history_rows(outdir)
    per_step = res.train_step.launches  # counted at the capture: what each replay launches
    want = {k: 0 for k in PORT_KERNELS}
    if kernel is not None:
        want[kernel] = len(res.state.model.couplings)  # 16 at the flagship
    check(per_step == want, f"pretrain {name}: launches a step in the graph {per_step} == {want}")
    check(all(math.isfinite(r[k]) for r in rows for k in ("loss", "z_loss", "y_loss",
                                                          "detJ_loss")),
          f"pretrain {name}: finite losses")
    check(os.path.exists(os.path.join(outdir, "conditioned_weights.npz")),
          f"pretrain {name}: conditioned_weights.npz written")
    phases.done(f"pretrain {name}: cnf-pretrain-noise", seconds=f"{run_s:.2f}")

    g = torch.Generator(device="cuda").manual_seed(5)
    stack = torch.randn((PRETRAIN_INNER, PRETRAIN_BATCH, 28, 28, 2), generator=g, device="cuda")
    call_walls = walls(lambda: res.train_step(res.state, stack), 3)
    prof = kernel_breakdown(lambda: res.train_step(res.state, stack), top=6)
    step_ms = statistics.median(call_walls) * 1e3 / PRETRAIN_INNER
    line = dict(
        lowering=name, flags=flags, batch=PRETRAIN_BATCH, batches_an_epoch=PRETRAIN_BATCHES,
        run_s=run_s, epoch_seconds=[r["seconds"] for r in rows],
        epoch_samples_per_s=[PRETRAIN_BATCH * PRETRAIN_BATCHES / r["seconds"] for r in rows],
        losses=[r["loss"] for r in rows],
        graph_step_ms=step_ms, graph_samples_per_s=PRETRAIN_BATCH / (step_ms / 1e3),
        busy_ms_a_step=prof["device_busy_ms"] / PRETRAIN_INNER,
        busy_share=prof["device_busy_ms"] / (step_ms * PRETRAIN_INNER),
        launches_a_step=prof["kernel_launches"] / PRETRAIN_INNER,
        port_kernel_launches_a_step=per_step,
        profiled_port_kernel_launches_a_step={k: v / PRETRAIN_INNER for k, v in
                                              prof["port_kernel_launches"].items()},
        chain_kernel_share=prof["chain_kernel_share"],
        coupling_kernel_share=prof["coupling_kernel_share"], conv_share=prof["conv_share"],
        max_memory_allocated_gb=peak_gb, top=prof["top"],
    )
    print("[pretrain] " + json.dumps(line), flush=True)
    phases.done(f"pretrain {name}: timing and profile")
    del res
    return line


def check_pretrain(phases):
    """[pretrain]: cnf-pretrain-noise under the three lowerings (K3 and K1
    16 times a step at batch 512, counted at the capture), then cnf-conv on
    the class workload from the pallas_subnet run's weights, and the same
    weights refused under another arch."""
    from arl_conditional_normalizing_flows_tpu_torch.drivers import conv as cnf_conv

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags, kernel in PRETRAIN_RUNS:
            out[name] = pretrain_lowering(name, flags, kernel, tmp, phases)
        npz = os.path.join(tmp, "pallas_subnet", "conditioned_weights.npz")
        load = ["--model-type", "class", "--dataset", "synthetic", "--synthetic-per-class",
                "256", "--fused-subnet", "--annealing-epochs", "0", "--scan-steps", "16",
                "--checkpoint-every", "0", "--eval-samples", "16", "--load", npz]
        torch.cuda.empty_cache()
        t = time.perf_counter()
        cnf_conv.main(load + ["--epochs", "1", "--outdir", os.path.join(tmp, "conv")])
        rows = history_rows(os.path.join(tmp, "conv"))
        check(len(rows) == 1 and all(math.isfinite(r[k]) for r in rows
                                     for k in ("loss", "val_loss")),
              "pretrain: cnf-conv --load of the pre-trained weights trains with finite losses")
        out["conv_load"] = dict(seconds=time.perf_counter() - t, rows=rows)
        try:
            cnf_conv.main(load + ["--epochs", "1", "--res-blocks", "2", "2", "2", "2",
                                  "--outdir", os.path.join(tmp, "mismatch")])
        except ValueError as e:
            refused = "arch" in str(e)
        else:
            refused = False
        check(refused, "pretrain: cnf-conv --load under another arch (--res-blocks 2 2 2 2) "
              "raises on the arch string")
    print("[pretrain] cnf-conv --load: " + json.dumps(out["conv_load"]), flush=True)
    phases.done("pretrain: cnf-conv from the pre-trained weights, and a mismatched arch")
    return out


#: [toy]: cnf-toy at the reference defaults (24 layers, width 32, 6 dense
#: layers, batch 1000, 10 batches a class, lr 1e-4); eager, graphed, the
#: mixed shapes, the continuous sectors, and a --load
TOY_CRESCENTS = ["--dataset", "crescents", "--annealing-epochs", "1", "--epochs", "2"]
TOY_ONE_EPOCH = ["--annealing-epochs", "0", "--epochs", "1"]
TOY_BATCH = 1000
TOY_INNER = 4
TOY_SERVE_DRAWS = 16


def finite_numbers(tree):
    """Every number in a JSON-like tree is finite."""
    if isinstance(tree, dict):
        return all(finite_numbers(v) for v in tree.values())
    if isinstance(tree, list):
        return all(finite_numbers(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def toy_run(name, flags, tmp, phases):
    """One cnf-toy run through ``main(argv)``: finite losses and a finite
    eval.json; returns (result, its line)."""
    from arl_conditional_normalizing_flows_tpu_torch.drivers import toy as cnf_toy

    outdir = os.path.join(tmp, name)
    t = time.perf_counter()
    res = cnf_toy.main(flags + ["--outdir", outdir])
    seconds = time.perf_counter() - t
    rows = history_rows(outdir)
    with open(os.path.join(outdir, "eval.json")) as f:
        report = json.load(f)
    check(all(math.isfinite(r[k]) for r in rows for k in ("loss", "z_loss", "y_loss",
                                                          "detJ_loss")),
          f"toy {name}: finite losses")
    check(finite_numbers(report), f"toy {name}: a finite eval.json")
    line = dict(run=name, seconds=seconds, epoch_seconds=[r["seconds"] for r in rows],
                losses=[r["loss"] for r in rows],
                eval={k: v for k, v in report.items() if k != "final"})
    print("[toy] " + json.dumps(line), flush=True)
    phases.done(f"toy {name}", seconds=f"{seconds:.2f}")
    return res, line


def toy_steps(model, phases):
    """Eager x-only-noise steps and graphed stacks of TOY_INNER at the
    reference batch from one model: wall a step, busy share and launches a
    step."""
    rng = np.random.default_rng(0)
    stack = torch.from_numpy(rng.normal(size=(TOY_INNER, TOY_BATCH, 3)).astype(np.float32)).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    state = create_train_state(model, 1e-4)
    train_step, _ = make_step_fns(model, noise_mode="x_only", x_d=2)
    multi = make_scan_train_step(model, TOY_INNER, noise_mode="x_only", x_d=2)

    def eager():
        for xy in stack:
            train_step(state, xy, g, 0.5)

    multi(state, stack, g, 0.5)  # the capture
    eager()
    graph_walls = walls(lambda: multi(state, stack, g, 0.5), 5)
    eager_walls = walls(eager, 5)
    graph_prof = kernel_breakdown(lambda: multi(state, stack, g, 0.5), top=4)
    eager_prof = kernel_breakdown(lambda: train_step(state, stack[0], g, 0.5), top=4)
    graph_ms = statistics.median(graph_walls) * 1e3 / TOY_INNER
    eager_ms = statistics.median(eager_walls) * 1e3 / TOY_INNER
    out = dict(batch=TOY_BATCH, graph_step_ms=graph_ms, graph_steps_per_s=1e3 / graph_ms,
               eager_step_ms=eager_ms, eager_steps_per_s=1e3 / eager_ms,
               graph_busy_ms_a_step=graph_prof["device_busy_ms"] / TOY_INNER,
               graph_busy_share=graph_prof["device_busy_ms"] / (graph_ms * TOY_INNER),
               graph_launches_a_step=graph_prof["kernel_launches"] / TOY_INNER,
               eager_busy_ms_a_step=eager_prof["device_busy_ms"],
               eager_busy_share=eager_prof["device_busy_ms"] / eager_ms,
               eager_launches_a_step=eager_prof["kernel_launches"],
               port_kernel_launches_a_step=multi.launches)
    check(all(v == 0 for v in multi.launches.values()),
          f"toy: a step launches no port kernel, as JAX's toy reaches no Pallas kernel "
          f"({multi.launches})")
    print("[toy] steps " + json.dumps(out), flush=True)
    phases.done("toy: eager and graphed steps")
    return out


def check_toy_model(model, tmp, phases):
    """The trained toy model in float32 against the same weights on the CPU
    at the reference batch (forward, inverse, log_loss), forward(inverse(zy))
    == zy, and a seeded multidraw artifact: graphed call == eager entry ==
    saved and reloaded artifact, bit for bit."""
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

    cpu = ToyCINN(model.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(1)
    xy = torch.from_numpy(rng.normal(size=(TOY_BATCH, 3)).astype(np.float32))
    zy_in = torch.from_numpy(rng.normal(size=(TOY_BATCH, 3)).astype(np.float32))
    with torch.no_grad():
        zy_g, ld_g = model(xy.cuda())
        zy_c, ld_c = cpu(xy)
        x_g, x_c = model.inverse(zy_in.cuda()), cpu.inverse(zy_in)
        loss_g, loss_c = model.log_loss(xy.cuda()), cpu.log_loss(xy)
        back, _ = model(x_g)
    errs = dict(zy=(zy_g.cpu() - zy_c).abs().max().item(),
                log_det=(ld_g.cpu() - ld_c).abs().max().item(),
                inverse=(x_g.cpu() - x_c).abs().max().item(),
                loss=max(abs(loss_g[k].item() - loss_c[k].item()) for k in loss_c),
                round_trip=(back.cpu() - zy_in).abs().max().item())
    # float32 sums in other orders on the two devices (TF32 off) through 24
    # couplings; a round trip in float32
    print(f"[toy] card vs CPU at float32, batch {TOY_BATCH}: {json.dumps(errs)} (tolerance "
          "1e-4 abs + 1e-4 rel on zy, log-det and inverse, 1e-4 abs + 1e-5 rel on the "
          "losses, 1e-4 on the round trip)", flush=True)
    check(torch.allclose(zy_g.cpu(), zy_c, rtol=1e-4, atol=1e-4), "toy: card vs CPU zy")
    check(torch.allclose(ld_g.cpu(), ld_c, rtol=1e-4, atol=1e-4), "toy: card vs CPU log-det")
    check(torch.allclose(x_g.cpu(), x_c, rtol=1e-4, atol=1e-4), "toy: card vs CPU inverse")
    check(all(abs(loss_g[k].item() - loss_c[k].item()) <= 1e-4 + 1e-5 * abs(loss_c[k].item())
              for k in loss_c), "toy: card vs CPU log_loss")
    check(errs["round_trip"] <= 1e-4, "toy: forward(inverse(zy)) == zy")

    fn = make_toy_serving_fn(model, 2)
    art = export_seeded_multidraw_sampler(fn, TOY_SERVE_DRAWS, (2,), (1,))
    y = torch.linspace(-1.0, 1.0, TOY_BATCH, device="cuda").view(TOY_BATCH, 1)
    t = time.perf_counter()
    first = art.call(SERVE_SEED, y)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    eager = make_seeded_multidraw_fn(art.fn, TOY_SERVE_DRAWS, (2,))(SERVE_SEED, y)
    path = os.path.join(tmp, "toy_seeded.pt")
    save_artifact(path, art, metadata={"model": "toy"})
    loaded = load_artifact(path)
    check(first.shape == (TOY_SERVE_DRAWS, TOY_BATCH, 3) and torch.equal(first, eager),
          "toy: the graphed artifact call is bit-equal to the eager entry")
    check(torch.equal(loaded.call(SERVE_SEED, y), first),
          "toy: the saved and loaded artifact gives the same bytes")
    call_ms = statistics.median(walls(lambda: art.call(SERVE_SEED, y), 5)) * 1e3
    out = dict(errors=errs, artifact=dict(draws=TOY_SERVE_DRAWS, conditions=TOY_BATCH,
                                          capture_s=capture_s, call_ms=call_ms,
                                          samples_per_s=TOY_SERVE_DRAWS * TOY_BATCH
                                          / (call_ms / 1e3)))
    print("[toy] artifact " + json.dumps(out["artifact"]), flush=True)
    phases.done("toy: card vs CPU, round trip, artifact")
    return out


def check_toy(phases):
    """[toy]: cnf-toy on crescents eagerly and through graphed stacks, the
    mixed shapes and the continuous sectors, a --load that restores the layer
    order; then the trained model against the CPU, its artifact, and its
    steps timed. No port kernel launches anywhere on the toy path."""
    from arl_conditional_normalizing_flows_tpu_torch.train import load_npz_extras

    out = {}
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        res, out["crescents_eager"] = toy_run("crescents_eager", TOY_CRESCENTS, tmp, phases)
        _, out["crescents_graphed"] = toy_run(
            "crescents_graphed", TOY_CRESCENTS + ["--scan-steps", str(TOY_INNER)], tmp, phases)
        _, out["mixed"] = toy_run("mixed", ["--dataset", "mixed"] + TOY_ONE_EPOCH, tmp, phases)
        _, out["continuous_sectors"] = toy_run(
            "continuous_sectors", ["--dataset", "continuous_sectors"] + TOY_ONE_EPOCH, tmp,
            phases)
        saved = os.path.join(tmp, "crescents_eager", "weights.npz")
        _, out["load"] = toy_run("load", ["--seed", "1", "--load", saved] + TOY_ONE_EPOCH,
                                 tmp, phases)
        order = load_npz_extras(saved)["mask_indices"]
        check(np.array_equal(load_npz_extras(os.path.join(tmp, "load", "weights.npz"))
                             ["mask_indices"], order),
              "toy: --load restores the saved layer order under another seed")
        check(all(v == 0 for v in launch_counts().values()),
              f"toy: cnf-toy launched no port kernel ({launch_counts()})")
        out["model"] = check_toy_model(res.state.model, tmp, phases)
    out["steps"] = toy_steps(res.state.model, phases)
    return out


#: [records]: the streamed record path of cnf-conv (the reference's TFRecord
#: training, create_tfrecords.py:54-67, conv_cINN_base_functions.py:26-65) at
#: the flagship arch on an MNIST-scale class set: synthetic digits, 6,000
#: train and 1,000 test images a class, classes 0-3 (24,000 train images,
#: 75 MB of float32 records), 46 class-pure batches of 128 a class, 184
#: batches, 11 graphed stacks of 16
RECORDS_CLASSES = ("0", "1", "2", "3")
RECORDS_TRAIN, RECORDS_TEST = 6000, 1000
RECORDS_FLAGS = ["--batch-size", "128", "--experimental-lowering", "pallas_coupling", "--dtype",
                 "bfloat16", "--fused-subnet", "--scan-steps", "16", "--epochs", "1",
                 "--annealing-epochs", "0", "--data-classes", *RECORDS_CLASSES]
RECORDS_INNER = 16
#: batches of the streaming sources held against the in-RAM ones, bit for bit
PARITY_BATCHES = 32
#: losses of the streamed and in-RAM runs: the same batches through the same
#: graph (pallas_coupling's graph equals eager steps bit for bit, [train]);
#: 1e-5 relative allows a float32 reduction in another order
RECORDS_LOSS_RTOL = 1e-5


def first_batches(src, generator, n):
    out = []
    it = src.epoch(generator)
    for xy in it:
        out.append(xy)
        if len(out) == n:
            break
    it.close()  # stops and reaps a streaming source's prefetch thread
    return out


def records_parity(cnf_conv, args_for, phases):
    """Item 3: one CUDA generator state, cloned; the in-RAM and the streaming
    source of each workload each take one copy; their first batches held to
    each other."""
    out = {}
    for model_type in ("class", "SR4,2", "SR2,1"):
        args = args_for(model_type)
        batch = args.batch_size
        ram, _, _ = cnf_conv.make_source(args, "train", stream=False)
        stream, _, _ = cnf_conv.make_source(args, "train", stream=True)
        check(ram.num_batches == stream.num_batches and ram.xy_shape == stream.xy_shape,
              f"records {model_type}: the sources agree on batches and shape")
        n = min(PARITY_BATCHES, ram.num_batches)
        g = torch.Generator(device="cuda").manual_seed(11)
        twin_g = torch.Generator(device="cuda")
        twin_g.set_state(g.get_state())
        a, b = first_batches(ram, g, n), first_batches(stream, twin_g, n)
        err = max((x - y).abs().max().item() for x, y in zip(a, b))
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"[records] parity {model_type}: {n} batches of {batch}, streamed against "
              f"in-RAM from one generator state: max |diff| {err:.3g}, bit-equal {equal}",
              flush=True)
        check(len(a) == len(b) == n and equal,
              f"records {model_type}: the streaming source yields the in-RAM batches")
        stream.close()
        out[model_type] = dict(batches=n, batch=batch, max_abs_diff=err, bit_equal=equal)
    phases.done("records: schedule parity on the card")
    return out


def records_run(cnf_conv, name, flags, big, tmp, phases):
    """Item 4: cnf-conv on the MNIST-scale set through main(argv), then a
    fresh epoch of the same source, fetched a stack at a time and replayed
    through the run's own graph: the first stack untimed (the fresh
    generator recaptures the graph), the next all but one timed, the last
    profiled."""
    outdir = os.path.join(tmp, name)
    stream = "--no-stream-records" not in flags
    reset_launches()
    t = time.perf_counter()
    res = cnf_conv.main(RECORDS_FLAGS + ["--records-dir", big, "--outdir", outdir] + flags)
    run_s = time.perf_counter() - t
    launches = launch_counts()
    rows = history_rows(outdir)
    per_step = res.train_step.launches  # counted at the capture: what each replay launches
    couplings = len(res.state.model.couplings)
    check(per_step == {"affine_forward": couplings, "affine_inverse": 0, "fused_subnet": 0},
          f"records {name}: K1 launches {couplings} times a step in the graph ({per_step})")
    # the run's only inverse passes are the end-of-training sampling, one a class
    want_k2 = couplings * len(RECORDS_CLASSES)
    check(launches["affine_inverse"] == want_k2,
          f"records {name}: K2 launches {want_k2} times in the sampling ({launches})")
    check(len(rows) == 1 and all(math.isfinite(v) for k, v in rows[0].items()
                                 if k not in ("epoch", "alpha")),
          f"records {name}: one epoch, finite losses")
    phases.done(f"records {name}: cnf-conv", seconds=f"{run_s:.2f}")

    args = cnf_conv.build_parser().parse_args(RECORDS_FLAGS + ["--records-dir", big] + flags)
    check(args.eval_samples == RECORDS_SAMPLES,
          f"records {name}: K2 sampled at the {RECORDS_SAMPLES} rows [kernel] holds it at")
    src, _, _ = cnf_conv.make_source(args, "train", stream=stream)
    stacks = src.num_batches // RECORDS_INNER
    g = torch.Generator(device="cuda").manual_seed(1)
    it = epoch_stacks(src.epoch(g), RECORDS_INNER)

    def stack_step():
        res.train_step(res.state, next(it), g, 1.0)

    stack_step()
    torch.cuda.synchronize()
    stack_walls = walls(stack_step, stacks - 2)
    prof = kernel_breakdown(stack_step, top=4)
    it.close()
    stack_ms = statistics.median(stack_walls) * 1e3
    batch = int(args.batch_size)
    line = dict(
        run=name, reader=cnf_conv.records_reader(stream), run_s=run_s,
        batches_an_epoch=src.num_batches, stacks_an_epoch=stacks,
        epoch_s=rows[0]["seconds"],
        epoch_samples_per_s=stacks * RECORDS_INNER * batch / rows[0]["seconds"],
        stacks_timed=len(stack_walls), stack_ms_median=stack_ms,
        stack_ms_min=min(stack_walls) * 1e3, stack_ms_max=max(stack_walls) * 1e3,
        stack_ms_all=[round(w * 1e3, 3) for w in stack_walls],
        samples_per_s=RECORDS_INNER * batch / (stack_ms / 1e3),
        step_ms=stack_ms / RECORDS_INNER,
        stack_busy_ms=prof["device_busy_ms"], busy_share=prof["device_busy_ms"] / stack_ms,
        stack_launches=prof["kernel_launches"],
        k1_launches_a_step=per_step["affine_forward"],
        k2_launches_in_sampling=launches["affine_inverse"],
        wrapper_launches_in_run=launches, history=rows, top=prof["top"],
    )
    print("[records] " + json.dumps(line), flush=True)
    phases.done(f"records {name}: timing and profile")
    if stream:
        src.close()
    return line


def write_toy_reference(tmp):
    """Item 6: a reference-layout toy checkpoint at the reference defaults
    (24 layers, width 32, 6 dense layers): an object array of per-coupling
    get_weights() lists in Keras's graph-depth order (A and b Dense layers
    interleaved) and the layer order, from a seeded numpy draw."""
    from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (
        flax_from_state_dict,
    )
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import (
        ToyConfig,
        shuffle_mask_indices,
    )
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

    cfg = ToyConfig()
    rng = np.random.default_rng(0)
    model = ToyCINN(cfg, device="cpu")
    template = flax_from_state_dict(model.state_dict(), model)
    nl = cfg.num_layers + 2  # Dense layers a stack
    weights = np.empty(cfg.num_coupling_layers, dtype=object)
    for j in range(cfg.num_coupling_layers):
        dense = template[f"couplings_{j}"]
        flat = []
        for i in range(nl):  # A_i, then b_i
            for d in (dense[f"Dense_{nl + i}"], dense[f"Dense_{i}"]):
                flat += [(0.05 * rng.normal(size=d["kernel"].shape)).astype(np.float32),
                         (0.01 * rng.normal(size=d["bias"].shape)).astype(np.float32)]
        weights[j] = flat
    order = shuffle_mask_indices(rng, cfg.num_coupling_layers)
    wpath = os.path.join(tmp, "weights_crescents_NCL24_ID32_NL6.npy")
    mpath = os.path.join(tmp, "mask_indices_crescents_NCL24_ID32_NL6.npy")
    np.save(wpath, weights, allow_pickle=True)
    np.save(mpath, np.asarray(order))
    return wpath, mpath, order


def check_records(phases):
    """[records]: cnf-build-records (per-class and --combined, with the
    reference's TFRecords beside them, one read back through
    convert_to_cnfrec); the MNIST-scale class set; the streaming sources
    against the in-RAM ones on the card; cnf-conv streamed and in RAM
    through K1 at the flagship arch, batch 128; SR4,2 streamed; cnf-eval
    --records-dir; and cnf-import-reference toy, then cnf-toy --load of
    its weights."""
    from arl_conditional_normalizing_flows_tpu_torch.data import records, tfrecord_compat
    from arl_conditional_normalizing_flows_tpu_torch.drivers import build_records as cnf_build
    from arl_conditional_normalizing_flows_tpu_torch.drivers import conv as cnf_conv
    from arl_conditional_normalizing_flows_tpu_torch.drivers import evaluate as cnf_eval
    from arl_conditional_normalizing_flows_tpu_torch.drivers import import_reference
    from arl_conditional_normalizing_flows_tpu_torch.drivers import toy as cnf_toy
    from arl_conditional_normalizing_flows_tpu_torch.train import load_npz_extras

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        per_class, combined = os.path.join(tmp, "per_class"), os.path.join(tmp, "combined")
        build = ["--dataset", "synthetic", "--which-classes", *RECORDS_CLASSES, "--tfrecords"]
        t = time.perf_counter()
        cnf_build.main(build + ["--outdir", per_class])
        cnf_build.main(build + ["--combined", "--outdir", combined])
        back = os.path.join(tmp, "back.cnfrec")
        tfrecord_compat.convert_to_cnfrec(
            os.path.join(per_class, "x_train_synthetic_c0.tfrecords"), back)
        a = records.read_records(back, verify=True)
        b = records.read_records(records.class_file(per_class, "train", 0), verify=True)
        check(a.shape == b.shape and a.tobytes() == b.tobytes()
              and records.read_header(back)["label"] == 0,
              "records: a .tfrecords file read back through convert_to_cnfrec is bit-equal to "
              "its .cnfrec")
        phases.done("records: cnf-build-records, per-class and --combined, with --tfrecords",
                    seconds=f"{time.perf_counter() - t:.2f}")

        big = os.path.join(tmp, "mnist_scale")
        t = time.perf_counter()
        for split, n, seed in (("train", RECORDS_TRAIN, 0), ("test", RECORDS_TEST, 1)):
            x, y = synthetic_digits(num_per_class=n, seed=seed)
            records.write_class_sorted_dataset(big, split, x, y, [int(c) for c in RECORDS_CLASSES],
                                               combined=False)
        nbytes = sum(os.path.getsize(os.path.join(big, f)) for f in os.listdir(big))
        phases.done("records: the MNIST-scale class set written",
                    seconds=f"{time.perf_counter() - t:.2f}", mb=f"{nbytes / 1e6:.1f}")

        def args_for(model_type):
            if model_type == "class":
                return cnf_conv.build_parser().parse_args(RECORDS_FLAGS + ["--records-dir", big])
            return cnf_conv.build_parser().parse_args(["--model-type", model_type,
                                                       "--records-dir", combined])

        out["parity"] = records_parity(cnf_conv, args_for, phases)
        torch.cuda.empty_cache()
        out["streamed"] = records_run(cnf_conv, "streamed", [], big, tmp, phases)
        torch.cuda.empty_cache()
        out["in_ram"] = records_run(cnf_conv, "in_ram", ["--no-stream-records"], big, tmp,
                                    phases)
        worst = 0.0
        for r, s in zip(out["streamed"]["history"], out["in_ram"]["history"]):
            for k, v in s.items():
                if k not in ("seconds", "epoch", "alpha"):
                    worst = max(worst, abs(r[k] - v) / max(abs(v), 1e-30))
        equal = all({k: v for k, v in r.items() if k != "seconds"}
                    == {k: v for k, v in s.items() if k != "seconds"}
                    for r, s in zip(out["streamed"]["history"], out["in_ram"]["history"]))
        print(f"[records] streamed against in-RAM loss histories: worst relative difference "
              f"{worst:.3g} (tolerance {RECORDS_LOSS_RTOL:g}), bit-equal {equal}", flush=True)
        check(worst <= RECORDS_LOSS_RTOL, "records: streamed and in-RAM runs, equal losses")
        out["histories_bit_equal"], out["histories_worst_rel"] = equal, worst
        torch.cuda.empty_cache()

        sr = os.path.join(tmp, "sr42")
        t = time.perf_counter()
        cnf_conv.main(["--model-type", "SR4,2", "--records-dir", combined, "--squeeze-factor",
                       "0", "0", "0", "0", "--res-blocks", "1", "1", "1", "1", "--epochs", "1",
                       "--annealing-epochs", "0", "--checkpoint-every", "0", "--eval-samples",
                       "16", "--outdir", sr])
        rows = history_rows(sr)
        check(len(rows) == 1 and all(math.isfinite(rows[0][k]) for k in ("loss", "val_loss")),
              "records: SR4,2 streamed from the combined file, finite losses")
        out["sr42"] = dict(seconds=time.perf_counter() - t, rows=rows)
        phases.done("records: cnf-conv SR4,2 streamed", seconds=f"{out['sr42']['seconds']:.2f}")

        t = time.perf_counter()
        report = cnf_eval.main(["--checkpoint-dir", os.path.join(tmp, "streamed", "checkpoints"),
                                "--records-dir", big, "--data-classes", *RECORDS_CLASSES,
                                "--batch-size", "128", "--eval-samples",
                                str(RECORDS_EVAL_SAMPLES)])
        check(report["epoch"] == 0 and math.isfinite(report["bits_per_dim"])
              and set(report["sampling"]["per_class"]) == set(RECORDS_CLASSES),
              "records: cnf-eval --records-dir restored epoch 0, finite bits/dim")
        out["eval"] = dict(seconds=time.perf_counter() - t, bits_per_dim=report["bits_per_dim"],
                           loss=report["loss"])
        phases.done("records: cnf-eval --records-dir", seconds=f"{out['eval']['seconds']:.2f}")

        wpath, mpath, order = write_toy_reference(tmp)
        npz = os.path.join(tmp, "toy_imported.npz")
        import_reference.main(["toy", "--weights", wpath, "--mask-indices", mpath,
                               "--output", npz])
        toy_out = os.path.join(tmp, "toy")
        t = time.perf_counter()
        cnf_toy.main(["--load", npz, "--epochs", "1", "--annealing-epochs", "0",
                      "--outdir", toy_out])
        with open(os.path.join(toy_out, "eval.json")) as f:
            toy_report = json.load(f)
        check(tuple(int(i) for i in load_npz_extras(npz)["mask_indices"]) == order
              and tuple(int(i) for i in load_npz_extras(os.path.join(toy_out, "weights.npz"))
                        ["mask_indices"]) == order,
              "records: the imported toy weights carry the reference's layer order through "
              "cnf-toy --load")
        check(finite_numbers(toy_report), "records: cnf-toy --load of imported weights, a "
              "finite eval.json")
        out["toy_import"] = dict(seconds=time.perf_counter() - t,
                                 loss=toy_report["final"]["loss"])
        phases.done("records: cnf-import-reference toy, then cnf-toy --load",
                    seconds=f"{out['toy_import']['seconds']:.2f}")
    print("[records] " + json.dumps({k: out[k] for k in ("parity", "sr42", "eval",
                                                           "toy_import")}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    phases = Phases()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card_line(), flush=True)
    print(f"[device] {kind} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    # every float32 reference in full float32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phases.done("device", tf32="off")

    names = ("affine_coupling", "fused_subnet")
    cached = {n: build.library_path(n).is_file() for n in names}
    t = time.perf_counter()
    build.load_libraries(*names)
    phases.done("build", seconds=f"{time.perf_counter() - t:.2f}",
                nvcc=build.nvcc_path(), cached=json.dumps(cached))
    sass = sass_summary()
    check(any(v["hmma"] + v["hgmma"] > 0 for k, v in sass.items() if "mma_kernel" in k),
          "the bf16 conv-chain kernel runs its products on the tensor cores")
    phases.done("SASS of the conv-chain kernels")

    results, floor_ms = check_kernels(phases)
    check_chain_small(phases)
    subnet_model = ConvCFlow(FLAGSHIP_SUBNET, seed=0)  # no device: the card
    phases.done("flagship built", arch=arch_string(FLAGSHIP),
                params=sum(p.numel() for p in subnet_model.parameters()))
    chain_results, chain_serving, chain_pretrain, chain_pass = check_chain_kernel(
        chain_specs(subnet_model), phases)

    coupling_model = ConvCFlow(FLAGSHIP, seed=0)
    launches = run_main_path(coupling_model, FLAGSHIP, phases)
    chain_launches = run_main_path(subnet_model, FLAGSHIP_SUBNET, phases)
    grads = check_grads(coupling_model, subnet_model, phases)
    del coupling_model, subnet_model
    torch.cuda.empty_cache()
    train = check_train(phases)
    torch.cuda.empty_cache()
    serve = check_serve(phases)
    cli = check_cli(phases)
    torch.cuda.empty_cache()
    pretrain = check_pretrain(phases)
    torch.cuda.empty_cache()
    toy = check_toy(phases)
    torch.cuda.empty_cache()
    recs = check_records(phases)

    entries = []
    for name, k in KERNELS.items():
        t784 = results[name]["timings"][784]
        entries.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=k["replaces"],
            launches=launches[name], max_abs_err=results[name]["max_abs_err"],
            ms=t784["ms"], plain_ms=t784["plain_ms"], bound_ms=t784["bound_ms"],
            bound_by=t784["bound_by"], library_ms=None, floor_ms=floor_ms,
            shape=[BATCH, 784], dtype="float32",
            ms_at_392=results[name]["timings"][392]["ms"],
            plain_ms_at_392=results[name]["timings"][392]["plain_ms"],
            bound_ms_at_392=results[name]["timings"][392]["bound_ms"],
            at_serving_batch={n: results[name]["serving_timings"][n] for n in (784, 392)},
            at_pretrain_batch={n: results[name]["pretrain_timings"][n] for n in (784, 392)},
        ))
    # K3's main keys are those of its largest spec; every spec is listed
    largest = max(chain_results, key=lambda r: r["gflop"])
    entries.append(dict(
        name="fused_subnet", route="cuda", source=CHAIN_SOURCE, replaces=CHAIN_REPLACES,
        launches=chain_launches["fused_subnet"],
        max_abs_err=max(r["max_abs_err"] for r in chain_results),
        ms=largest["ms"], plain_ms=largest["plain_ms"], bound_ms=largest["bound_ms"],
        bound_by=largest["bound_by"], library_ms=None, floor_ms=floor_ms,
        shape=largest["shape"], dtype="bfloat16", eager_chain_ms=largest["eager_chain_ms"],
        achieved_tflops=largest["achieved_tflops"], bound_share=largest["bound_share"],
        max_abs_err_f32=max(r["max_abs_err_f32"] for r in chain_results),
        pass_ms=chain_pass["ms"], eager_pass_ms=chain_pass["eager_chain_ms"],
        specs=chain_results, specs_at_serving_batch=chain_serving,
        pass_ms_at_serving_batch=chain_pass["serving_ms"],
        at_pretrain_batch=chain_pretrain,
        pass_ms_at_pretrain_batch=chain_pass["pretrain_ms"],
        grad_f32=grads["pallas_subnet_f32"], grad_cpu=grads["pallas_subnet_cpu"],
    ))
    entries[0]["grad"] = grads["pallas_coupling"]
    # launches a training step inside the CUDA-graph replays (counted at the
    # capture)
    entries[0]["launches_a_train_step"] = train["pallas_coupling"][
        "graph_port_kernel_launches_a_step_at_capture"]["affine_forward"]
    entries[1]["launches_a_train_step"] = train["pallas_coupling"][
        "graph_port_kernel_launches_a_step_at_capture"]["affine_inverse"]
    entries[2]["launches_a_train_step"] = train["pallas_subnet"][
        "graph_port_kernel_launches_a_step_at_capture"]["fused_subnet"]
    # launches a seeded serving call (16 draws x 128) inside the CUDA-graph
    # replay (counted at the capture)
    entries[0]["launches_a_serving_call"] = serve["pallas_coupling"][
        "port_kernel_launches_a_call"]["affine_forward"]
    entries[1]["launches_a_serving_call"] = serve["pallas_coupling"][
        "port_kernel_launches_a_call"]["affine_inverse"]
    entries[2]["launches_a_serving_call"] = serve["pallas_subnet"][
        "port_kernel_launches_a_call"]["fused_subnet"]
    # launches a cnf-pretrain-noise step at batch 512 inside the CUDA-graph
    # replays (counted at the capture)
    entries[0]["launches_a_pretrain_step"] = pretrain["pallas_coupling"][
        "port_kernel_launches_a_step"]["affine_forward"]
    entries[1]["launches_a_pretrain_step"] = pretrain["pallas_coupling"][
        "port_kernel_launches_a_step"]["affine_inverse"]
    entries[2]["launches_a_pretrain_step"] = pretrain["pallas_subnet"][
        "port_kernel_launches_a_step"]["fused_subnet"]
    # the streamed records run: K1's launches a step of its graph (counted at
    # the capture), K2's in its end-of-training sampling
    entries[0]["launches_a_records_step"] = recs["streamed"]["k1_launches_a_step"]
    entries[1]["launches_a_records_sampling"] = recs["streamed"]["k2_launches_in_sampling"]
    print(f"[summary] pretrain step ms: "
          f"{json.dumps({k: v['graph_step_ms'] for k, v in pretrain.items() if k != 'conv_load'})}"
          f"; toy steps/s graphed {toy['steps']['graph_steps_per_s']:.1f}, eager "
          f"{toy['steps']['eager_steps_per_s']:.1f}", flush=True)
    print(f"[summary] serve samples/s a call: "
          f"{json.dumps({k: v['samples_per_s'] for k, v in serve.items()})}; "
          f"cli: {json.dumps({k: v.get('seconds', v.get('first_s')) for k, v in cli.items()})}",
          flush=True)
    print(f"[summary] records samples/s, streamed {recs['streamed']['samples_per_s']:.1f} "
          f"(busy share {recs['streamed']['busy_share']:.3f}), in RAM "
          f"{recs['in_ram']['samples_per_s']:.1f} (busy share "
          f"{recs['in_ram']['busy_share']:.3f})", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
