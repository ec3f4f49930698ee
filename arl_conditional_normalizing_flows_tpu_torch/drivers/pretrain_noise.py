"""Noise pre-training driver, ``cnf-pretrain-noise`` (port of the JAX
``drivers/pretrain_noise.py``; the reference's
conv_pre_training_cINN_on_noise.py as a CLI).

Warm-starts a conv cINN on pure N(0,1) xy data so that the model learns
identity-on-y and a Gaussian z first (README.md:92-98 of the reference);
``cnf-conv --load <outdir>/conditioned_weights.npz`` then trains it on real
data. The architecture MUST match the later run exactly: the weights carry
their arch string (``__extra__arch``), which ``cnf-conv --load`` checks
(conv_pre_training_cINN_on_noise.py:47-60).

Reference defaults: the flagship arch, 20 batches of 512 an epoch, lr 3e-4,
100 epochs, early stopping with patience 10 on the train loss, the
shared-shape init (conv_pre_training_cINN_on_noise.py:24-29).

Runs on the CUDA card, or on the CPU with ``--cpu``; without a card and
without ``--cpu`` it raises. ``--scan-steps N`` trains through
``make_scan_train_step`` (on the card, one train step captured as a CUDA
graph and replayed N times a call). The multi-host flags and the
fused_dilated and dense_groups lowerings exit with the ROADMAP item that
will bring them. The noise comes from one ``torch.Generator`` on the run's
device seeded with ``--seed``.

Example:
    python -m arl_conditional_normalizing_flows_tpu_torch.drivers.pretrain_noise \\
        --fused-subnet --scan-steps 4 --outdir /tmp/noise
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=28)
    p.add_argument("--width", type=int, default=28)
    p.add_argument("--xy-depth", type=int, default=2)
    p.add_argument("--x-d", type=int, default=1)
    p.add_argument("--squeeze-factor", type=int, nargs="*", default=[0, 1, 0, 0])
    p.add_argument("--res-blocks", type=int, nargs="*", default=[3, 3, 3, 3])
    p.add_argument("--kernels", type=int, nargs="*", default=[64, 64, 32, 32])
    p.add_argument("--cardinality", type=int, nargs="*", default=[8, 8, 4, 4])
    p.add_argument("--ksize", type=int, default=3)
    p.add_argument("--no-dilations", dest="dilations", action="store_false", default=True)
    p.add_argument("--layer-norm", action="store_true")
    p.add_argument("--fused-subnet", action="store_true",
                   help="one two-headed A/b subnet per coupling")
    p.add_argument("--shared-init", dest="shared_init", action="store_true", default=True,
                   help="reference-faithful shared-shape init, the driver's default (must "
                   "match the main run's init mode); the pallas_subnet lowering needs "
                   "--no-shared-init")
    p.add_argument("--no-shared-init", dest="shared_init", action="store_false",
                   help="independent orthogonal draws per kernel")
    p.add_argument("--experimental-lowering", default=None,
                   choices=["pallas_coupling", "fused_dilated", "dense_groups",
                            "pallas_subnet"],
                   help="another lowering of the same math: pallas_coupling (the "
                   "coupling-law kernels) or pallas_subnet (the conv-chain kernel); "
                   "fused_dilated and dense_groups are not ported yet (ROADMAP A.12)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--num-batches", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--outdir", default="noise_pretrain")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard batches over devices (not ported yet: ROADMAP A.10)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator (not ported yet: ROADMAP A.10)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host process count (not ported yet: ROADMAP A.10)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host rank (not ported yet: ROADMAP A.10)")
    p.add_argument("--scan-steps", type=int, default=0,
                   help="N optimizer steps a call (train.make_scan_train_step; on the "
                   "card one captured CUDA graph of the step replayed N times); a "
                   "trailing partial group an epoch is dropped. 0 disables")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from arl_conditional_normalizing_flows_tpu_torch.drivers.conv import refuse_unported

    refuse_unported(args)
    from arl_conditional_normalizing_flows_tpu_torch.device import resolve_device
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import (
        ConvFlowConfig,
        arch_string,
    )
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow, check_ported
    from arl_conditional_normalizing_flows_tpu_torch.train import (
        CheckpointManager,
        HistoryLogger,
        create_train_state,
        epoch_stacks,
        fit,
        make_scan_train_step,
        make_step_fns,
        noise_batches,
        save_params_npz,
    )
    from arl_conditional_normalizing_flows_tpu_torch.utils import write_run_metadata

    device = resolve_device("cpu" if args.cpu else None)
    cfg = ConvFlowConfig(
        io_shape=(args.height, args.width, args.xy_depth),
        x_d=args.x_d,
        squeeze_factor_blocks=tuple(args.squeeze_factor),
        res_blocks=tuple(args.res_blocks),
        num_kernels=tuple(args.kernels),
        cardinality=tuple(args.cardinality),
        ksize=args.ksize,
        dilations=args.dilations,
        layer_norm=args.layer_norm,
        fused_subnet=args.fused_subnet,
        compute_dtype=args.dtype,
        experimental_lowering=args.experimental_lowering,
        ref_compat_shared_init=args.shared_init,
    )
    try:
        check_ported(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"--experimental-lowering/--dtype: {e}") from e
    os.makedirs(args.outdir, exist_ok=True)
    write_run_metadata(args.outdir, args, device, extra={"arch": arch_string(cfg)})
    model = ConvCFlow(cfg, device=device, seed=args.seed)
    print("arch:", arch_string(cfg), "device:", device, flush=True)
    state = create_train_state(model, args.lr, seed=args.seed)
    shape = cfg.io_shape

    def data_epoch(g, epoch):
        return noise_batches(g, args.num_batches, args.batch_size, shape)

    if args.scan_steps > 1:
        if args.num_batches < args.scan_steps:
            raise ValueError(f"--scan-steps {args.scan_steps} exceeds the {args.num_batches} "
                             "batches an epoch: every epoch would be empty")
        train_step = make_scan_train_step(model, args.scan_steps, noise_mode="none")

        def feed(g, epoch):
            return epoch_stacks(data_epoch(g, epoch), args.scan_steps)
    else:
        train_step, _ = make_step_fns(model, noise_mode="none")
        feed = data_epoch

    history = HistoryLogger(csv_path=os.path.join(args.outdir, "history.csv"),
                            jsonl_path=os.path.join(args.outdir, "history.jsonl"))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    res = fit(state, train_step, feed, generator=generator, num_epochs=args.epochs,
              patience=args.patience, history=history)
    if res.completed_epochs > 0:
        mgr = CheckpointManager(os.path.join(args.outdir, "checkpoints"), config=cfg)
        mgr.save(res.completed_epochs - 1, res.state, generator)
    # the arch identity rides WITH the weights: the reference encodes it in
    # the file name as the pre-training -> training contract
    # (conv_pre_training_cINN_on_noise.py:47-48, README.md:98)
    save_params_npz(os.path.join(args.outdir, "conditioned_weights.npz"), model,
                    extra={"arch": np.asarray(arch_string(cfg))})
    final = history.rows[-1] if history.rows else {}
    print(json.dumps(final, indent=2), flush=True)
    return res


def cli():
    """Console-script entry: discard the return value so that
    ``sys.exit(main())`` does not print it and exit non-zero."""
    main()
    return 0


if __name__ == "__main__":
    cli()
