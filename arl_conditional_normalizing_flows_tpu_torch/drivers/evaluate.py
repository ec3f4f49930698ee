"""Checkpoint evaluation CLI, ``cnf-eval``, for conv models (port of the JAX
``drivers/evaluate.py``).

Restores a checkpoint directory written by this package's ``cnf-conv`` (the
architecture comes from its ``arch.json``) and computes, without training:

- the validation joint-NLL components and bits/dim;
- latent-normality statistics of the encoded validation set, from the same
  forward pass (``log_loss_with_latent``);
- conditional-sampling moments;

on the test split of ``--dataset`` or of the ``.cnfrec`` files in
``--records-dir``; and, on request, writes serving artifacts
(``serve.export``): the single-draw sampler (``--export-sampler``) and the
multidraw one (``--export-multidraw``). Runs on the card, or on the CPU with
``--cpu``.

Example:
    python -m arl_conditional_normalizing_flows_tpu_torch.drivers.evaluate \\
        --checkpoint-dir /tmp/run/checkpoints --dataset synthetic \\
        --export-multidraw /tmp/run/multidraw.pt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True,
                   help="checkpoint dir written by cnf-conv (contains arch.json)")
    p.add_argument("--model-type", default="class", choices=["class", "SR4,2", "SR2,1"])
    # cnf-conv's default, so that a checkpoint is scored on the
    # data it trained on (mnist is synthesised when no archive is cached)
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "fashion_mnist", "synthetic"])
    p.add_argument("--synthetic-per-class", type=int, default=128)
    p.add_argument("--data-classes", type=int, nargs="*", default=[0, 1, 2, 3])
    p.add_argument("--records-dir", default=None,
                   help="read the test split from pre-built .cnfrec files "
                   "(cnf-build-records) into RAM, as cnf-conv --no-stream-records does")
    p.add_argument("--logits", action="store_true", default=True)
    p.add_argument("--no-logits", dest="logits", action="store_false")
    p.add_argument("--residual", action="store_true", default=True)
    p.add_argument("--no-residual", dest="residual", action="store_false")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--eval-samples", type=int, default=64)
    p.add_argument("--plot", action="store_true",
                   help="sample-grid / SR-panel PNGs (not ported yet: ROADMAP A.9)")
    p.add_argument("--outdir", default=None, help="default: <checkpoint-dir>/..")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--export-sampler", default=None, metavar="PATH",
                   help="also write the single-draw serving artifact "
                   "(serve.export_sampler, any batch)")
    p.add_argument("--export-platforms", nargs="*", default=None, choices=["cuda", "cpu"],
                   help="platforms the artifacts are exported for (default: the "
                   "device this run uses); the file loads on any of them")
    p.add_argument("--export-multidraw", default=None, metavar="PATH",
                   help="also write the multidraw serving artifact: one call computes "
                   "(d, b) draws (serve.export_multidraw_sampler; d and b free)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from arl_conditional_normalizing_flows_tpu_torch.device import resolve_device
    from arl_conditional_normalizing_flows_tpu_torch.drivers import conv as conv_driver
    from arl_conditional_normalizing_flows_tpu_torch.evaluation import (
        bits_per_dim,
        latent_normality_stats,
    )
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow
    from arl_conditional_normalizing_flows_tpu_torch.train import (
        CheckpointManager,
        MeanMetrics,
        create_train_state,
    )
    from arl_conditional_normalizing_flows_tpu_torch.train.checkpoints import read_arch
    from arl_conditional_normalizing_flows_tpu_torch.train.metrics import LOSS_KEYS

    conv_driver.refuse_unported(args)
    device = resolve_device("cpu" if args.cpu else None)
    # the architecture comes from the checkpoint's own metadata
    cfg = read_arch(args.checkpoint_dir, ConvFlowConfig)
    val_src, _, _ = conv_driver.make_source(args, "test")
    if args.records_dir:
        print(f"records: {conv_driver.records_reader(False)} from {args.records_dir}",
              flush=True)
    h, w, xy_d = cfg.io_shape
    if tuple(val_src.xy_shape) != tuple(cfg.io_shape):
        raise ValueError(f"the data's xy shape {val_src.xy_shape} is not the checkpoint's "
                         f"{cfg.io_shape}")

    model = ConvCFlow(cfg, device=device)
    state = create_train_state(model, 1e-3)
    # create=False: a mistyped path raises instead of "restoring" an
    # untrained model
    mgr = CheckpointManager(args.checkpoint_dir, config=cfg, create=False)
    epoch, state = mgr.restore(state)
    print(f"restored epoch {epoch}", flush=True)

    if args.export_sampler or args.export_multidraw:
        from arl_conditional_normalizing_flows_tpu_torch.serve import (
            export_multidraw_sampler,
            export_sampler,
            make_image_serving_fn,
            save_artifact,
        )

        de_logit = args.model_type == "class" and args.logits
        residual = args.model_type != "class" and args.residual
        fn = make_image_serving_fn(model, cfg.x_d, de_logit=de_logit, residual=residual)
        meta = {"arch": dataclasses.asdict(cfg),
                "model_type": args.model_type, "epoch": int(epoch),
                "de_logit": de_logit, "residual": residual}
        z_shape, y_shape = (h, w, cfg.x_d), (h, w, xy_d - cfg.x_d)
        if args.export_sampler:
            art = export_sampler(fn, [z_shape, y_shape], platforms=args.export_platforms)
            side = save_artifact(args.export_sampler, art, metadata=meta)
            print(f"exported serving artifact: {args.export_sampler} ({side['nr_bytes']} "
                  f"bytes, platforms={side['platforms']})", flush=True)
        if args.export_multidraw:
            art = export_multidraw_sampler(fn, z_shape, y_shape,
                                           platforms=args.export_platforms)
            side = save_artifact(args.export_multidraw, art,
                                 metadata={**meta, "entry": "multidraw"})
            print(f"exported multidraw artifact: {args.export_multidraw} "
                  f"({side['nr_bytes']} bytes, platforms={side['platforms']})", flush=True)

    # one forward a batch: the loss components and the latent come from the
    # same pass
    metrics = MeanMetrics()
    zs = []
    with torch.inference_mode():
        for xy in val_src.epoch(torch.Generator(device=device).manual_seed(0)):
            out, zy = model.log_loss_with_latent(xy)
            metrics.update(dict(zip(LOSS_KEYS, torch.stack([out[k] for k in LOSS_KEYS])
                                    .tolist())))
            zs.append(zy[..., :cfg.x_d].cpu().numpy())
    row = metrics.result()
    report = {"epoch": int(epoch), "dataset": args.dataset, "model_type": args.model_type,
              **row}
    report["bits_per_dim"] = bits_per_dim(row["z_loss"] + row["detJ_loss"], h * w * cfg.x_d)
    report["latent_normality"] = latent_normality_stats(np.concatenate(zs))
    outdir = args.outdir or os.path.dirname(os.path.abspath(args.checkpoint_dir))
    os.makedirs(outdir, exist_ok=True)
    report["sampling"] = conv_driver.sampling_eval(args, model, val_src, cfg.x_d)
    with open(os.path.join(outdir, "checkpoint_eval.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2), flush=True)
    return report


def cli():
    main()
    return 0


if __name__ == "__main__":
    cli()
