"""Conv cINN training driver, ``cnf-conv`` (port of the JAX
``drivers/conv.py``; the reference's conv_cINN.py as a CLI).

Covers the three workloads (conv_cINN.py:28-30): class-conditional
generation ('class') and the two super-resolution stages ('SR4,2',
'SR2,1'), with the reference's default architecture (conv_cINN.py:56-96):
squeeze/factor [0,1,0,0], ResNeXt blocks [3,3,3,3], kernels [64,64,32,32],
cardinality [8,8,4,4], ksize 3, auto dilations, batch 32, lr 3e-4, patience
20, 100 annealing epochs, 400 clean epochs, the 2% noise floor, and the
shared-shape init.

Runs on the CUDA card, or on the CPU with ``--cpu``; without a card and
without ``--cpu`` it raises. ``--scan-steps N`` trains through
``make_scan_train_step`` (on the card, one train step captured as a CUDA
graph and replayed N times a call). ``--records-dir`` reads the ``.cnfrec``
files that ``cnf-build-records`` writes: streamed through the native loader
(``--stream-records``, the default: ``data/native_loader.py``, host memory
bounded by a few batches) or read into the in-RAM sources
(``--no-stream-records``); both give the same batches for the same seed.
``--plot`` writes the sample grids (needs matplotlib). Every
``--experimental-lowering`` runs, ``pallas_subnet`` at any width (the JAX
package's capacity preset: ``--kernels 128 128 128 128 --cardinality 8 8 8
8 --fused-subnet --dtype bfloat16``); ``pallas_subnet``, ``fused_dilated``
and ``dense_groups`` need ``--no-shared-init``: the shared-shape init
refuses them, as JAX's does.

Multi-process data parallel (JAX ``drivers/conv.py:90-98, 205-235,
343-378``): ``--coordinator host:port --num-processes N --process-id i`` in
each of N processes (NCCL on the cards, gloo with ``--cpu``), or
``--data-parallel`` in each process torchrun starts (alone: a group of
one). ``--batch-size`` stays per process, so the global batch is N times
it, class-pure across the processes (``epoch_distributed``); the gradients
are averaged every step inside the step's CUDA graph. With N > 1 there is
no checkpoint directory and ``--load`` takes a weights ``.npz`` only; in a
process group rank 0 writes ``weights.npz`` (with ``arch``); only rank 0
writes ``run.json``, ``history.*`` and ``eval.json`` and runs the sampling
eval.

Example:
    python -m arl_conditional_normalizing_flows_tpu_torch.drivers.conv \\
        --model-type class --dataset synthetic --epochs 50 --outdir /tmp/run
    torchrun --nproc-per-node 4 -m arl_conditional_normalizing_flows_tpu_torch.drivers.conv \\
        --data-parallel --dataset synthetic --outdir /tmp/run4

The data order and the noise come from one ``torch.Generator`` seeded with
``--seed``. Each checkpoint keeps the generator's state and a resumed run
restores it, so that the resumed epochs draw what an uninterrupted run's
would have (the JAX driver keys each epoch by its number instead).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from arl_conditional_normalizing_flows_tpu_torch.drivers.common import (
    add_distributed_flags,
    check_plot,
    distributed_run,
    run_placement,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-type", default="class", choices=["class", "SR4,2", "SR2,1"],
                   help="conv_cINN.py:28-30")
    p.add_argument("--dataset", default="mnist", choices=["mnist", "fashion_mnist", "synthetic"])
    p.add_argument("--synthetic-per-class", type=int, default=512,
                   help="train images per class for the synthetic dataset")
    p.add_argument("--data-classes", type=int, nargs="*", default=[0, 1, 2, 3],
                   help="conv_cINN.py:37")
    p.add_argument("--records-dir", default=None,
                   help="read pre-built .cnfrec files (cnf-build-records) instead of "
                   "raw arrays")
    p.add_argument("--stream-records", action="store_true", default=True,
                   help="stream batches from .cnfrec via the native loader with bounded "
                   "host memory (default); --no-stream-records reads the whole dataset "
                   "into RAM instead")
    p.add_argument("--no-stream-records", dest="stream_records", action="store_false")
    p.add_argument("--residual", action="store_true", default=True,
                   help="SR residual target (conv_cINN.py:45)")
    p.add_argument("--no-residual", dest="residual", action="store_false")
    p.add_argument("--logits", action="store_true", default=True,
                   help="discrete logit transform (conv_cINN.py:49)")
    p.add_argument("--no-logits", dest="logits", action="store_false")
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
                   help="reference-faithful shared-shape init "
                   "(ConvFlowConfig.ref_compat_shared_init), the cnf-conv default")
    p.add_argument("--no-shared-init", dest="shared_init", action="store_false",
                   help="independent orthogonal draws per kernel")
    p.add_argument("--experimental-lowering", default=None,
                   choices=["pallas_coupling", "fused_dilated", "dense_groups",
                            "pallas_subnet"],
                   help="another lowering of the same math: pallas_coupling (the "
                   "coupling-law kernels), pallas_subnet (the conv-chain kernel), "
                   "fused_dilated or dense_groups (the branch convs as masked dense "
                   "convs; with the shared init they need --no-shared-init)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--annealing-epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="epochs between checkpoints (conv_cINN.py:110)")
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load", default=None,
                   help="warm start: a weights .npz (either package's save_params_npz) "
                   "or a checkpoint directory of this package")
    p.add_argument("--outdir", default="conv_run")
    add_distributed_flags(p)
    p.add_argument("--scan-steps", type=int, default=0,
                   help="N optimizer steps a call (train.make_scan_train_step; on the "
                   "card one captured CUDA graph of the step replayed N times); a "
                   "trailing partial group an epoch is dropped. 0 disables")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--eval-samples", type=int, default=64,
                   help="conditional samples per condition for the final eval")
    p.add_argument("--plot", action="store_true",
                   help="sample-grid / SR-panel PNGs (class_samples.png / sr_panel.png; "
                   "needs matplotlib)")
    return p


def load_arrays(args, split):
    from arl_conditional_normalizing_flows_tpu_torch.data.images import (
        load_image_dataset,
        synthetic_digits,
    )

    if args.records_dir:
        return load_from_records(args, split)
    if args.dataset == "synthetic":
        n = (args.synthetic_per_class if split == "train"
             else max(32, args.synthetic_per_class // 4))
        return synthetic_digits(num_per_class=n, seed=0 if split == "train" else 1)
    return load_image_dataset(args.dataset, split)


def load_from_records(args, split):
    """(images, labels) of ``split`` read from the ``.cnfrec`` files in
    ``args.records_dir`` (the layout ``cnf-build-records`` writes): the
    per-class files for 'class'; for SR the combined file, else the per-class
    files concatenated."""
    from arl_conditional_normalizing_flows_tpu_torch.data import records

    split_name = "train" if split == "train" else "test"
    if args.model_type == "class":
        xs, ys = [], []
        for c in args.data_classes:
            arr = records.read_records(records.class_file(args.records_dir, split_name, int(c)))
            xs.append(arr)
            ys.append(np.full((len(arr),), int(c), np.int32))
        return np.concatenate(xs), np.concatenate(ys)
    path = records.combined_file(args.records_dir, split_name)
    if os.path.exists(path):
        arr = np.array(records.read_records(path))  # into RAM, writable
    else:
        arr = np.concatenate([
            records.read_records(records.class_file(args.records_dir, split_name, int(c)))
            for c in args.data_classes])
    return arr, np.zeros((len(arr),), np.int32)


def streaming_source(args, split):
    """(source, x_d, y_d) of ``split`` streamed from the ``.cnfrec`` files in
    ``args.records_dir`` through the native loader: per-class files for
    'class', the combined file for SR."""
    from arl_conditional_normalizing_flows_tpu_torch.data import records
    from arl_conditional_normalizing_flows_tpu_torch.data.native_loader import (
        StreamingClassSource,
        StreamingSRSource,
    )

    split_name = "train" if split == "train" else "test"
    if args.model_type == "class":
        paths = [records.class_file(args.records_dir, split_name, int(c))
                 for c in args.data_classes]
        src = StreamingClassSource(paths, args.data_classes, args.batch_size,
                                   use_logits=args.logits)
        return src, src.xy_shape[2] - 1, 1
    path = records.combined_file(args.records_dir, split_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SR streaming needs the combined records file {path} (cnf-build-records "
            "--combined); --no-stream-records reads the per-class files instead")
    src = StreamingSRSource(path, args.model_type, args.batch_size, residual=args.residual)
    return src, src.xy_shape[2] // 2, src.xy_shape[2] // 2


def make_source(args, split, stream=False):
    """(source, x_d, y_d) of ``split`` for ``args.model_type``; with
    ``stream`` (and ``args.records_dir``), a streaming source."""
    from arl_conditional_normalizing_flows_tpu_torch.data.images import (
        ClassConditionalSource,
        SRSource,
    )

    if stream:
        return streaming_source(args, split)
    x, y = load_arrays(args, split)
    x_d = x.shape[-1] if x.ndim == 4 else 1
    if args.model_type == "class":
        src = ClassConditionalSource(x, y, args.data_classes, args.batch_size,
                                     use_logits=args.logits)
        return src, x_d, 1
    return SRSource(x, args.model_type, args.batch_size, residual=args.residual), x_d, x_d


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_plot(args)
    with distributed_run(args):
        return train(args)


def train(args):
    """The run of ``main``, in the process group it formed."""
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import (
        ConvFlowConfig,
        arch_string,
    )
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow
    from arl_conditional_normalizing_flows_tpu_torch.train import (
        CheckpointManager,
        HistoryLogger,
        create_train_state,
        epoch_stacks,
        fit,
        load_npz_extras,
        load_params_npz,
        make_scan_train_step,
        make_step_fns,
        save_params_npz,
    )
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib
    from arl_conditional_normalizing_flows_tpu_torch.utils import write_run_metadata

    device, mesh, nproc, rank = run_placement(args)
    is_main = rank == 0
    stream = bool(args.records_dir) and args.stream_records
    train_src, x_d, y_d = make_source(args, "train", stream)
    val_src, _, _ = make_source(args, "test", stream)
    if args.records_dir and is_main:
        print(f"records: {records_reader(stream)} from {args.records_dir}", flush=True)
    h, w, xy_d = train_src.xy_shape
    if xy_d != x_d + y_d:
        raise ValueError(f"xy has {xy_d} channels, not x_d + y_d = {x_d + y_d}")

    cfg = ConvFlowConfig(
        io_shape=(h, w, xy_d),
        x_d=x_d,
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
    os.makedirs(args.outdir, exist_ok=True)
    if is_main:
        write_run_metadata(args.outdir, args, device,
                           extra={"arch": arch_string(cfg), "processes": nproc})
    model = ConvCFlow(cfg, device=device, seed=args.seed)
    print("arch:", arch_string(cfg), "device:", device,
          *([f"process {rank} of {nproc}"] if mesh is not None else []), flush=True)
    state = create_train_state(model, args.lr, seed=args.seed)

    # a multi-process run keeps no checkpoint directory and warm-starts from
    # npz weights only (JAX drivers/conv.py:295-325)
    mgr = (CheckpointManager(os.path.join(args.outdir, "checkpoints"), config=cfg)
           if nproc == 1 else None)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    initial_epoch = 0
    if args.load:
        if args.load.endswith(".npz"):
            extras = load_npz_extras(args.load)
            # conv params do not depend on the spatial size, so a mismatched
            # arch can have identical shapes and would load silently
            # (conv_pre_training_cINN_on_noise.py:47-48, README.md:98)
            if "arch" in extras and str(extras["arch"]) != arch_string(cfg):
                raise ValueError(f"loaded weights were trained with arch {extras['arch']}, "
                                 f"but the requested architecture is {arch_string(cfg)}")
            load_params_npz(args.load, model)
        elif nproc > 1:
            raise ValueError(f"--load {args.load}: a multi-process run warm-starts from a "
                             "weights .npz only")
        else:
            # create=False: a bad path raises instead of minting an empty
            # checkpoint directory and training from scratch
            ep, state = CheckpointManager(args.load, config=cfg, create=False).restore(state)
            print(f"restored epoch {ep} from {args.load}", flush=True)
    elif mgr is not None and mgr.latest_epoch() is not None:
        # the generator goes on from where the interrupted run's stopped, so
        # that the resumed epochs draw what an uninterrupted run would have
        ep, state = mgr.restore(state, generator=generator)
        initial_epoch = ep + 1
        print(f"resuming from epoch {ep}", flush=True)

    if mesh is not None:
        mesh_lib.broadcast_parameters(model)

    _, eval_step = make_step_fns(model, mesh, noise_mode="full")
    # this process's slice of each globally class-pure epoch (one process:
    # the epoch itself)
    per_process = (len(train_src.slot_groups(nproc)) if hasattr(train_src, "slot_groups")
                   else train_src.num_batches // nproc)

    def train_epoch(g):
        return train_src.epoch_distributed(g, nproc, rank)

    if args.scan_steps > 1:
        if per_process < args.scan_steps:
            raise ValueError(f"--scan-steps {args.scan_steps} exceeds the {per_process} "
                             "batches an epoch: every epoch would be empty")
        train_step = make_scan_train_step(model, args.scan_steps, mesh, noise_mode="full")

        def train_feed(g, epoch):
            return epoch_stacks(train_epoch(g), args.scan_steps)
    else:
        train_step, _ = make_step_fns(model, mesh, noise_mode="full")

        def train_feed(g, epoch):
            return train_epoch(g)

    history = HistoryLogger(
        csv_path=os.path.join(args.outdir, "history.csv") if is_main else None,
        jsonl_path=os.path.join(args.outdir, "history.jsonl") if is_main else None)
    res = fit(
        state, train_step, train_feed,
        generator=generator,
        num_epochs=args.epochs,
        num_annealing_epochs=args.annealing_epochs,
        eval_step=eval_step,
        val_epoch_fn=lambda g, epoch: val_src.epoch_distributed(g, nproc, rank),
        patience=args.patience,
        monitor="val_loss",
        history=history,
        initial_epoch=initial_epoch,
        checkpoint_fn=(lambda epoch, st: mgr.save(epoch, st, generator)) if mgr else None,
        checkpoint_every=args.checkpoint_every if mgr else 0,
        mesh=mesh,
    )
    if mgr is not None and res.completed_epochs > 0:
        mgr.save(res.completed_epochs - 1, res.state, generator)
    if mesh is not None and is_main:
        save_params_npz(os.path.join(args.outdir, "weights.npz"), model,
                        extra={"arch": np.asarray(arch_string(cfg))})
    if not is_main:
        return res

    # bits/dim of the validation NLL (the parity metric, BASELINE.md): the
    # NLL of the PREPROCESSED x, the noise-floored logit space the model is
    # trained in (conv_cINN.py:246-249, :307-315), over x's dims; not a
    # literature-comparable discrete bits/dim, and it can be negative
    final = history.rows[-1] if history.rows else {}
    if "val_z_loss" in final:
        nll_x = final["val_z_loss"] + final["val_detJ_loss"]
        final["val_bits_per_dim"] = nll_x / (np.log(2.0) * h * w * x_d)
        final["bits_per_dim_space"] = "noise-floored logit (parity metric)"
    final["sampling"] = sampling_eval(args, model, val_src, x_d)
    with open(os.path.join(args.outdir, "eval.json"), "w") as f:
        json.dump(final, f, indent=2)
    print(json.dumps(final, indent=2), flush=True)
    return res


def records_reader(stream: bool) -> str:
    """Which reader a --records-dir run used, for its log."""
    if stream:
        from arl_conditional_normalizing_flows_tpu_torch.data.native_loader import reader_name

        return f"streamed through the {reader_name()}"
    return "read into RAM by records.read_records"


def sampling_eval(args, model, val_src, x_d):
    """Conditional-sampling statistics (the reference only eyeballs them,
    TOYcINN.py:321-1206): per class, the moments of ``--eval-samples`` draws
    of x | class; for SR, reconstructions of one validation low-res plane.
    Draws come from generators seeded 500 + i. With ``--plot``, the first 8
    draws of each class (``class_samples.png``) or up to 6 reconstructions
    beside the condition and the truth (``sr_panel.png``) in ``--outdir``,
    as the JAX driver writes them."""
    from arl_conditional_normalizing_flows_tpu_torch.data.images import class_labels_01
    from arl_conditional_normalizing_flows_tpu_torch.evaluation import sr_residual_block_sums
    from arl_conditional_normalizing_flows_tpu_torch.sample.sampler import (
        conditional_moments,
        sample_conditional_images,
    )

    device = model.device
    h, w, _ = val_src.xy_shape
    n = args.eval_samples
    out = {}
    if args.model_type == "class":
        labels = class_labels_01(len(args.data_classes))
        per_class, grids = {}, []
        for i, c in enumerate(args.data_classes):
            y_plane = torch.full((h, w, 1), float(labels[i]), device=device)
            xs = sample_conditional_images(
                model, y_plane, n, x_d, de_logit=args.logits,
                generator=torch.Generator(device=device).manual_seed(500 + i))
            m = conditional_moments(xs)
            per_class[str(c)] = {
                "pixel_mean": m["mean"].mean().item(),
                "pixel_std": m["std"].mean().item(),
                "min": xs.min().item(),
                "max": xs.max().item(),
            }
            grids.append(xs[:8].cpu().numpy())
        out["per_class"] = per_class
        if args.plot:
            from arl_conditional_normalizing_flows_tpu_torch.evaluation import plots

            plots.plot_image_grid(np.concatenate(grids),
                                  os.path.join(args.outdir, "class_samples.png"),
                                  ncols=8, title="x | class")
        return out
    # SR: condition on a validation low-res plane, sample reconstructions
    val_batch = next(iter(val_src.epoch(torch.Generator(device=device).manual_seed(0))))
    y_img = val_batch[0, ..., x_d:]
    xs = sample_conditional_images(
        model, y_img, n, x_d, residual=False,
        generator=torch.Generator(device=device).manual_seed(500))
    if args.residual:
        out["residual_block_sums"] = sr_residual_block_sums(xs)
        recon = xs + y_img[None, ..., :x_d]
    else:
        recon = xs
    out["recon_pixel_mean"] = recon.mean().item()
    out["recon_pixel_std"] = recon.std(correction=0).item()
    truth = val_batch[0, ..., :x_d] + (val_batch[0, ..., x_d:] if args.residual else 0.0)
    out["recon_mean_vs_truth_mean"] = [recon.mean().item(), truth.mean().item()]
    if args.plot:
        from arl_conditional_normalizing_flows_tpu_torch.evaluation import plots

        nshow = min(6, len(recon))
        y_np, truth_np = y_img.cpu().numpy(), truth.cpu().numpy()
        plots.plot_sr_comparison(np.repeat(y_np[None, ..., :1], nshow, 0),
                                 recon[:nshow].cpu().numpy(),
                                 np.repeat(truth_np[None, ..., :1], nshow, 0),
                                 os.path.join(args.outdir, "sr_panel.png"), n=nshow)
    return out


def cli():
    """Console-script entry: discard the return value so that
    ``sys.exit(main())`` does not print it and exit non-zero."""
    main()
    return 0


if __name__ == "__main__":
    cli()
