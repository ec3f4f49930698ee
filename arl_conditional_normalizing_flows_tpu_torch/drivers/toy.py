"""Toy cINN training and evaluation driver, ``cnf-toy`` (port of the JAX
``drivers/toy.py``; the reference's TOYcINN.py as a CLI).

Reference hyperparameter block: TOYcINN.py:32-183. Defaults mirror the
reference: 4 coupling blocks x 6 masks = 24 layers, intermediate dims 32, 6
dense layers, batch 1000, 10 batches a class, lr 1e-4, 10 annealing epochs
of x-only instance noise, early stopping with patience 10 on the train loss.

Runs on the CUDA card, or on the CPU with ``--cpu``; without a card and
without ``--cpu`` it raises. ``--scan-steps N`` trains through
``make_scan_train_step`` (on the card, one train step captured as a CUDA
graph and replayed N times a call). ``--plot`` and the multi-host flags exit
with the ROADMAP item that will bring them. The data, the noise and the
evaluation draws come from ``torch.Generator``s on the run's device (the
training one seeded with ``--seed``), so the port's runs draw other points
than the JAX driver's.

Writes ``weights.npz`` (the JAX package's format, with the layer order as
``__extra__mask_indices``), ``history.csv``/``history.jsonl``, ``run.json``
and ``eval.json``: per-class sample moments against the data's, or, for
``continuous_sectors``, per-sector conditional fidelity; ``--sweep`` adds the
moments of samples at extra (standardized) conditions.

Example:
    python -m arl_conditional_normalizing_flows_tpu_torch.drivers.toy \\
        --dataset crescents --epochs 200 --outdir /tmp/toy_run
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
    p.add_argument("--dataset", default="crescents",
                   choices=["crescents", "crescents_overlapping", "mixed", "continuous_sectors"],
                   help="TOYcINN.py:37-62")
    p.add_argument("--which-classes", type=int, nargs="*", default=[0, 1, 4],
                   help="mixed-shapes class subset (TOYcINN.py:56)")
    p.add_argument("--noise", type=float, default=0.05, help="crescent noise")
    p.add_argument("--sector-width", type=float, default=np.pi / 4)
    p.add_argument("--coupling-blocks", type=int, default=4,
                   help="x6 masks = num coupling layers (TOYcINN.py:93)")
    p.add_argument("--intermediate-dims", type=int, default=32)
    p.add_argument("--num-layers", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=1000)
    p.add_argument("--batches-per-class", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--annealing-epochs", type=int, default=10)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fixed-mask-order", action="store_true",
                   help="skip the within-group mask shuffle (TOYcINN.py:172-182)")
    p.add_argument("--load", default=None,
                   help="npz weights to resume from (either package's save_params_npz); "
                   "the layer order saved with them is restored")
    p.add_argument("--outdir", default="toy_run")
    p.add_argument("--eval-samples", type=int, default=2000)
    p.add_argument("--plot", action="store_true",
                   help="joint/conditional/latent/loss PNGs (not ported yet: ROADMAP A.9)")
    p.add_argument("--sweep", type=float, nargs="*", default=None,
                   help="extra y' values (standardized) for an off-manifold interpolation "
                   "sweep (TOYcINN.py:1115-1206); their sample moments go to eval.json")
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


def mask_order(args, num_layers_total):
    """The layer order: the one saved with ``--load``'s weights, else the
    identity (``--fixed-mask-order``), else shuffled within each group of 6
    from numpy's generator seeded ``--seed``. The order is part of the
    model's identity (TOYcINN.py:174): the reference silently invalidates a
    loaded model when a fresh random order differs (TOYcINN.py:228-235)."""
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import shuffle_mask_indices
    from arl_conditional_normalizing_flows_tpu_torch.train import load_npz_extras

    if args.load:
        extras = load_npz_extras(args.load)
        if "mask_indices" in extras:
            order = tuple(int(i) for i in extras["mask_indices"])
            if len(order) != num_layers_total:
                raise ValueError(f"loaded mask order has {len(order)} layers but the "
                                 f"requested architecture has {num_layers_total}: pass the "
                                 "matching --coupling-blocks")
            return order
    if args.fixed_mask_order:
        return tuple(range(num_layers_total))
    return shuffle_mask_indices(np.random.default_rng(args.seed), num_layers_total)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from arl_conditional_normalizing_flows_tpu_torch.drivers.conv import refuse_unported

    refuse_unported(args)
    from arl_conditional_normalizing_flows_tpu_torch.data import toy_datasets
    from arl_conditional_normalizing_flows_tpu_torch.device import resolve_device
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import ToyConfig
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN
    from arl_conditional_normalizing_flows_tpu_torch.train import (
        HistoryLogger,
        create_train_state,
        epoch_stacks,
        fit,
        load_params_npz,
        make_scan_train_step,
        make_step_fns,
        save_params_npz,
    )
    from arl_conditional_normalizing_flows_tpu_torch.utils import write_run_metadata

    device = resolve_device("cpu" if args.cpu else None)
    num_layers_total = 6 * args.coupling_blocks
    order = mask_order(args, num_layers_total)
    cfg = ToyConfig(num_coupling_layers=num_layers_total,
                    intermediate_dims=args.intermediate_dims, num_layers=args.num_layers,
                    mask_indices=order)
    os.makedirs(args.outdir, exist_ok=True)
    write_run_metadata(args.outdir, args, device, extra={"mask_indices": list(order)})
    model = ToyCINN(cfg, device=device, seed=args.seed)
    if args.load:
        load_params_npz(args.load, model)
    state = create_train_state(model, args.lr, seed=args.seed)

    if args.dataset in ("crescents", "crescents_overlapping"):
        ds = toy_datasets.make_moons_dataset(
            noise=args.noise, overlapping=args.dataset.endswith("overlapping"))
    elif args.dataset == "mixed":
        ds = toy_datasets.make_mixed_dataset(args.which_classes)
    else:
        ds = None  # continuous sectors: no class structure
    if ds is not None and not ds.stats_pinned:
        print("toy: standardization statistics drawn by the port (torch.Generator seeded "
              "1234), not JAX's: a weights.npz trained by the JAX package under these flags "
              "sees inputs up to ~2% of a std off its training data", flush=True)

    if ds is not None:
        per_epoch = args.batches_per_class * len(ds.class_labels)

        def data_epoch(g, epoch):
            return ds.epoch_iterator(g, args.batches_per_class, args.batch_size)
    else:
        per_epoch = args.batches_per_class * 2

        def data_epoch(g, epoch):
            for _ in range(per_epoch):
                yield toy_datasets.sample_continuous_sectors(g, args.batch_size,
                                                             args.sector_width)

    if args.scan_steps > 1:
        if per_epoch < args.scan_steps:
            raise ValueError(f"--scan-steps {args.scan_steps} exceeds the {per_epoch} "
                             "batches an epoch: every epoch would be empty")
        train_step = make_scan_train_step(model, args.scan_steps, noise_mode="x_only",
                                          x_d=cfg.x_d)

        def feed(g, epoch):
            return epoch_stacks(data_epoch(g, epoch), args.scan_steps)
    else:
        train_step, _ = make_step_fns(model, noise_mode="x_only", x_d=cfg.x_d)
        feed = data_epoch

    history = HistoryLogger(csv_path=os.path.join(args.outdir, "history.csv"),
                            jsonl_path=os.path.join(args.outdir, "history.jsonl"))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    res = fit(state, train_step, feed, generator=generator, num_epochs=args.epochs,
              num_annealing_epochs=args.annealing_epochs, patience=args.patience,
              history=history)
    save_params_npz(os.path.join(args.outdir, "weights.npz"), model,
                    extra={"mask_indices": np.asarray(order)})

    report = {"final": history.rows[-1] if history.rows else {}}
    report.update(evaluate(args, model, ds))
    with open(os.path.join(args.outdir, "eval.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["final"], indent=2), flush=True)
    return res


def _generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def evaluate(args, model, ds) -> dict:
    """Conditional-sampling evaluation, the quantitative core of the
    reference's plot harness (TOYcINN.py:321-757): per class, the moments of
    ``--eval-samples`` draws of x | y' against a fresh batch of the class
    (draws seeded 100 + i, data 200 + i); for continuous sectors, the
    fidelity at 8 pinned sector centres (draws seeded 300 + i); with
    ``--sweep``, the moments at each extra condition (draws seeded 4)."""
    from arl_conditional_normalizing_flows_tpu_torch.evaluation import sector_fidelity
    from arl_conditional_normalizing_flows_tpu_torch.sample.sampler import (
        conditional_moments,
        sample_conditional,
        sweep_conditions,
    )

    x_d, device, n = model.cfg.x_d, model.device, args.eval_samples
    out = {}
    if ds is not None:
        per_class = {}
        for ci, lab in enumerate(ds.class_labels):
            lab_std = (lab - ds.mean[2]) / ds.std[2]
            s = sample_conditional(model, lab_std, n, x_d, generator=_generator(device, 100 + ci))
            m = conditional_moments(s[:, :x_d])
            truth = ds.sample_class_batch(_generator(device, 200 + ci), ci, n)
            per_class[str(lab)] = {
                "sample_mean": m["mean"].tolist(),
                "sample_std": m["std"].tolist(),
                "true_mean": truth[:, :x_d].mean(0).tolist(),
                "true_std": truth[:, :x_d].std(0, correction=0).tolist(),
                "y_identity_mean": s[:, x_d:].mean().item(),
            }
        out["per_class_moments"] = per_class
    else:
        # continuous sectors (TOYcINN_make_datasets.py:1114-1300): circular
        # angular error against the requested centre and the in-sector
        # fraction, the quantitative form of the reference's "deeper
        # network" claim for this dataset (README.md:71)
        centers = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        per_sector = {}
        for ci, c in enumerate(centers):
            s = sample_conditional(model, float(c), n, x_d, generator=_generator(device, 300 + ci))
            per_sector[f"{c:.3f}"] = sector_fidelity(s, float(c), args.sector_width, x_d=x_d)
        out["per_sector"] = per_sector
        out["sector_aggregate"] = {
            k: float(np.mean([v[k] for v in per_sector.values()]))
            for k in ("mean_abs_angular_error", "frac_in_sector", "frac_in_unit_disk")
        }
    if args.sweep:
        sweeps = sweep_conditions(model, np.asarray(args.sweep, np.float32), n, x_d,
                                  generator=_generator(device, 4))
        out["sweep"] = {}
        for v, s in zip(args.sweep, sweeps):
            m = conditional_moments(s[:, :x_d])
            out["sweep"][str(v)] = {"sample_mean": m["mean"].tolist(),
                                    "sample_std": m["std"].tolist(),
                                    "y_identity_mean": s[:, x_d:].mean().item()}
    return out


def cli():
    """Console-script entry: discard the return value so that
    ``sys.exit(main())`` does not print it and exit non-zero."""
    main()
    return 0


if __name__ == "__main__":
    cli()
