"""Dataset build CLI, ``cnf-build-records`` (port of the JAX
``drivers/build_records.py``; the reference's create_tfrecords.py as a CLI).

Writes an image dataset's train and test splits as ``.cnfrec`` files: one
combined file a split for SR training (``--combined``), or one file a class
for class-conditional training (create_tfrecords.py:54-67); then checks
them (create_tfrecords.py:366-400). ``--tfrecords`` also writes the
reference's own TFRecord files beside them, byte-compatible with
create_tfrecords.py's, under its naming scheme. The files are the JAX
package's: either package reads what the other writes. ``--plot`` (the
reference's visual verify) writes the first 8 images of each file beside it
as ``<file>.png``; it needs matplotlib.

Example:
    python -m arl_conditional_normalizing_flows_tpu_torch.drivers.build_records \\
        --dataset synthetic --which-classes 0 1 2 3 --outdir /tmp/records
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="mnist", choices=["mnist", "fashion_mnist", "synthetic"])
    p.add_argument("--which-classes", type=int, nargs="*", default=list(range(10)))
    p.add_argument("--combined", action="store_true",
                   help="one combined file (SR); default is per-class files")
    p.add_argument("--outdir", required=True)
    p.add_argument("--verify", action="store_true", default=True)
    p.add_argument("--no-verify", dest="verify", action="store_false")
    p.add_argument("--plot", action="store_true",
                   help="a decoded-image verification grid a file, <file>.png (needs "
                   "matplotlib)")
    p.add_argument("--tfrecords", action="store_true",
                   help="ALSO write reference-format .tfrecords files (byte-compatible "
                   "with create_tfrecords.py output, its naming scheme included) so that "
                   "the data can feed the original TF codebase")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from arl_conditional_normalizing_flows_tpu_torch.drivers.common import check_plot

    check_plot(args)
    if not args.which_classes:  # nargs='*' permits an empty list
        raise SystemExit("cnf-build-records: --which-classes must name at least one class "
                         "(an empty list would write zero files)")
    from arl_conditional_normalizing_flows_tpu_torch.data.images import (
        load_image_dataset,
        synthetic_digits,
    )
    from arl_conditional_normalizing_flows_tpu_torch.data.records import (
        read_records,
        verify_records,
        write_class_sorted_dataset,
    )

    written = []
    for split in ("train", "test"):
        if args.dataset == "synthetic":
            n = 256 if split == "train" else 64
            x, y = synthetic_digits(num_per_class=n, seed=0 if split == "train" else 1)
        else:
            x, y = load_image_dataset(args.dataset, split)
        written += write_class_sorted_dataset(args.outdir, split, x, y, args.which_classes,
                                              args.combined)
        if args.tfrecords:
            print(f"wrote reference-format files: {write_reference_files(args, split, x, y)}")
    print(f"wrote {len(written)} files to {args.outdir}")
    if args.verify:
        report = verify_records(written)
        print(json.dumps({k: {**v, "shape": list(v["shape"])} for k, v in report.items()},
                         indent=2))
    if args.plot:
        from arl_conditional_normalizing_flows_tpu_torch.evaluation import plots

        for path in written:
            plots.plot_image_grid(read_records(path)[:8], path + ".png", ncols=8,
                                  title=os.path.basename(path))
    return written


def write_reference_files(args, split, x, y):
    """The reference-format sidecar: ``.tfrecords`` under the reference's
    naming (create_tfrecords.py:307-309, 360-364:
    ``x_{train|val}_{dataset}_c<classes>.tfrecords``, one combined file or
    one a class) with 10-wide one-hot labels (create_tfrecords.py:330-334).
    Returns the paths written."""
    from arl_conditional_normalizing_flows_tpu_torch.data.tfrecord_compat import (
        write_reference_tfrecords,
    )

    split_name = "train" if split == "train" else "val"
    x = np.asarray(x, np.float32)
    y = np.asarray(y).astype(int)
    onehot_width = max(10, int(max(args.which_classes)) + 1)
    groups = ([list(args.which_classes)] if args.combined
              else [[c] for c in args.which_classes])
    paths = []
    for group in groups:
        sel = np.isin(y, group)
        imgs, ys = x[sel], y[sel]
        onehot = np.zeros((len(imgs), onehot_width), np.float32)
        onehot[np.arange(len(imgs)), ys] = 1.0
        cs = "".join(str(c) for c in group)
        path = os.path.join(args.outdir, f"x_{split_name}_{args.dataset}_c{cs}.tfrecords")
        write_reference_tfrecords(path, imgs, onehot)
        paths.append(path)
    return paths


def cli():
    """Console-script entry: discard the return value so that
    ``sys.exit(main())`` does not print it and exit non-zero."""
    main()
    return 0


if __name__ == "__main__":
    cli()
