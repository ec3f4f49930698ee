"""Reference checkpoint import CLI, ``cnf-import-reference`` (port of the JAX
``drivers/import_reference.py``): TF-free conversion of reference-trained
checkpoints into weight ``.npz`` files of both packages' ``save_params_npz``
format.

Subcommands:

- ``conv``: a reference ``weights_… .h5`` / ``checkpoint_… .hdf5``
  (conv_cINN.py:639-641, :517-526; Keras 2 or Keras 3 layout) -> an npz
  with the arch string attached (the contract the reference encodes in the
  filename). The architecture is parsed from the filename where it can be;
  explicit flags override. Needs h5py.
- ``toy``: the object-array ``weights_… .npy`` + ``mask_indices_… .npy`` pair
  (TOYcINN.py:306-317) -> an npz with the layer order attached.

The npz loads through either package's ``--load`` (``cnf-conv``,
``cnf-toy``) and ``load_params_npz``, which check the arch and the layer
order again. The conversion runs on the CPU.

Examples:
    python -m arl_conditional_normalizing_flows_tpu_torch.drivers.import_reference conv \\
        --weights weights_class_mnist_28x28x2_SqFa0100_NRB3333_C8844_NK64643232_KS3_D124_LNTrue.h5 \\
        --output imported.npz
    python -m arl_conditional_normalizing_flows_tpu_torch.drivers.import_reference toy \\
        --weights weights_crescents_NCL24_ID32_NL6.npy \\
        --mask-indices mask_indices_crescents_NCL24_ID32_NL6.npy --output toy.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="kind", required=True)

    c = sub.add_parser("conv", help="import a conv cFlow .h5/.hdf5 checkpoint")
    c.add_argument("--weights", required=True)
    c.add_argument("--output", default=None, help="default: <weights>.npz")
    c.add_argument("--x-d", type=int, default=1)
    c.add_argument("--io-shape", type=int, nargs=3, default=None,
                   help="override h w d (default: parsed from the filename)")
    c.add_argument("--squeeze-factor", type=int, nargs="*", default=None)
    c.add_argument("--res-blocks", type=int, nargs="*", default=None)
    c.add_argument("--kernels", type=int, nargs="*", default=None)
    c.add_argument("--cardinality", type=int, nargs="*", default=None)
    c.add_argument("--ksize", type=int, default=None)
    c.add_argument("--layer-norm", action="store_true", default=None)
    c.add_argument("--no-layer-norm", dest="layer_norm", action="store_false")
    c.add_argument("--true-grouped-conv", action="store_true",
                   help="import for the DOCUMENTED grouped-conv semantics instead of the "
                   "reference's actual runtime behavior (its late-bound group slices, "
                   "PARITY.md §2). Kernel shapes are identical; only apply-time semantics "
                   "differ")

    t = sub.add_parser("toy", help="import a toy .npy weights checkpoint")
    t.add_argument("--weights", required=True)
    t.add_argument("--mask-indices", required=True,
                   help="the mask_indices_… .npy saved with the weights: part of the "
                   "model's identity (TOYcINN.py:306-317)")
    t.add_argument("--output", default=None, help="default: <weights>.npz")
    return p


def _save(out_path, tree, model, extra):
    """Write ``tree`` (flax layout) through ``model``: loading it checks
    every shape, and ``save_params_npz`` writes the same arrays back."""
    from arl_conditional_normalizing_flows_tpu_torch.convert.from_jax import (
        state_dict_from_flax,
    )
    from arl_conditional_normalizing_flows_tpu_torch.train import save_params_npz

    model.load_state_dict(state_dict_from_flax(tree["params"], model))
    save_params_npz(out_path, model, extra=extra)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from arl_conditional_normalizing_flows_tpu_torch.convert.reference_import import (
        import_conv_h5,
        import_toy_npy,
        parse_conv_filename,
    )
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import (
        ConvFlowConfig,
        arch_string,
    )
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow
    from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

    out_path = args.output or os.path.splitext(args.weights)[0] + ".npz"
    if args.kind == "toy":
        tree, mask_indices, cfg = import_toy_npy(args.weights, args.mask_indices)
        _save(out_path, tree, ToyCINN(cfg, device="cpu"),
              {"mask_indices": np.asarray(mask_indices)})
        print(f"imported {len(mask_indices)} coupling layers (ID {cfg.intermediate_dims}, "
              f"NL {cfg.num_layers}) -> {out_path}")
        return out_path

    try:
        kw = parse_conv_filename(os.path.basename(args.weights))
    except ValueError:
        kw = {}
        needed = ("io_shape", "squeeze_factor", "res_blocks", "kernels", "cardinality",
                  "ksize")
        missing = [f for f in needed if getattr(args, f, None) is None]
        if missing:
            raise SystemExit("cnf-import-reference: the filename does not encode the "
                             "architecture (conv_cINN.py:639-641); pass explicit flags for: "
                             f"{missing}")
    overrides = {
        "io_shape": args.io_shape,
        "squeeze_factor_blocks": args.squeeze_factor,
        "res_blocks": args.res_blocks,
        "num_kernels": args.kernels,
        "cardinality": args.cardinality,
        "ksize": args.ksize,
        "layer_norm": args.layer_norm,
    }
    for k, v in overrides.items():
        if v is not None:
            kw[k] = tuple(v) if isinstance(v, list) else v
    cfg = ConvFlowConfig(x_d=args.x_d, ref_compat_group_slice=not args.true_grouped_conv, **kw)
    tree = import_conv_h5(args.weights, cfg)
    _save(out_path, tree, ConvCFlow(cfg, device="cpu"), {"arch": np.asarray(arch_string(cfg))})
    print(f"imported arch {arch_string(cfg)} -> {out_path}")
    return out_path


def cli():
    """Console-script entry: discard the return value so that
    ``sys.exit(main())`` does not print it and exit non-zero."""
    main()
    return 0


if __name__ == "__main__":
    cli()
