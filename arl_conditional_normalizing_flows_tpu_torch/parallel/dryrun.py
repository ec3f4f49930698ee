"""The multi-device dry run: the port's counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip`` (``:38-157``).

``dryrun_multichip(n)`` trains in ``n`` processes (``launch.run_ranks``)
through the drivers' feed path at the flagship's widths: a 2-D ``(n/2, 2)``
``("data", "model")`` mesh with FSDP (``mesh.state_shardings``) when ``n``
is even and at least 4, else a 1-D data mesh; batches from
``ClassConditionalSource.epoch_distributed``, checked class-pure across the
processes; two Adam steps with a finite loss; then the conditional fan-out
of ``4 * data`` samples sharded over the ``data`` axis, with finite moments.

The model keeps the flagship's 28x28 io shape, kernels (64, 64, 32, 32) and
cardinality (8, 8, 4, 4) (conv_cINN.py:56-65) with one ResNeXt block a
coupling; ``CNF_DRYRUN_FULL_DEPTH=1`` in the environment gives the
production depth (3, 3, 3, 3). NCCL on the card (one process a card,
``rank % device_count``), gloo with ``device="cpu"``.

    python -m arl_conditional_normalizing_flows_tpu_torch.parallel.dryrun 4 --cpu
    CNF_DRYRUN_FULL_DEPTH=1 python -m arl_conditional_normalizing_flows_tpu_torch.parallel.dryrun 1
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import torch
import torch.distributed as dist

#: rows a process feeds each step
LOCAL_BATCH = 2


def dryrun_config(depth: int):
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import ConvFlowConfig

    return ConvFlowConfig(
        io_shape=(28, 28, 2), x_d=1, squeeze_factor_blocks=(0, 1, 0, 0),
        res_blocks=(depth,) * 4, num_kernels=(64, 64, 32, 32), cardinality=(8, 8, 4, 4),
        ksize=3, layer_norm=True)


def _gathered(t, group, size):
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _dryrun_rank(rank, world_size, depth):
    """One process of :func:`dryrun_multichip`; returns its summary."""
    from arl_conditional_normalizing_flows_tpu_torch.data.images import (
        ClassConditionalSource,
        synthetic_digits,
    )
    from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib
    from arl_conditional_normalizing_flows_tpu_torch.sample.sampler import (
        conditional_moments,
        sample_conditional_images,
    )
    from arl_conditional_normalizing_flows_tpu_torch.train import (
        create_train_state,
        make_step_fns,
    )

    on_card = dist.get_backend() == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    if world_size >= 4 and world_size % 2 == 0:
        mesh = mesh_lib.make_2d_mesh(world_size // 2, 2)
    else:
        mesh = mesh_lib.make_mesh()
    group, data, index = mesh_lib.data_axis(mesh)

    # the driver feed: this process's slot of each class-pure global batch
    # group, two groups a class
    imgs, labels = synthetic_digits(num_per_class=2 * data * LOCAL_BATCH, num_classes=2, size=28)
    src = ClassConditionalSource(imgs, labels, [0, 1], LOCAL_BATCH, use_logits=True)
    batches = list(src.epoch_distributed(torch.Generator(device=device).manual_seed(0), data,
                                         index))
    # class purity must survive the grouping: the label plane is one class's
    # (under the 2% noise floor) across every process's rows
    for b in batches:
        planes = _gathered(b[..., -1], group, data)
        if float(planes.std()) >= 0.1:
            raise RuntimeError("a global batch mixes classes")

    model = ConvCFlow(dryrun_config(depth), device=device, seed=0)
    sharding = mesh_lib.state_shardings(mesh, model) if "model" in mesh.mesh_dim_names else None
    state = create_train_state(model, 3e-4)
    train_step, _ = make_step_fns(model, mesh, noise_mode="full", state_sharding=sharding)
    step_generator = torch.Generator(device=device).manual_seed(1)
    losses = []
    for b in batches[:2]:
        state, out = train_step(state, b, step_generator, 1.0)
        losses.append(float(out["loss"]))
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"non-finite loss {losses}")

    # the sampling path under the same mesh: the conditional fan-out sharded
    # on the samples axis, on the just-trained (FSDP-sharded, when 2-D) model
    num_samples = 4 * data
    rows = mesh_lib.local_batch_slice(num_samples, mesh)
    xs = sample_conditional_images(
        model, torch.zeros((28, 28, 1), device=device), num_samples, 1, de_logit=True,
        generator=torch.Generator(device=device).manual_seed(2), mesh=mesh)
    if tuple(xs.shape) != (num_samples, 28, 28, 1):
        raise RuntimeError(f"sampled {tuple(xs.shape)}, not ({num_samples}, 28, 28, 1)")
    moments = conditional_moments(xs)
    for k, v in moments.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"non-finite sample {k}")
    sharded = [n for n, dim in (sharding or {}).items() if dim != mesh_lib.REPLICATED]
    return dict(
        rank=rank, mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), depth=depth,
        data_index=index, batches=len(batches), losses=losses,
        fsdp_sharded_params=len(sharded),
        params=sum(p.numel() for p in model.parameters()),
        samples=num_samples, sample_rows=[rows.start, rows.stop],
        sample_mean=float(moments["mean"].mean()), sample_std=float(moments["std"].mean()),
        device=str(device))


def dryrun_multichip(n_devices: int, device=None, *, timeout: float = 900.0) -> list:
    """Train two steps and sample in ``n_devices`` processes (module
    docstring); raises on any failure. ``device``: None for the cards
    (NCCL), "cpu" for CPU processes over gloo. Returns every process's
    summary; the processes must agree on the losses."""
    from arl_conditional_normalizing_flows_tpu_torch.device import resolve_device
    from arl_conditional_normalizing_flows_tpu_torch.parallel.launch import run_ranks

    on_card = resolve_device(device).type == "cuda"
    full_depth = os.environ.get("CNF_DRYRUN_FULL_DEPTH") == "1"
    with tempfile.TemporaryDirectory() as tmp:
        results = run_ranks(_dryrun_rank, n_devices, "nccl" if on_card else "gloo",
                            os.path.join(tmp, "rendezvous"), args=(3 if full_depth else 1,),
                            device_type="cuda" if on_card else "cpu", timeout=timeout)
    if any(r["losses"] != results[0]["losses"] for r in results):
        raise RuntimeError(f"the processes disagree on the losses: "
                           f"{[r['losses'] for r in results]}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_devices", type=int)
    p.add_argument("--cpu", action="store_true", help="CPU processes over gloo")
    args = p.parse_args(argv)
    results = dryrun_multichip(args.n_devices, "cpu" if args.cpu else None)
    print(json.dumps(results[0]))


if __name__ == "__main__":
    main()
