"""Rank functions of the multi-process checks: each runs in every process of
a group (``launch.run_ranks``), and the same body runs in one process for
the single-process side of a comparison. They live in the package, not in
the test files, because a spawned process imports its function's module
by name, and the tests import jax.
"""

from __future__ import annotations

import torch


def _device(device_type):
    """The process's current card for "cuda" (``run_ranks`` made it so),
    else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _model(kind, config, state_dict, device):
    from arl_conditional_normalizing_flows_tpu_torch.models.arch import (
        ConvFlowConfig,
        ToyConfig,
    )

    if kind == "toy":
        from arl_conditional_normalizing_flows_tpu_torch.models.toy import ToyCINN

        model = ToyCINN(ToyConfig(**config), device=device, seed=0)
    else:
        from arl_conditional_normalizing_flows_tpu_torch.models.conv import ConvCFlow

        model = ConvCFlow(ConvFlowConfig(**config), device=device, seed=0)
    model.load_state_dict(state_dict)
    return model


def _moment_sizes(model, state) -> dict:
    """Each parameter's name -> the elements of its first Adam moment in
    this process (a shard's under FSDP)."""
    shards = getattr(model, "fsdp_shards", None)
    held = dict(zip(shards.names, shards.shards)) if shards is not None else {}
    return {name: state.optimizer.state[held.get(name, p)]["exp_avg"].numel()
            for name, p in model.named_parameters()}


def train_steps(config, state_dict, batches, lr, noise_mode="none", alpha=1.0, seed=0,
                mesh=None, device="cpu", scan=False) -> dict:
    """``len(batches)`` Adam steps of a conv model of ``config`` holding
    ``state_dict``: with ``mesh``, on this process's rows of each global
    batch (FSDP when the mesh is 2-D); without, on the whole batch. The
    instance noise comes from a generator on the device seeded ``seed``.
    ``scan``: all steps in one ``make_scan_train_step`` call (a CUDA graph
    on the card). Returns the losses (each step's; with ``scan`` the call's
    mean), the parameters after the last step (on the CPU) and the elements
    of each parameter's Adam moment held here."""
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib
    from arl_conditional_normalizing_flows_tpu_torch.train import (
        create_train_state,
        make_scan_train_step,
        make_step_fns,
    )

    device = torch.device(device)
    model = _model("conv", config, state_dict, device)
    sharding = None
    if mesh is not None and "model" in mesh.mesh_dim_names:
        sharding = mesh_lib.state_shardings(mesh, model)
    state = create_train_state(model, lr)
    generator = torch.Generator(device=device).manual_seed(seed)
    rows = [(mesh_lib.shard_batch(b, mesh) if mesh is not None else b).to(device)
            for b in batches]
    if scan:
        multi = make_scan_train_step(model, len(rows), mesh, noise_mode=noise_mode,
                                     state_sharding=sharding)
        state, out = multi(state, torch.stack(rows), generator, alpha)
        losses = [float(out["loss"])]
    else:
        step, _ = make_step_fns(model, mesh, noise_mode=noise_mode, state_sharding=sharding)
        losses = []
        for xy in rows:
            state, out = step(state, xy, generator, alpha)
            losses.append(float(out["loss"]))
    return dict(losses=losses, params={k: v.detach().cpu().clone()
                                       for k, v in model.named_parameters()},
                moments=_moment_sizes(model, state))


def train_steps_rank(rank, world_size, config, state_dict, batches, lr, noise_mode="none",
                     alpha=1.0, seed=0, mesh_shape=None, scan=False,
                     device_type="cpu") -> dict:
    """:func:`train_steps` in one process of a group: over a 1-D data mesh,
    or, with ``mesh_shape`` ``(data, model)``, over an FSDP mesh; on the
    process's card for ``device_type`` "cuda"."""
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib

    mesh = (mesh_lib.make_2d_mesh(*mesh_shape) if mesh_shape is not None
            else mesh_lib.make_mesh())
    return train_steps(config, state_dict, batches, lr, noise_mode, alpha, seed, mesh,
                       _device(device_type), scan)


def sample(kind, config, state_dict, num_samples, seed, mesh=None, device="cpu"):
    """A conditional fan-out of ``num_samples``: the toy at condition 0.5,
    or the conv model at a class plane of 0.5, de-logit; sharded over
    ``mesh``'s data axis when given."""
    from arl_conditional_normalizing_flows_tpu_torch.sample.sampler import (
        sample_conditional,
        sample_conditional_images,
    )

    device = torch.device(device)
    model = _model(kind, config, state_dict, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    if kind == "toy":
        return sample_conditional(model, 0.5, num_samples, model.cfg.x_d, generator=generator,
                                  mesh=mesh).cpu()
    h, w, _ = model.cfg.io_shape
    y = torch.full((h, w, 1), 0.5, device=device)
    return sample_conditional_images(model, y, num_samples, model.cfg.x_d, de_logit=True,
                                     generator=generator, mesh=mesh).cpu()


def sample_rank(rank, world_size, kind, config, state_dict, num_samples, seed,
                device_type="cpu"):
    """:func:`sample` in one process of a group, over a 1-D data mesh."""
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh as mesh_lib

    return sample(kind, config, state_dict, num_samples, seed, mesh_lib.make_mesh(),
                  _device(device_type))


def jobs_rank(rank, world_size, jobs) -> list:
    """Several rank functions of this module in one group, in turn: each
    ``(name, args)`` of ``jobs`` runs ``name(rank, world_size, *args)``;
    their results, in order (one group's start-up for all of them)."""
    return [globals()[name](rank, world_size, *args) for name, args in jobs]


def one_process_steps_rank(rank, world_size, config, state_dict, batches, lr, noise_mode="none",
                           alpha=1.0, seed=0, device_type="cpu", scan=False):
    """:func:`train_steps` on the whole global batches without a mesh, in
    rank 0 alone (None elsewhere): the single-process side of a comparison,
    made in a process set up as the group's."""
    if rank != 0:
        return None
    return train_steps(config, state_dict, batches, lr, noise_mode, alpha, seed,
                       device=_device(device_type), scan=scan)


def conv_driver_rank(rank, world_size, argv):
    """``cnf-conv``'s ``main(argv)`` in one process of the group (the driver
    takes the group as its own): the numbers of every epoch's row of its
    history (rank 0 adds its evaluation's to the last), and what each
    replay of its graphed step launches of the hand-written kernels and of
    the collectives (counted at the capture)."""
    from arl_conditional_normalizing_flows_tpu_torch.drivers import conv

    res = conv.main(argv)
    step = res.train_step
    rows = [{k: float(v) for k, v in row.items() if isinstance(v, (int, float))}
            for row in res.history.rows]
    return dict(rows=rows, launches=getattr(step, "launches", None),
                collectives=getattr(step, "collectives", None))
