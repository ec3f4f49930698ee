"""What the drivers share: the multi-process flags and the process group and
placement they ask for, and the check that ``--plot`` can plot."""

from __future__ import annotations

import importlib.util

import torch


def add_distributed_flags(p) -> None:
    """The multi-process flags of the training drivers (JAX's four)."""
    p.add_argument("--data-parallel", action="store_true",
                   help="train data parallel over the process group: the processes torchrun "
                   "started (env://), or a group of one")
    p.add_argument("--coordinator", default=None,
                   help="multi-process rendezvous host:port (torch.distributed, tcp://); "
                   "implies --data-parallel")
    p.add_argument("--num-processes", type=int, default=None,
                   help="the number of processes (with --coordinator; default torchrun's "
                   "WORLD_SIZE, else 1)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --coordinator; default torchrun's RANK, "
                   "else 0)")


def distributed_run(args):
    """The process group the multi-process flags ask for
    (``parallel.mesh.distributed``), for a ``with`` block around a run."""
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh

    return mesh.distributed(args.coordinator, args.num_processes, args.process_id,
                            cpu=args.cpu, data_parallel=args.data_parallel)


def run_placement(args):
    """(device, mesh, nproc, rank) of this process: in a process group its
    card (or the CPU), a 1-D data mesh over the group, the group's size and
    this process's rank; else the run's device, no mesh, 1 and 0."""
    import torch.distributed as dist

    from arl_conditional_normalizing_flows_tpu_torch.device import resolve_device
    from arl_conditional_normalizing_flows_tpu_torch.parallel import mesh

    device = resolve_device("cpu" if args.cpu else None)
    if not dist.is_initialized():
        return device, None, 1, 0
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return device, mesh.make_mesh(), mesh.process_count(), mesh.process_index()


def check_plot(args) -> None:
    """Exit before any work when ``--plot`` is asked for and matplotlib is
    not installed (the plots are made after training)."""
    if getattr(args, "plot", False) and importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("--plot needs matplotlib, which is not installed here; "
                         "run without --plot, or plot on a machine that has it")
