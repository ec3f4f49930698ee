"""Process groups, device meshes and the data-parallel helpers (port of the
JAX ``parallel/mesh.py``).

The reference has no parallelism of any kind (conv_cINN.py:617-636). JAX
runs one program over a mesh of devices and lets XLA insert the collectives;
the port runs one process a device over ``torch.distributed`` and makes them
itself:

- data parallel over a 1-D ``("data",)`` mesh: every process holds the whole
  model, feeds its own slice of the global batch, and averages the gradients
  with :func:`all_reduce_gradients` (one collective a step over one flat
  buffer, JAX's one ``psum``) before the optimizer step;
- FSDP-style over a 2-D ``("data", "model")`` mesh (:func:`state_shardings`):
  FSDP2's ``fully_shard`` shards every parameter and its Adam moments on
  ``model`` and replicates them on ``data``, and makes its own all-gathers
  and gradient reductions; rank ``(d, m)`` is fed data slice ``d``, as JAX
  replicates the batch over ``model``.

NCCL serves the card and gloo the CPU. A failed init or collective raises:
nothing falls back to a single process.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

#: launches of the helpers' collectives, counted where each launches its
#: collective, as the kernel wrappers count theirs; inside a CUDA graph these
#: are the counts during the capture (``utils/graphs.py::capture``)
LAUNCHES = {"all_reduce_gradients": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rank_device(process_id: int = 0, cpu: bool = False) -> torch.device:
    """This process's device: the CPU when asked for; else the card
    ``cuda:{LOCAL_RANK}`` when torchrun set ``LOCAL_RANK``, else
    ``cuda:{process_id % device_count}``. Raises when there is no card and
    the CPU was not asked for."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu (device='cpu') to run "
                           "the processes on the CPU")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else process_id % torch.cuda.device_count()
    return torch.device("cuda", index)


def initialize_distributed(coordinator=None, num_processes=None, process_id=None, *,
                           cpu: bool = False, data_parallel: bool = False) -> bool:
    """Form the process group; True when this call formed it (its caller
    then ends it with ``destroy_process_group``).

    With ``coordinator`` (``host:port``): a TCP rendezvous of
    ``num_processes`` processes, this one ``process_id`` (each defaults to
    torchrun's ``WORLD_SIZE``/``RANK``, else 1 and 0). Without it,
    ``data_parallel`` alone forms a group of the processes torchrun started
    (``env://``), else a group of one; with neither, nothing happens, as JAX
    ignores ``--num-processes`` and ``--process-id`` without a coordinator.
    NCCL on the card, gloo with ``cpu``; the card of each process is
    :func:`rank_device`'s, made the current one."""
    if dist.is_initialized():
        return False
    env_world, env_rank = os.environ.get("WORLD_SIZE"), os.environ.get("RANK")
    kw = {}
    if coordinator is not None:
        world = num_processes if num_processes is not None else int(env_world or 1)
        rank = process_id if process_id is not None else int(env_rank or 0)
        kw["init_method"] = f"tcp://{coordinator}"
    elif data_parallel and env_world is not None:
        world, rank = int(env_world), int(env_rank or 0)
        kw["init_method"] = "env://"
    elif data_parallel:
        world, rank = 1, 0
        kw["store"] = dist.HashStore()
    else:
        return False
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is not in [0, {world})")
    device = rank_device(rank, cpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", world_size=world,
                            rank=rank, **kw)
    return True


@contextlib.contextmanager
def distributed(coordinator=None, num_processes=None, process_id=None, *, cpu: bool = False,
                data_parallel: bool = False):
    """The process group of :func:`initialize_distributed` for the ``with``
    block: ended when the block ends (after a barrier; at once when the
    block raises, since the other processes may wait in a collective)."""
    formed = initialize_distributed(coordinator, num_processes, process_id, cpu=cpu,
                                    data_parallel=data_parallel)
    try:
        yield
    except BaseException:
        if formed:
            dist.destroy_process_group()
        raise
    if formed:
        end_distributed()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


#: the mesh axis :func:`state_shardings` shards the parameters on
MODEL_AXIS = "model"


def _mesh_device_type():
    """The mesh's device type, from the group's backend: the card under
    NCCL, else the CPU (gloo's collectives take tensors of either device)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh():
    """A 1-D data-parallel mesh ``("data",)`` over every process."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (process_count(),), mesh_dim_names=("data",))


def make_2d_mesh(data: int, model: int):
    """A ``("data", "model")`` mesh of ``data * model`` processes (all of
    them) for :func:`state_shardings`."""
    from torch.distributed.device_mesh import init_device_mesh

    if data * model != process_count():
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} processes, not "
                         f"{process_count()}")
    return init_device_mesh(_mesh_device_type(), (data, model),
                            mesh_dim_names=("data", MODEL_AXIS))


def data_axis(mesh):
    """(group, size, index) of ``mesh``'s ``data`` axis: the processes that
    hold the other slices of the global batch, how many slices there are,
    and which one this process feeds."""
    return mesh.get_group("data"), mesh.size(mesh.mesh_dim_names.index("data")), \
        mesh.get_local_rank("data")


def local_batch_slice(global_batch_size: int, mesh=None) -> slice:
    """The half-open row range of the global batch this process feeds (its
    slice on the ``data`` axis; every process without a mesh)."""
    if mesh is None:
        return slice(0, global_batch_size)
    _, size, index = data_axis(mesh)
    if global_batch_size % size:
        raise ValueError(f"a global batch of {global_batch_size} does not split into {size} "
                         "slices")
    per = global_batch_size // size
    return slice(per * index, per * (index + 1))


def shard_batch(batch, mesh):
    """This process's rows of a global batch that every process holds."""
    return batch[local_batch_slice(batch.shape[0], mesh)]


def fsdp_placement(mesh):
    """JAX's ``_fsdp_rule`` as FSDP2's ``shard_placement_fn``: shard a
    parameter along its largest dim divisible by the size of the
    :data:`MODEL_AXIS`. Where JAX replicates (a scalar, an indivisible
    shape), FSDP2, which has no replicated placement inside a sharded group,
    takes its default: dim 0, padded."""
    from torch.distributed.tensor import Shard

    n = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))

    def place(p):
        dims = [d for d in range(p.dim()) if p.shape[d] % n == 0 and p.shape[d] >= n]
        return Shard(max(dims, key=lambda d: p.shape[d])) if dims else None

    return place


#: the placement :func:`state_shardings` gives a parameter FSDP2 leaves alone
REPLICATED = "replicated"


def state_shardings(mesh, model) -> dict:
    """FSDP-style sharding of ``model`` over the 2-D ``mesh``, in place:
    FSDP2's ``fully_shard``, each parameter sharded on ``model`` by
    :func:`fsdp_placement` and replicated on ``data``. Scalar parameters
    (each coupling's ``tanh_scale``), which FSDP2 cannot shard and JAX's rule
    replicates, stay plain tensors on every process; the step averages
    their gradients over all processes (``all_reduce_gradients``). Adam's
    moments follow their parameters when the optimizer is made after this
    call (``create_train_state``). ``log_loss`` and ``sample_xy`` become
    FSDP forward methods, so that they gather the parameters as ``forward``
    does. Returns each parameter's placements (:data:`REPLICATED` for a
    scalar), the counterpart of JAX's tree of NamedShardings; pass it to the
    step builders as ``state_sharding``.

    The conv-chain kernel's lowering (``pallas_subnet``) is refused: it
    keeps weights packed from the parameters' storage between calls, which
    FSDP frees and refills."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    if getattr(getattr(model, "cfg", None), "experimental_lowering", None) == "pallas_subnet":
        raise ValueError("FSDP does not take the pallas_subnet lowering: its packed weights "
                         "outlive the gathered parameters")
    scalars = {p for p in model.parameters() if p.dim() == 0}
    fully_shard(model, mesh=mesh, shard_placement_fn=fsdp_placement(mesh),
                reshard_after_forward=True, ignored_params=scalars or None)
    for method in ("log_loss", "sample_xy"):
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    placements = {n: REPLICATED if p in scalars else tuple(p.placements)
                  for n, p in model.named_parameters()}
    if not any(v != REPLICATED and any(getattr(pl, "dim", None) is not None for pl in v)
               for v in placements.values()):
        raise RuntimeError("no parameter was sharded on the model axis")
    return placements


def all_reduce_gradients(params, group=None) -> None:
    """Average the gradients of ``params`` over ``group``: one flat buffer of
    every gradient, summed by one collective and divided by the group's
    size, then copied back (389,800 float32 at the flagship, 1.56 MB). One
    collective is simple to capture in a CUDA graph, as JAX's one ``psum``
    sits in its step. Every process must hold gradients for the same
    parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    LAUNCHES["all_reduce_gradients"] += 1
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def all_reduce_mean(tensor, group=None):
    """The mean of ``tensor`` over ``group`` (SUM, then divided by its
    size), in place; returns it."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor.div_(dist.get_world_size(group))


@torch.no_grad()
def broadcast_parameters(model, group=None) -> None:
    """Rank 0's parameters on every process of ``group``: one flat
    broadcast. Every process builds the same model from the same seed; this
    holds them to it."""
    params = [p.detach() for p in model.parameters()]
    flat = torch.cat([p.reshape(-1) for p in params])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0) if group is not None else 0,
                   group=group)
    torch._foreach_copy_(params, [v.view_as(p) for v, p in
                                  zip(flat.split([p.numel() for p in params]), params)])


def end_distributed() -> None:
    """Wait for every process, then end the process group."""
    if dist.get_world_size() > 1:
        dist.barrier()
    dist.destroy_process_group()


def rank_generator(seed: int, device, rank: int):
    """Process ``rank``'s own generator for data that every process draws
    for itself (noise pre-training, the toy's continuous sectors; JAX's
    ``fold_in(key, rank)``): None on rank 0, which draws from the shared
    generator; elsewhere a generator on ``device`` seeded from ``(seed,
    rank)``."""
    if rank == 0:
        return None
    child = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(child)


def own_batches(epoch_fn, generator, own=None):
    """``epoch_fn(generator)``'s batches, or, with ``own``
    (:func:`rank_generator`), ``epoch_fn(own)``'s, while ``generator``
    still makes the draws of rank 0's batches (thrown away), so that the
    shared generator stays in lockstep with every other process's."""
    if own is None:
        yield from epoch_fn(generator)
        return
    for _, batch in zip(epoch_fn(generator), epoch_fn(own)):
        yield batch
