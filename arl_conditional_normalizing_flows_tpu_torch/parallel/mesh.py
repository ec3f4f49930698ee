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
- FSDP-style over a 2-D ``("data", "model")`` mesh (:func:`state_shardings`,
  :class:`FlatShards`): each parameter is sharded on ``model`` by JAX's rule
  and replicated on ``data``, the optimizer steps the shards, and a step
  makes one reduce-scatter of a flat gradient buffer and one all-gather of a
  flat parameter buffer, which a CUDA graph captures as it does the
  data-parallel all-reduce; rank ``(d, m)`` is fed data slice ``d``, as JAX
  replicates the batch over ``model``.

NCCL serves the card and gloo the CPU. A failed init or collective raises:
nothing falls back to a single process.
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.autograd.graph import increment_version

#: launches of the helpers' collectives, counted where each launches its
#: collective, as the kernel wrappers count theirs; inside a CUDA graph these
#: are the counts during the capture (``utils/graphs.py::capture``)
LAUNCHES = {"all_reduce_gradients": 0, "reduce_scatter_gradients": 0,
            "all_reduce_shard_gradients": 0, "all_gather_parameters": 0}


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


def model_axis(mesh):
    """(group, size, index) of ``mesh``'s :data:`MODEL_AXIS`: the processes
    that hold the other shards of each parameter, how many shards there
    are, and which one this process holds."""
    return mesh.get_group(MODEL_AXIS), mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS)), \
        mesh.get_local_rank(MODEL_AXIS)


def fsdp_placement(mesh):
    """JAX's ``_fsdp_rule``: ``place(p)`` is the dim a parameter is sharded
    on, its largest dim divisible by the size of the :data:`MODEL_AXIS`, or
    None where JAX replicates it (a scalar, an indivisible shape). On a
    model axis of 1, where JAX replicates everything and a shard is the
    whole parameter, the rule still names a dim, so that a one-process mesh
    runs the FSDP step and its collectives."""
    n = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))

    def place(p):
        dims = [d for d in range(p.dim()) if p.shape[d] % n == 0 and p.shape[d] >= n]
        return max(dims, key=lambda d: p.shape[d]) if dims else None

    return place


#: the placement :func:`state_shardings` gives a parameter that it does not
#: shard
REPLICATED = "replicated"

#: the offset of each parameter in the flat buffers is a multiple of this
#: many elements (256 bytes of float32), so that a parameter view starts on
#: the alignment of a tensor of its own, as cuDNN and the foreach kernels
#: find the parameters of an unsharded model
_ALIGN = 64

# the collectives under their current names (the older ones are deprecated)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _aligned_offsets(numels):
    """Each of ``numels``' offset in one flat buffer, and the buffer's size."""
    offsets, end = [], 0
    for k in numels:
        offsets.append(end)
        end += -(-k // _ALIGN) * _ALIGN
    return offsets, end


def _split(t, dim: int, n: int):
    """``t`` as ``(n, *shard shape)``: its ``n`` slices along ``dim``, slice
    ``j`` at index ``j`` (a view when ``t`` is contiguous). For ``n`` 1,
    ``t`` itself: copies between contiguous tensors of one shape take the
    foreach kernels' fast path (a few launches for all the parameters, not
    one each), which needs equal strides."""
    if n == 1:
        return t
    shape = tuple(t.shape)
    return t.reshape(shape[:dim] + (n, shape[dim] // n) + shape[dim + 1:]).movedim(dim, 0)


class FlatShards:
    """The FSDP state of a model that :func:`state_shardings` sharded:
    flat buffers and plain collectives, which a CUDA graph captures, in
    place of hooks, side streams and storage freed and refilled.

    Process ``(d, m)`` holds :attr:`shards`, the ``m``-th slice along its
    sharded dim of every sharded parameter, as views into one flat buffer;
    the optimizer steps them (:meth:`optimizer_params`), so that its
    moments take ``1 / model`` of the sharded parameters' memory. The
    model's parameters stay the full tensors, views into one buffer that
    lives as long as the model (the all-gather's output itself on a model axis of
    1), so that sampling, ``log_loss`` and saving read current weights with
    no hooks, and caches keyed on a parameter's version and address (the
    conv-chain kernel's packed weights) stay correct.

    A step: forward and backward on the full parameters;
    :meth:`reduce_gradients` (one reduce-scatter over ``model`` of a flat
    gradient buffer laid out so that rank ``m`` receives its shard, then
    one all-reduce over ``data``, and the replicated parameters' gradients
    averaged over every process); the optimizer; :meth:`gather` (one
    all-gather over ``model`` into the full parameters).
    """

    def __init__(self, model, mesh, placements: dict):
        self.model_group, self.n, self.m = model_axis(mesh)
        self.data_group = data_axis(mesh)[0]
        self.world = mesh.size()
        named = dict(model.named_parameters())
        self.names = [k for k, v in placements.items() if v != REPLICATED]
        self.dims = [placements[k] for k in self.names]
        self.replicated = [named[k] for k, v in placements.items() if v == REPLICATED]
        old = [named[k] for k in self.names]
        if len({(p.dtype, p.device) for p in old}) != 1:
            raise ValueError("the sharded parameters must share one dtype and one device")
        dtype, device = old[0].dtype, old[0].device
        full_shapes = [tuple(p.shape) for p in old]
        shard_shapes = [s[:d] + (s[d] // self.n,) + s[d + 1:]
                        for s, d in zip(full_shapes, self.dims)]
        numels = [math.prod(s) for s in shard_shapes]
        offsets, size = _aligned_offsets(numels)

        def zeros(count):
            return torch.zeros(count, dtype=dtype, device=device)

        # rank-major: rank j's block holds every parameter's j-th slice
        self._gathered, self._scattered = zeros(self.n * size), zeros(self.n * size)
        self._shard, self._grad_shard = zeros(size), zeros(size)

        def rank_major(buf):
            if self.n == 1:
                return [buf[o:o + k].view(s) for o, k, s in zip(offsets, numels, shard_shapes)]
            return [buf.view(self.n, size)[:, o:o + k].view((self.n,) + s)
                    for o, k, s in zip(offsets, numels, shard_shapes)]

        self._gathered_slices, self._scattered_slices = (rank_major(self._gathered),
                                                         rank_major(self._scattered))
        if self.n == 1:
            self._full, full_offsets = self._gathered, offsets
        else:
            full_offsets, full_size = _aligned_offsets([math.prod(s) for s in full_shapes])
            self._full = zeros(full_size)
        with torch.no_grad():
            self.params = []
            for p, o, s in zip(old, full_offsets, full_shapes):
                view = self._full[o:o + math.prod(s)].view(s)
                view.copy_(p)
                self.params.append(nn.Parameter(view, requires_grad=p.requires_grad))
        replace = {id(p): q for p, q in zip(old, self.params)}
        for module in model.modules():
            for key, p in module._parameters.items():
                if p is not None and id(p) in replace:
                    module._parameters[key] = replace[id(p)]
        # views of the detached parameters: a view of a parameter itself
        # would keep its AccumulateGrad node alive from here, on this stream,
        # and a later capture's backward would then wait on the legacy stream
        self._full_slices = ([_split(p.detach(), d, self.n)
                              for p, d in zip(self.params, self.dims)] if self.n > 1 else None)
        self.shards = [nn.Parameter(self._shard[o:o + k].view(s))
                       for o, k, s in zip(offsets, numels, shard_shapes)]
        self._grads = [self._grad_shard[o:o + k].view(s)
                       for o, k, s in zip(offsets, numels, shard_shapes)]
        self._cut_shards()

    def optimizer_params(self) -> list:
        """What the optimizer steps: this process's shards, then the
        replicated parameters whole."""
        return self.shards + self.replicated

    @torch.no_grad()
    def _cut_shards(self):
        """Each shard from its full parameter. The full parameters are the
        state (a restore, a load or an init writes them), so every step
        cuts the shards anew; after a step they are equal already."""
        torch._foreach_copy_(self.shards, [p if self.n == 1 else _split(p, d, self.n)[self.m]
                                           for p, d in zip(self.params, self.dims)])

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """After backward: each shard's ``.grad``, its slice of the
        parameter's gradient averaged over every process, and the
        replicated parameters' gradients averaged over every process
        (:func:`all_reduce_gradients`). The full parameters' gradients are
        consumed (set to None)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        torch._foreach_copy_(self._scattered_slices, [_split(g, d, self.n)
                                                      for g, d in zip(grads, self.dims)])
        for p in self.params:
            p.grad = None
        self.reduce_scatter()
        LAUNCHES["all_reduce_shard_gradients"] += 1
        dist.all_reduce(self._grad_shard, op=dist.ReduceOp.SUM, group=self.data_group)
        # summed over the model axis (the same rows on each) and the data
        # axis: the mean over the global batch
        self._grad_shard.div_(self.world)
        self._cut_shards()
        for s, g in zip(self.shards, self._grads):
            s.grad = g
        if self.replicated:
            all_reduce_gradients(self.replicated)

    def reduce_scatter(self) -> None:
        """The flat gradient buffer summed over ``model`` into this
        process's gradient shard (one reduce-scatter)."""
        LAUNCHES["reduce_scatter_gradients"] += 1
        _reduce_scatter(self._grad_shard, self._scattered, op=dist.ReduceOp.SUM,
                        group=self.model_group)

    @torch.no_grad()
    def gather(self) -> None:
        """After the optimizer: every process's shards into the full
        parameters (one all-gather over ``model``)."""
        LAUNCHES["all_gather_parameters"] += 1
        _all_gather(self._gathered, self._shard, group=self.model_group)
        if self._full_slices is not None:
            torch._foreach_copy_(self._full_slices, self._gathered_slices)
        # the parameters share the buffer's version counter; a collective
        # may not move it
        increment_version(self._full)


def state_shardings(mesh, model) -> dict:
    """FSDP-style sharding of ``model`` over the 2-D ``mesh``, in place (JAX
    ``parallel/mesh.py::state_shardings``): each parameter sharded on
    ``model`` by :func:`fsdp_placement` and replicated on ``data``, its
    Adam moments with it when the optimizer is made after this call
    (``create_train_state``); the parameters JAX replicates stay whole on
    every process. The model gets its :class:`FlatShards` as
    ``model.fsdp_shards``. Returns each parameter's sharded dim
    (:data:`REPLICATED` for one that is not sharded), the counterpart of
    JAX's tree of NamedShardings; pass it to the step builders as
    ``state_sharding``."""
    if getattr(model, "fsdp_shards", None) is not None:
        raise ValueError("the model is sharded already")
    place = fsdp_placement(mesh)
    placements = {}
    for name, p in model.named_parameters():
        dim = place(p)
        placements[name] = REPLICATED if dim is None else dim
    if all(v == REPLICATED for v in placements.values()):
        raise RuntimeError("no parameter was sharded on the model axis")
    model.fsdp_shards = FlatShards(model, mesh, placements)
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
