"""Run one function in N processes of one process group
(``torch.multiprocessing`` with *spawn*: each process starts from a fresh
interpreter, so none inherits a CUDA context or a thread).

``run_ranks(fn, world_size, backend, init_file)`` is what the tests, the
dry run (``parallel/dryrun.py``) and ``chip_smoke.py`` share. The processes
meet through a ``file://`` rendezvous at ``init_file``, so that concurrent
runs (test workers) never contend for a port. ``fn(rank, world_size,
*args)`` runs in each process with one CPU thread, and its result (tensors,
numbers, strings, lists and dicts of them) comes back through a file beside
``init_file``.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist


def _rank_main(rank, fn, world_size, backend, init_file, args, device_type):
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank)
    try:
        result = fn(rank, world_size, *args)
        torch.save(result, f"{init_file}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str, init_file: str, args=(), *,
              device_type: str = "cpu", timeout: float = 600.0) -> list:
    """``[fn(rank, world_size, *args) for each rank]``, each run in its own
    process of a ``world_size`` group over ``backend`` ("gloo" or "nccl").

    ``fn`` must be importable by name (a module-level function of the
    package, never of a test file that imports jax). ``init_file`` must not
    exist yet. ``device_type`` "cuda" makes each process's current card
    ``rank % device_count`` (under gloo too, whose collectives take CUDA
    tensors). A process that raises ends the run with its traceback; one
    that outlives ``timeout`` seconds is killed, with every other, and the
    run raises ``TimeoutError``."""
    if os.path.exists(init_file):
        raise FileExistsError(f"the rendezvous file {init_file} exists already")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world_size, backend, init_file, tuple(args), device_type),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} processes of {fn.__qualname__} outlived "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for rank in range(world_size):
        path = f"{init_file}.rank{rank}.pt"
        results.append(torch.load(path, weights_only=True))
        os.remove(path)
    if os.path.exists(init_file):
        os.remove(init_file)
    return results
