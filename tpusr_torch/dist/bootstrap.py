"""Multi-process bootstrap (port of ``tpusr/dist/bootstrap.py``).

Every other helper of ``tpusr_torch.dist`` builds meshes over the ranks of
one process group. A multi-card or multi-node run starts one process per
card (``torchrun``, ``python -m torch.distributed.run``); ``initialize``
joins them into one group, and the meshes are laid out so that NVLink
within a node carries the bandwidth-hungry collectives (JAX: ICI) while the
network between nodes (JAX: DCN) carries only the data-parallel gradient
all-reduce.

Usage (one process per card)::

    from tpusr_torch.dist import bootstrap
    bootstrap.initialize()                # torchrun's environment, or args
    mesh = bootstrap.global_mesh(("data",))
    # ... the same program on every rank; build global batches from each
    # rank's own rows with process_local_batch(...)
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from tpusr_torch.device import resolve_device
from tpusr_torch.dist.mesh import (axis_size, backend_for, batch_shard,
                                   make_mesh, mesh_device)

_initialized = False  # set by a successful multi-process initialize()


def is_initialized() -> bool:
    """True once a multi-process group is up in this process (by
    ``initialize`` or by the caller); a world-1 group is not one."""
    return _initialized or (dist.is_initialized()
                            and dist.get_world_size() > 1)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, device=None) -> bool:
    """Idempotent ``torch.distributed.init_process_group``.

    The arguments fall back to torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) where JAX
    reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``. ``coordinator_address`` is ``host:port``; rank 0
    listens there. The backend follows ``device`` (NCCL on a card, gloo on
    the CPU); on a card the process takes card ``local_device_ids`` (an
    int, or the first of a list), else ``LOCAL_RANK``, modulo the cards it
    sees.

    Returns True if a multi-process group is (now) up, False for the
    single-process no-op, so library code can call this unconditionally.
    Raises when several processes are asked for with no address.
    """
    global _initialized
    if is_initialized():
        return True
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    from_env = coordinator_address is None and "MASTER_ADDR" in env
    if coordinator_address is None and not from_env:
        if num_processes not in (None, 1):
            raise ValueError("multi-process run needs a coordinator address "
                             "(MASTER_ADDR/MASTER_PORT or argument)")
        return False  # single process: nothing to do
    if num_processes is None or process_id is None:
        raise ValueError("multi-process run needs the number of processes "
                         "and this process's id (WORLD_SIZE/RANK or "
                         "arguments)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = local_device_ids
        if isinstance(local, (list, tuple)):
            local = local[0]
        if local is None:
            local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    # torchrun's agent may host the store already: env:// joins it
    init = "env://" if from_env else f"tcp://{coordinator_address}"
    dist.init_process_group(backend_for(dev), init_method=init,
                            rank=process_id, world_size=num_processes)
    _initialized = True
    return True


def spawn(fn, nprocs: int, args: tuple, timeout_s: float = 600.0) -> None:
    """Run ``fn(i, *args)`` in ``nprocs`` fresh processes (spawn: nothing of
    this process's state, CUDA's included, is inherited) and wait for them;
    raises on the first that fails, and on ``timeout_s``, and stops the
    others either way."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: {nprocs} processes still "
                                   f"running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def global_mesh(axis_names: tuple[str, ...] = ("data",),
                shape: tuple[int, ...] | None = None, device=None):
    """A mesh over every rank of the group, ranks in order: with
    ``shape=(n_nodes * per_node, ...)`` and a leading data axis, each node's
    ranks are contiguous along 'data', so batch shards stay on the node that
    loaded them and only the gradient all-reduce crosses nodes."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} ranks")
    return make_mesh(shape=tuple(shape), axis_names=axis_names, device=dev)


def _local_world_size() -> int:
    """Ranks per node: torchrun's ``LOCAL_WORLD_SIZE``, else the whole
    group (one node)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def hybrid_mesh(dcn_axis: str = "replica",
                ici_axes: tuple[str, ...] = ("data",),
                ici_shape: tuple[int, ...] | None = None, device=None):
    """Nodes x cards mesh: the leading axis spans nodes (JAX: DCN, slices),
    the trailing axes each node's ranks (JAX: ICI; here NVLink). Shard pure
    data parallelism over ``dcn_axis`` and the bandwidth-hungry axes
    (tp/sp/pp traffic) over ``ici_axes``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = _local_world_size()
    n_nodes = world // local
    if ici_shape is None:
        ici_shape = (local,) + (1,) * (len(ici_axes) - 1)
    if math.prod(ici_shape) != local:
        raise ValueError(f"ici shape {tuple(ici_shape)} != {local} "
                         f"ranks/node")
    return make_mesh(shape=(n_nodes,) + tuple(ici_shape),
                     axis_names=(dcn_axis,) + tuple(ici_axes), device=device)


def process_local_batch(mesh, array, batch_axis: str = "data"
                        ) -> torch.Tensor:
    """The GLOBAL batch from each rank's LOCAL rows: every rank passes the
    examples it loaded, and every rank gets the batch of all of them,
    ranks in axis order (JAX: ``make_array_from_process_local_data``)."""
    t = torch.as_tensor(array).to(mesh_device(mesh))
    n = t.shape[0] * axis_size(mesh, batch_axis)
    return batch_shard(mesh, n, batch_axis).gather(t)
