"""Process groups, spawned ranks and multi-host meshes.  Counterpart of
`sais_tpu/parallel/distributed.py`.

- `initialize()` joins a group that a launcher set up through `env://`
  (torchrun's MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK):
  the counterpart of `jax.distributed.initialize`.  NCCL on the card,
  gloo on the CPU.
- `run_ranks(fn, n, device)` runs fn in n spawned processes, one per
  device of this host (cuda:i over NCCL, or n gloo processes on the CPU).
  The ranks meet through a `FileStore` in a temporary directory, not a
  TCP port: nothing here needs a network.
- `multislice_mesh()` builds a ("dcn", "data", "model") mesh whose outer
  axis crosses hosts.  torchrun numbers ranks host-major, so the ordered
  split of the ranks into `num_slices` blocks puts each host's devices in
  one block, as JAX's hybrid mesh does; gradient sums then reduce inside
  a host first.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from sais_tpu_torch.parallel.mesh import (  # noqa: F401  (re-exported)
    DATA_AXIS, DCN_AXIS, MODEL_AXIS, BatchSharding, data_parallel_size,
    data_sharding, mesh_from_ranks)


def _dist():
    import torch.distributed as dist
    return dist


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def initialize(device_type: Optional[str] = None) -> None:
    """Join the process group a launcher describes in the environment
    (torchrun: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; LOCAL_RANK picks
    this process's card).  device_type: "cuda" (NCCL, the default when a
    card is present) or "cpu" (gloo).  A no-op when a group exists."""
    dist = _dist()
    if dist.is_initialized():
        return
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(device_type), init_method="env://")


def _rank_main(rank: int, fn: Callable, world_size: int, device_type: str,
               store_path: str, args: Sequence[Any]) -> None:
    dist = _dist()
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend_for(device_type), store=store,
                            rank=rank, world_size=world_size)
    try:
        fn(*args)
        dist.barrier()
    except BaseException:
        # the other ranks may wait in a collective that will not finish,
        # and tearing down NCCL would wait with them: leave the group to
        # the process's exit (spawn then stops the others)
        if world_size == 1:
            dist.destroy_process_group()
        raise
    from sais_tpu_torch.parallel.mesh import _GROUPS
    _GROUPS.clear()
    dist.destroy_process_group()
    if world_size > 1:
        # a spawned rank is done: leave without the interpreter's
        # teardown, in which gloo's threads have aborted a finished rank
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)


def run_ranks(fn: Callable, world_size: int, device_type: str,
              *args: Any) -> None:
    """fn(*args) in `world_size` spawned processes that form one group:
    rank i on cuda:i over NCCL, or gloo ranks on the CPU.  fn must be
    picklable (a module-level function).  A rank that raises fails the
    call (the others are stopped).  A world of one runs in this process,
    in a group of its own for the call."""
    tmp = tempfile.mkdtemp(prefix="sais_ranks_")
    store = os.path.join(tmp, "store")
    try:
        if world_size == 1:
            _rank_main(0, fn, 1, device_type, store, args)
            return
        import torch.multiprocessing as mp
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, world_size, device_type, store, args))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def multislice_mesh(num_slices: int, model_parallel: int = 1,
                    ranks: Optional[Sequence[int]] = None):
    """("dcn", "data", "model") mesh with slices (hosts) on the outermost
    axis: the ranks (default: every rank of the group, host-major as
    torchrun numbers them) split into `num_slices` equal blocks in order,
    with JAX's errors."""
    ranks = list(range(_dist().get_world_size()) if ranks is None
                 else ranks)
    n = len(ranks)
    if n % num_slices:
        raise ValueError(f"{n} devices not divisible into {num_slices} "
                         "slices")
    per_slice = n // num_slices
    if per_slice % model_parallel:
        raise ValueError(f"slice size {per_slice} not divisible by "
                         f"model_parallel={model_parallel}")
    arr = np.asarray(ranks).reshape(num_slices, per_slice // model_parallel,
                                    model_parallel)
    return mesh_from_ranks(arr, (DCN_AXIS, DATA_AXIS, MODEL_AXIS))


def is_multislice(mesh) -> bool:
    return DCN_AXIS in mesh.mesh_dim_names


def batch_sharding(mesh) -> BatchSharding:
    """Leading batch axis split jointly over (dcn, data): an alias of
    `mesh.data_sharding`, re-exported so multi-host call sites read
    naturally."""
    return data_sharding(mesh)
