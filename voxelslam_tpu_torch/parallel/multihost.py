"""Several cards for the global BA's window fleet (port of
`voxelslam_tpu/parallel/multihost.py`, in torch.distributed's idiom).

The JAX package runs one process over every device it sees and shards a
batch of windows over a mesh of them. Here one process drives one card:
start one process a card with `torchrun --nproc-per-node=N ...` (and
`--nnodes`/`--rdzv-endpoint` for several hosts). `ensure_distributed`
then joins the process group that torchrun's environment names, and
`global_win_mesh` describes it as a `WinMesh` that
`HbaRunner(mesh=...)` splits each batch of windows over
(`parallel.dist_gba.make_window_fleet`).

A process started without torchrun is alone: `ensure_distributed` does
nothing, `global_win_mesh()` is None, and the process uses one card even
when it sees several (`resolve_device`'s "cuda", the current card).
`SlamSystem` calls both unconditionally, as the JAX system does.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class WinMesh:
    """The ranks a batch of GBA windows is split over: `size` ranks, this
    process's `rank`, their process `group` (None for a single process,
    which gathers nothing) and the `device` the group's collectives run on
    (None without a group)."""
    size: int
    rank: int
    group: object = None
    device: torch.device | None = None


def ensure_distributed(init_method: str | None = None,
                       world_size: int | None = None,
                       rank: int | None = None) -> bool:
    """Join the process group once per process: NCCL when CUDA is present
    (after `torch.cuda.set_device(LOCAL_RANK)`, so the rank's "cuda" is
    its own card), gloo on the CPU.

    Without arguments the group comes from the environment torchrun sets
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with none of it there is
    no cluster, and it returns False and does nothing. A cluster that is
    named but cannot be joined raises: the process does not carry on
    alone. Returns whether more than one rank takes part."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and world_size is None and not (
            "RANK" in env and "WORLD_SIZE" in env):
        return False
    if rank is None:
        rank = int(env["RANK"])
    if world_size is None:
        world_size = int(env["WORLD_SIZE"])
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size > 1


def global_win_mesh(min_devices: int = 2) -> WinMesh | None:
    """The mesh over every rank of the process group, or None when it has
    fewer than `min_devices` ranks. Without a group a single process is
    one rank: `min_devices=1` then gives the size-1 mesh that batches
    windows on this process's card alone.

    A batch is padded to a multiple of the mesh size (HbaRunner's fleet
    batching does this)."""
    if not dist.is_initialized():
        return WinMesh(size=1, rank=0) if min_devices <= 1 else None
    size = dist.get_world_size()
    if size < min_devices:
        return None
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return WinMesh(size=size, rank=dist.get_rank(), group=dist.group.WORLD,
                   device=device)
