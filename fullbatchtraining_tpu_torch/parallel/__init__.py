"""Data parallelism across processes (``fullbatchtraining_tpu/parallel/mesh.py``).

The JAX package runs one program over a mesh of devices; the port runs one
process per card (``torchrun``, or ``impl.setup.{url,world_size,rank}``) in a
``torch.distributed`` group: NCCL for CUDA tensors, gloo for CPU tensors
(:func:`setup_distributed` takes another, e.g. gloo for two ranks that share
one card). A :class:`World` stands where the JAX package has the mesh's ``data``
axis: ``rank`` is the index ``jax.lax.axis_index`` gives there, ``size`` the
mesh's device count ``W``.

The port calls four collectives and only these: :func:`all_reduce` (a sum),
:func:`all_gather` (of L-BFGS's sharded vectors, ``impl.shard_opt_vectors``),
:func:`broadcast` (of an integer, or :func:`broadcast_flags` of booleans: the
loss surface's pending positions) and :func:`barrier`. Gloo takes all four for CUDA tensors
too. Each call adds one to ``calls[name]``. Without a process group (one
process, ``group is None``) each returns its input and counts nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch
import torch.distributed as dist

calls = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "barrier": 0}


def reset_counts() -> None:
    for name in calls:
        calls[name] = 0


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the job: ``rank`` of ``size``, and the process
    group its collectives run in (None: one process, no group)."""

    rank: int = 0
    size: int = 1
    group: object = None


def current_world() -> World:
    """The default process group's world, or one process where none is set up."""
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)
    return World()


def setup_distributed(cfg_setup, device, backend: str | None = None) -> World:
    """Join the job that ``impl/setup=distributed`` asks for and return its world.

    The rendezvous is ``tcp://<impl.setup.url>`` where a url is set, else
    ``env://`` where ``MASTER_ADDR`` is (torchrun also sets ``RANK`` and
    ``WORLD_SIZE``); ``impl.setup.world_size`` and ``rank`` win over the
    environment. With neither and a world size of 1 the group is one process
    on an in-memory store, so one process runs the same code path. A failed
    rendezvous raises: the job never carries on as one process. Without
    ``impl.setup.dist`` there is no group."""
    if not cfg_setup.get("dist"):
        return World()
    if dist.is_initialized():
        return current_world()
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    env = os.environ
    size = int(cfg_setup.get("world_size") or env.get("WORLD_SIZE", 1))
    rank = int(cfg_setup.rank if cfg_setup.get("rank") is not None else env.get("RANK", 0))
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is outside a world of {size} processes")
    if cfg_setup.get("url"):
        rendezvous = {"init_method": f"tcp://{cfg_setup.url}"}
    elif env.get("MASTER_ADDR"):
        rendezvous = {"init_method": "env://"}
    elif size == 1:
        rendezvous = {"store": dist.HashStore()}
    else:
        raise RuntimeError(f"impl.setup.world_size={size} with nothing to rendezvous with: set "
                           "impl.setup.url or launch with torchrun")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(backend, world_size=size, rank=rank, **rendezvous)
    except (RuntimeError, ValueError) as err:
        raise RuntimeError(f"the rendezvous of the {size}-process job failed ({err}); "
                           "refusing to continue as one process") from err
    return current_world()


def shutdown(world: World) -> None:
    """Destroy the world's process group, where it has one."""
    if world.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def all_reduce(world: World, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the ranks, in place."""
    if world.group is not None:
        calls["all_reduce"] += 1
        dist.all_reduce(tensor, group=world.group)
    return tensor


def all_gather(world: World, tensor: torch.Tensor) -> torch.Tensor:
    """The ranks' ``tensor``s (each of one length) concatenated in rank order."""
    if world.group is None:
        return tensor
    calls["all_gather"] += 1
    out = tensor.new_empty((world.size * tensor.shape[0], *tensor.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, tensor.contiguous(), group=world.group)
    return out


def broadcast(world: World, value: int) -> int:
    """Rank 0's integer ``value``, on every rank."""
    if world.group is None:
        return value
    calls["broadcast"] += 1
    on = (torch.device("cuda", torch.cuda.current_device())
          if dist.get_backend(world.group) == "nccl" else torch.device("cpu"))
    tensor = torch.tensor([value], dtype=torch.int64, device=on)
    dist.broadcast(tensor, src=0, group=world.group)
    return int(tensor.item())


def broadcast_flags(world: World, flags) -> list:
    """Rank 0's list of booleans ``flags``, on every rank (each rank passes
    a list of the same length)."""
    flags = [bool(f) for f in flags]
    if world.group is None or not flags:
        return flags
    calls["broadcast"] += 1
    on = (torch.device("cuda", torch.cuda.current_device())
          if dist.get_backend(world.group) == "nccl" else torch.device("cpu"))
    tensor = torch.tensor(flags, dtype=torch.uint8, device=on)
    dist.broadcast(tensor, src=0, group=world.group)
    return [bool(v) for v in tensor.tolist()]


def barrier(world: World) -> None:
    if world.group is not None:
        calls["barrier"] += 1
        dist.barrier(group=world.group)


def all_reduce_parts(world: World, parts) -> list:
    """The sum over the ranks of each tensor of ``parts``, through one
    :func:`all_reduce` of one flat bucket in the widest of their floating
    dtypes (each cast into it exact), each sum cast back to its part's dtype.
    Without a group, ``parts`` themselves."""
    parts = list(parts)
    if world.group is None:
        return parts
    dtype = functools.reduce(torch.promote_types, [p.dtype for p in parts])
    bucket = torch.cat([p.reshape(-1).to(dtype) for p in parts])
    all_reduce(world, bucket)
    pieces = bucket.split([p.numel() for p in parts])
    return [piece.view(p.shape).to(p.dtype) for piece, p in zip(pieces, parts)]
