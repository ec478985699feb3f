"""The shard group: one rank per shard of the sharded counter.

The JAX package lays its shards over a `jax.sharding.Mesh` of devices
driven by one controller (`tsxcount_tpu/parallel/mesh.py`).  Here every
shard is a process (a rank of a `torch.distributed` process group) with
one device of its own, and the ranks exchange k-mers with collectives:
NCCL on the card, gloo only when asked for (CPU tensors; gloo also stages
CUDA tensors through the host).  Nothing falls back from one to the other.

A group is joined, or made from an `init_method` the caller names, where
the processes were started by a launcher (`torchrun`: its RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK), by the command
line's --shards, or by the caller (`torch.distributed.init_process_group`
before the counter is built).  A single shard in a plain process makes
no group: its exchange is the identity and every collective is local.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from tsxcount_tpu_torch._build import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    rank: int              # this process's shard
    world_size: int        # shards, one a rank
    device: torch.device   # this rank's device
    backend: str | None    # "nccl" or "gloo"; None: one shard, no group

    @property
    def joined(self) -> bool:
        """Whether the collectives go through a process group."""
        return self.backend is not None


def default_device(rank: int) -> torch.device:
    """The rank's own card: cuda:LOCAL_RANK (a launcher's), else
    cuda:rank.  Raises where no GPU is present."""
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}")


def _rank_device(device, rank: int) -> torch.device:
    """`device`, where None or "cuda" without an index is the rank's own
    card."""
    dev = None if device is None else resolve_device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        return default_device(rank)
    return dev


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _check_backend(backend: str | None, dev: torch.device) -> None:
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if dev.type == "cpu" and (backend or "gloo") != "gloo":
        raise ValueError(f"a {backend} process group cannot exchange CPU "
                         f"tensors: use backend='gloo' with device='cpu'")


def _launched() -> bool:
    return "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


def init_shard_group(n_shards: int, device=None, backend: str | None = None,
                     init_method: str | None = None,
                     rank: int | None = None) -> ShardGroup:
    """Join the process group of `n_shards` ranks: the one that exists, the
    one `init_method` (with `rank`) names, or a launcher's; one shard
    with none of these runs alone, with no group.  Makes `device`
    (default, or "cuda" without an index: the rank's own card) the
    current CUDA device, as the kernels launch on it.  backend: "nccl"
    (the default on the card) or "gloo" (the default on the CPU, which
    must be asked for with device="cpu").  Raises when the group's size
    is not n_shards, or its backend not the one asked."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if not dist.is_initialized():
        if init_method is None and _launched():
            world = int(os.environ["WORLD_SIZE"])
            if world != n_shards:
                raise ValueError(f"n_shards={n_shards} but the launcher "
                                 f"started {world} ranks")
            if n_shards > 1:
                init_method, rank = "env://", int(os.environ["RANK"])
        if init_method is None:
            if n_shards > 1:
                raise ValueError(
                    f"n_shards={n_shards} needs {n_shards} ranks, one a "
                    f"shard: start them with torchrun or the command "
                    f"line's --shards, or call "
                    f"torch.distributed.init_process_group first")
            dev = _rank_device(device, 0)
            _check_backend(backend, dev)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            return ShardGroup(rank=0, world_size=1, device=dev, backend=None)
        if rank is None:
            raise ValueError("init_method needs this process's rank")
        dev = _rank_device(device, rank)
        _check_backend(backend, dev)
        dist.init_process_group(backend or default_backend(dev),
                                init_method=init_method,
                                world_size=n_shards, rank=rank)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != n_shards:
        raise ValueError(f"n_shards={n_shards} but the process group has "
                         f"{world} ranks")
    dev = _rank_device(device, rank)
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"backend {backend!r} asked for, but the process "
                         f"group runs {have!r}")
    _check_backend(have, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return ShardGroup(rank=rank, world_size=world, device=dev, backend=have)
