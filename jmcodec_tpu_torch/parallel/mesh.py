"""Mesh and sharding configuration: the port of jmcodec_tpu/parallel/mesh.py.

  dp - GOP/frame data parallelism (independent closed GOPs across ranks)
  sp - spatial parallelism (frame rows across ranks, with a halo exchange
       between sp neighbours for the filters that cross a band's edge)

One process per rank and one device per process. A mesh is a
torch.distributed DeviceMesh over every rank of the world, shaped (dp, sp)
with rank = dp_index * sp + sp_index, as the JAX package reshapes its
device list; its per-dimension process groups carry the collectives. The
backend follows the device: NCCL on the card, gloo on the CPU. A process
that has no process group yet gets a one-rank group of that backend, so a
sharded function runs at world size 1 through the same collectives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import require_cuda


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass
class ShardingConfig:
    dp: int = 1          # frame/GOP-parallel ways
    sp: int = 1          # spatial (row-shard) ways
    axis_dp: str = "dp"
    axis_sp: str = "sp"

    @property
    def n_devices(self) -> int:
        return self.dp * self.sp

    @staticmethod
    def auto(n_devices: Optional[int] = None, sp: int = 2) -> "ShardingConfig":
        """n_devices None: the world size."""
        n = n_devices or world_size()
        if n == 1:
            return ShardingConfig(1, 1)
        sp = min(sp, n)
        while n % sp:
            sp -= 1
        return ShardingConfig(dp=n // sp, sp=sp)


def rank_device(device=None) -> torch.device:
    """The device this rank works on: `device` as given, or for None this
    rank's card (rank modulo the cards of the host; raises without one)."""
    if device is not None:
        return torch.device(device)
    require_cuda()
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count()
                        if dist.is_initialized() else 0)


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def ensure_process_group(device: torch.device) -> None:
    """A one-rank process group of the device's backend where the process
    has none; raises where the group it has is of another backend."""
    want = backend_for(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() != want:
        raise RuntimeError(f"process group backend {dist.get_backend()}, "
                           f"device {device} needs {want}")


def build_mesh(cfg: ShardingConfig, device=None) -> DeviceMesh:
    """The (dp, sp) DeviceMesh over every rank (collective: every rank
    calls it). device: this rank's device (rank_device)."""
    dev = rank_device(device)
    ensure_process_group(dev)
    if world_size() != cfg.n_devices:
        raise ValueError(f"need {cfg.n_devices} ranks, have {world_size()}")
    return init_device_mesh(dev.type, (cfg.dp, cfg.sp),
                            mesh_dim_names=(cfg.axis_dp, cfg.axis_sp))


def mesh_index(mesh: DeviceMesh, cfg: ShardingConfig) -> tuple[int, int]:
    """This rank's (dp, sp) coordinates."""
    return (mesh.get_local_rank(cfg.axis_dp), mesh.get_local_rank(cfg.axis_sp))


def _block(arr, i: int, n: int, axis: int):
    size = arr.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of size {size} does not split {n} ways")
    k = size // n
    idx = [slice(None)] * axis + [slice(i * k, (i + 1) * k)]
    return arr[tuple(idx)]


def shard_frames(mesh: DeviceMesh, cfg: ShardingConfig, arr):
    """This rank's block of a frame batch [B, H, W]: frames over dp, rows
    over sp (the JAX package's P("dp", "sp", None))."""
    d, s = mesh_index(mesh, cfg)
    return _block(_block(arr, d, cfg.dp, 0), s, cfg.sp, 1)


def shard_batch(mesh: DeviceMesh, cfg: ShardingConfig, arr):
    """This rank's block of the leading (frame) axis split over every rank,
    dp and sp jointly (P(("dp", "sp"))); the other axes whole."""
    d, s = mesh_index(mesh, cfg)
    return _block(arr, d * cfg.sp + s, cfg.n_devices, 0)


def exchange_edges(group, first, last):
    """Halo exchange with the group's neighbours, in rank order: send
    `first` to the previous rank and `last` to the next. Returns
    (the previous rank's last, the next rank's first), None at the group's
    two ends. Tensors must be contiguous and of one shape on every rank."""
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    peer = lambda r: dist.get_global_rank(group, r)
    ops, got = [], [None, None]
    if me > 0:
        got[0] = torch.empty_like(last)
        ops += [dist.P2POp(dist.isend, first, peer(me - 1), group),
                dist.P2POp(dist.irecv, got[0], peer(me - 1), group)]
    if me < n - 1:
        got[1] = torch.empty_like(first)
        ops += [dist.P2POp(dist.isend, last, peer(me + 1), group),
                dist.P2POp(dist.irecv, got[1], peer(me + 1), group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(got)
