"""Sharded transcode step: decoded frames -> 2x downscale -> intra encode
forward pass, SPMD over a (dp, sp) mesh with explicit collectives. The
port of jmcodec_tpu/parallel/transcode.py.

Frames are split batch-over-dp and rows-over-sp. The vertical [1,2,1]/4
pre-filter of the downscaler needs one halo row from each sp neighbour
(point-to-point sends, the JAX package's ppermute), and the rate-control
statistics are summed over the whole mesh with all_reduce (its psum).
Every rank calls a step with its own block; the levels stay sharded, the
sums are the mesh's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kernels._tables import device_table
from ..ops import transform as T
from .mesh import (ShardingConfig, build_mesh, exchange_edges, rank_device,
                   shard_frames)


def _downscale2x_with_halo(Y, group):
    """[B, h_shard, W] int32 -> [B, h_shard/2, W/2]; the vertical [1,2,1]/4
    smoothing takes the previous sp rank's last row and the next one's
    first; the frame's top and bottom bands replicate their edge row."""
    first, last = Y[:, :1].contiguous(), Y[:, -1:].contiguous()
    up, down = exchange_edges(group, first, last)
    up = first if up is None else up
    down = last if down is None else down
    ext = torch.cat([up, Y, down], dim=1)                     # [B, h+2, W]
    smoothed = (ext[:, :-2] + 2 * ext[:, 1:-1] + ext[:, 2:] + 2) >> 2
    # horizontal smoothing needs no halo (the full width is local)
    extw = torch.cat([smoothed[..., :1], smoothed, smoothed[..., -1:]], -1)
    sm = (extw[..., :-2] + 2 * extw[..., 1:-1] + extw[..., 2:] + 2) >> 2
    return sm[:, ::2, ::2]


def _encode_forward(Y, qp: int):
    """Batched intra forward pass on a row band: 4x4 transform, quantiser
    and exact recon against a flat-DC prediction. Returns (levels [B, h/4,
    w/4, 4, 4] int32, bits estimate, ssd), the two sums int64 0-d."""
    B, h, w = Y.shape
    dev = Y.device
    resid = Y.to(torch.int32) - 128
    blocks = resid.reshape(B, h // 4, 4, w // 4, 4).permute(0, 1, 3, 2, 4)
    wt = T.forward_transform_4x4(blocks)
    z = T.quant_4x4(wt, qp, True, device_table(T.QUANT_MF4x4, dev))
    qps = torch.full(z.shape[:-2], qp, dtype=torch.int32, device=dev)
    d = T.dequant_4x4(z, qps, device_table(T.DEQUANT4x4, dev))
    rec = T.inverse_transform_4x4(d)
    err = (rec - blocks).to(torch.int64)
    ssd = (err * err).sum()
    bits = z.abs().sum(dtype=torch.int64) * 2 + (z != 0).sum()
    return z, bits, ssd


def make_transcode_step(mesh, cfg: ShardingConfig, qp: int = 30):
    """The SPMD transcode step of a mesh: step(Y) with Y this rank's block
    [B/dp, H/sp, W] of the decoder's frames (shard_frames), uint8 or int.
    Returns (levels [B/dp, H/(8*sp), W/8, 4, 4] int32, this rank's block of
    the downscaled, transformed and quantised frames; bits, ssd: int64
    0-d tensors summed over the whole mesh)."""
    sp_group = mesh.get_group(cfg.axis_sp)

    def step(Y):
        Ys = _downscale2x_with_halo(Y.to(torch.int32), sp_group)
        z, bits, ssd = _encode_forward(Ys, qp)
        stats = torch.stack([bits, ssd])
        dist.all_reduce(stats)
        return z, stats[0], stats[1]

    return step


def gather_levels(mesh, cfg: ShardingConfig, z):
    """Every rank's levels block assembled into the whole [B, H/8, W/8, 4,
    4] array (numpy) on every rank, the JAX step's global result."""
    n = cfg.n_devices
    parts = [torch.empty_like(z) for _ in range(n)]
    dist.all_gather(parts, z.contiguous())
    grid = [[parts[d * cfg.sp + s].cpu().numpy() for s in range(cfg.sp)]
            for d in range(cfg.dp)]
    return np.concatenate([np.concatenate(row, axis=1) for row in grid])


def run_transcode_step(Y, cfg: ShardingConfig, qp: int = 30, device=None):
    """One sharded transcode step on the whole frame batch Y [B, H, W]
    (numpy, the same on every rank): each rank takes its block, and every
    rank returns (levels numpy [B, H/8, W/8, 4, 4], bits, ssd)."""
    mesh = build_mesh(cfg, device)
    step = make_transcode_step(mesh, cfg, qp=qp)
    dev = rank_device(device)
    z, bits, ssd = step(torch.from_numpy(
        np.ascontiguousarray(shard_frames(mesh, cfg, Y))).to(dev))
    return gather_levels(mesh, cfg, z), int(bits), int(ssd)


def run_transcode_demo(n_devices=None, B: int = 2, H: int = 64, W: int = 64,
                       qp: int = 30, device=None):
    """One sharded transcode step on seeded frames over every rank
    (ShardingConfig.auto(n_devices)), tiny shapes: the multichip dryrun's
    first check. Returns (levels, bits, ssd, cfg) on every rank."""
    cfg = ShardingConfig.auto(n_devices)
    rng = np.random.default_rng(0)
    # shapes must tile: rows divisible by sp * 8 (downscale 2x then 4x4 grid)
    H = max(H, cfg.sp * 16)
    B = max(B, cfg.dp)
    Y = rng.integers(0, 256, (B, H, W), np.uint8)
    z, bits, ssd = run_transcode_step(Y, cfg, qp, device)
    return z, bits, ssd, cfg
