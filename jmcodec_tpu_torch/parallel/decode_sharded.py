"""The codec's decode under a (dp, sp) mesh: the port of
jmcodec_tpu/parallel/decode_sharded.py.

  decode stage   frames split over EVERY rank (dp x sp jointly): each rank
                 runs the H.264 all-intra batch decode
                 (kernels/recon_tiles.decode_frames_batch, with the CUDA
                 dequant+IDCT on the card) on its own frames
  reshard        frame-parallel -> row-parallel: all_gather over sp, then
                 each sp rank keeps its own row band
  spatial stage  2x downscale whose vertical filter takes one halo row from
                 each sp neighbour, then the intra-encode forward pass; the
                 rate statistics all_reduced over the whole mesh

Every rank calls these functions with the same arguments (SPMD); where the
JAX package returns a whole array from one controller, every rank here
returns the whole array.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import recon_tiles
from ..kernels.recon import stack_symbols
from .mesh import ShardingConfig, build_mesh, rank_device, shard_batch
from .transcode import _downscale2x_with_halo, _encode_forward, gather_levels


def pad_batch(arrs: List, ways: int) -> Tuple[list, int]:
    """Pad the leading frame axis to a multiple of `ways` by repeating the
    last frame; returns (padded args, original length)."""
    n = int(arrs[0].shape[0])
    pad = (-n) % ways
    if pad == 0:
        return list(arrs), n
    return [torch.cat([a] + [a[-1:]] * pad, dim=0) for a in arrs], n


def make_h264_decode_sharded(mesh, cfg: ShardingConfig, mbh: int, mbw: int,
                             deblock: bool = True):
    """The sharded decode: fn(*args) with args this rank's block of the 16
    symbol tensors of decode_frames_batch (stack_symbols, then shard_batch)
    -> this rank's (Y, U, V) uint8 [F/n, 16*mbh, 16*mbw]."""
    def step(*args):
        return recon_tiles.decode_frames_batch(mbh, mbw, *args,
                                               deblock=deblock)
    return step


def _gather_frames(planes):
    """Every rank's frame blocks concatenated in rank order, to numpy."""
    n = dist.get_world_size()
    out = []
    for p in planes:
        whole = p.new_empty((n * p.shape[0], *p.shape[1:]))
        recon_tiles.all_gather(whole, p.contiguous())
        out.append(whole.cpu().numpy())
    return out


def decode_symbols_sharded(fss, cfg: ShardingConfig = None, mesh=None,
                           deblock: bool = True, device=None):
    """Same-geometry FrameSymbols -> (Y, U, V) numpy [F, h, w] on every
    rank, decoded with the frames split over every rank of the mesh;
    bit-exact against the one-device decode. device: this rank's device
    (None: its card)."""
    if cfg is None:
        cfg = ShardingConfig.auto()
    if mesh is None:
        mesh = build_mesh(cfg, device)
    args, n = pad_batch(stack_symbols(fss, rank_device(device)),
                        cfg.n_devices)
    fn = make_h264_decode_sharded(mesh, cfg, fss[0].mb_height,
                                  fss[0].mb_width, deblock=deblock)
    Y, U, V = _gather_frames(fn(*(shard_batch(mesh, cfg, a) for a in args)))
    return Y[:n], U[:n], V[:n]


def make_transcode_real_step(mesh, cfg: ShardingConfig, mbh: int, mbw: int,
                             qp_out: int = 30, deblock: bool = True):
    """The whole multichip step: the H.264 decode (frame-parallel over
    every rank) -> all_gather over sp and the row-band reshard -> the halo
    downscale -> the intra-encode forward pass -> the rate statistics summed
    over the mesh.

    Returns fn(*args) with args this rank's block of the symbol tensors
    (shard_batch) -> (levels, bits, ssd): levels this rank's [F/dp,
    16*mbh/(8*sp), 16*mbw/8, 4, 4] block (frames over dp, rows over sp);
    bits and ssd int64 0-d tensors, the mesh's sums."""
    sp_group = mesh.get_group(cfg.axis_sp)
    sp_index = mesh.get_local_rank(cfg.axis_sp)
    rows = mbh * 16 // cfg.sp

    def step(*args):
        Y, _, _ = recon_tiles.decode_frames_batch(mbh, mbw, *args,
                                                  deblock=deblock)
        # reshard frame-parallel -> row-parallel: gather the sp group's
        # frames, keep this rank's row band
        Yg = Y.new_empty((cfg.sp * Y.shape[0], *Y.shape[1:]))
        recon_tiles.all_gather(Yg, Y.contiguous(), sp_group)
        Yb = Yg[:, sp_index * rows:(sp_index + 1) * rows]
        Ys = _downscale2x_with_halo(Yb.to(torch.int32), sp_group)
        z, bits, ssd = _encode_forward(Ys, qp_out)
        stats = torch.stack([bits, ssd])
        dist.all_reduce(stats)
        return z, stats[0], stats[1]

    return step


def run_transcode_real_step(fss, cfg: ShardingConfig, qp_out: int = 30,
                            device=None):
    """make_transcode_real_step on a list of FrameSymbols (padded to the
    mesh), every rank taking its block: returns (levels numpy [F, h/8,
    w/8, 4, 4], bits, ssd) on every rank."""
    mesh = build_mesh(cfg, device)
    args, _ = pad_batch(stack_symbols(fss, rank_device(device)),
                        cfg.n_devices)
    step = make_transcode_real_step(mesh, cfg, fss[0].mb_height,
                                    fss[0].mb_width, qp_out)
    z, bits, ssd = step(*(shard_batch(mesh, cfg, a) for a in args))
    return gather_levels(mesh, cfg, z), int(bits), int(ssd)


def _synthetic_symbols(mbh: int, mbw: int, n: int, qp: int = 30):
    """Valid intra FrameSymbols without needing a bitstream (for dryruns)."""
    from ..codec.h264.symbols import FrameSymbols
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        fs = FrameSymbols(mbw, mbh)
        fs.mb_class[:] = rng.integers(0, 2, (mbh, mbw))
        fs.qp[:] = qp
        fs.i4_modes[:] = 2
        fs.i16_mode[:] = 2
        fs.chroma_mode[:] = 0
        fs.luma_coeffs[:] = rng.integers(-8, 9, fs.luma_coeffs.shape)
        fs.luma_dc[:] = rng.integers(-16, 17, fs.luma_dc.shape)
        fs.chroma_coeffs[:] = rng.integers(-4, 5, fs.chroma_coeffs.shape)
        fs.chroma_dc[:] = rng.integers(-8, 9, fs.chroma_dc.shape)
        fs.fill_availability(np.zeros((mbh, mbw), np.int32))
        out.append(fs)
    return out


def run_decode_sharded_dryrun(n_devices=None, mbh: int = 4, mbw: int = 4,
                              device=None):
    """The dryrun: ONE whole sharded step (the decode, the all_gather
    reshard, the halo downscale, the psum'd statistics) on tiny shapes over
    every rank (ShardingConfig.auto(n_devices)). Returns (levels, bits,
    ssd, cfg) on every rank."""
    cfg = ShardingConfig.auto(n_devices)
    # rows after downscale must tile 4x4 per sp band: mbh*16/(2*sp) % 4 == 0
    mbh = max(mbh, cfg.sp)
    fss = _synthetic_symbols(mbh, mbw, n=max(2 * cfg.n_devices, 4))
    z, bits, ssd = run_transcode_real_step(fss, cfg, device=device)
    return z, bits, ssd, cfg
