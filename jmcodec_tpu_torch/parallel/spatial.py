"""Spatial (macroblock-row) sharding of the H.264 decode: one picture's MB
rows banded across the ranks of the sp group. The port of
jmcodec_tpu/parallel/spatial.py.

The wavefront's only cross-lane (cross-row) dataflow is a lane roll of its
carry (top, top-right and top-left neighbour tiles), and the deblock scan
reads the row above the same way. On the card each rank launches the scan
kernels on its band with the lane above it as a halo, one tile a diagonal
sent by the rank above after each launch (kernels/h264_scan.py); on the
CPU, under kernels/recon_tiles.lane_group, each roll of the torch scans
sends one boundary lane to the neighbouring rank and takes the other
neighbour's (a point-to-point exchange per roll per step). The finished
tiles are gathered so that every rank returns the whole picture. P pictures first predict
each band from its reference band plus MC_PAD rows of halo sent by the
neighbouring ranks (_halo_rows).

Every rank calls these functions with the same arguments (SPMD).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import recon_tiles as RT
from ..kernels._planes import edge_pad
from ..kernels.idct import dequant_idct_blocks
from ..kernels.recon import stack_motion, stack_symbols
from .mesh import ShardingConfig, build_mesh, exchange_edges, rank_device


def _check_band(fs, cfg: ShardingConfig):
    if fs.has_pcm:
        raise NotImplementedError("PCM macroblocks are not on the device "
                                  "path")
    if fs.mb_height % cfg.sp:
        raise ValueError(f"mb_height {fs.mb_height} not divisible by "
                         f"sp={cfg.sp}")


def decode_frame_rows_sharded(fs, mesh=None, cfg: ShardingConfig = None,
                              deblock=None, device=None):
    """Decode ONE intra picture with its MB rows banded over the sp group:
    the wavefront recon and the deblock both run sharded, with the
    boundary-lane exchange. Returns (Y, U, V) numpy on every rank, padded
    to whole macroblocks, bit-exact against the one-device decode. device:
    this rank's device (None: its card)."""
    if cfg is None:
        cfg = ShardingConfig.auto()
    _check_band(fs, cfg)
    if mesh is None:
        mesh = build_mesh(cfg, device)
    if deblock is None:
        deblock = fs.deblock_enabled
    sym = stack_symbols([fs], rank_device(device))
    out = RT._reconstruct(fs.mb_height, fs.mb_width, sym, bool(deblock),
                          dequant_idct_blocks,
                          group=mesh.get_group(cfg.axis_sp))
    return tuple(p[0].cpu().numpy() for p in out)


# ---------------------------------------------------------------------------
# inter (P) pictures: MC with the cross-band reference-window exchange
# ---------------------------------------------------------------------------


def _halo_rows(band, group, halo: int):
    """band [n, h_loc, W] of a row-sharded plane -> [n, halo+h_loc+halo,
    W]: the neighbouring ranks' rows arrive by point-to-point sends; the
    picture's top and bottom bands edge-replicate their own border row
    (matching the whole padded reference plane)."""
    first = band[:, :halo].contiguous()
    last = band[:, -halo:].contiguous()
    above, below = exchange_edges(group, first, last)
    if above is None:
        above = band[:, :1].expand(-1, halo, -1)
    if below is None:
        below = band[:, -1:].expand(-1, halo, -1)
    return torch.cat([above, band, below], dim=1)


def _mc_rows_sharded(group, sp_index: int, n_sp: int, mbh: int):
    """mc_fn of recon_tiles.decode_frame_inter for a row-sharded picture:
    each rank predicts its own band against a reference WINDOW (its band
    of the unpadded reference plus MC_PAD halo rows from the neighbouring
    bands, the x padding rebuilt locally), with the vertical clamp of the
    whole picture moved by the band's first row (clip_y); the bands'
    predictions are gathered over the group. Bit-exact against the
    whole-picture MC for |mvy| <= 4*(MC_PAD-8)."""
    hb = (mbh // n_sp) * 16          # luma band height (pixels)
    gb = hb // 4                     # 4x4-block rows of a band
    i = sp_index
    P_, Pc = RT.MC_PAD, RT.MC_PAD // 2

    def window(plane, h, pad):
        return edge_pad(_halo_rows(plane[:, i * h:(i + 1) * h], group, pad),
                        2, pad, pad)

    def gathered(mc):
        whole = mc.new_empty((n_sp * mc.shape[0], *mc.shape[1:]))
        RT.all_gather(whole, mc.contiguous(), group)
        return whole

    def mc(ref_y, ref_u, ref_v, mv, ref_idx):
        mv_b, ri_b = mv[i * gb:(i + 1) * gb], ref_idx[i * gb:(i + 1) * gb]
        Hp_g = mbh * 16 + 2 * P_
        mc_y = RT._mc_luma_batched(window(ref_y, hb, P_), mv_b, ri_b,
                                   clip_y=(3 - i * hb, Hp_g - 8 - i * hb))
        Hc_g = mbh * 8 + 2 * Pc
        clip_c = (0 - i * (hb // 2), Hc_g - 4 - i * (hb // 2))
        mc_u, mc_v = (RT._mc_chroma_batched(window(r, hb // 2, Pc), mv_b,
                                            ri_b, clip_y=clip_c)
                      for r in (ref_u, ref_v))
        return [gathered(m) for m in (mc_y, mc_u, mc_v)]

    return mc


def decode_frame_rows_sharded_inter(fs, refs, mesh=None,
                                    cfg: ShardingConfig = None,
                                    deblock=None, ref_ids=None):
    """Decode ONE P picture with its MB rows banded over the sp group:
    motion compensation reads each band's reference rows plus MC_PAD halo
    rows sent by the neighbouring ranks, then the intra wavefront and the
    bS deblock run row-sharded as in the intra path. refs: [(Yp, Up, Vp)]
    padded planes (pad_ref_device) in list-0 order, on this rank's device;
    ref_ids: each list index's picture identity (None: the indices).
    Returns (Y, U, V) numpy on every rank, bit-exact against
    decode_frame_symbols_inter for |mvy| <= 4*(MC_PAD-8)."""
    if cfg is None:
        cfg = ShardingConfig.auto()
    _check_band(fs, cfg)
    if (fs.mb_height // cfg.sp) * 16 < RT.MC_PAD:
        raise NotImplementedError(
            "row band shorter than the one-hop halo (MC_PAD rows)")
    if int(np.max(np.abs(np.asarray(fs.mv)[..., 1]))) > 4 * (RT.MC_PAD - 8):
        raise NotImplementedError("vertical MV beyond the halo budget")
    dev = refs[0][0].device
    if mesh is None:
        mesh = build_mesh(cfg, dev)
    if deblock is None:
        deblock = fs.deblock_enabled
    group = mesh.get_group(cfg.axis_sp)
    # refs arrive padded (pad_ref_device); strip to the picture's planes:
    # the sharded MC rebuilds the x padding locally and the y padding from
    # the halo
    P_, Pc = RT.MC_PAD, RT.MC_PAD // 2
    ref_y, ref_u, ref_v = (torch.stack([r[k] for r in refs])[:, p:-p, p:-p]
                           for k, p in enumerate((P_, Pc, Pc)))
    sym = [a[0] for a in stack_symbols([fs], dev)]
    mv, ref_idx = (a[0] for a in stack_motion([fs], dev))
    wp = None if fs.wp is None else torch.as_tensor(fs.wp, dtype=torch.int32,
                                                     device=dev)
    ids = torch.as_tensor(np.arange(len(refs)) if ref_ids is None
                          else ref_ids, dtype=torch.int32, device=dev)
    out = RT.decode_frame_inter(
        fs.mb_height, fs.mb_width, *sym, mv, ref_idx, ref_y, ref_u, ref_v,
        ids, RT.intra_steps(fs.mb_class), deblock=bool(deblock), wp=wp,
        wp_logwd=tuple(fs.wp_logwd),
        mc_fn=_mc_rows_sharded(group, mesh.get_local_rank(cfg.axis_sp),
                               cfg.sp, fs.mb_height),
        group=group)
    return tuple(p.cpu().numpy() for p in out)
