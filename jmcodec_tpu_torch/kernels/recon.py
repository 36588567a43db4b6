"""H.264 intra reconstruction, the stages shared by every scan: batched
residual decode and the three intra predictors, on int32 torch tensors.
The port of the batched parts of jmcodec_tpu/kernels/recon.py; the
wavefront that calls them is recon_tiles.py.

Every tensor may carry leading batch axes (frames, lanes); the functions
work on the trailing ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.h264 import macroblock as MB
from ..ops import intra as IP
from ..ops import transform as T
from ._tables import device_table as _t
from .idct import dequant_idct_blocks

_I32 = torch.int32

# per-blkIdx source of the top-right 4x4 neighbour's availability:
# 0 = always, 1 = avail_top, 2 = avail_topright, 3 = never
_TR_SRC = np.zeros(16, np.int32)
for _i in range(16):
    if _i in MB.TR_UNAVAILABLE_IN_MB:
        _TR_SRC[_i] = 3
    elif MB.BLK_Y[_i] > 0:
        _TR_SRC[_i] = 0
    elif MB.BLK_X[_i] == 12:
        _TR_SRC[_i] = 2
    else:
        _TR_SRC[_i] = 1

# Intra_4x4 gather table: per mode the 16 A, 16 B and 16 C neighbour
# indices of ops/intra.py, side by side, so one gather serves all three
_I4_ABC = np.concatenate([IP.I4_TAB_A.reshape(9, 16),
                          IP.I4_TAB_B.reshape(9, 16),
                          IP.I4_TAB_C.reshape(9, 16)], axis=1)    # [9, 48]
_W8 = np.arange(1, 9, dtype=np.int32)
_W4 = np.arange(1, 5, dtype=np.int32)
_RAMP16 = np.arange(16, dtype=np.int32) - 7
_RAMP8 = np.arange(8, dtype=np.int32) - 3


# ---------------------------------------------------------------------------
# residual decode (stage 1): fully batched
# ---------------------------------------------------------------------------


def _rep(a, k: int):
    """Repeat the two trailing (macroblock grid) axes k times each."""
    return a.repeat_interleave(k, -2).repeat_interleave(k, -1)


def _mb_to_blocks(v):
    """[..., mbh, mbw, k, k] per-macroblock values -> [..., mbh*k, mbw*k]
    on the 4x4-block grid."""
    *lead, mbh, mbw, k, _ = v.shape
    return v.transpose(-3, -2).reshape(*lead, mbh * k, mbw * k)


def _residuals(luma_coeffs, luma_dc, chroma_coeffs, chroma_dc, qp, mb_class,
               chroma_qp_off, second_chroma_qp_off,
               residual_fn=dequant_idct_blocks):
    """Residuals of every 4x4 block. luma_coeffs [..., mbh*4, mbw*4, 4, 4]
    and chroma_coeffs [..., 2, mbh*2, mbw*2, 4, 4] int16 or int32 levels;
    luma_dc [..., mbh, mbw, 4, 4], chroma_dc [..., 2, mbh, mbw, 2, 2];
    qp, mb_class [..., mbh, mbw] int32; the qp offsets [...] int32.
    Returns int32 (resid_y, resid_u, resid_v) in the coefficients' shapes.

    The DC values (one Hadamard per macroblock) are plain tensor ops;
    residual_fn (idct.dequant_idct_blocks, two launches: luma, then both
    chroma planes) dequantises every block, splices them in and runs the
    inverse transform."""
    dev = qp.device
    dq = _t(T.DEQUANT4x4, dev)
    ls00 = lambda q: dq[(q % 6).long()][..., 0, 0, None, None] * 16
    sh = lambda s: s.clamp(min=0)[..., None, None]
    one = torch.ones_like(qp)

    # Intra16x16 luma DC (8.5.10): inverse Hadamard, then exact scaling
    f = T.hadamard_4x4(luma_dc.to(_I32)) * ls00(qp)
    q6 = qp // 6
    dc_y = torch.where((qp >= 36)[..., None, None], f << sh(q6 - 6),
                       (f + (one << (5 - q6).clamp(min=0))[..., None, None])
                       >> sh(6 - q6))
    resid_y = residual_fn(
        luma_coeffs.reshape(-1, 4, 4), _rep(qp, 4).reshape(-1),
        _mb_to_blocks(dc_y).reshape(-1),
        _rep(mb_class == 1, 4).reshape(-1)).reshape(luma_coeffs.shape)

    # chroma DC (8.5.11), Cb and Cr together on the axis before the grid
    offs = torch.stack([chroma_qp_off, second_chroma_qp_off], dim=-1)
    qpc = _t(T.CHROMA_QP, dev)[(qp[..., None, :, :] + offs[..., None, None])
                               .clamp(0, 51).long()]
    fc = T.hadamard_2x2(chroma_dc.to(_I32)) * ls00(qpc)
    dc_c = (fc << (qpc // 6)[..., None, None]) >> 5
    resid_c = residual_fn(
        chroma_coeffs.reshape(-1, 4, 4), _rep(qpc, 2).reshape(-1),
        _mb_to_blocks(dc_c).reshape(-1)).reshape(chroma_coeffs.shape)
    return resid_y, resid_c.select(-5, 0), resid_c.select(-5, 1)


# ---------------------------------------------------------------------------
# intra predictors (spec 8.3), batched over the leading axes
# ---------------------------------------------------------------------------


def _sum(x):
    """Sum over the last axis, kept in int32 (torch's default widens it)."""
    return x.sum(-1, dtype=_I32)


def _dc(sum_t, sum_l, avail_t, avail_l, log2n: int):
    """DC value from the top and left sums of 2^log2n samples each."""
    r = 1 << (log2n - 1)
    return torch.where(
        avail_t & avail_l, (sum_t + sum_l + 2 * r) >> (log2n + 1),
        torch.where(avail_l, (sum_l + r) >> log2n,
                    torch.where(avail_t, (sum_t + r) >> log2n, 128)))


def _pred_i4_batch(n, modes, avail_t, avail_l):
    """Intra_4x4: n [..., 13] neighbour vectors (ops/intra.py's layout),
    modes [...] -> [..., 4, 4]. The directional modes are one integer
    gather: (n[A] + 2 n[B] + n[C] + 2) >> 2."""
    idx = _t(_I4_ABC, n.device, torch.int64)[modes.long()]       # [..., 48]
    a, b, c = torch.gather(n, -1, idx).split(16, dim=-1)
    pred_dir = ((a + 2 * b + c + 2) >> 2).reshape(*modes.shape, 4, 4)
    dc = _dc(_sum(n[..., 5:9]), _sum(n[..., 0:4]), avail_t, avail_l, 2)
    return torch.where((modes == IP.I4_DC)[..., None, None],
                       dc[..., None, None], pred_dir)


def _plane(t, l, tl, size: int):
    """Plane prediction (8.3.3.4 for 16, 8.3.4.4 for 8) from the top row t
    and left column l [..., size] and the corner tl [...]."""
    half = size // 2
    dev = t.device
    w = _t(_W8 if size == 16 else _W4, dev)
    ramp = _t(_RAMP16 if size == 16 else _RAMP8, dev)

    def grad(e):
        ext = torch.cat([tl[..., None], e], dim=-1)
        return _sum(w * (ext[..., half + 1:] - ext[..., :half].flip(-1)))
    a = 16 * (l[..., size - 1] + t[..., size - 1])
    if size == 16:
        b, c = (5 * grad(t) + 32) >> 6, (5 * grad(l) + 32) >> 6
    else:
        b, c = (17 * grad(t) + 16) >> 5, (17 * grad(l) + 16) >> 5
    return ((a[..., None, None] + b[..., None, None] * ramp
             + c[..., None, None] * ramp[:, None] + 16) >> 5).clamp(0, 255)


def _pred_16_batch(t16, l16, tl, mode, avail_t, avail_l):
    """Intra_16x16 for a batch of macroblocks. t16, l16 [..., 16]; tl,
    mode, avail_* [...] -> [..., 16, 16]."""
    shape = (*t16.shape, 16)
    v = t16[..., None, :].expand(shape)
    h = l16[..., :, None].expand(shape)
    dc = _dc(_sum(t16), _sum(l16), avail_t, avail_l, 4)
    m = mode[..., None, None]
    return torch.where(m == IP.I16_V, v, torch.where(
        m == IP.I16_H, h, torch.where(
            m == IP.I16_DC, dc[..., None, None], _plane(t16, l16, tl, 16))))


def _pred_chroma_batch(t8, l8, tl, mode, avail_t, avail_l):
    """Chroma 8x8 prediction. t8, l8 [..., 8] -> [..., 8, 8]."""
    shape = (*t8.shape, 8)
    v = t8[..., None, :].expand(shape)
    h = l8[..., :, None].expand(shape)
    # DC per 4x4 quadrant (8.3.4.1-3): which neighbours each may use
    ts = _sum(t8.reshape(*t8.shape[:-1], 2, 4))             # [..., bx]
    ls = _sum(l8.reshape(*l8.shape[:-1], 2, 4))             # [..., by]
    only_t = lambda s: torch.where(avail_t, (s + 2) >> 2, 128)
    only_l = lambda s: torch.where(avail_l, (s + 2) >> 2, 128)
    quad = {}
    for by in (0, 1):
        for bx in (0, 1):
            t, l = ts[..., bx], ls[..., by]
            if bx == by:
                quad[by, bx] = _dc(t, l, avail_t, avail_l, 2)
            elif bx == 1:
                quad[by, bx] = torch.where(avail_t, (t + 2) >> 2, only_l(l))
            else:
                quad[by, bx] = torch.where(avail_l, (l + 2) >> 2, only_t(t))
    dc = torch.stack([torch.stack([quad[0, 0], quad[0, 1]], -1),
                      torch.stack([quad[1, 0], quad[1, 1]], -1)], -2)
    dc = dc.repeat_interleave(4, -2).repeat_interleave(4, -1)
    m = mode[..., None, None]
    return torch.where(m == IP.IC_DC, dc, torch.where(
        m == IP.IC_H, h, torch.where(
            m == IP.IC_V, v, _plane(t8, l8, tl, 8))))


# ---------------------------------------------------------------------------
# FrameSymbols -> device arguments
# ---------------------------------------------------------------------------

_NARROW = {"mb_class": np.int8, "qp": np.int8, "i4_modes": np.int8,
           "i16_mode": np.int8, "chroma_mode": np.int8,
           "luma_coeffs": np.int16, "luma_dc": np.int16,
           "chroma_coeffs": np.int16, "chroma_dc": np.int16,
           "avail_left": np.int8, "avail_top": np.int8,
           "avail_topright": np.int8}
_SCALARS = ("alpha_off", "beta_off", "chroma_qp_off", "second_chroma_qp_off")
# a P picture's motion: quarter-pel MVs fit int16 at every level's range,
# list-0 indices (-1 intra) int8
_NARROW_MOTION = {"mv": np.int16, "ref": np.int8}


def stack_symbols(fss, device=None):
    """Same-geometry FrameSymbols -> the tensor arguments of
    recon_tiles.decode_frames_batch, each with a leading frame axis, on
    `device` (None: the card). Planes travel in the narrowest exact dtype
    (levels fit int16 at every legal QP, metadata int8); the decode widens
    the metadata on the device and reads the levels as they are."""
    if device is None:
        from ..utils.device import require_cuda
        device = require_cuda()
    scal = [torch.tensor([getattr(f, n) for f in fss], dtype=_I32,
                         device=device) for n in _SCALARS]
    return _stack(fss, _NARROW, device) + scal


def stack_motion(fss, device=None):
    """The motion planes (mv [F, mbh*4, mbw*4, 2] int16, ref [F, mbh*4,
    mbw*4] int8) of same-geometry P-picture FrameSymbols on `device` (None:
    the card), narrowed as stack_symbols narrows."""
    if device is None:
        from ..utils.device import require_cuda
        device = require_cuda()
    return _stack(fss, _NARROW_MOTION, device)


def _stack(fss, narrow, device):
    return [torch.from_numpy(np.stack([getattr(f, n) for f in fss])
                             .astype(dt, copy=False)).to(device)
            for n, dt in narrow.items()]
