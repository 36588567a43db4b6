"""H.264 all-intra batched reconstruction in skewed tile space: symbol
tensors in, uint8 (Y, U, V) out. The port of the intra path of
jmcodec_tpu/kernels/recon_tiles.py.

    MB (my, mx) -> diagonal d = mx + 2*my, lane k = my
    tiles[d] : [lanes, 16, 16]  - all MBs of one wavefront step

The neighbours of (d, k) are (d-1, k) = left, (d-2, k-1) = top,
(d-1, k-1) = top-right and (d-3, k-1) = top-left: recent diagonals, rolled
by one lane. Stages:

  1. residuals  - recon._residuals: the dequant+IDCT CUDA kernel on the
                  card, its plain torch version on the CPU (idct.py)
  2. intra scan - a Python loop over the diagonals that carries the last
                  three and emits each finished one
  3. deblock    - a second loop, two diagonals behind: a tile is final once
                  its right and bottom neighbours have filtered the edges
                  they share with it

Every tensor has a leading frame axis; the lane axis is the second, and
the only cross-lane operation is a roll along it, so frames never mix.
All pixel math is exact int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec.h264 import macroblock as MB
from ..ops import deblock as DB
from ..ops import transform as T
from ._tables import device_table as _t
from .idct import dequant_idct_blocks
from .recon import (_TR_SRC, _pred_16_batch, _pred_chroma_batch,
                    _pred_i4_batch, _residuals, stack_symbols)

_I32 = torch.int32
_LANE = 1       # axis of the wavefront lanes, after the frame axis


# ---------------------------------------------------------------------------
# skew helpers (static per geometry)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _skew_geometry(mbh: int, mbw: int):
    """Tile schedule with lane == my, so the top and top-right neighbours
    of lane k are lane k-1 of an earlier diagonal. Returns (mys, mxs,
    valid) int32 [n_steps, mbh]."""
    n_steps = mbw + 2 * (mbh - 1)
    ks = np.arange(mbh)
    mys = np.broadcast_to(ks[None, :], (n_steps, mbh)).astype(np.int32)
    mxs = (np.arange(n_steps)[:, None] - 2 * ks[None, :]).astype(np.int32)
    valid = ((mxs >= 0) & (mxs < mbw)).astype(np.int32)
    mxs = np.clip(mxs, 0, mbw - 1)
    return mys, mxs, valid


def _to_tiles(plane_blocks, mbh: int, mbw: int, sub: int):
    """[F, mbh*s, mbw*s, 4, 4] block array -> [F, mbh, mbw, 4s, 4s] tiles."""
    s = sub
    return plane_blocks.reshape(-1, mbh, s, mbw, s, 4, 4) \
        .permute(0, 1, 3, 2, 5, 4, 6).reshape(-1, mbh, mbw, 4 * s, 4 * s)


def _skew(arr_mb, mys, mxs):
    """[F, mbh, mbw, ...] -> [F, n_steps, lanes, ...] (one gather)."""
    return arr_mb[:, mys, mxs]


def _unskew_to_frame(tiles, mys, mxs, valid, mbh: int, mbw: int, ts: int):
    """[F, n_steps, lanes, ts, ts] -> [F, mbh*ts, mbw*ts] (one scatter;
    invalid lanes land in a spare slot that is dropped)."""
    nf = tiles.shape[0]
    flat = torch.where(valid == 1, mys * mbw + mxs,
                       mbh * mbw).reshape(-1).long()
    frame = tiles.new_zeros((nf, mbh * mbw + 1, ts, ts))
    frame[:, flat] = tiles.reshape(nf, -1, ts, ts)
    return frame[:, :-1].reshape(nf, mbh, mbw, ts, ts) \
        .permute(0, 1, 3, 2, 4).reshape(nf, mbh * ts, mbw * ts)


def _roll1(x):
    """Lane k takes lane k-1's value (lane 0 wraps; its users mask it)."""
    return torch.roll(x, 1, dims=_LANE)


# ---------------------------------------------------------------------------
# intra wavefront
# ---------------------------------------------------------------------------


def _intra_step(carry, xs):
    """One wavefront step of intra reconstruction. carry: the last three
    diagonals of Y, U and V (newest first), [F, lanes, 16, 16] and
    [F, lanes, 8, 8]. xs: this diagonal's residual tiles, modes
    [F, lanes, 4, 4], and per-lane class, modes, availability and valid
    [F, lanes]. Returns (carry, (Y, U, V) tiles of this diagonal)."""
    (P1y, P2y, P3y, P1u, P2u, P3u, P1v, P2v, P3v) = carry
    (resid, resid_u, resid_v, modes, cls, i16m, cmode,
     a_l, a_t, a_tr, valid) = xs
    act = (valid == 1)[..., None, None]
    a_l, a_t, a_tr = a_l == 1, a_t == 1, a_tr == 1
    a_tl = a_t & a_l

    top_row = _roll1(P2y)[..., 15, :]           # top MB's bottom row
    tr_row = _roll1(P1y)[..., 15, :]            # top-right MB's bottom row
    tl_corner = _roll1(P3y)[..., 15, 15]
    left_col = P1y[..., :, 15]

    R = torch.zeros_like(P1y)
    true = torch.ones_like(a_t)
    # ---- Intra_4x4: 16 sub-blocks in decode order ----
    for i in range(16):
        bx, by = int(MB.BLK_X[i]), int(MB.BLK_Y[i])
        src = _TR_SRC[i]
        # t8: four samples above, four above-right or, where those are
        # not available, the last of the first four
        above = top_row if by == 0 else R[..., by - 1, :]
        t04 = above[..., bx:bx + 4]
        if src == 3:
            t47 = t04[..., 3:4].expand(t04.shape)
        else:
            t47 = above[..., bx + 4:bx + 8] if bx < 12 else tr_row[..., 0:4]
            if src == 2:                        # blkIdx 5: the top-right MB
                t47 = torch.where(a_tr[..., None], t47, t04[..., 3:4])
        t8 = torch.cat([t04, t47], dim=-1)
        l4 = (left_col[..., by:by + 4] if bx == 0
              else R[..., by:by + 4, bx - 1])
        if bx == 0 and by == 0:
            tl = tl_corner
        elif by == 0:
            tl = top_row[..., bx - 1]
        elif bx == 0:
            tl = left_col[..., by - 1]
        else:
            tl = R[..., by - 1, bx - 1]
        # unavailable neighbours read as 0
        bt = a_t if by == 0 else None
        bl = a_l if bx == 0 else None
        if bt is not None:
            t8 = torch.where(bt[..., None], t8, 0)
        if bl is not None:
            l4 = torch.where(bl[..., None], l4, 0)
        if bt is not None or bl is not None:
            both = a_tl if bx == 0 and by == 0 else (bt if bl is None else bl)
            tl = torch.where(both, tl, 0)
        n = torch.cat([l4.flip(-1), tl[..., None], t8], dim=-1)
        pred = _pred_i4_batch(n, modes[..., by // 4, bx // 4],
                              true if bt is None else bt,
                              true if bl is None else bl)
        R[..., by:by + 4, bx:bx + 4] = \
            (pred + resid[..., by:by + 4, bx:bx + 4]).clamp(0, 255)

    # ---- Intra_16x16 ----
    t16 = torch.where(a_t[..., None], top_row, 0)
    l16 = torch.where(a_l[..., None], left_col, 0)
    tl16 = torch.where(a_tl, tl_corner, 0)
    rec16 = (_pred_16_batch(t16, l16, tl16, i16m, a_t, a_l)
             + resid).clamp(0, 255)
    Ry = torch.where(act, torch.where((cls == 1)[..., None, None], rec16, R),
                     0)

    # ---- chroma ----
    outs_c = []
    for P1c, P2c, P3c, residc in ((P1u, P2u, P3u, resid_u),
                                  (P1v, P2v, P3v, resid_v)):
        t8c = torch.where(a_t[..., None], _roll1(P2c)[..., 7, :], 0)
        l8c = torch.where(a_l[..., None], P1c[..., :, 7], 0)
        tlc = torch.where(a_tl, _roll1(P3c)[..., 7, 7], 0)
        predc = _pred_chroma_batch(t8c, l8c, tlc, cmode, a_t, a_l)
        outs_c.append(torch.where(act, (predc + residc).clamp(0, 255), 0))

    Ru, Rv = outs_c
    return (Ry, P1y, P2y, Ru, P1u, P2u, Rv, P1v, P2v), (Ry, Ru, Rv)


def _intra_tile_scan(resid_y_t, resid_u_t, resid_v_t, modes_t, cls_t,
                     i16_t, cmode_t, a_l_t, a_t_t, a_tr_t, valid_t):
    """The intra wavefront over skewed inputs [F, n_steps, lanes, ...]
    (valid_t [n_steps, lanes]). Returns skewed (Y, U, V) tiles."""
    nf, n_steps, lanes = cls_t.shape
    dev = cls_t.device
    z = lambda n: torch.zeros((nf, lanes, n, n), dtype=_I32, device=dev)
    carry = (z(16), z(16), z(16), z(8), z(8), z(8), z(8), z(8), z(8))
    seqs = [a.unbind(1) for a in (resid_y_t, resid_u_t, resid_v_t, modes_t,
                                  cls_t, i16_t, cmode_t, a_l_t, a_t_t,
                                  a_tr_t)]
    out = []
    for d in range(n_steps):
        carry, ys = _intra_step(carry, (*(s[d] for s in seqs), valid_t[d]))
        out.append(ys)
    return tuple(torch.stack(p, dim=1) for p in zip(*out))


# ---------------------------------------------------------------------------
# deblocking in tile space
# ---------------------------------------------------------------------------


def _edge_luma(P, Q, dim: int, bs, ia, ib, tabs):
    """One luma edge between the 4-sample-deep strips P (p3..p0) and Q
    (q0..q3) along `dim` (-1: vertical edge, strips [.., 16, 4]; -2:
    horizontal, [.., 4, 16]). Returns the filtered (P, Q)."""
    res = DB._filter_edge_luma(*P.unbind(dim), *Q.unbind(dim), bs, ia, ib,
                               *tabs)
    return torch.stack(res[:4], dim=dim), torch.stack(res[4:], dim=dim)


def _edge_chroma(P, Q, dim: int, bs, ia, ib, tabs):
    """One chroma edge between the 2-sample-deep strips P (p1, p0) and Q
    (q0, q1) along `dim`. Returns the filtered (P, Q)."""
    p1, p0 = P.unbind(dim)
    q0, q1 = Q.unbind(dim)
    p0n, q0n = DB._filter_edge_chroma(p1, p0, q0, q1, bs, ia, ib, *tabs)
    return torch.stack([p1, p0n], dim=dim), torch.stack([q0n, q1], dim=dim)


def _strip(x, dim: int, lo: int, hi: int):
    return x.narrow(dim, lo, hi - lo)


def _deblock_tile_scan_intra(Yt, Ut, Vt, qp_t, mxs_t, mys_t, valid_t,
                             alpha_off, beta_off, chroma_qp_off,
                             second_chroma_qp_off):
    """Deblock skewed all-intra recon tiles [F, n_steps, lanes, ...]: bS is
    the constant pattern 4 on macroblock edges, 3 inside, 0 on the picture
    boundary. qp_t [F, n_steps, lanes]; mxs_t/mys_t/valid_t [n_steps,
    lanes]; the offsets [F]. Step t filters diagonal t against t-1 (left)
    and t-2 (top) and emits diagonal t-2, then final. Returns same-shape
    deblocked tiles."""
    nf, n_steps, lanes = qp_t.shape
    dev = qp_t.device
    tabs = (_t(DB.ALPHA_TABLE, dev), _t(DB.BETA_TABLE, dev),
            _t(DB.TC0_TABLE.reshape(-1), dev))
    cqt = _t(T.CHROMA_QP, dev)
    a_off, b_off = alpha_off[:, None], beta_off[:, None]
    qav = lambda qa, qb: (qa + qb + 1) >> 1
    idx = lambda q: ((q + a_off).clamp(0, 51)[..., None],
                     (q + b_off).clamp(0, 51)[..., None])

    z = lambda n: torch.zeros((nf, lanes, n, n), dtype=_I32, device=dev)
    zq = torch.zeros((nf, lanes), dtype=_I32, device=dev)
    zv = torch.zeros((nf, lanes), dtype=torch.bool, device=dev)
    zg = torch.zeros(lanes, dtype=_I32, device=dev)
    # window: A = diagonal t-1, B = diagonal t-2
    Ay, Au, Av, By, Bu, Bv = z(16), z(8), z(8), z(16), z(8), z(8)
    qA, qB, vA, vB = zq, zq, zv, zv
    Ys, Us, Vs, qps = (a.unbind(1) for a in (Yt, Ut, Vt, qp_t))
    out = []
    for t in range(n_steps + 2):
        if t < n_steps:
            # clones: the edges below are written in place
            R, Ru, Rv = Ys[t].clone(), Us[t].clone(), Vs[t].clone()
            qp, mxs, mys, act = qps[t], mxs_t[t], mys_t[t], valid_t[t] == 1
        else:
            R, Ru, Rv, qp, mxs, mys = z(16), z(8), z(8), zq, zg, zg
            act = torch.zeros(lanes, dtype=torch.bool, device=dev)
        act = act.expand(nf, lanes)
        q_left, q_top = qA, _roll1(qB)
        left_ok = act & (mxs > 0) & vA
        top_ok = act & (mys > 0) & _roll1(vB)
        bs_left = (left_ok.to(_I32) * 4)[..., None]
        bs_top = (top_ok.to(_I32) * 4)[..., None]
        bs3 = (act.to(_I32) * 3)[..., None]

        # ---------- luma: vertical edges, then horizontal ----------
        ia, ib = idx(qp)
        Ty = _roll1(By)                       # top MB tile per lane
        for dim, Nb, bs0, q_nb in ((-1, Ay, bs_left, q_left),
                                   (-2, Ty, bs_top, q_top)):
            # edge 0: the macroblock boundary against the neighbour
            Pn, Qn = _edge_luma(_strip(Nb, dim, 12, 16), _strip(R, dim, 0, 4),
                                dim, bs0, *idx(qav(qp, q_nb)), tabs)
            _strip(Nb, dim, 12, 16).copy_(Pn)
            _strip(R, dim, 0, 4).copy_(Qn)
            for e in (4, 8, 12):              # internal edges, bS 3
                Pn, Qn = _edge_luma(_strip(R, dim, e - 4, e),
                                    _strip(R, dim, e, e + 4), dim, bs3,
                                    ia, ib, tabs)
                _strip(R, dim, e - 4, e).copy_(Pn)
                _strip(R, dim, e, e + 4).copy_(Qn)
        By = torch.roll(Ty, -1, dims=_LANE)

        # ---------- chroma ----------
        new_c = []
        for Ac, Bc, Rc, off in ((Au, Bu, Ru, chroma_qp_off),
                                (Av, Bv, Rv, second_chroma_qp_off)):
            qc_of = lambda q: cqt[(q + off[:, None]).clamp(0, 51).long()]
            qc = qc_of(qp)
            iac, ibc = idx(qc)
            Tc = _roll1(Bc)
            for dim, Nb, bs0, q_nb in ((-1, Ac, bs_left, q_left),
                                       (-2, Tc, bs_top, q_top)):
                Pn, Qn = _edge_chroma(_strip(Nb, dim, 6, 8),
                                      _strip(Rc, dim, 0, 2), dim, bs0,
                                      *idx(qav(qc, qc_of(q_nb))), tabs)
                _strip(Nb, dim, 6, 8).copy_(Pn)
                _strip(Rc, dim, 0, 2).copy_(Qn)
                Pn, Qn = _edge_chroma(_strip(Rc, dim, 2, 4),
                                      _strip(Rc, dim, 4, 6), dim, bs3,
                                      iac, ibc, tabs)
                _strip(Rc, dim, 2, 4).copy_(Pn)
                _strip(Rc, dim, 4, 6).copy_(Qn)
            new_c.append((Rc, Ac, torch.roll(Tc, -1, dims=_LANE)))

        (Ru, Au2, Bu), (Rv, Av2, Bv) = new_c
        # diagonal t-2 is final; the window moves on: A <- this diagonal,
        # B <- the old A (its last columns updated by our edge 0)
        out.append((By, Bu, Bv))
        Ay, Au, Av, By, Bu, Bv = R, Ru, Rv, Ay, Au2, Av2
        qA, qB, vA, vB = qp, qA, act, vA
    return tuple(torch.stack(p[2:], dim=1) for p in zip(*out))


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def decode_frames_batch(mbh: int, mbw: int, mb_class, qp, i4_modes,
                        i16_mode, chroma_mode, luma_coeffs, luma_dc,
                        chroma_coeffs, chroma_dc, avail_left, avail_top,
                        avail_topright, alpha_off, beta_off, chroma_qp_off,
                        second_chroma_qp_off, deblock: bool = True, *,
                        residual_fn=dequant_idct_blocks):
    """Batched all-intra H.264 decode. Every tensor carries a leading frame
    axis (the four offsets are [F]) and lies on one device, in the dtypes
    of stack_symbols. residual_fn is the dequant+IDCT stage
    (idct.dequant_idct_blocks; checks pass idct.dequant_idct_reference).
    Returns (Y, U, V) uint8 [F, mbh*16, mbw*16] (chroma half size), padded
    to whole macroblocks: the caller crops."""
    (mb_class, qp, i4_modes, i16_mode, chroma_mode, avail_left, avail_top,
     avail_topright) = (a.to(_I32) for a in (
         mb_class, qp, i4_modes, i16_mode, chroma_mode, avail_left,
         avail_top, avail_topright))
    dev = qp.device
    mys, mxs, valid = (_t(a, dev) for a in _skew_geometry(mbh, mbw))
    mys_i, mxs_i = mys.long(), mxs.long()

    resid_y, resid_u, resid_v = _residuals(
        luma_coeffs, luma_dc, chroma_coeffs, chroma_dc, qp, mb_class,
        chroma_qp_off, second_chroma_qp_off, residual_fn)

    sk = lambda a: _skew(a, mys_i, mxs_i)
    modes_mb = i4_modes.reshape(-1, mbh, 4, mbw, 4).permute(0, 1, 3, 2, 4)
    Yt, Ut, Vt = _intra_tile_scan(
        sk(_to_tiles(resid_y, mbh, mbw, 4)),
        sk(_to_tiles(resid_u, mbh, mbw, 2)),
        sk(_to_tiles(resid_v, mbh, mbw, 2)), sk(modes_mb), sk(mb_class),
        sk(i16_mode), sk(chroma_mode), sk(avail_left), sk(avail_top),
        sk(avail_topright), valid)
    if deblock:
        Yt, Ut, Vt = _deblock_tile_scan_intra(
            Yt, Ut, Vt, sk(qp), mxs, mys, valid, alpha_off, beta_off,
            chroma_qp_off, second_chroma_qp_off)
    un = lambda tiles, ts: _unskew_to_frame(
        tiles, mys, mxs, valid, mbh, mbw, ts).to(torch.uint8)
    return un(Yt, 16), un(Ut, 8), un(Vt, 8)


def decode_frame(mbh: int, mbw: int, *args, deblock: bool = True,
                 residual_fn=dequant_idct_blocks):
    """One intra frame (the tensors of decode_frames_batch without the
    frame axis) -> (Y, U, V) uint8: a batch of one."""
    Y, U, V = decode_frames_batch(mbh, mbw, *(a[None] for a in args),
                                  deblock=deblock, residual_fn=residual_fn)
    return Y[0], U[0], V[0]


def decode_frame_symbols_device(fs, deblock=None, device=None):
    """FrameSymbols -> (Y, U, V) uint8 tensors on `device` (None: the
    card), padded to whole macroblocks. deblock None: as the picture's
    slice headers say."""
    if fs.has_pcm:
        raise NotImplementedError("PCM macroblocks are not on the device "
                                  "path")
    if deblock is None:
        deblock = fs.deblock_enabled
    Y, U, V = decode_frames_batch(fs.mb_height, fs.mb_width,
                                  *stack_symbols([fs], device),
                                  deblock=deblock)
    return Y[0], U[0], V[0]


def decode_frame_symbols(fs, deblock=None, device=None):
    """FrameSymbols -> (Y, U, V) uint8 numpy via the tile decode."""
    return tuple(p.cpu().numpy()
                 for p in decode_frame_symbols_device(fs, deblock, device))
