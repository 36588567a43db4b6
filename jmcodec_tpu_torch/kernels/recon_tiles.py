"""H.264 reconstruction in skewed tile space: symbol tensors in, uint8
(Y, U, V) out. The port of jmcodec_tpu/kernels/recon_tiles.py: the
all-intra batch decode and the P-picture decode against padded reference
planes.

    MB (my, mx) -> diagonal d = mx + 2*my, lane k = my
    tiles[d] : [lanes, 16, 16]  - all MBs of one wavefront step

The neighbours of (d, k) are (d-1, k) = left, (d-2, k-1) = top,
(d-1, k-1) = top-right and (d-3, k-1) = top-left: recent diagonals, rolled
by one lane. Stages:

  1. residuals  - recon._residuals: the dequant+IDCT CUDA kernel on the
                  card, its plain torch version on the CPU (idct.py)
  1b. inter     - P pictures: quarter-pel MC of every 4x4 block from the
                  padded references (weighted where the slice says so)
                  plus the residual, wavefront-free
  2. intra scan - a Python loop over the diagonals that carries the last
                  three and emits each finished one; in a P picture the
                  inter macroblocks take their MC tile, and a diagonal
                  without an intra macroblock is its MC tiles, with no
                  launch
  3. deblock    - a second loop, two diagonals behind: a tile is final once
                  its right and bottom neighbours have filtered the edges
                  they share with it; bS is the constant intra pattern
                  or, in a P picture, per 4-sample edge from _bs_planes

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
from ._planes import cell_origins, edge_pad
from ._tables import device_table as _t
from .idct import dequant_idct_blocks
from .recon import (_TR_SRC, _pred_16_batch, _pred_chroma_batch,
                    _pred_i4_batch, _residuals, stack_motion, stack_symbols)

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
    """[F, mbh*s, mbw*s, k, k] block array -> [F, mbh, mbw, ks, ks]
    tiles."""
    s, k = sub, plane_blocks.shape[-1]
    return plane_blocks.reshape(-1, mbh, s, mbw, s, k, k) \
        .permute(0, 1, 3, 2, 5, 4, 6).reshape(-1, mbh, mbw, k * s, k * s)


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


def _intra_step(carry, xs, inter=None):
    """One wavefront step of intra reconstruction. carry: the last three
    diagonals of Y, U and V (newest first), [F, lanes, 16, 16] and
    [F, lanes, 8, 8]. xs: this diagonal's residual tiles, modes
    [F, lanes, 4, 4], and per-lane class, modes, availability and valid
    [F, lanes]. inter: in a P picture, this diagonal's inter (MC +
    residual) tiles (Y, U, V), which an inter macroblock (class 3) takes
    in place of the intra reconstruction. Returns (carry, (Y, U, V) tiles
    of this diagonal)."""
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
    Ry = torch.where((cls == 1)[..., None, None], rec16, R)
    if inter is not None:
        is_inter = (cls == 3)[..., None, None]
        Ry = torch.where(is_inter, inter[0], Ry)
    Ry = torch.where(act, Ry, 0)

    # ---- chroma ----
    outs_c = []
    for k, (P1c, P2c, P3c, residc) in enumerate(((P1u, P2u, P3u, resid_u),
                                                 (P1v, P2v, P3v, resid_v))):
        t8c = torch.where(a_t[..., None], _roll1(P2c)[..., 7, :], 0)
        l8c = torch.where(a_l[..., None], P1c[..., :, 7], 0)
        tlc = torch.where(a_tl, _roll1(P3c)[..., 7, 7], 0)
        predc = _pred_chroma_batch(t8c, l8c, tlc, cmode, a_t, a_l)
        recc = (predc + residc).clamp(0, 255)
        if inter is not None:
            recc = torch.where(is_inter, inter[1 + k], recc)
        outs_c.append(torch.where(act, recc, 0))

    Ru, Rv = outs_c
    return (Ry, P1y, P2y, Ru, P1u, P2u, Rv, P1v, P2v), (Ry, Ru, Rv)


def _intra_tile_scan(resid_y_t, resid_u_t, resid_v_t, modes_t, cls_t,
                     i16_t, cmode_t, a_l_t, a_t_t, a_tr_t, valid_t,
                     inter_t=None, walk=None):
    """The intra wavefront over skewed inputs [F, n_steps, lanes, ...]
    (valid_t [n_steps, lanes]). In a P picture inter_t holds the skewed
    inter tiles (Y, U, V) that seed it, and walk (intra_steps; only with
    inter_t) says which diagonals hold an intra macroblock: any other is
    its inter tiles, zero on invalid lanes, carried on without a launch.
    Returns skewed (Y, U, V) tiles."""
    nf, n_steps, lanes = cls_t.shape
    dev = cls_t.device
    z = lambda n: torch.zeros((nf, lanes, n, n), dtype=_I32, device=dev)
    carry = (z(16), z(16), z(16), z(8), z(8), z(8), z(8), z(8), z(8))
    seqs = [a.unbind(1) for a in (resid_y_t, resid_u_t, resid_v_t, modes_t,
                                  cls_t, i16_t, cmode_t, a_l_t, a_t_t,
                                  a_tr_t)]
    inter_seqs = [t.unbind(1) for t in inter_t or ()]
    if walk is not None:
        vm = (valid_t == 1)[..., None, None]
        base = [torch.where(vm, t, 0).unbind(1) for t in inter_t]
    out = []
    for d in range(n_steps):
        if walk is not None and not walk[d]:
            ys = tuple(b[d] for b in base)
            c = carry
            carry = (ys[0], c[0], c[1], ys[1], c[3], c[4], ys[2], c[6], c[7])
        else:
            carry, ys = _intra_step(
                carry, (*(s[d] for s in seqs), valid_t[d]),
                tuple(s[d] for s in inter_seqs) if inter_seqs else None)
        out.append(ys)
    return tuple(torch.stack(p, dim=1) for p in zip(*out))


def intra_steps(mb_class) -> list:
    """Per diagonal of the intra scan: does a valid lane hold an intra
    macroblock (class 0 or 1)? Read from the picture's numpy mb_class [mbh,
    mbw] on the host, so the scan skips a diagonal without one with no
    device-to-host copy."""
    mbh, mbw = mb_class.shape
    mys, mxs, valid = _skew_geometry(mbh, mbw)
    return ((np.asarray(mb_class)[mys, mxs] <= 1)
            & (valid == 1)).any(axis=1).tolist()


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


def _deblock_scan(Yt, Ut, Vt, qp_t, valid_t, alpha_off, beta_off,
                  chroma_qp_off, second_chroma_qp_off, edge_bs):
    """Deblock skewed recon tiles [F, n_steps, lanes, ...]. qp_t [F,
    n_steps, lanes]; valid_t [n_steps, lanes]; the offsets [F].
    edge_bs(t, act, vA, vB) gives step t's bS (act: its valid lanes [F,
    lanes]; vA, vB: those of the two diagonals before): four lists, luma
    vertical and horizontal edges 0..3, chroma vertical and horizontal
    edges 0 and 2 (the chroma edge at 4 takes luma edge 2's bS), each
    broadcastable against a line set [F, lanes, n]. Edge 0 is the
    macroblock boundary. Step t filters diagonal t against t-1 (left) and
    t-2 (top) and emits diagonal t-2, then final. Returns same-shape
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
    # window: A = diagonal t-1, B = diagonal t-2
    Ay, Au, Av, By, Bu, Bv = z(16), z(8), z(8), z(16), z(8), z(8)
    qA, qB, vA, vB = zq, zq, zv, zv
    Ys, Us, Vs, qps = (a.unbind(1) for a in (Yt, Ut, Vt, qp_t))
    out = []
    for t in range(n_steps + 2):
        if t < n_steps:
            # clones: the edges below are written in place
            R, Ru, Rv = Ys[t].clone(), Us[t].clone(), Vs[t].clone()
            qp, act = qps[t], valid_t[t] == 1
        else:
            R, Ru, Rv, qp = z(16), z(8), z(8), zq
            act = torch.zeros(lanes, dtype=torch.bool, device=dev)
        act = act.expand(nf, lanes)
        q_left, q_top = qA, _roll1(qB)
        bs_lv, bs_lh, bs_cv, bs_ch = edge_bs(t, act, vA, vB)

        # ---------- luma: vertical edges, then horizontal ----------
        ia, ib = idx(qp)
        Ty = _roll1(By)                       # top MB tile per lane
        for dim, Nb, bs, q_nb in ((-1, Ay, bs_lv, q_left),
                                  (-2, Ty, bs_lh, q_top)):
            # edge 0: the macroblock boundary against the neighbour
            Pn, Qn = _edge_luma(_strip(Nb, dim, 12, 16), _strip(R, dim, 0, 4),
                                dim, bs[0], *idx(qav(qp, q_nb)), tabs)
            _strip(Nb, dim, 12, 16).copy_(Pn)
            _strip(R, dim, 0, 4).copy_(Qn)
            for e in (4, 8, 12):              # internal edges
                Pn, Qn = _edge_luma(_strip(R, dim, e - 4, e),
                                    _strip(R, dim, e, e + 4), dim,
                                    bs[e // 4], ia, ib, tabs)
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
            for dim, Nb, bs, q_nb in ((-1, Ac, bs_cv, q_left),
                                      (-2, Tc, bs_ch, q_top)):
                Pn, Qn = _edge_chroma(_strip(Nb, dim, 6, 8),
                                      _strip(Rc, dim, 0, 2), dim, bs[0],
                                      *idx(qav(qc, qc_of(q_nb))), tabs)
                _strip(Nb, dim, 6, 8).copy_(Pn)
                _strip(Rc, dim, 0, 2).copy_(Qn)
                Pn, Qn = _edge_chroma(_strip(Rc, dim, 2, 4),
                                      _strip(Rc, dim, 4, 6), dim, bs[1],
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


def _deblock_tile_scan_intra(Yt, Ut, Vt, qp_t, mxs_t, mys_t, valid_t,
                             alpha_off, beta_off, chroma_qp_off,
                             second_chroma_qp_off):
    """Deblock skewed all-intra recon tiles (_deblock_scan's layout;
    mxs_t/mys_t [n_steps, lanes]): bS is the constant pattern 4 on
    macroblock edges, 3 inside, 0 on the picture boundary."""
    n_steps, lanes = valid_t.shape
    zg = torch.zeros(lanes, dtype=_I32, device=valid_t.device)

    def edge_bs(t, act, vA, vB):
        mxs, mys = (mxs_t[t], mys_t[t]) if t < n_steps else (zg, zg)
        left = ((act & (mxs > 0) & vA).to(_I32) * 4)[..., None]
        top = ((act & (mys > 0) & _roll1(vB)).to(_I32) * 4)[..., None]
        b3 = (act.to(_I32) * 3)[..., None]
        return [left, b3, b3, b3], [top, b3, b3, b3], [left, b3], [top, b3]

    return _deblock_scan(Yt, Ut, Vt, qp_t, valid_t, alpha_off, beta_off,
                         chroma_qp_off, second_chroma_qp_off, edge_bs)


def _deblock_tile_scan(Yt, Ut, Vt, qp_t, valid_t, alpha_off, beta_off,
                       chroma_qp_off, second_chroma_qp_off, bs_v_t, bs_h_t):
    """Deblock skewed recon tiles of a P picture (_deblock_scan's layout)
    with per-edge bS: bs_v_t / bs_h_t [F, n_steps, lanes, 4 (edge), 4
    (sub-edge)], 0 where an edge must not filter (the picture boundary
    included), each sub-edge's bS for its four luma lines (two chroma
    lines)."""
    n_steps = valid_t.shape[0]

    def edge_bs(t, act, vA, vB):
        v, h = bs_v_t[:, min(t, n_steps - 1)], bs_h_t[:, min(t, n_steps - 1)]
        m = act.to(_I32)[..., None]
        lines = lambda b, k: b.repeat_interleave(k, -1) * m
        return ([lines(v[..., e, :], 4) for e in range(4)],
                [lines(h[..., e, :], 4) for e in range(4)],
                [lines(v[..., e, :], 2) for e in (0, 2)],
                [lines(h[..., e, :], 2) for e in (0, 2)])

    return _deblock_scan(Yt, Ut, Vt, qp_t, valid_t, alpha_off, beta_off,
                         chroma_qp_off, second_chroma_qp_off, edge_bs)


# ---------------------------------------------------------------------------
# inter prediction (wavefront-free: reads only the reference planes)
# ---------------------------------------------------------------------------

MC_PAD = 32     # luma padding of a reference plane (chroma: half)


def pad_ref_device(Y, U, V):
    """A decoded picture (uint8 tensors, whole macroblocks) padded for use
    as an MC reference, int32, on its device."""
    pad = lambda a, n: edge_pad(edge_pad(a.to(_I32), 0, n, n), 1, n, n)
    return pad(Y, MC_PAD), pad(U, MC_PAD // 2), pad(V, MC_PAD // 2)


def _halfpel_planes(refp):
    """refp [n_refs, Hp, Wp] int32 -> the planes (G, b, h, j) of 8.4.2.2.1:
    the full-sample plane and the three half-sample ones. The six-tap
    intermediates (b1, h1, j1) stay unclipped int32."""
    xpad = edge_pad(edge_pad(refp, 1, 2, 3), 2, 2, 3)

    def six(a, dim):
        n = a.shape[dim] - 5
        tap = lambda k: a.narrow(dim, k, n)
        return (tap(0) - 5 * tap(1) + 20 * tap(2) + 20 * tap(3)
                - 5 * tap(4) + tap(5))

    b1 = six(xpad, 2)[:, 2:-3, :]               # [n, Hp, Wp]
    b = ((b1 + 16) >> 5).clamp(0, 255)
    h1 = six(xpad, 1)[:, :, 2:-3]
    hh = ((h1 + 16) >> 5).clamp(0, 255)
    j1 = six(edge_pad(b1, 1, 2, 3), 1)
    jj = ((j1 + 512) >> 10).clamp(0, 255)
    return refp, b, hh, jj


# per quarter phase (fy, fx): (plane 1, dx1, dy1, plane 2, dx2, dy2,
# average), planes 0 = G, 1 = b, 2 = h, 3 = j; a quarter position averages
# two planes (8.4.2.2.1, Table 8-12)
_MC_SEL = np.zeros((4, 4, 7), np.int32)
for _fy in range(4):
    for _fx in range(4):
        G, B_, H_, J_ = 0, 1, 2, 3
        if (_fx, _fy) == (0, 0):
            sel = (G, 0, 0, G, 0, 0, 0)
        elif _fy == 0:
            sel = {1: (G, 0, 0, B_, 0, 0, 1), 2: (B_, 0, 0, B_, 0, 0, 0),
                   3: (G, 1, 0, B_, 0, 0, 1)}[_fx]
        elif _fx == 0:
            sel = {1: (G, 0, 0, H_, 0, 0, 1), 2: (H_, 0, 0, H_, 0, 0, 0),
                   3: (G, 0, 1, H_, 0, 0, 1)}[_fy]
        elif (_fx, _fy) == (2, 2):
            sel = (J_, 0, 0, J_, 0, 0, 0)
        elif _fy == 2:
            sel = (H_, _fx // 3, 0, J_, 0, 0, 1)
        elif _fx == 2:
            sel = (B_, 0, _fy // 3, J_, 0, 0, 1)
        else:
            sel = (B_, 0, _fy // 3, H_, _fx // 3, 0, 1)
        _MC_SEL[_fy, _fx] = sel


def _mc_luma_batched(refp, mv, ref_idx):
    """refp [n_refs, Hp, Wp] padded luma (pad_ref_device); mv [mbh*4,
    mbw*4, 2] quarter-pel and ref_idx [mbh*4, mbw*4] (-1: intra) per 4x4
    block -> the predicted luma [mbh*4, mbw*4, 4, 4] int32. The block's
    position is clamped into the padded plane, the reference index into
    the list, as in jmcodec_tpu, so any MV and an intra block stay in
    range."""
    return _mc_luma_batched_from_planes(_halfpel_planes(refp), mv, ref_idx)


def _mc_luma_batched_from_planes(planes, mv, ref_idx):
    """_mc_luma_batched from the half-pel planes of the references
    (_halfpel_planes), computed once by a caller that predicts from them
    many times (the encoder's sub-pel search). mv and ref_idx may carry leading axes, [..., mbh*4,
    mbw*4, 2] and [..., mbh*4, mbw*4]: one prediction per leading
    index."""
    n_refs, Hp, Wp = planes[0].shape
    dev = planes[0].device
    planes = torch.stack(planes, dim=1).reshape(-1)
    mv, ref_idx = mv.long(), ref_idx.long()
    y0, x0 = cell_origins(ref_idx, 4, MC_PAD)
    xi = (x0 + (mv[..., 0] >> 2)).clamp(3, Wp - 8)
    yi = (y0 + (mv[..., 1] >> 2)).clamp(3, Hp - 8)
    sel = _t(_MC_SEL, dev, torch.int64)[mv[..., 1] & 3, mv[..., 0] & 3]
    r = ref_idx.clamp(0, n_refs - 1)
    r4 = torch.arange(4, device=dev)

    def plane(k):
        # every index is in range by the clamps: one flat gather
        pid, dx, dy = (sel[..., k + i] for i in range(3))
        row = ((r * 4 + pid) * Hp + yi + dy) * Wp + xi + dx
        return planes[row[..., None, None] + r4[:, None] * Wp + r4]

    p1, p2 = plane(0), plane(3)
    return torch.where((sel[..., 6] == 1)[..., None, None],
                       (p1 + p2 + 1) >> 1, p1)


def _mc_chroma_batched(refc, mv, ref_idx):
    """refc [n_refs, Hc, Wc] padded chroma. Chroma moves with the luma
    partitions, so each luma 4x4 block predicts its co-located 2x2 chroma
    block at eighth-sample precision (8.4.2.2.2): returns [mbh*4, mbw*4,
    2, 2] int32, clamped as _mc_luma_batched is."""
    n_refs, Hc, Wc = refc.shape
    dev = refc.device
    mv, ref_idx = mv.long(), ref_idx.long()
    y0, x0 = cell_origins(ref_idx, 2, MC_PAD // 2)
    xi = (x0 + (mv[..., 0] >> 3)).clamp(0, Wc - 4)
    yi = (y0 + (mv[..., 1] >> 3)).clamp(0, Hc - 4)
    dx = (mv[..., 0] & 7)[..., None, None]
    dy = (mv[..., 1] & 7)[..., None, None]
    r = ref_idx.clamp(0, n_refs - 1)
    r2 = torch.arange(2, device=dev)
    # every index is in range by the clamps: one flat gather per tap
    at0 = ((r * Hc + yi) * Wc + xi)[..., None, None] + r2[:, None] * Wc + r2
    flat = refc.reshape(-1)
    at = lambda oy, ox: flat[at0 + oy * Wc + ox]
    return (((8 - dx) * (8 - dy) * at(0, 0) + dx * (8 - dy) * at(0, 1)
             + (8 - dx) * dy * at(1, 0) + dx * dy * at(1, 1) + 32) >> 6
            ).to(_I32)


def _bs_planes(mb_class, nz_luma, mv, ref_idx, ref_ids=None):
    """Boundary strengths of every 4x4 block's left and top edge (8.7.2.1):
    mb_class [mbh, mbw]; nz_luma [gh, gw] (the block has a nonzero luma
    level); mv [gh, gw, 2]; ref_idx [gh, gw]. Returns (bs_v, bs_h) [gh,
    gw] int32, 0 on the picture boundary. ref_ids [R] maps list indices to
    picture identities: the spec compares pictures, and x264's weightp=2
    puts one picture at two indices. None compares the indices, as
    jmcodec_tpu's default does: right only without duplicates."""
    gh, gw = nz_luma.shape
    blk_intra = (mb_class != 3).repeat_interleave(4, 0) \
        .repeat_interleave(4, 1)
    nz = nz_luma > 0
    refpic = ref_idx if ref_ids is None else \
        ref_ids[ref_idx.clamp(0, ref_ids.shape[0] - 1).long()]

    def edge(pi, qi, mb_edge):
        intra_e = blk_intra[pi] | blk_intra[qi]
        mvd = ((mv[pi][..., 0] - mv[qi][..., 0]).abs() >= 4) | \
              ((mv[pi][..., 1] - mv[qi][..., 1]).abs() >= 4)
        inter_bs = torch.where(nz[pi] | nz[qi], 2,
                               torch.where(mvd | (refpic[pi] != refpic[qi]),
                                           1, 0))
        return torch.where(intra_e, torch.where(mb_edge, 4, 3), inter_bs)

    dev = nz_luma.device
    col_edge = torch.arange(1, gw, device=dev) % 4 == 0
    row_edge = torch.arange(1, gh, device=dev) % 4 == 0
    bs_v = torch.zeros((gh, gw), dtype=_I32, device=dev)
    bs_h = torch.zeros((gh, gw), dtype=_I32, device=dev)
    bs_v[:, 1:] = edge((slice(None), slice(0, gw - 1)),
                       (slice(None), slice(1, gw)), col_edge[None, :])
    bs_h[1:, :] = edge((slice(0, gh - 1), slice(None)),
                       (slice(1, gh), slice(None)), row_edge[:, None])
    return bs_v, bs_h


def _weight(mc, wp, ref_idx, wi: int, log2wd: int):
    """Explicit weighted prediction (8.4.2.3.2) of one component: wp [R,
    6] the list-0 LUT (wY, oY, wCb, oCb, wCr, oCr), wi the component's
    weight column."""
    rw = ref_idx.clamp(0, wp.shape[0] - 1).long()
    w = wp[rw, wi][..., None, None]
    o = wp[rw, wi + 1][..., None, None]
    rnd = 1 << (log2wd - 1) if log2wd >= 1 else 0
    return (((mc * w + rnd) >> max(log2wd, 0)) + o).clamp(0, 255)


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
    return _reconstruct(mbh, mbw, (
        mb_class, qp, i4_modes, i16_mode, chroma_mode, luma_coeffs, luma_dc,
        chroma_coeffs, chroma_dc, avail_left, avail_top, avail_topright,
        alpha_off, beta_off, chroma_qp_off, second_chroma_qp_off), deblock,
        residual_fn)


def _reconstruct(mbh: int, mbw: int, sym, deblock: bool, residual_fn,
                 inter=None, walk=None):
    """The device stages of a decode: residuals, the intra scan, deblocking
    and the unskew. sym: decode_frames_batch's tensors, with the frame
    axis. In a P picture, inter(resid_y, resid_u, resid_v) returns the
    inter tiles [F, mbh, mbw, 16, 16] / [..., 8, 8] that seed the scan and
    the per-edge bS (bs_v, bs_h) [F, mbh, mbw, 4, 4], and walk is the
    picture's intra_steps."""
    (mb_class, qp, i4_modes, i16_mode, chroma_mode, luma_coeffs, luma_dc,
     chroma_coeffs, chroma_dc, avail_left, avail_top, avail_topright,
     alpha_off, beta_off, chroma_qp_off, second_chroma_qp_off) = sym
    (mb_class, qp, i4_modes, i16_mode, chroma_mode, avail_left, avail_top,
     avail_topright) = (a.to(_I32) for a in (
         mb_class, qp, i4_modes, i16_mode, chroma_mode, avail_left,
         avail_top, avail_topright))
    dev = qp.device
    mys, mxs, valid = (_t(a, dev) for a in _skew_geometry(mbh, mbw))
    mys_i, mxs_i = mys.long(), mxs.long()
    sk = lambda a: _skew(a, mys_i, mxs_i)

    resid_y, resid_u, resid_v = _residuals(
        luma_coeffs, luma_dc, chroma_coeffs, chroma_dc, qp, mb_class,
        chroma_qp_off, second_chroma_qp_off, residual_fn)
    resid = (_to_tiles(resid_y, mbh, mbw, 4), _to_tiles(resid_u, mbh, mbw, 2),
             _to_tiles(resid_v, mbh, mbw, 2))
    inter_t, bs = None, None
    if inter is not None:
        tiles, bs = inter(*resid)
        inter_t = tuple(sk(t) for t in tiles)

    modes_mb = i4_modes.reshape(-1, mbh, 4, mbw, 4).permute(0, 1, 3, 2, 4)
    Yt, Ut, Vt = _intra_tile_scan(
        *(sk(r) for r in resid), sk(modes_mb), sk(mb_class), sk(i16_mode),
        sk(chroma_mode), sk(avail_left), sk(avail_top), sk(avail_topright),
        valid, inter_t, walk)
    offs = (alpha_off, beta_off, chroma_qp_off, second_chroma_qp_off)
    if deblock and bs is None:
        Yt, Ut, Vt = _deblock_tile_scan_intra(Yt, Ut, Vt, sk(qp), mxs, mys,
                                              valid, *offs)
    elif deblock:
        Yt, Ut, Vt = _deblock_tile_scan(Yt, Ut, Vt, sk(qp), valid, *offs,
                                        sk(bs[0]), sk(bs[1]))
    un = lambda tiles, ts: _unskew_to_frame(
        tiles, mys, mxs, valid, mbh, mbw, ts).to(torch.uint8)
    return un(Yt, 16), un(Ut, 8), un(Vt, 8)


def decode_frame_inter(mbh: int, mbw: int, mb_class, qp, i4_modes, i16_mode,
                       chroma_mode, luma_coeffs, luma_dc, chroma_coeffs,
                       chroma_dc, avail_left, avail_top, avail_topright,
                       alpha_off, beta_off, chroma_qp_off,
                       second_chroma_qp_off, mv, ref_idx, ref_y, ref_u, ref_v,
                       ref_ids, walk, deblock: bool = True, wp=None,
                       wp_logwd=(0, 0), *, residual_fn=dequant_idct_blocks):
    """One P picture: batched MC (wavefront-free), the intra scan over it
    for the intra macroblocks, and the per-edge-bS deblock. The symbol
    tensors are decode_frame's (no frame axis; the offsets 0-d); mv [mbh*4,
    mbw*4, 2] and ref_idx [mbh*4, mbw*4] (-1 intra) per 4x4 block;
    ref_y/u/v [R, ...] the list-0 references padded by pad_ref_device.
    wp: the explicit pred_weight_table as a LUT [R, 6] (wY, oY, wCb, oCb,
    wCr, oCr) with wp_logwd (luma, chroma) ints, or None. ref_ids [R]:
    each list index's picture identity, for bS. walk: intra_steps of the
    picture's mb_class (host numpy). Returns (Y, U, V)
    uint8 [mbh*16, mbw*16] (chroma half size), padded to whole
    macroblocks."""
    mv, ref_idx = mv.to(_I32), ref_idx.to(_I32)

    def inter(resid_y, resid_u, resid_v):
        mc = [_mc_luma_batched(ref_y.to(_I32), mv, ref_idx),
              _mc_chroma_batched(ref_u.to(_I32), mv, ref_idx),
              _mc_chroma_batched(ref_v.to(_I32), mv, ref_idx)]
        if wp is not None:
            w = wp.to(_I32)
            mc = [_weight(m, w, ref_idx, 2 * k, wp_logwd[min(k, 1)])
                  for k, m in enumerate(mc)]
        # chroma MC is per 2x2 block on the luma grid; the tiles meet the
        # residual's [mbh, mbw, 8, 8] per macroblock
        tiles = tuple((_to_tiles(m[None], mbh, mbw, 4) + r).clamp(0, 255)
                      for m, r in zip(mc, (resid_y, resid_u, resid_v)))
        nz = (luma_coeffs != 0).flatten(-2).any(-1).to(_I32)
        bs_v, bs_h = _bs_planes(mb_class, nz, mv, ref_idx, ref_ids)
        return tiles, (bs_v.reshape(mbh, 4, mbw, 4).permute(0, 2, 3, 1)[None],
                       bs_h.reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3)[None])

    Y, U, V = _reconstruct(mbh, mbw, tuple(a[None] for a in (
        mb_class, qp, i4_modes, i16_mode, chroma_mode, luma_coeffs, luma_dc,
        chroma_coeffs, chroma_dc, avail_left, avail_top, avail_topright,
        alpha_off, beta_off, chroma_qp_off, second_chroma_qp_off)), deblock,
        residual_fn, inter, walk)
    return Y[0], U[0], V[0]


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


def decode_frame_symbols_inter(fs, refs, ref_ids, deblock=None, *,
                               residual_fn=dequant_idct_blocks):
    """FrameSymbols of a P picture and its list-0 references [(Y, U, V),
    ...] (pad_ref_device, list order, on one device) -> (Y, U, V) uint8
    tensors on that device, padded to whole macroblocks. ref_ids: each
    list index's picture identity, for bS. The symbols go up in the
    narrow dtypes of stack_symbols / stack_motion; which diagonals the
    intra scan walks is read from fs on the host."""
    if fs.has_pcm:
        raise NotImplementedError("PCM macroblocks are not on the device "
                                  "path")
    if deblock is None:
        deblock = fs.deblock_enabled
    dev = refs[0][0].device
    sym = [a[0] for a in stack_symbols([fs], dev)]
    mv, ref_idx = (a[0] for a in stack_motion([fs], dev))
    ref_y, ref_u, ref_v = (torch.stack([r[k] for r in refs]) for k in range(3))
    wp = None if fs.wp is None else torch.as_tensor(fs.wp, dtype=_I32,
                                                     device=dev)
    ids = torch.as_tensor(ref_ids, dtype=_I32, device=dev)
    return decode_frame_inter(
        fs.mb_height, fs.mb_width, *sym, mv, ref_idx, ref_y, ref_u, ref_v,
        ids, intra_steps(fs.mb_class), deblock=deblock, wp=wp,
        wp_logwd=tuple(fs.wp_logwd), residual_fn=residual_fn)
