"""H.264 in-loop deblocking edge filters (spec 8.7.2) on int32 torch
tensors, with the alpha, beta and tc0 tables; and the host decoder's numpy
deblocking pass (deblock_frame, intra_frame_bs; codec/h264/refdec.py).

An edge is filtered as a set of lines: the samples p3..p0 | q0..q3 across
it are tensors of one shape, vectorised along the edge. bS, indexA and
indexB broadcast against them. The tables come in as tensors on the
samples' device (tc0 flattened to [3 * 52]).
"""

from __future__ import annotations

import numpy as np
import torch

from .transform import chroma_qp

# Table 8-16 (indexA/indexB 0..51)
ALPHA_TABLE = np.array(
    [0] * 16 +
    [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45,
     50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255],
    dtype=np.int32)

BETA_TABLE = np.array(
    [0] * 16 +
    [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11,
     12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int32)

# Table 8-17: tc0[bS-1][indexA]
TC0_TABLE = np.array([
    [0] * 16 + [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
                2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13],
    [0] * 16 + [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
                3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11, 12, 13, 15, 17],
    [0] * 16 + [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4,
                4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 23, 25],
], dtype=np.int32)


def _clip3(lo, hi, x):
    return torch.minimum(torch.maximum(x, lo), hi)


def _thresholds(bs, index_a, index_b, alpha_t, beta_t, tc0_t):
    ia = index_a.long()
    alpha = alpha_t[ia]
    beta = beta_t[index_b.long()]
    tc0 = tc0_t[(bs.clamp(1, 3) - 1).long() * 52 + ia]
    return alpha, beta, tc0


def _filter_edge_luma(p3, p2, p1, p0, q0, q1, q2, q3, bs, index_a, index_b,
                      alpha_t, beta_t, tc0_t):
    """Filter one luma edge line-set; returns the filtered 8-tuple."""
    alpha, beta, tc0 = _thresholds(bs, index_a, index_b, alpha_t, beta_t,
                                   tc0_t)
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    # --- bS < 4 (8.7.2.3) ---
    tc = tc0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
    p0_s = (p0 + delta).clamp(0, 255)
    q0_s = (q0 - delta).clamp(0, 255)
    avg = (p0 + q0 + 1) >> 1
    p1_s = torch.where(
        ap, p1 + _clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1), p1)
    q1_s = torch.where(
        aq, q1 + _clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1), q1)

    # --- bS == 4 (8.7.2.4) ---
    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = ap & strong
    p0_4 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    p1_4 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_4 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq = aq & strong
    q0_4 = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    q1_4 = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_4 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    f4 = filt & is4
    p0_n = torch.where(filt, torch.where(is4, p0_4, p0_s), p0)
    p1_n = torch.where(filt, torch.where(is4, p1_4, p1_s), p1)
    p2_n = torch.where(f4, p2_4, p2)
    q0_n = torch.where(filt, torch.where(is4, q0_4, q0_s), q0)
    q1_n = torch.where(filt, torch.where(is4, q1_4, q1_s), q1)
    q2_n = torch.where(f4, q2_4, q2)
    return p3, p2_n, p1_n, p0_n, q0_n, q1_n, q2_n, q3


def _filter_edge_chroma(p1, p0, q0, q1, bs, index_a, index_b,
                        alpha_t, beta_t, tc0_t):
    """Filter one chroma edge line-set; returns the new (p0, q0)."""
    alpha, beta, tc0 = _thresholds(bs, index_a, index_b, alpha_t, beta_t,
                                   tc0_t)
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha) & ((p1 - p0).abs() < beta)
            & ((q1 - q0).abs() < beta))
    tc = tc0 + 1
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
    p0_s = (p0 + delta).clamp(0, 255)
    q0_s = (q0 - delta).clamp(0, 255)
    p0_4 = (2 * p1 + p0 + q1 + 2) >> 2
    q0_4 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    p0_n = torch.where(filt, torch.where(is4, p0_4, p0_s), p0)
    q0_n = torch.where(filt, torch.where(is4, q0_4, q0_s), q0)
    return p0_n, q0_n


# ---------------------------------------------------------------------------
# numpy twins of the host decoder: the whole pass over a frame, in place
# ---------------------------------------------------------------------------

def _np_clip3(lo, hi, x):
    return np.minimum(np.maximum(x, lo), hi)


def _np_filter_edge_luma(p3, p2, p1, p0, q0, q1, q2, q3, bs, index_a,
                         index_b):
    """numpy twin of _filter_edge_luma. All args are int32 arrays of equal
    shape (the samples perpendicular to the edge, vectorized along the
    edge); bs per line, index_a/index_b scalars. Returns filtered
    8-tuple."""
    alpha = np.take(ALPHA_TABLE, index_a)
    beta = np.take(BETA_TABLE, index_b)
    filt = (bs > 0) & (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta) \
        & (np.abs(q1 - q0) < beta)
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta

    # --- bS < 4 branch (8.7.2.3) ---
    tc0 = np.take(TC0_TABLE, (np.clip(bs, 1, 3) - 1) * 52 + index_a)
    tc = tc0 + ap.astype(np.int32) + aq.astype(np.int32)
    delta = _np_clip3(-tc, tc, ((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3))
    p0_s = np.clip(p0 + delta, 0, 255)
    q0_s = np.clip(q0 - delta, 0, 255)
    p1_s = np.where(ap, p1 + _np_clip3(-tc0, tc0,
                    (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1), p1)
    q1_s = np.where(aq, q1 + _np_clip3(-tc0, tc0,
                    (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1), q1)

    # --- bS == 4 branch (8.7.2.4) ---
    strong = np.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp = ap & strong
    p0_4 = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                    (2 * p1 + p0 + q1 + 2) >> 2)
    p1_4 = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_4 = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq = aq & strong
    q0_4 = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                    (2 * q1 + q0 + p1 + 2) >> 2)
    q1_4 = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_4 = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    p0_n = np.where(filt, np.where(is4, p0_4, p0_s), p0)
    p1_n = np.where(filt, np.where(is4, p1_4, p1_s), p1)
    p2_n = np.where(filt & is4, p2_4, p2)
    q0_n = np.where(filt, np.where(is4, q0_4, q0_s), q0)
    q1_n = np.where(filt, np.where(is4, q1_4, q1_s), q1)
    q2_n = np.where(filt & is4, q2_4, q2)
    return p3, p2_n, p1_n, p0_n, q0_n, q1_n, q2_n, q3


def _np_filter_edge_chroma(p1, p0, q0, q1, bs, index_a, index_b):
    """numpy twin of _filter_edge_chroma; returns the new (p0, q0)."""
    alpha = np.take(ALPHA_TABLE, index_a)
    beta = np.take(BETA_TABLE, index_b)
    filt = (bs > 0) & (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta) \
        & (np.abs(q1 - q0) < beta)
    tc0 = np.take(TC0_TABLE, (np.clip(bs, 1, 3) - 1) * 52 + index_a)
    tc = tc0 + 1
    delta = _np_clip3(-tc, tc, ((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3))
    p0_s = np.clip(p0 + delta, 0, 255)
    q0_s = np.clip(q0 - delta, 0, 255)
    p0_4 = (2 * p1 + p0 + q1 + 2) >> 2
    q0_4 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    p0_n = np.where(filt, np.where(is4, p0_4, p0_s), p0)
    q0_n = np.where(filt, np.where(is4, q0_4, q0_s), q0)
    return p0_n, q0_n


def deblock_frame(Y, U, V, qp_mb, bs_v, bs_h, alpha_off=0, beta_off=0,
                  chroma_qp_off=0, second_chroma_qp_off=None):
    """Apply the full deblocking pass in place (arrays are modified).

    Y: [H, W] int32; U, V: [H/2, W/2] int32; qp_mb: [mbh, mbw] luma QP per MB;
    bs_v/bs_h: [H/4, W/4] boundary strengths (0 disables an edge).
    alpha_off/beta_off: slice_alpha_c0_offset_div2*2 / slice_beta_offset_div2*2.
    """
    H, W = Y.shape
    mbh, mbw = qp_mb.shape
    if second_chroma_qp_off is None:
        second_chroma_qp_off = chroma_qp_off
    qp_mb = qp_mb.astype(np.int32)

    def avg_qp(qa, qb):
        return (qa + qb + 1) >> 1

    for my in range(mbh):
        for mx in range(mbw):
            y0, x0 = my * 16, mx * 16
            qp_cur = qp_mb[my, mx]
            # ---- luma vertical edges ----
            for e in range(4):
                x = x0 + 4 * e
                if x == 0:
                    continue
                qp_nb = qp_mb[my, mx - 1] if e == 0 else qp_cur
                qav = avg_qp(qp_cur, qp_nb)
                ia = np.clip(qav + alpha_off, 0, 51)
                ib = np.clip(qav + beta_off, 0, 51)
                bs = bs_v[y0 // 4: y0 // 4 + 4, x // 4]          # [4] per 4x4
                bs_l = np.repeat(bs, 4)                           # per line
                cols = Y[y0:y0 + 16, x - 4:x + 4]                # [16, 8]
                res = _np_filter_edge_luma(*[cols[:, k].copy() for k in range(8)],
                                        bs_l, ia, ib)
                for k in range(8):
                    cols[:, k] = res[k]
            # ---- luma horizontal edges ----
            for e in range(4):
                y = y0 + 4 * e
                if y == 0:
                    continue
                qp_nb = qp_mb[my - 1, mx] if e == 0 else qp_cur
                qav = avg_qp(qp_cur, qp_nb)
                ia = np.clip(qav + alpha_off, 0, 51)
                ib = np.clip(qav + beta_off, 0, 51)
                bs = bs_h[y // 4, x0 // 4: x0 // 4 + 4]
                bs_l = np.repeat(bs, 4)
                rows = Y[y - 4:y + 4, x0:x0 + 16]                # [8, 16]
                res = _np_filter_edge_luma(*[rows[k, :].copy() for k in range(8)],
                                        bs_l, ia, ib)
                for k in range(8):
                    rows[k, :] = res[k]
            # ---- chroma edges (4:2:0: vertical x=0,4; horizontal y=0,4) ----
            cy0, cx0 = my * 8, mx * 8
            for plane, qoff in ((U, chroma_qp_off), (V, second_chroma_qp_off)):
                for e in (0, 2):  # luma edge index = 2 * chroma edge position
                    cx = cx0 + 2 * e
                    if cx == 0:
                        continue
                    qp_nb = qp_mb[my, mx - 1] if e == 0 else qp_cur
                    qav = avg_qp(chroma_qp(qp_cur, qoff), chroma_qp(qp_nb, qoff))
                    ia = np.clip(qav + alpha_off, 0, 51)
                    ib = np.clip(qav + beta_off, 0, 51)
                    # chroma line yc uses bS of luma line 2*yc
                    bs = bs_v[y0 // 4: y0 // 4 + 4, (x0 + 4 * e) // 4]
                    bs_l = np.repeat(bs, 2)
                    cols = plane[cy0:cy0 + 8, cx - 2:cx + 2]      # [8, 4]
                    p0n, q0n = _np_filter_edge_chroma(
                        cols[:, 0].copy(), cols[:, 1].copy(),
                        cols[:, 2].copy(), cols[:, 3].copy(), bs_l, ia, ib)
                    cols[:, 1] = p0n
                    cols[:, 2] = q0n
                for e in (0, 2):
                    cy = cy0 + 2 * e
                    if cy == 0:
                        continue
                    qp_nb = qp_mb[my - 1, mx] if e == 0 else qp_cur
                    qav = avg_qp(chroma_qp(qp_cur, qoff), chroma_qp(qp_nb, qoff))
                    ia = np.clip(qav + alpha_off, 0, 51)
                    ib = np.clip(qav + beta_off, 0, 51)
                    bs = bs_h[(y0 + 4 * e) // 4, x0 // 4: x0 // 4 + 4]
                    bs_l = np.repeat(bs, 2)
                    rows = plane[cy - 2:cy + 2, cx0:cx0 + 8]      # [4, 8]
                    p0n, q0n = _np_filter_edge_chroma(
                        rows[0, :].copy(), rows[1, :].copy(),
                        rows[2, :].copy(), rows[3, :].copy(), bs_l, ia, ib)
                    rows[1, :] = p0n
                    rows[2, :] = q0n


def intra_frame_bs(mbh: int, mbw: int):
    """Boundary strengths for an all-intra frame: 4 on MB edges, 3 inside."""
    bs_v = np.full((mbh * 4, mbw * 4), 3, np.int32)
    bs_h = np.full((mbh * 4, mbw * 4), 3, np.int32)
    bs_v[:, 0::4] = 4
    bs_h[0::4, :] = 4
    bs_v[:, 0] = 0   # frame boundary
    bs_h[0, :] = 0
    return bs_v, bs_h
