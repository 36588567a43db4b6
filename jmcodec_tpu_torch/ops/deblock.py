"""H.264 in-loop deblocking edge filters (spec 8.7.2) on int32 torch
tensors, with the alpha, beta and tc0 tables.

An edge is filtered as a set of lines: the samples p3..p0 | q0..q3 across
it are tensors of one shape, vectorised along the edge. bS, indexA and
indexB broadcast against them. The tables come in as tensors on the
samples' device (tc0 flattened to [3 * 52]).
"""

from __future__ import annotations

import numpy as np
import torch

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
