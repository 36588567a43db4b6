"""Static tables of the HEVC intra decode, as numpy (no torch, no jax).

Derived from the spec tables in codec/hevc/intra.py (ANGLES, INV_ANGLE,
_FILTER_THRESH); tests hold each one equal to its counterpart in
jmcodec_tpu.kernels.hevc_tiles.

Reference-vector layout (the substitution scan order of 8.4.4.2.2), for a
TU of size n: v[0] = p[-1][2n-1] (bottom-most left) ... v[2n-1] =
p[-1][0], v[2n] = corner, v[2n+1 .. 4n] = p[0 .. 2n-1][-1].
"""

from __future__ import annotations

import functools

import numpy as np

from ..codec.hevc import intra as HIP


@functools.lru_cache(maxsize=8)
def pred_tables(n: int):
    """Angular-prediction tables for TU size n:
      EXT   [35, 3n+2, 4n+1] one-hot main-reference construction over v
                             (with the invAngle projection, 8.4.4.2.6)
      OFF   [35, n, 2n+1]    one-hot window start per prediction row
      FRAC  [35, n]          per-row fractional weight
      ISHOR [35]             horizontal family (prediction transposed)
    """
    L = 4 * n + 1
    EXT = np.zeros((35, 3 * n + 2, L), np.float32)
    OFF = np.zeros((35, n, 2 * n + 1), np.float32)
    FRAC = np.zeros((35, n), np.int32)
    ISHOR = np.zeros(35, bool)
    corner = 2 * n
    base = n + 1
    for mode in range(2, 35):
        ang = HIP.ANGLES[mode - 2]
        hor = mode < 18
        ISHOR[mode] = hor
        left = lambda j: 2 * n - 1 - j          # left[j] (downward) -> v
        top = lambda i: 2 * n + 1 + i
        main, side = (left, top) if hor else (top, left)
        src = np.full(3 * n + 2, -1, np.int64)
        for i in range(2 * n):
            src[base + i] = main(i)
        src[base - 1] = corner
        if ang < 0:
            inv = HIP.INV_ANGLE[ang]
            for i in range(-1, ((n * ang) >> 5) - 1, -1):
                j = min((i * inv + 128) >> 8, 2 * n - 1) - 1
                src[base + i - 1] = corner if j < 0 else side(j)
        for s in range(3 * n + 2):
            if src[s] >= 0:
                EXT[mode, s, src[s]] = 1.0
        for y in range(n):
            FRAC[mode, y] = ((y + 1) * ang) & 31
            OFF[mode, y, (((y + 1) * ang) >> 5) + n] = 1.0
    return EXT, OFF, FRAC, ISHOR


@functools.lru_cache(maxsize=8)
def pred_idx_tables(n: int):
    """EXT/OFF collapsed to source indices: ext_idx [35, 3n+2] in 0..4n,
    or 4n+1 for "no source" (reads as 0); off_idx [35, n] in 0..2n."""
    EXT, OFF, _, _ = pred_tables(n)
    L = 4 * n + 1
    has = EXT.any(axis=-1)
    ext_idx = np.where(has, EXT.argmax(axis=-1), L).astype(np.int32)
    off_idx = OFF.argmax(axis=-1).astype(np.int32)
    return ext_idx, off_idx


@functools.lru_cache(maxsize=8)
def filter_flags(n: int):
    """FILT [35] bool: [1 2 1] smoothing applies (8.4.4.2.3), luma only."""
    f = np.zeros(35, bool)
    if n == 4:
        return f
    thr = HIP._FILTER_THRESH[n.bit_length() - 1]
    for mode in range(35):
        if mode != HIP.DC and min(abs(mode - HIP.HOR),
                                  abs(mode - HIP.VER)) > thr:
            f[mode] = True
    return f


@functools.lru_cache(maxsize=16)
def zorder_candidates(C: int, max_tu: int):
    """The TU-slot candidates [(n, x0, y0), ...] of one C x C CTB in z-scan
    (quadtree pre-)order, from T = min(C, max_tu) down to 4: every
    reference a TU reads is written by an earlier candidate."""
    T = min(C, max_tu)
    assert C // T <= 2, (C, T)
    cands = []

    def level(sz, x0, y0):
        cands.append((sz, x0, y0))
        if sz > 4:
            h = sz // 2
            for j in range(4):
                level(h, x0 + (j & 1) * h, y0 + (j >> 1) * h)

    nt = C // T
    for i in range(nt * nt):
        level(T, (i & 1) * T, (i >> 1) * T)
    return tuple(cands)


@functools.lru_cache(maxsize=32)
def skew_geometry(ctb_h: int, ctb_w: int, skew: int):
    """Diagonal schedule d = cx + skew*cy, lane = cy: every CTB a TU reads
    from (left, top, top-left, top-right) lies on an earlier diagonal.
    Returns cys, cxs, valid, has_left, each [steps, ctb_h] int32."""
    n_steps = ctb_w + skew * (ctb_h - 1)
    ks = np.arange(ctb_h)
    cys = np.broadcast_to(ks[None, :], (n_steps, ctb_h)).astype(np.int32)
    cxs = (np.arange(n_steps)[:, None] - skew * ks[None, :]).astype(np.int32)
    valid = ((cxs >= 0) & (cxs < ctb_w)).astype(np.int32)
    has_left = ((cxs > 0) & (cxs <= ctb_w)).astype(np.int32)
    cxs = np.clip(cxs, 0, ctb_w - 1)
    return cys, cxs, valid, has_left


def skew_for(C: int) -> int:
    """Wavefront skew for CTB size C: top-right reach in CTBs + 1."""
    maxtb = min(32, C)
    return 1 + (2 * maxtb + C - 1) // C


# deblocking (8.7.2): beta' and tc' by Q (Tables 8-12)
BETA_T = np.array([0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                              18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
                              40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60,
                              62, 64], np.int32)
TC_T = np.array([0] * 18 + [1] * 9 + [2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5,
                                      5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16,
                                      18, 20, 22, 24], np.int32)
# chroma QP mapping for 4:2:0 (Table 8-10), as a dense 0..57 lookup
QPC_T = np.array([q if q < 30 else
                  (q - 6 if q > 43 else
                   [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]
                   [q - 30]) for q in range(58)], np.int32)
