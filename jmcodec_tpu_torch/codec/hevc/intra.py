"""HEVC intra-picture prediction (H.265 spec 8.4.4.2): 35 modes over
4..32 TUs, with reference-sample substitution, [1 2 1] filtering and
32x32 strong (bilinear) smoothing.

Host oracle for the device recon kernels (SURVEY §7.2 L0).
"""

from __future__ import annotations

import numpy as np

PLANAR, DC, HOR, VER = 0, 1, 10, 26

# intraPredAngle for modes 2..34 (Table 8-5)
ANGLES = [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
          -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26,
          32]
# invAngle for angles -2..-32 (Table 8-6), indexed by mode via ANGLES
INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482,
             -21: -390, -26: -315, -32: -256}

_FILTER_THRESH = {2: 10, 3: 7, 4: 1, 5: 0}  # log2 size -> minDist threshold


def gather_references(plane: np.ndarray, avail4: np.ndarray, x0: int,
                      y0: int, n: int, bit_depth: int = 8):
    """Collect the 4n+1 reference samples p[-1][-1..2n-1], p[-1..2n-1][-1]
    with availability substitution (8.4.4.2.2).

    avail4: bool map at 4x4 granularity of already-reconstructed blocks of
    THIS plane's grid (chroma maps are in chroma coords).
    Returns (left[2n], topleft, top[2n]) where left runs downward.
    """
    h, w = plane.shape
    gran = 4

    def ok(x, y):
        if x < 0 or y < 0 or x >= w or y >= h:
            return False
        return bool(avail4[y // gran, x // gran])

    # sample list in substitution scan order: from p[-1][2n-1] (bottom-left,
    # bottom-most) upward, corner, then top leftward to p[2n-1][-1]
    coords = ([(x0 - 1, y0 + i) for i in range(2 * n - 1, -1, -1)] +
              [(x0 - 1, y0 - 1)] +
              [(x0 + i, y0 - 1) for i in range(2 * n)])
    vals = np.empty(4 * n + 1, np.int32)
    have = np.zeros(4 * n + 1, bool)
    for i, (x, y) in enumerate(coords):
        if ok(x, y):
            vals[i] = plane[y, x]
            have[i] = True
    if not have.any():
        vals[:] = 1 << (bit_depth - 1)
    else:
        # 8.4.4.2.2: fill unavailable from the previous available in scan
        # order; leading run copies from the first available
        first = int(np.argmax(have))
        vals[:first] = vals[first]
        for i in range(first + 1, 4 * n + 1):
            if not have[i]:
                vals[i] = vals[i - 1]
    left = vals[2 * n - 1::-1]   # p[-1][0..2n-1] downward
    topleft = int(vals[2 * n])
    top = vals[2 * n + 1:]
    return left.copy(), topleft, top.copy()


def filter_references(left, topleft, top, n, mode, strong_smoothing,
                      bit_depth=8):
    """8.4.4.2.3: [1 2 1] smoothing / 32x32 bilinear strong smoothing."""
    log2 = n.bit_length() - 1
    if mode == DC or n == 4:
        return left, topleft, top
    min_dist = min(abs(mode - HOR), abs(mode - VER))
    if min_dist <= _FILTER_THRESH[log2]:
        return left, topleft, top
    if n == 32 and strong_smoothing:
        thr = 1 << (bit_depth - 5)
        flat_t = abs(topleft + int(top[2 * n - 1]) - 2 * int(top[n - 1])) < thr
        flat_l = abs(topleft + int(left[2 * n - 1]) - 2 * int(left[n - 1])) < thr
        if flat_t and flat_l:
            tl = topleft
            bl = int(left[2 * n - 1])
            tr = int(top[2 * n - 1])
            x = np.arange(2 * n - 1, dtype=np.int32)
            nl = np.empty_like(left)
            nt = np.empty_like(top)
            nl[:2 * n - 1] = ((2 * n - 1 - x) * tl + (x + 1) * bl + 32) >> 6
            nl[2 * n - 1] = bl
            nt[:2 * n - 1] = ((2 * n - 1 - x) * tl + (x + 1) * tr + 32) >> 6
            nt[2 * n - 1] = tr
            return nl, topleft, nt
    # [1 2 1]
    ext = np.concatenate([left[::-1], [topleft], top]).astype(np.int32)
    sm = ext.copy()
    sm[1:-1] = (ext[:-2] + 2 * ext[1:-1] + ext[2:] + 2) >> 2
    nl = sm[:2 * n][::-1].copy()
    ntl = int(sm[2 * n])
    nt = sm[2 * n + 1:].copy()
    return nl, ntl, nt


def predict(mode: int, left, topleft, top, n: int, cidx: int,
            bit_depth: int = 8) -> np.ndarray:
    """8.4.4.2.5-6: produce the nxn prediction block (int32)."""
    mx = (1 << bit_depth) - 1
    if mode == PLANAR:
        x = np.arange(n, dtype=np.int32)
        y = np.arange(n, dtype=np.int32)
        tr = int(top[n])
        bl = int(left[n])
        log2 = n.bit_length() - 1
        px = ((n - 1 - x)[None, :] * left[:n][:, None]
              + (x + 1)[None, :] * tr
              + (n - 1 - y)[:, None] * top[:n][None, :]
              + (y + 1)[:, None] * bl + n)
        return (px >> (log2 + 1)).astype(np.int32)
    if mode == DC:
        dc = (int(left[:n].sum()) + int(top[:n].sum()) + n) >> (
            n.bit_length())
        out = np.full((n, n), dc, np.int32)
        if cidx == 0 and n < 32:
            out[0, 0] = (int(left[0]) + 2 * dc + int(top[0]) + 2) >> 2
            out[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            out[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        return out
    # angular (8.4.4.2.6)
    ang = ANGLES[mode - 2]
    out = np.empty((n, n), np.int32)
    if mode >= 18:  # vertical family: main ref = top
        ref = np.zeros(3 * n + 2, np.int32)  # index shift n+1: ref[n+1+i]=top[i]
        base = n + 1
        ref[base:base + 2 * n] = top
        ref[base - 1] = topleft
        if ang < 0:
            inv = INV_ANGLE[ang]
            lo = (n * ang) >> 5
            # spec ref[s] maps to ref[base + s - 1] here; projection fills
            # spec indices -1 .. (nTbS*angle)>>5 from the left column
            for i in range(-1, lo - 1, -1):
                j = min((i * inv + 128) >> 8, 2 * n - 1) - 1
                ref[base + i - 1] = topleft if j < 0 else left[j]
        for y in range(n):
            idx = ((y + 1) * ang) >> 5
            fact = ((y + 1) * ang) & 31
            seg = ref[base + idx:base + idx + n + 1]
            if fact:
                out[y, :] = ((32 - fact) * seg[:n] + fact * seg[1:n + 1]
                             + 16) >> 5
            else:
                out[y, :] = seg[:n]
        if mode == VER and cidx == 0 and n < 32:
            col = int(topleft)
            d = ((left[:n].astype(np.int32) - col) >> 1) + top[0]
            out[:, 0] = np.clip(d, 0, mx)
    else:  # horizontal family: main ref = left
        ref = np.zeros(3 * n + 2, np.int32)
        base = n + 1
        ref[base:base + 2 * n] = left
        ref[base - 1] = topleft
        if ang < 0:
            inv = INV_ANGLE[ang]
            lo = (n * ang) >> 5
            for i in range(-1, lo - 1, -1):
                j = min((i * inv + 128) >> 8, 2 * n - 1) - 1
                ref[base + i - 1] = topleft if j < 0 else top[j]
        for x in range(n):
            idx = ((x + 1) * ang) >> 5
            fact = ((x + 1) * ang) & 31
            seg = ref[base + idx:base + idx + n + 1]
            if fact:
                out[:, x] = ((32 - fact) * seg[:n] + fact * seg[1:n + 1]
                             + 16) >> 5
            else:
                out[:, x] = seg[:n]
        if mode == HOR and cidx == 0 and n < 32:
            row = int(topleft)
            d = ((top[:n].astype(np.int32) - row) >> 1) + left[0]
            out[0, :] = np.clip(d, 0, mx)
    return out
