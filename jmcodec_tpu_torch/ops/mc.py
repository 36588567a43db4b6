"""H.264 fractional-pel motion compensation (spec 8.4.2.2), exact integer.

Luma: 6-tap [1,-5,20,20,-5,1] half-pel filter, quarter-pel by rounding
average of neighbors (Table 8-12 positions). Chroma: 1/8-pel bilinear.

numpy, one block at a time (the host decoder's; the device path's batched
MC is kernels/recon_tiles.py). References are edge-replicated ("clamped"
addressing per 8.4.2.2.1's coordinate clipping), which callers realize by
padding the reference plane.
"""

from __future__ import annotations

import numpy as np

# padding needed around a reference plane for any legal MV after clipping
REF_PAD = 24


def pad_ref(plane, pad: int = REF_PAD):
    """Edge-replicate pad a [H, W] plane (numpy)."""
    return np.pad(plane, pad, mode="edge")


def _six_tap(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def mc_luma_block(refp, x0: int, y0: int, mvx: int, mvy: int, w: int, h: int,
                  pad: int = REF_PAD):
    """Predict a [h, w] luma block (numpy path, one block).

    refp: padded reference (pad_ref); (x0, y0): block position in unpadded
    coords; mv in quarter-pel units.
    """
    xi = x0 + (mvx >> 2) + pad
    yi = y0 + (mvy >> 2) + pad
    fx = mvx & 3
    fy = mvy & 3
    if fx == 0 and fy == 0:
        return refp[yi:yi + h, xi:xi + w].astype(np.int32)

    # working window with 6-tap support: rows yi-2..yi+h+2, cols xi-2..xi+w+2
    win = refp[yi - 2:yi + h + 3, xi - 2:xi + w + 3].astype(np.int32)  # [h+5, w+5]

    # half-pel horizontal (unrounded b1 on all rows), value between col k and k+1
    b1 = _six_tap(win[:, 0:-5], win[:, 1:-4], win[:, 2:-3], win[:, 3:-2],
                  win[:, 4:-1], win[:, 5:])           # [h+5, w]
    b = np.clip((b1 + 16) >> 5, 0, 255)
    # half-pel vertical h1 on all cols
    h1 = _six_tap(win[0:-5, :], win[1:-4, :], win[2:-3, :], win[3:-2, :],
                  win[4:-1, :], win[5:, :])           # [h, w+5]
    hh = np.clip((h1 + 16) >> 5, 0, 255)
    # center j from vertical 6-tap over b1 columns
    j1 = _six_tap(b1[0:-5, :], b1[1:-4, :], b1[2:-3, :], b1[3:-2, :],
                  b1[4:-1, :], b1[5:, :])             # [h, w]
    jj = np.clip((j1 + 512) >> 10, 0, 255)

    G = win[2:2 + h, 2:2 + w]
    H_ = win[2:2 + h, 3:3 + w]
    M_ = win[3:3 + h, 2:2 + w]
    bG = b[2:2 + h, :]          # b at row of G
    bM = b[3:3 + h, :]          # s: half-pel horizontal one row below
    hG = hh[:, 2:2 + w]         # h at col of G
    hH = hh[:, 3:3 + w]         # m: half-pel vertical one col right

    if fy == 0:
        if fx == 1:
            return (G + bG + 1) >> 1
        if fx == 2:
            return bG
        return (H_ + bG + 1) >> 1                     # fx == 3
    if fx == 0:
        if fy == 1:
            return (G + hG + 1) >> 1
        if fy == 2:
            return hG
        return (M_ + hG + 1) >> 1                     # fy == 3
    if fx == 2 and fy == 2:
        return jj
    if fy == 2:  # i / k: average of vertical half-pels with j
        return (hG + jj + 1) >> 1 if fx == 1 else (hH + jj + 1) >> 1
    if fx == 2:  # f / q: average of horizontal half-pels with j
        return (bG + jj + 1) >> 1 if fy == 1 else (bM + jj + 1) >> 1
    # diagonal quarters e, g, p, r: average nearest horizontal+vertical halfs
    bsel = bG if fy == 1 else bM
    hsel = hG if fx == 1 else hH
    return (bsel + hsel + 1) >> 1


def mc_chroma_block(refp, x0: int, y0: int, mvx: int, mvy: int, w: int, h: int,
                    pad: int = REF_PAD):
    """Predict a [h, w] chroma block; mv in luma quarter-pel units -> chroma
    eighth-pel (spec 8.4.2.2.2)."""
    xi = x0 + (mvx >> 3) + pad
    yi = y0 + (mvy >> 3) + pad
    dx = mvx & 7
    dy = mvy & 7
    A = refp[yi:yi + h, xi:xi + w].astype(np.int32)
    B = refp[yi:yi + h, xi + 1:xi + 1 + w].astype(np.int32)
    C = refp[yi + 1:yi + 1 + h, xi:xi + w].astype(np.int32)
    D = refp[yi + 1:yi + 1 + h, xi + 1:xi + 1 + w].astype(np.int32)
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
            + (8 - dx) * dy * C + dx * dy * D + 32) >> 6
