"""H.264 Intra_4x4 prediction tables (spec 8.3.1.2), the mode numbers of
all three intra predictors, and the host decoder's numpy predictors
(pred4x4, pred16x16, pred_chroma8x8, pred8x8; codec/h264/refdec.py).

The eight directional Intra_4x4 modes are one table-driven gather over a
13-element neighbour vector

    n = [l3, l2, l1, l0, tl, t0, t1, t2, t3, t4, t5, t6, t7]

    pred[y, x] = (n[A[m,y,x]] + 2*n[B[m,y,x]] + n[C[m,y,x]] + 2) >> 2

which covers copies (a, a, a), 2-tap rounds ((a+b+1)>>1 ==
(a+2b+a+2)>>2) and 3-tap filters alike. The index tables are generated
below from the spec formulas. DC depends on availability and is handled by
the caller.
"""

from __future__ import annotations

import numpy as np

# mode numbers (spec 8.3.1.1)
I4_V, I4_H, I4_DC, I4_DDL, I4_DDR, I4_VR, I4_HD, I4_VL, I4_HU = range(9)
# 16x16 modes (spec 8.3.3)
I16_V, I16_H, I16_DC, I16_PLANE = range(4)
# chroma modes (spec 8.3.4)
IC_DC, IC_H, IC_V, IC_PLANE = range(4)


def _nidx(x: int, y: int) -> int:
    """Index into the 13-vector n for spec pixel p[x, y] (x or y == -1)."""
    if y == -1 and x == -1:
        return 4
    if y == -1:
        assert 0 <= x <= 7
        return 5 + x
    assert x == -1 and 0 <= y <= 3
    return 3 - y

def _gen_tables():
    A = np.zeros((9, 4, 4), np.int32)
    B = np.zeros((9, 4, 4), np.int32)
    C = np.zeros((9, 4, 4), np.int32)

    def put(m, x, y, taps):
        if len(taps) == 1:  # copy
            a = _nidx(*taps[0])
            A[m, y, x] = B[m, y, x] = C[m, y, x] = a
        elif len(taps) == 2:  # (a+b+1)>>1
            a, b = (_nidx(*t) for t in taps)
            A[m, y, x] = a
            B[m, y, x] = b
            C[m, y, x] = a
        else:  # (a+2b+c+2)>>2
            a, b, c = (_nidx(*t) for t in taps)
            A[m, y, x] = a
            B[m, y, x] = b
            C[m, y, x] = c

    for y in range(4):
        for x in range(4):
            # Vertical / Horizontal as exact copies
            put(I4_V, x, y, [(x, -1)])
            put(I4_H, x, y, [(-1, y)])
            # DC placeholder (unused): copy of tl
            put(I4_DC, x, y, [(-1, -1)])
            # Diagonal down-left (8.3.1.2.4)
            if x == 3 and y == 3:
                put(I4_DDL, x, y, [(6, -1), (7, -1), (7, -1)])
            else:
                put(I4_DDL, x, y, [(x + y, -1), (x + y + 1, -1), (x + y + 2, -1)])
            # Diagonal down-right (8.3.1.2.5)
            if x > y:
                put(I4_DDR, x, y, [(x - y - 2, -1), (x - y - 1, -1), (x - y, -1)])
            elif x < y:
                put(I4_DDR, x, y, [(-1, y - x - 2), (-1, y - x - 1), (-1, y - x)])
            else:
                put(I4_DDR, x, y, [(0, -1), (-1, -1), (-1, 0)])
            # Vertical right (8.3.1.2.6)
            zVR = 2 * x - y
            if zVR in (0, 2, 4, 6):
                put(I4_VR, x, y, [(x - (y >> 1) - 1, -1), (x - (y >> 1), -1)])
            elif zVR in (1, 3, 5):
                put(I4_VR, x, y, [(x - (y >> 1) - 2, -1), (x - (y >> 1) - 1, -1),
                                  (x - (y >> 1), -1)])
            elif zVR == -1:
                put(I4_VR, x, y, [(-1, 0), (-1, -1), (0, -1)])
            else:  # -2, -3
                def pv(i):
                    return (-1, i) if i >= 0 else (-1, -1)
                put(I4_VR, x, y, [pv(y - 2 * x - 1), pv(y - 2 * x - 2),
                                  pv(y - 2 * x - 3)])
            # Horizontal down (8.3.1.2.7)
            zHD = 2 * y - x
            if zHD in (0, 2, 4, 6):
                put(I4_HD, x, y, [(-1, y - (x >> 1) - 1), (-1, y - (x >> 1))])
            elif zHD in (1, 3, 5):
                put(I4_HD, x, y, [(-1, y - (x >> 1) - 2), (-1, y - (x >> 1) - 1),
                                  (-1, y - (x >> 1))])
            elif zHD == -1:
                put(I4_HD, x, y, [(-1, 0), (-1, -1), (0, -1)])
            else:  # -2, -3
                def ph(i):
                    return (i, -1) if i >= 0 else (-1, -1)
                put(I4_HD, x, y, [ph(x - 2 * y - 1), ph(x - 2 * y - 2),
                                  ph(x - 2 * y - 3)])
            # Vertical left (8.3.1.2.8)
            if y % 2 == 0:
                put(I4_VL, x, y, [(x + (y >> 1), -1), (x + (y >> 1) + 1, -1)])
            else:
                put(I4_VL, x, y, [(x + (y >> 1), -1), (x + (y >> 1) + 1, -1),
                                  (x + (y >> 1) + 2, -1)])
            # Horizontal up (8.3.1.2.9)
            zHU = x + 2 * y
            if zHU in (0, 2, 4):
                put(I4_HU, x, y, [(-1, y + (x >> 1)), (-1, y + (x >> 1) + 1)])
            elif zHU in (1, 3):
                put(I4_HU, x, y, [(-1, y + (x >> 1)), (-1, y + (x >> 1) + 1),
                                  (-1, y + (x >> 1) + 2)])
            elif zHU == 5:
                put(I4_HU, x, y, [(-1, 2), (-1, 3), (-1, 3)])
            else:
                put(I4_HU, x, y, [(-1, 3)])
    return A, B, C


I4_TAB_A, I4_TAB_B, I4_TAB_C = _gen_tables()


# ---------------------------------------------------------------------------
# numpy predictors of the host decoder, one block at a time
# ---------------------------------------------------------------------------

def build_neighbor_vec(t8, l4, tl) -> np.ndarray:
    """Assemble the 13-vector n (numpy path). t8: 8 top pixels (with top-right
    substitution already applied by the caller), l4: 4 left, tl: corner."""
    n = np.empty(13, np.int32)
    n[0:4] = l4[::-1]
    n[4] = tl
    n[5:13] = t8
    return n


def pred4x4_directional(mode: int, n):
    """Table-driven prediction for any non-DC 4x4 mode. n: [..., 13] int32."""
    a = n[..., I4_TAB_A[mode]]
    b = n[..., I4_TAB_B[mode]]
    c = n[..., I4_TAB_C[mode]]
    return (a + 2 * b + c + 2) >> 2


def pred4x4_dc(t4, l4, avail_top: bool, avail_left: bool):
    """8.3.1.2.3 DC: neighbor sums by availability. Returns scalar value."""
    if avail_top and avail_left:
        return (int(np.sum(t4)) + int(np.sum(l4)) + 4) >> 3
    if avail_left:
        return (int(np.sum(l4)) + 2) >> 2
    if avail_top:
        return (int(np.sum(t4)) + 2) >> 2
    return 128


def pred4x4(mode: int, t8, l4, tl, avail_top: bool, avail_left: bool):
    """Single-block numpy prediction -> [4,4] int32."""
    if mode == I4_DC:
        return np.full((4, 4), pred4x4_dc(t8[:4], l4, avail_top, avail_left),
                       np.int32)
    n = build_neighbor_vec(t8, l4, tl)
    return pred4x4_directional(mode, n).astype(np.int32)


def _clip1(x):
    return np.clip(x, 0, 255)


def pred16x16(mode: int, t16, l16, tl, avail_top: bool, avail_left: bool):
    """16x16 luma prediction (spec 8.3.3) -> [16,16] int32."""
    t16 = np.asarray(t16, np.int32)
    l16 = np.asarray(l16, np.int32)
    if mode == I16_V:
        if not avail_top:
            raise ValueError("I16 V requires top")
        return np.broadcast_to(t16, (16, 16)).astype(np.int32)
    if mode == I16_H:
        if not avail_left:
            raise ValueError("I16 H requires left")
        return np.broadcast_to(l16[:, None], (16, 16)).astype(np.int32)
    if mode == I16_DC:
        if avail_top and avail_left:
            v = (int(t16.sum()) + int(l16.sum()) + 16) >> 5
        elif avail_left:
            v = (int(l16.sum()) + 8) >> 4
        elif avail_top:
            v = (int(t16.sum()) + 8) >> 4
        else:
            v = 128
        return np.full((16, 16), v, np.int32)
    # plane (8.3.3.4)
    if not (avail_top and avail_left):
        raise ValueError("I16 plane requires top+left")
    xs = np.arange(8)
    # p[-1..] with corner: index -1 of top row is tl
    top_ext = np.concatenate([[tl], t16])  # top_ext[1+x] = p[x,-1]
    left_ext = np.concatenate([[tl], l16])
    H = int(np.sum((xs + 1) * (top_ext[1 + 8 + xs] - top_ext[1 + 6 - xs])))
    V = int(np.sum((xs + 1) * (left_ext[1 + 8 + xs] - left_ext[1 + 6 - xs])))
    a = 16 * (int(l16[15]) + int(t16[15]))
    b = (5 * H + 32) >> 6
    c = (5 * V + 32) >> 6
    y, x = np.mgrid[0:16, 0:16]
    return _clip1((a + b * (x - 7) + c * (y - 7) + 16) >> 5).astype(np.int32)


def pred_chroma8x8(mode: int, t8, l8, tl, avail_top: bool, avail_left: bool):
    """Chroma 8x8 prediction (spec 8.3.4) -> [8,8] int32."""
    t8 = np.asarray(t8, np.int32)
    l8 = np.asarray(l8, np.int32)
    if mode == IC_H:
        if not avail_left:
            raise ValueError("chroma H requires left")
        return np.broadcast_to(l8[:, None], (8, 8)).astype(np.int32)
    if mode == IC_V:
        if not avail_top:
            raise ValueError("chroma V requires top")
        return np.broadcast_to(t8, (8, 8)).astype(np.int32)
    if mode == IC_DC:
        out = np.empty((8, 8), np.int32)
        for by in (0, 1):
            for bx in (0, 1):
                ts = t8[4 * bx:4 * bx + 4]
                ls = l8[4 * by:4 * by + 4]
                if bx == by:  # (0,0) and (1,1): use both if available
                    if avail_top and avail_left:
                        v = (int(ts.sum()) + int(ls.sum()) + 4) >> 3
                    elif avail_left:
                        v = (int(ls.sum()) + 2) >> 2
                    elif avail_top:
                        v = (int(ts.sum()) + 2) >> 2
                    else:
                        v = 128
                elif bx == 1:  # (4,0): prefer top
                    if avail_top:
                        v = (int(ts.sum()) + 2) >> 2
                    elif avail_left:
                        v = (int(ls.sum()) + 2) >> 2
                    else:
                        v = 128
                else:  # (0,4): prefer left
                    if avail_left:
                        v = (int(ls.sum()) + 2) >> 2
                    elif avail_top:
                        v = (int(ts.sum()) + 2) >> 2
                    else:
                        v = 128
                out[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = v
        return out
    # plane (8.3.4.4)
    if not (avail_top and avail_left):
        raise ValueError("chroma plane requires top+left")
    xs = np.arange(4)
    top_ext = np.concatenate([[tl], t8])
    left_ext = np.concatenate([[tl], l8])
    H = int(np.sum((xs + 1) * (top_ext[1 + 4 + xs] - top_ext[1 + 2 - xs])))
    V = int(np.sum((xs + 1) * (left_ext[1 + 4 + xs] - left_ext[1 + 2 - xs])))
    a = 16 * (int(l8[7]) + int(t8[7]))
    b = (17 * H + 16) >> 5
    c = (17 * V + 16) >> 5
    y, x = np.mgrid[0:8, 0:8]
    return _clip1((a + b * (x - 3) + c * (y - 3) + 16) >> 5).astype(np.int32)


# ---------------------------------------------------------------------------
# Intra 8x8 luma prediction (High profile, spec 8.3.2.2)
# ---------------------------------------------------------------------------

def filter_ref8x8(t16, l8, tl, avail_top: bool, avail_left: bool,
                  avail_tl: bool):
    """Reference sample filtering (8.3.2.2.1). t16: 16 top samples (top-right
    already replicated from t[7] by the caller when unavailable), l8: 8 left,
    tl: corner. Returns (t16f, l8f, tlf) int32."""
    t = np.asarray(t16, np.int64)
    l = np.asarray(l8, np.int64)
    tf = np.zeros(16, np.int64)
    lf = np.zeros(8, np.int64)
    tlf = int(tl)
    if avail_top:
        tf[0] = ((int(tl) + 2 * t[0] + t[1] + 2) >> 2) if avail_tl \
            else ((3 * t[0] + t[1] + 2) >> 2)
        tf[1:15] = (t[0:14] + 2 * t[1:15] + t[2:16] + 2) >> 2
        tf[15] = (t[14] + 3 * t[15] + 2) >> 2
    if avail_tl:
        if avail_top and avail_left:
            tlf = int((t[0] + 2 * int(tl) + l[0] + 2) >> 2)
        elif avail_top:
            tlf = int((3 * int(tl) + t[0] + 2) >> 2)
        elif avail_left:
            tlf = int((3 * int(tl) + l[0] + 2) >> 2)
    if avail_left:
        lf[0] = ((int(tl) + 2 * l[0] + l[1] + 2) >> 2) if avail_tl \
            else ((3 * l[0] + l[1] + 2) >> 2)
        lf[1:7] = (l[0:6] + 2 * l[1:7] + l[2:8] + 2) >> 2
        lf[7] = (l[6] + 3 * l[7] + 2) >> 2
    return tf.astype(np.int32), lf.astype(np.int32), tlf


def pred8x8(mode: int, t16, l8, tl, avail_top: bool, avail_left: bool,
            avail_tl: bool):
    """Single-block 8x8 luma prediction -> [8,8] int32 (filtered refs
    computed internally). Mode numbering matches the 4x4 set."""
    t, l, tlf = filter_ref8x8(t16, l8, tl, avail_top, avail_left, avail_tl)
    y, x = np.mgrid[0:8, 0:8]
    if mode == I4_V:
        if not avail_top:
            raise ValueError("I8 V requires top")
        return np.broadcast_to(t[:8], (8, 8)).astype(np.int32)
    if mode == I4_H:
        if not avail_left:
            raise ValueError("I8 H requires left")
        return np.broadcast_to(l[:, None], (8, 8)).astype(np.int32)
    if mode == I4_DC:
        if avail_top and avail_left:
            v = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
        elif avail_top:
            v = (int(t[:8].sum()) + 4) >> 3
        elif avail_left:
            v = (int(l.sum()) + 4) >> 3
        else:
            v = 128
        return np.full((8, 8), v, np.int32)
    if mode == I4_DDL:
        if not avail_top:
            raise ValueError("I8 DDL requires top")
        te = np.concatenate([t, [t[15], t[15]]])
        p = (te[x + y] + 2 * te[x + y + 1] + te[x + y + 2] + 2) >> 2
        p[7, 7] = (t[14] + 3 * t[15] + 2) >> 2
        return p.astype(np.int32)
    if mode == I4_DDR:
        if not (avail_top and avail_left and avail_tl):
            raise ValueError("I8 DDR requires top+left")
        p = np.zeros((8, 8), np.int64)
        for yy in range(8):
            for xx in range(8):
                if xx > yy:
                    a = t[xx - yy - 2] if xx - yy - 2 >= 0 else tlf
                    p[yy, xx] = (a + 2 * t[xx - yy - 1] + t[xx - yy] + 2) >> 2
                elif xx < yy:
                    a = l[yy - xx - 2] if yy - xx - 2 >= 0 else tlf
                    p[yy, xx] = (a + 2 * l[yy - xx - 1] + l[yy - xx] + 2) >> 2
                else:
                    p[yy, xx] = (t[0] + 2 * tlf + l[0] + 2) >> 2
        return p.astype(np.int32)
    if mode == I4_VR:
        if not (avail_top and avail_left and avail_tl):
            raise ValueError("I8 VR requires top+left")
        p = np.zeros((8, 8), np.int64)
        for yy in range(8):
            for xx in range(8):
                z = 2 * xx - yy
                if z >= 0 and z % 2 == 0:
                    i = xx - (yy >> 1)
                    a = t[i - 1] if i - 1 >= 0 else tlf
                    p[yy, xx] = (a + t[i] + 1) >> 1
                elif z >= 0:
                    i = xx - (yy >> 1)
                    a = t[i - 2] if i - 2 >= 0 else tlf
                    b = t[i - 1] if i - 1 >= 0 else tlf
                    p[yy, xx] = (a + 2 * b + t[i] + 2) >> 2
                elif z == -1:
                    p[yy, xx] = (l[0] + 2 * tlf + t[0] + 2) >> 2
                else:
                    i = yy - 2 * xx
                    c = l[i - 3] if i - 3 >= 0 else tlf
                    p[yy, xx] = (l[i - 1] + 2 * l[i - 2] + c + 2) >> 2
        return p.astype(np.int32)
    if mode == I4_HD:
        if not (avail_top and avail_left and avail_tl):
            raise ValueError("I8 HD requires top+left")
        p = np.zeros((8, 8), np.int64)
        for yy in range(8):
            for xx in range(8):
                z = 2 * yy - xx
                if z >= 0 and z % 2 == 0:
                    i = yy - (xx >> 1)
                    a = l[i - 1] if i - 1 >= 0 else tlf
                    p[yy, xx] = (a + l[i] + 1) >> 1
                elif z >= 0:
                    i = yy - (xx >> 1)
                    a = l[i - 2] if i - 2 >= 0 else tlf
                    b = l[i - 1] if i - 1 >= 0 else tlf
                    p[yy, xx] = (a + 2 * b + l[i] + 2) >> 2
                elif z == -1:
                    p[yy, xx] = (t[0] + 2 * tlf + l[0] + 2) >> 2
                else:
                    i = xx - 2 * yy
                    c = t[i - 3] if i - 3 >= 0 else tlf
                    p[yy, xx] = (t[i - 1] + 2 * t[i - 2] + c + 2) >> 2
        return p.astype(np.int32)
    if mode == I4_VL:
        if not avail_top:
            raise ValueError("I8 VL requires top")
        p = np.zeros((8, 8), np.int64)
        for yy in range(8):
            i = np.arange(8) + (yy >> 1)
            if yy % 2 == 0:
                p[yy] = (t[i] + t[i + 1] + 1) >> 1
            else:
                p[yy] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return p.astype(np.int32)
    if mode == I4_HU:
        if not avail_left:
            raise ValueError("I8 HU requires left")
        p = np.zeros((8, 8), np.int64)
        for yy in range(8):
            for xx in range(8):
                z = xx + 2 * yy
                i = yy + (xx >> 1)
                if z < 13 and z % 2 == 0:
                    p[yy, xx] = (l[i] + l[i + 1] + 1) >> 1
                elif z < 13:
                    p[yy, xx] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 13:
                    p[yy, xx] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    p[yy, xx] = l[7]
        return p.astype(np.int32)
    raise ValueError(f"bad intra8x8 mode {mode}")
