"""H.264 Intra_4x4 prediction tables (spec 8.3.1.2) and the mode numbers
of all three intra predictors.

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

