"""Macroblock-layer constants the device path reads (spec 6.4.3, 6.4.11):
the 4x4 luma block scan inside a macroblock."""

from __future__ import annotations

import numpy as np

# blkIdx scan (6.4.3): 8x8 quadrants in raster order, 4x4 blocks in raster
# order inside the quadrant. BLK_X/BLK_Y are the pixel offsets per blkIdx.
BLK_X = np.array([(((i >> 2) & 1) << 3) + ((i & 1) << 2) for i in range(16)],
                 dtype=np.int32)
BLK_Y = np.array([((i >> 3) << 3) + (((i & 3) >> 1) << 2) for i in range(16)],
                 dtype=np.int32)

# blkIdx whose top-right 4x4 neighbour is decoded later within the macroblock
# (6.4.11), so it is never available
TR_UNAVAILABLE_IN_MB = frozenset({3, 7, 11, 13, 15})
