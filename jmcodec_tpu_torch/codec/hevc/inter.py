"""HEVC inter prediction: motion compensation, MV scaling, merge/AMVP
candidate helpers, and the DPB entry with the motion field that temporal
MV prediction reads (H.265 8.3.2, 8.5.3, 8.5.4).

The port's copy of jmcodec_tpu/codec/hevc/inter.py. The device path runs
its motion derivation in the native parser or the Python parse
(refdec.py) and its motion compensation on the device
(kernels/hevc_tiles.py); the numpy MC here is the host decode's.

MVs are quarter-pel int32 (x, y). Reference pictures are RefPic entries
holding full pixel planes plus the per-4x4-cell motion field needed for
temporal MV prediction (8.5.3.2.8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

# fractional-sample interpolation filters (spec 8.5.4.2.2.1 / .2)
LUMA_FILT = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], np.int32)

CHROMA_FILT = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], np.int32)

PRED_L0, PRED_L1, PRED_BI = 1, 2, 3


@dataclass
class RefPic:
    """A decoded picture in the DPB, with the motion field kept for TMVP.
    y/cb/cr are the coded-size planes as its decode returned them: tensors
    that stay on the device for a device-decoded picture, numpy uint8
    planes for a host-decoded one."""
    poc: int
    y: Any
    cb: Any
    cr: Any
    # per-4x4-luma-cell motion data (TMVP reads it 16x16-rounded, 8.5.3.2.8)
    mv: np.ndarray          # [2, H4, W4, 2] int32 quarter-pel
    ref_poc: np.ndarray     # [2, H4, W4] int32 (POC of the ref each MV uses)
    pred: np.ndarray        # [2, H4, W4] uint8 predFlagLX
    intra: np.ndarray       # [H4, W4] uint8
    output_needed: bool = True
    is_reference: bool = True
    crop: Tuple[int, int] = (0, 0)   # output (width, height), conf window
    # numpy copies of device-resident planes, made when the host MC of a
    # later picture first reads them (refdec._host_planes)
    host: Optional[tuple] = field(default=None, repr=False)


# ---------------------------------------------------------------------------
# MV scaling (8.5.3.2.8 / 8.5.3.2.9: the td/tb POC-distance scaler)
# ---------------------------------------------------------------------------


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def scale_mv(mv: Tuple[int, int], tb: int, td: int) -> Tuple[int, int]:
    """Scale mv by POC distances: tb = curr->target ref, td = col->col ref."""
    td = max(-128, min(127, td))
    tb = max(-128, min(127, tb))
    tx = _trunc_div(16384 + (abs(td) >> 1), td)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        v = dsf * c
        s = -1 if v < 0 else 1
        out.append(max(-32768, min(32767, s * ((abs(v) + 127) >> 8))))
    return (out[0], out[1])


# ---------------------------------------------------------------------------
# motion compensation (8.5.4.2.2): block fetch with edge clamp + separable
# 8-tap (luma) / 4-tap (chroma) filtering at 14-bit intermediate precision
# ---------------------------------------------------------------------------


def _fetch(plane: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """Window [y0:y0+h, x0:x0+w] with border clamp (spec edge padding)."""
    H, W = plane.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, H - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, W - 1)
    return plane[np.ix_(ys, xs)].astype(np.int32)


def mc_luma(ref: np.ndarray, xp: int, yp: int, w: int, h: int,
            mvx: int, mvy: int) -> np.ndarray:
    """14-bit luma prediction block (pre weighted-sample stage)."""
    xi, yi = xp + (mvx >> 2), yp + (mvy >> 2)
    xf, yf = mvx & 3, mvy & 3
    if xf == 0 and yf == 0:
        return _fetch(ref, xi, yi, w, h) << 6
    if yf == 0:
        win = _fetch(ref, xi - 3, yi, w + 7, h)
        f = LUMA_FILT[xf]
        return sum(int(f[k]) * win[:, k:k + w] for k in range(8))
    if xf == 0:
        win = _fetch(ref, xi, yi - 3, w, h + 7)
        f = LUMA_FILT[yf]
        return sum(int(f[k]) * win[k:k + h, :] for k in range(8))
    win = _fetch(ref, xi - 3, yi - 3, w + 7, h + 7)
    fh = LUMA_FILT[xf]
    tmp = sum(int(fh[k]) * win[:, k:k + w] for k in range(8))
    fv = LUMA_FILT[yf]
    return sum(int(fv[k]) * tmp[k:k + h, :] for k in range(8)) >> 6


def mc_chroma(ref: np.ndarray, xp: int, yp: int, w: int, h: int,
              mvx: int, mvy: int) -> np.ndarray:
    """14-bit chroma prediction block; mv is the luma quarter-pel MV
    (chroma step = 1/8 in chroma coords, 8.5.4.2.2.2)."""
    xi, yi = xp + (mvx >> 3), yp + (mvy >> 3)
    xf, yf = mvx & 7, mvy & 7
    if xf == 0 and yf == 0:
        return _fetch(ref, xi, yi, w, h) << 6
    if yf == 0:
        win = _fetch(ref, xi - 1, yi, w + 3, h)
        f = CHROMA_FILT[xf]
        return sum(int(f[k]) * win[:, k:k + w] for k in range(4))
    if xf == 0:
        win = _fetch(ref, xi, yi - 1, w, h + 3)
        f = CHROMA_FILT[yf]
        return sum(int(f[k]) * win[k:k + h, :] for k in range(4))
    win = _fetch(ref, xi - 1, yi - 1, w + 3, h + 3)
    fh = CHROMA_FILT[xf]
    tmp = sum(int(fh[k]) * win[:, k:k + w] for k in range(4))
    fv = CHROMA_FILT[yf]
    return sum(int(fv[k]) * tmp[k:k + h, :] for k in range(4)) >> 6


def predict_pu(refs: List[List[Optional[RefPic]]], xp: int, yp: int,
               w: int, h: int, pred: int,
               mv: List[Tuple[int, int]], ref_idx: List[int],
               wp=None):
    """Full PU prediction -> (luma, cb, cr) uint8-range int32 blocks.
    Default or explicit-weighted sample prediction, 8.5.4.2.3; `wp` is
    (hdr.wp, luma_denom, chroma_denom) when the PPS enables weighting."""
    planes = []
    for comp in range(3):
        acc = []
        wo = []  # (weight, offset) per list for this component
        for lx in (0, 1):
            if not (pred & (1 << lx)):
                acc.append(None)
                wo.append((0, 0))
                continue
            rp = refs[lx][ref_idx[lx]]
            mvx, mvy = mv[lx]
            if comp == 0:
                acc.append(mc_luma(rp.y, xp, yp, w, h, mvx, mvy))
            else:
                plane = rp.cb if comp == 1 else rp.cr
                acc.append(mc_chroma(plane, xp >> 1, yp >> 1,
                                     w >> 1, h >> 1, mvx, mvy))
            if wp is not None:
                e = wp[0][lx][ref_idx[lx]]
                wo.append((e[2 * comp], e[2 * comp + 1]))
        if wp is None:
            if acc[0] is not None and acc[1] is not None:
                out = np.clip((acc[0] + acc[1] + 64) >> 7, 0, 255)
            else:
                p = acc[0] if acc[0] is not None else acc[1]
                out = np.clip((p + 32) >> 6, 0, 255)
        else:
            # explicit weighted prediction (8.5.4.2.3.3), 8-bit: shift1=6
            log2wd = (wp[1] if comp == 0 else wp[2]) + 6
            if acc[0] is not None and acc[1] is not None:
                (w0, o0), (w1, o1) = wo
                out = np.clip(
                    (acc[0] * w0 + acc[1] * w1 +
                     ((o0 + o1 + 1) << log2wd)) >> (log2wd + 1), 0, 255)
            else:
                lx = 0 if acc[0] is not None else 1
                wgt, off = wo[lx]
                p = acc[lx]
                out = np.clip(
                    ((p * wgt + (1 << (log2wd - 1))) >> log2wd) + off,
                    0, 255)
        planes.append(out)
    return planes[0], planes[1], planes[2]


# ---------------------------------------------------------------------------
# candidate derivation helpers
# ---------------------------------------------------------------------------


@dataclass
class MotionCand:
    """One merge/AMVP candidate: per-list MV + ref idx + pred flags."""
    mv: List[Tuple[int, int]] = field(
        default_factory=lambda: [(0, 0), (0, 0)])
    ref_idx: List[int] = field(default_factory=lambda: [-1, -1])
    pred: int = 0

    def same_motion(self, o: "MotionCand") -> bool:
        if self.pred != o.pred:
            return False
        for lx in (0, 1):
            if self.pred & (1 << lx):
                if (self.mv[lx] != o.mv[lx] or
                        self.ref_idx[lx] != o.ref_idx[lx]):
                    return False
        return True


# merge combined-bi pair order (spec Table 8-? in 8.5.3.2.4)
COMB_L0 = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
COMB_L1 = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)
