"""HEVC inverse transforms and dequantisation (H.265 spec 8.6).

The DCT-II matrices (4/8/16/32) are built from the spec's integer basis: the
32 distinct magnitudes of the first column (Table in 8.6.4.1) plus the DCT
symmetry T[k][n] = sign * b[(k*(2n+1)) folded].  The 4x4 DST-VII matrix for
intra luma is given explicitly (8.6.4.2).

This mirrors what the reference's decode silicon performs after entropy
decode (SURVEY §7.2 L0); the device twin lives in kernels/ (jnp matmul form,
MXU-friendly), this module is the host oracle.
"""

from __future__ import annotations

import numpy as np

# First-column magnitudes of the 32-point DCT-II matrix: value for angle
# i*pi/64, i = 0..32 (spec 8.6.4.1 transMatrix).
_B = [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
      64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0]


def _cos64(a: int) -> int:
    """Spec-rounded 90.51*cos(a*pi/64) via the _B basis and symmetry."""
    a %= 128
    if a <= 32:
        return _B[a]
    if a <= 64:
        return -_B[64 - a]
    return -_cos64(a - 64)


def dct_matrix(n: int) -> np.ndarray:
    """Forward DCT-II transMatrix rows k, cols j for size n (4/8/16/32)."""
    step = 32 // n
    m = np.empty((n, n), np.int32)
    for k in range(n):
        for j in range(n):
            m[k, j] = _cos64(k * step * (2 * j + 1))
    return m


DCT = {n: dct_matrix(n) for n in (4, 8, 16, 32)}

# 4x4 DST-VII (spec 8.6.4.2), used for intra luma 4x4 TUs
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29]], np.int32)

LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], np.int32)

# Table 8-10: chroma QP mapping for 4:2:0 (qPi 30..43)
_QPC_MAP = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]


def chroma_qp(qpy: int, offset: int) -> int:
    qpi = max(-0, min(57, qpy + offset))
    if qpi < 30:
        return qpi
    if qpi > 43:
        return qpi - 6
    return _QPC_MAP[qpi - 30]


def dequant(coeffs: np.ndarray, qp: int, log2_size: int,
            bit_depth: int = 8) -> np.ndarray:
    """Scaling of transform coefficients (8.6.3), flat scaling list m=16."""
    bd_shift = bit_depth + log2_size - 5
    scale = int(LEVEL_SCALE[qp % 6]) << (qp // 6)
    d = coeffs.astype(np.int64) * scale * 16
    d = (d + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)


def inverse_transform(d: np.ndarray, log2_size: int, dst: bool,
                      bit_depth: int = 8) -> np.ndarray:
    """Two-stage inverse transform (8.6.4.2): vertical pass, clip to int16,
    horizontal pass. Returns residual int32 [n][n]."""
    n = 1 << log2_size
    m = DST4 if dst else DCT[n]
    mt = m.T.astype(np.int64)
    # stage 1 (columns): e = M^T * d, shift 7
    e = mt @ d.astype(np.int64)
    e = np.clip((e + 64) >> 7, -32768, 32767)
    # stage 2 (rows): r[j][x] = sum_k e[j][k] * M[k][x], shift 20 - bitDepth
    shift2 = 20 - bit_depth
    r = e @ m.astype(np.int64)
    r = (r + (1 << (shift2 - 1))) >> shift2
    return np.clip(r, -32768, 32767).astype(np.int32)


def transform_skip_residual(d: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """transform_skip_flag path (8.6.4.2): r = (d<<7 + rnd) >> (20-bd)."""
    shift2 = 20 - bit_depth
    r = (d.astype(np.int64) << 7)
    r = (r + (1 << (shift2 - 1))) >> shift2
    return np.clip(r, -32768, 32767).astype(np.int32)
