"""H.264 exact integer transforms and quantisation (spec 8.5, flat
scaling matrices) on int32 torch tensors: the inverse transforms and
dequantisation of the decode, the forward transform and quantiser of the
device encoder (kernels/encode_tiles.py); and their numpy twins for the
host decoder and encoders (codec/h264/refdec.py, refenc.py: the np_*
functions, chroma_qp, the zig-zag scans and the 8x8 transform).

Blocks are batched as [..., 4, 4] (or [..., 2, 2] for chroma DC). Every
operation is an int32 add, multiply or shift, so the spec's truncating
`>> 1` is reproduced exactly; `>>` on a negative int32 tensor or array is
arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

# normAdjust4x4(m, idx) (8.5.9): idx 0 = (even, even), 1 = (odd, odd),
# 2 = other
_V = np.array(
    [[10, 16, 13],
     [11, 18, 14],
     [13, 20, 16],
     [14, 23, 18],
     [16, 25, 20],
     [18, 29, 23]], dtype=np.int32)

_POS_IDX = np.array(
    [[0, 2, 0, 2],
     [2, 1, 2, 1],
     [0, 2, 0, 2],
     [2, 1, 2, 1]], dtype=np.int32)

# the encoder's quantiser multipliers MF(m, posidx) (JM's quant_coef)
_MF = np.array(
    [[13107, 5243, 8066],
     [11916, 4660, 7490],
     [10082, 4194, 6554],
     [9362, 3647, 5825],
     [8192, 3355, 5243],
     [7282, 2893, 4559]], dtype=np.int32)

# DEQUANT4x4[m, i, j] = v[m, posidx(i, j)] (flat weightScale = 16 folded in)
DEQUANT4x4 = _V[:, _POS_IDX]        # [6, 4, 4]
QUANT_MF4x4 = _MF[:, _POS_IDX]      # [6, 4, 4]

# Chroma QP mapping, qPi 0..51 -> QPc (spec table 8-15)
CHROMA_QP = np.array(
    list(range(30)) +
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38,
     39, 39, 39, 39], dtype=np.int32)


def inverse_transform_4x4(d):
    """Spec 8.5.12.2: the inverse core transform with its final
    (x + 32) >> 6. d [..., 4, 4] int32 dequantised -> [..., 4, 4] int32."""
    d0, d1, d2, d3 = d.unbind(-1)
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f0, f1, f2, f3 = torch.stack(
        [e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1).unbind(-2)
    g0 = f0 + f2
    g1 = f0 - f2
    g2 = (f1 >> 1) - f3
    g3 = f1 + (f3 >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


def hadamard_4x4(x):
    """4x4 Hadamard (self-inverse up to scale): the inverse transform of
    the Intra16x16 luma DC block (8.5.10)."""
    r0, r1, r2, r3 = x.unbind(-2)
    s0, s1, s2, s3 = r0 + r3, r1 + r2, r1 - r2, r0 - r3
    c0, c1, c2, c3 = torch.stack(
        [s0 + s1, s3 + s2, s0 - s1, s3 - s2], dim=-2).unbind(-1)
    u0, u1, u2, u3 = c0 + c3, c1 + c2, c1 - c2, c0 - c3
    return torch.stack([u0 + u1, u3 + u2, u0 - u1, u3 - u2], dim=-1)


def hadamard_2x2(x):
    """2x2 Hadamard of the chroma DC block (8.5.11)."""
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    return torch.stack([
        torch.stack([a + b + c + d, a - b + c - d], dim=-1),
        torch.stack([a + b - c - d, a - b - c + d], dim=-1),
    ], dim=-2)


def forward_transform_4x4(x):
    """The encoder's core transform W = Cf X Cf^T (exact, unscaled): x
    [..., 4, 4] int32 residual -> [..., 4, 4] int32, columns first."""
    r0, r1, r2, r3 = x.unbind(-2)
    s0, s1, s2, s3 = r0 + r3, r1 + r2, r1 - r2, r0 - r3
    c0, c1, c2, c3 = torch.stack(
        [s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], dim=-2).unbind(-1)
    u0, u1, u2, u3 = c0 + c3, c1 + c2, c1 - c2, c0 - c3
    return torch.stack([u0 + u1, 2 * u3 + u2, u0 - u1, u3 - 2 * u2], dim=-1)


def quant_4x4(w, qp: int, intra: bool, mf_table):
    """The encoder's quantiser (JM-style, non-normative): sign(W) *
    ((|W| * MF + f) >> qbits), f a third (intra) or a sixth (inter) of a
    step. w [..., 4, 4] int32; mf_table the QUANT_MF4x4 tensor on w's
    device."""
    qbits = 15 + qp // 6
    f = ((1 << qbits) // 3) if intra else ((1 << qbits) // 6)
    z = (w.abs() * mf_table[qp % 6] + f) >> qbits
    return torch.where(w < 0, -z, z)


def quant_dc(w, qp: int):
    """The encoder's DC quantiser of the Hadamard-domain chroma 2x2 (and
    luma 4x4) DC block: sign(W) * ((|W| * MF(0, 0) + 2f) >> (qbits + 1))."""
    qbits = 15 + qp // 6
    f = 2 * ((1 << qbits) // 3)
    z = (w.abs() * int(QUANT_MF4x4[qp % 6, 0, 0]) + f) >> (qbits + 1)
    return torch.where(w < 0, -z, z)


def dequant_4x4(c, qp, dq_table):
    """Spec 8.5.12.1 with flat scaling lists: d = c * DQ[qp % 6] << (qp // 6).
    c [..., 4, 4] int32; qp [...] int32 per block; dq_table the DEQUANT4x4
    tensor [6, 4, 4] on c's device."""
    scale = dq_table[(qp % 6).long()]
    return (c * scale) << (qp // 6)[..., None, None]


# ---------------------------------------------------------------------------
# numpy twins (the host decoder's): one block at a time, qp a Python int
# ---------------------------------------------------------------------------

# zig-zag scan for 4x4 (spec table 8-13, frame coding)
ZIGZAG4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                     dtype=np.int32)
# inverse: raster position of scan index
INV_ZIGZAG4x4 = np.argsort(ZIGZAG4x4).astype(np.int32)


def chroma_qp(qp_y, chroma_qp_index_offset: int):
    """QPc from luma QP + PPS offset (spec 8.5.8). Works on scalars or
    arrays."""
    qpi = np.clip(qp_y + chroma_qp_index_offset, 0, 51)
    return CHROMA_QP[qpi]


def _np_inverse_transform_4x4(d):
    """numpy twin of inverse_transform_4x4: rows first, then columns."""
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h = np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2)
    return (h + 32) >> 6


def np_forward_transform_4x4(x):
    """numpy twin of forward_transform_4x4."""
    x = np.asarray(x, np.int32)
    r0, r1, r2, r3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    s0, s1, s2, s3 = r0 + r3, r1 + r2, r1 - r2, r0 - r3
    t = np.stack([s0 + s1, 2 * s3 + s2, s0 - s1, s3 - 2 * s2], axis=-2)
    c0, c1, c2, c3 = t[..., :, 0], t[..., :, 1], t[..., :, 2], t[..., :, 3]
    u0, u1, u2, u3 = c0 + c3, c1 + c2, c1 - c2, c0 - c3
    return np.stack([u0 + u1, 2 * u3 + u2, u0 - u1, u3 - 2 * u2], axis=-1)


def np_quant_4x4(w, qp: int, intra: bool):
    """numpy twin of quant_4x4."""
    w = np.asarray(w, np.int32)
    qbits = 15 + qp // 6
    f = ((1 << qbits) // 3) if intra else ((1 << qbits) // 6)
    z = (np.abs(w) * QUANT_MF4x4[qp % 6] + f) >> qbits
    return np.where(w < 0, -z, z)


def np_quant_dc(w, qp: int):
    """numpy twin of quant_dc."""
    w = np.asarray(w, np.int32)
    qbits = 15 + qp // 6
    f = 2 * ((1 << qbits) // 3)
    z = (np.abs(w) * QUANT_MF4x4[qp % 6, 0, 0] + f) >> (qbits + 1)
    return np.where(w < 0, -z, z)


def np_hadamard_4x4(x):
    """numpy twin of hadamard_4x4 (the encoder's forward luma DC transform
    too: the Hadamard is its own inverse up to scale)."""
    r0, r1, r2, r3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    s0, s1, s2, s3 = r0 + r3, r1 + r2, r1 - r2, r0 - r3
    t = np.stack([s0 + s1, s3 + s2, s0 - s1, s3 - s2], axis=-2)
    c0, c1, c2, c3 = t[..., :, 0], t[..., :, 1], t[..., :, 2], t[..., :, 3]
    u0, u1, u2, u3 = c0 + c3, c1 + c2, c1 - c2, c0 - c3
    return np.stack([u0 + u1, u3 + u2, u0 - u1, u3 - u2], axis=-1)


def np_hadamard_2x2(x):
    """numpy twin of hadamard_2x2."""
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    return np.stack([
        np.stack([a + b + c + d, a - b + c - d], axis=-1),
        np.stack([a + b - c - d, a - b - c + d], axis=-1),
    ], axis=-2)


def np_inverse_transform_4x4(d):
    return _np_inverse_transform_4x4(d.astype(np.int32))


def np_dequant_4x4(c, qp: int):
    """Spec 8.5.12.1, flat scaling lists: c * DQ[qp % 6] << (qp // 6)."""
    return (c.astype(np.int32) * DEQUANT4x4[qp % 6]) << (qp // 6)


def np_luma_dc_decode(c_dc, qp: int):
    """Inverse Hadamard + scaling of the Intra16x16 luma DC block
    (8.5.10)."""
    f = np_hadamard_4x4(c_dc.astype(np.int32))
    ls = DEQUANT4x4[qp % 6][..., 0, 0] * 16
    q6 = qp // 6
    if qp >= 36:
        return (f * ls) << (q6 - 6)
    return (f * ls + (1 << max(5 - q6, 0))) >> (6 - q6)


def np_chroma_dc_decode(c_dc, qpc: int):
    """Spec 8.5.11: dcC = ((f * LS(qPc % 6, 0, 0)) << (qPc // 6)) >> 5."""
    f = np_hadamard_2x2(c_dc.astype(np.int32))
    ls = DEQUANT4x4[qpc % 6][..., 0, 0] * 16
    return ((f * ls) << (qpc // 6)) >> 5


# ---------------------------------------------------------------------------
# 8x8 transform (High profile, spec 8.5.12.2/8.5.13), flat scaling matrices
# ---------------------------------------------------------------------------

def _zigzag(n):
    """Classic zigzag scan order for an n x n block (spec Table 8-8 for 8x8
    frame coding): raster index of each scan position."""
    order = sorted(range(n * n),
                   key=lambda p: ((p // n) + (p % n),
                                  (p // n) if ((p // n) + (p % n)) % 2
                                  else (p % n)))
    return np.array(order, dtype=np.int32)


ZIGZAG8x8 = _zigzag(8)
assert ZIGZAG4x4.tolist() == _zigzag(4).tolist(), "zigzag generator bug"

# normAdjust8x8 "v" values per m = QP%6 (spec 8.5.13.1)
_V8 = np.array(
    [[20, 18, 32, 19, 25, 24],
     [22, 19, 35, 21, 28, 26],
     [26, 23, 42, 24, 33, 31],
     [28, 25, 45, 26, 35, 33],
     [32, 28, 51, 30, 40, 38],
     [36, 32, 58, 34, 46, 43]], dtype=np.int32)


def _pos8(i: int, j: int) -> int:
    """Position class of 8x8 coefficient (i, j) (8.5.13.1)."""
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


_POS8 = np.array([[_pos8(i, j) for j in range(8)] for i in range(8)],
                 np.int32)

# LevelScale8x8[m][i][j] with flat weightScale8x8 == 16 folded in
DEQUANT8x8 = 16 * _V8[:, _POS8]     # [6, 8, 8]


def np_dequant_8x8(block, qp: int):
    """Spec 8.5.13.1 scaling of one 8x8 luma block of levels: the product
    in int32, the rounding and shift in int64."""
    prod = (np.asarray(block, np.int32) * DEQUANT8x8[qp % 6]).astype(np.int64)
    q6 = qp // 6
    if qp >= 36:
        return prod << (q6 - 6)
    return (prod + (1 << max(5 - q6, 0))) >> (6 - q6)


def _butterfly8(d0, d1, d2, d3, d4, d5, d6, d7):
    e0 = d0 + d4
    e1 = -d3 + d5 - d7 - (d7 >> 1)
    e2 = d0 - d4
    e3 = d1 + d7 - d3 - (d3 >> 1)
    e4 = (d2 >> 1) - d6
    e5 = -d1 + d7 + d5 + (d5 >> 1)
    e6 = d2 + (d6 >> 1)
    e7 = d3 + d5 + d1 + (d1 >> 1)
    f0 = e0 + e6
    f1 = e1 + (e7 >> 2)
    f2 = e2 + e4
    f3 = e3 + (e5 >> 2)
    f4 = e2 - e4
    f5 = (e3 >> 2) - e5
    f6 = e0 - e6
    f7 = e7 - (e1 >> 2)
    return (f0 + f7, f2 + f5, f4 + f3, f6 + f1,
            f6 - f1, f4 - f3, f2 - f5, f0 - f7)


def np_inverse_transform_8x8(d):
    """Spec 8.5.12.2 8x8 inverse transform incl. final (x+32)>>6: exact
    integer butterflies over the rows, then the columns."""
    d = np.asarray(d, np.int32)
    dh = np.stack(_butterfly8(*(d[..., :, i] for i in range(8))), axis=-1)
    out = np.stack(_butterfly8(*(dh[..., i, :] for i in range(8))), axis=-2)
    return (out + 32) >> 6
