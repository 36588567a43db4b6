"""H.264 exact integer inverse transforms and dequantisation (spec 8.5,
flat scaling matrices) on int32 torch tensors.

Blocks are batched as [..., 4, 4] (or [..., 2, 2] for chroma DC). Every
operation is an int32 add, multiply or shift, so the spec's truncating
`>> 1` is reproduced exactly; `>>` on a negative int32 tensor is
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

# DEQUANT4x4[m, i, j] = v[m, posidx(i, j)] (flat weightScale = 16 folded in)
DEQUANT4x4 = _V[:, _POS_IDX]        # [6, 4, 4]

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


def dequant_4x4(c, qp, dq_table):
    """Spec 8.5.12.1 with flat scaling lists: d = c * DQ[qp % 6] << (qp // 6).
    c [..., 4, 4] int32; qp [...] int32 per block; dq_table the DEQUANT4x4
    tensor [6, 4, 4] on c's device."""
    scale = dq_table[(qp % 6).long()]
    return (c * scale) << (qp // 6)[..., None, None]
