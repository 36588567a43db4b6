"""P-slice inter syntax + motion vector prediction (spec 7.3.5.1, 8.4.1).

Extends the macroblock layer with inter MB parsing and the normative
MV predictors (median, 16x8/8x16 directional rules, P_Skip). Motion state
lives in per-4x4 grids on MBGrids-like storage so CAVLC nC, MV prediction and
deblock bS derivation all share one source of truth.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ...utils.bits import BitReader
from . import macroblock as MB

# P mb_type (Table 7-13)
P_16x16 = 0
P_16x8 = 1
P_8x16 = 2
P_8x8 = 3
P_8x8REF0 = 4
# internal class id for inter MBs in MBGrids.mb_class
MB_P = 3

# sub_mb_type (Table 7-17): (parts, w4, h4) in 4x4 units per 8x8 block
SUB_SHAPES = {0: (1, 2, 2), 1: (2, 2, 1), 2: (2, 1, 2), 3: (4, 1, 1)}


class _ListView:
    """List-1 view over MotionGrids with the attribute shape _neighbor and
    predict_mv expect (mv/ref/done)."""

    __slots__ = ("mv", "ref", "done")

    def __init__(self, mv, ref, done):
        self.mv = mv
        self.ref = ref
        self.done = done


@dataclass
class MotionGrids:
    """Per-4x4 motion state for one frame. The object itself doubles as the
    list-0 view; .lst(1) exposes list 1 (B slices)."""
    mb_width: int
    mb_height: int
    mv: np.ndarray = None        # [mbh*4, mbw*4, 2] int32 quarter-pel (L0)
    ref: np.ndarray = None       # [mbh*4, mbw*4] int32; -1 = intra/unset
    done: np.ndarray = None      # [mbh*4, mbw*4] 1 once the block's motion
    #                              is final (spec 6.4.11.7: a within-MB C
    #                              neighbor not yet decoded is unavailable)
    mv1: np.ndarray = None       # list 1 (B slices)
    ref1: np.ndarray = None
    # DPB-picture identity (POC) each list references; INT32_MIN = none.
    # Deblock bS must compare reference PICTURES, not indices (8.7.2.1)
    refpic0: np.ndarray = None
    refpic1: np.ndarray = None

    NO_PIC = np.int32(-(1 << 30))

    def __post_init__(self):
        if self.mv is None:
            h, w = self.mb_height * 4, self.mb_width * 4
            self.mv = np.zeros((h, w, 2), np.int32)
            self.ref = np.full((h, w), -1, np.int32)
            self.done = np.zeros((h, w), np.int32)
            self.mv1 = np.zeros((h, w, 2), np.int32)
            self.ref1 = np.full((h, w), -1, np.int32)
            self.refpic0 = np.full((h, w), self.NO_PIC, np.int32)
            self.refpic1 = np.full((h, w), self.NO_PIC, np.int32)

    def lst(self, i: int):
        return self if i == 0 else _ListView(self.mv1, self.ref1, self.done)


def _neighbor(g: MB.MBGrids, m: MotionGrids, by: int, bx: int,
              cur_slice: int) -> Tuple[np.ndarray, int]:
    """(mv, ref) of the 4x4 block at (by,bx); ref -1 when unavailable/intra."""
    gh, gw = m.ref.shape
    if bx < 0 or by < 0 or bx >= gw or by >= gh:
        return np.zeros(2, np.int32), -1, False
    my, mx = by // 4, bx // 4
    if g.slice_id[my, mx] != cur_slice or g.mb_class[my, mx] < 0 \
            or not m.done[by, bx]:
        return np.zeros(2, np.int32), -1, False
    r = int(m.ref[by, bx])
    if r < 0:  # intra MB: "available" but has no motion info
        return np.zeros(2, np.int32), -1, True
    return m.mv[by, bx].copy(), r, True


def predict_mv(g: MB.MBGrids, m: MotionGrids, by: int, bx: int,
               w4: int, h4: int, ref_idx: int, cur_slice: int,
               part_kind: str = "other") -> np.ndarray:
    """Luma MV predictor (8.4.1.3). part_kind: '16x8_top', '16x8_bot',
    '8x16_left', '8x16_right', or 'other'."""
    mvA, refA, availA = _neighbor(g, m, by, bx - 1, cur_slice)
    mvB, refB, availB = _neighbor(g, m, by - 1, bx, cur_slice)
    mvC, refC, availC = _neighbor(g, m, by - 1, bx + w4, cur_slice)
    if not availC:
        mvC, refC, availC = _neighbor(g, m, by - 1, bx - 1, cur_slice)  # D

    # directional shortcuts (8.4.1.3 clause 2)
    if part_kind == "16x8_top" and refB == ref_idx:
        return mvB
    if part_kind == "16x8_bot" and refA == ref_idx:
        return mvA
    if part_kind == "8x16_left" and refA == ref_idx:
        return mvA
    if part_kind == "8x16_right" and refC == ref_idx:
        return mvC

    if not availB and not availC and availA:
        return mvA
    match = [r == ref_idx for r in (refA, refB, refC)]
    if sum(match) == 1:
        return (mvA, mvB, mvC)[match.index(True)]
    return np.array([int(np.median([mvA[0], mvB[0], mvC[0]])),
                     int(np.median([mvA[1], mvB[1], mvC[1]]))], np.int32)


def pskip_mv(g: MB.MBGrids, m: MotionGrids, my: int, mx: int,
             cur_slice: int) -> np.ndarray:
    """P_Skip motion (8.4.1.1): zero if edge conditions hit, else 16x16 pred."""
    by, bx = my * 4, mx * 4
    mvA, refA, availA = _neighbor(g, m, by, bx - 1, cur_slice)
    mvB, refB, availB = _neighbor(g, m, by - 1, bx, cur_slice)
    if not availA or not availB:
        return np.zeros(2, np.int32)
    if refA == 0 and mvA[0] == 0 and mvA[1] == 0:
        return np.zeros(2, np.int32)
    if refB == 0 and mvB[0] == 0 and mvB[1] == 0:
        return np.zeros(2, np.int32)
    return predict_mv(g, m, by, bx, 4, 4, 0, cur_slice)


def read_te(r: BitReader, max_val: int) -> int:
    """te(v) (spec 9.1.1): 1-bit inverted flag when range is [0,1]."""
    if max_val == 1:
        return 1 - r.u(1)
    return r.ue()


@dataclass
class InterPartition:
    by: int          # 4x4-grid coords within frame
    bx: int
    w4: int
    h4: int
    ref_idx: int     # list-0 ref (-1 = list 0 unused, B only)
    mv: np.ndarray   # [2] list-0 MV
    ref_idx1: int = -1           # list-1 ref (B slices)
    mv1: Optional[np.ndarray] = None


@dataclass
class PMBSymbols(MB.MBSymbols):
    """Extends MBSymbols with inter partition info."""
    p_type: int = P_16x16
    sub_types: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    partitions: List[InterPartition] = field(default_factory=list)
    is_skip: bool = False


def parse_p_macroblock(r: BitReader, g: MB.MBGrids, m: MotionGrids,
                       my: int, mx: int, cur_slice: int, qp_prev: int,
                       mb_type: int, num_ref: int,
                       t8_allowed: bool = False) -> PMBSymbols:
    """Parse one non-skip P macroblock after its mb_type."""
    if mb_type >= 5:
        s0 = MB.parse_i_macroblock(r, g, my, mx, cur_slice, qp_prev,
                                   mb_type - 5, t8_allowed)
        s = PMBSymbols(**{f: getattr(s0, f) for f in s0.__dataclass_fields__})
        # intra in P slice: motion grid stays -1
        m.ref[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
        m.mv[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        m.done[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 1
        return s

    s = PMBSymbols()
    s.mb_class = MB_P
    s.p_type = mb_type
    g.mb_class[my, mx] = MB_P
    g.slice_id[my, mx] = cur_slice
    g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
    by0, bx0 = my * 4, mx * 4

    def put_partition(by, bx, w4, h4, ref_idx, mvd, kind):
        mvp = predict_mv(g, m, by, bx, w4, h4, ref_idx, cur_slice, kind)
        mv = mvp + np.asarray(mvd, np.int32)
        m.mv[by:by + h4, bx:bx + w4] = mv
        m.ref[by:by + h4, bx:bx + w4] = ref_idx
        m.done[by:by + h4, bx:bx + w4] = 1
        s.partitions.append(InterPartition(by, bx, w4, h4, ref_idx, mv))

    if mb_type == P_16x16:
        ref = read_te(r, num_ref - 1) if num_ref > 1 else 0
        mvd = (r.se(), r.se())
        put_partition(by0, bx0, 4, 4, ref, mvd, "other")
    elif mb_type == P_16x8:
        refs = [read_te(r, num_ref - 1) if num_ref > 1 else 0 for _ in range(2)]
        mvds = [(r.se(), r.se()) for _ in range(2)]
        put_partition(by0, bx0, 4, 2, refs[0], mvds[0], "16x8_top")
        put_partition(by0 + 2, bx0, 4, 2, refs[1], mvds[1], "16x8_bot")
    elif mb_type == P_8x16:
        refs = [read_te(r, num_ref - 1) if num_ref > 1 else 0 for _ in range(2)]
        mvds = [(r.se(), r.se()) for _ in range(2)]
        put_partition(by0, bx0, 2, 4, refs[0], mvds[0], "8x16_left")
        put_partition(by0, bx0 + 2, 2, 4, refs[1], mvds[1], "8x16_right")
    elif mb_type in (P_8x8, P_8x8REF0):
        s.sub_types = [r.ue() for _ in range(4)]
        if any(t > 3 for t in s.sub_types):
            raise ValueError("bad sub_mb_type")
        if mb_type == P_8x8 and num_ref > 1:
            refs = [read_te(r, num_ref - 1) for _ in range(4)]
        else:
            refs = [0, 0, 0, 0]
        for b8 in range(4):
            n_parts, pw, ph = SUB_SHAPES[s.sub_types[b8]]
            oy = by0 + (b8 // 2) * 2
            ox = bx0 + (b8 % 2) * 2
            for p in range(n_parts):
                if s.sub_types[b8] == 1:      # 8x4: stacked vertically
                    py, px = oy + p * 1, ox
                elif s.sub_types[b8] == 2:    # 4x8: side by side
                    py, px = oy, ox + p * 1
                elif s.sub_types[b8] == 3:    # 4x4 raster
                    py, px = oy + (p // 2), ox + (p % 2)
                else:
                    py, px = oy, ox
                mvd = (r.se(), r.se())
                put_partition(py, px, pw, ph, refs[b8], mvd, "other")
    else:
        raise ValueError(f"bad P mb_type {mb_type}")

    # coded_block_pattern (inter mapping)
    code = r.ue()
    if code > 47:
        raise ValueError("cbp code out of range")
    cbp = int(MB.CBP_INTER_FROM_CODE[code])
    s.cbp_luma = cbp & 15
    s.cbp_chroma = cbp >> 4
    if s.cbp_chroma == 3:
        raise ValueError("invalid cbp_chroma")

    # transform_size_8x8_flag (7.3.5: after cbp, before mb_qp_delta; only
    # when luma is coded and no sub-partition is smaller than 8x8)
    if t8_allowed and s.cbp_luma and (
            mb_type not in (P_8x8, P_8x8REF0)
            or all(t == 0 for t in s.sub_types)):
        if r.flag():
            s.transform8x8 = 1
            g.t8[my, mx] = 1

    if s.cbp_luma or s.cbp_chroma:
        dq = r.se()
        if dq < -26 or dq > 25:
            raise ValueError("mb_qp_delta out of range")
        s.qp = (qp_prev + dq + 52) % 52
    else:
        s.qp = qp_prev
    g.qp[my, mx] = s.qp

    MB._parse_residual(r, g, my, mx, cur_slice, s)
    return s


def apply_skip(g: MB.MBGrids, m: MotionGrids, my: int, mx: int,
               cur_slice: int, qp_prev: int) -> PMBSymbols:
    """P_Skip macroblock: derived motion, no residual."""
    s = PMBSymbols()
    s.mb_class = MB_P
    s.p_type = P_16x16
    s.is_skip = True
    s.qp = qp_prev
    g.mb_class[my, mx] = MB_P
    g.slice_id[my, mx] = cur_slice
    g.qp[my, mx] = qp_prev
    g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
    g.nz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
    g.nz_chroma[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
    mv = pskip_mv(g, m, my, mx, cur_slice)
    m.mv[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = mv
    m.ref[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
    m.done[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 1
    s.partitions.append(InterPartition(my * 4, mx * 4, 4, 4, 0, mv))
    return s


# ---------------------------------------------------------------------------
# B slices (spec 7.3.5.1/7.4.5, 8.4.1.2): mb_type tables, spatial direct,
# CAVLC parse. Capability analog: frameIntervalP B-frames the reference
# configured into NVENC/NVDEC silicon (nv_enc/nv_enc.cpp:527-528,
# nv_dec/nv_dec.cpp:44-52 display callback).
# ---------------------------------------------------------------------------

MB_B = 5           # mb_class id for B-predicted MBs

# Table 7-14: value -> (shape, pred modes per partition); pred in
# {'L0','L1','BI'}; 'direct' and '8x8' handled specially. Shape '16x8' has
# partitions stacked, '8x16' side by side.
B_MB_TABLE = {
    0: ("direct",), 1: ("16x16", "L0"), 2: ("16x16", "L1"),
    3: ("16x16", "BI"),
    4: ("16x8", "L0", "L0"), 5: ("8x16", "L0", "L0"),
    6: ("16x8", "L1", "L1"), 7: ("8x16", "L1", "L1"),
    8: ("16x8", "L0", "L1"), 9: ("8x16", "L0", "L1"),
    10: ("16x8", "L1", "L0"), 11: ("8x16", "L1", "L0"),
    12: ("16x8", "L0", "BI"), 13: ("8x16", "L0", "BI"),
    14: ("16x8", "L1", "BI"), 15: ("8x16", "L1", "BI"),
    16: ("16x8", "BI", "L0"), 17: ("8x16", "BI", "L0"),
    18: ("16x8", "BI", "L1"), 19: ("8x16", "BI", "L1"),
    20: ("16x8", "BI", "BI"), 21: ("8x16", "BI", "BI"),
    22: ("8x8",),
}

# Table 7-18 sub_mb_type for B: value -> ((w4, h4), pred) or ('direct',)
B_SUB_TABLE = {
    0: ("direct",),
    1: ((2, 2), "L0"), 2: ((2, 2), "L1"), 3: ((2, 2), "BI"),
    4: ((2, 1), "L0"), 5: ((1, 2), "L0"),
    6: ((2, 1), "L1"), 7: ((1, 2), "L1"),
    8: ((2, 1), "BI"), 9: ((1, 2), "BI"),
    10: ((1, 1), "L0"), 11: ((1, 1), "L1"), 12: ((1, 1), "BI"),
}


@dataclass
class BMBSymbols(PMBSymbols):
    b_type: int = 0
    is_direct: bool = False


@dataclass
class DirectCtx:
    """Everything B direct-mode derivation needs about the colocated picture
    (RefPicList1[0]) and the current ref lists."""
    spatial: bool
    col_motion: Optional[tuple]      # (ref0, mv0, ref1, mv1) grids or None
    col_refpic: Optional[tuple]      # (refpic0, refpic1) POC-id grids
    col_intra_refpoc: int            # POC of colPic's own RefPicList0[0]
    cur_poc: int
    l0_pocs: np.ndarray              # POC per current list-0 index
    l1_pocs: np.ndarray
    col_is_short: bool = True


def _min_positive(a: int, b: int) -> int:
    if a >= 0 and b >= 0:
        return min(a, b)
    return max(a, b)


def spatial_direct(g: MB.MBGrids, m: MotionGrids, my: int, mx: int,
                   cur_slice: int, ctx: DirectCtx):
    """Spatial direct-mode derivation for one MB (8.4.1.2.2-.3). Returns
    (ref0, ref1, mv0, mv1, zero8) — MB-level predictors + per-8x8 colZero
    flags (direct_8x8_inference_flag == 1, as all frame-coded streams)."""
    by, bx = my * 4, mx * 4
    refs = [-1, -1]
    for lst in (0, 1):
        v = m.lst(lst)
        _, ra, aa = _neighbor(g, v, by, bx - 1, cur_slice)
        _, rb, ab = _neighbor(g, v, by - 1, bx, cur_slice)
        mvC, rc, ac = _neighbor(g, v, by - 1, bx + 4, cur_slice)
        if not ac:
            _, rc, ac = _neighbor(g, v, by - 1, bx - 1, cur_slice)
        refs[lst] = _min_positive(_min_positive(ra, rb), rc)
    ref0, ref1 = refs
    if ref0 < 0 and ref1 < 0:        # directZeroPredictionFlag
        return 0, 0, np.zeros(2, np.int32), np.zeros(2, np.int32), \
            np.ones((2, 2), bool)
    mv0 = predict_mv(g, m.lst(0), by, bx, 4, 4, ref0, cur_slice) \
        if ref0 >= 0 else np.zeros(2, np.int32)
    mv1 = predict_mv(g, m.lst(1), by, bx, 4, 4, ref1, cur_slice) \
        if ref1 >= 0 else np.zeros(2, np.int32)

    zero8 = np.zeros((2, 2), bool)
    if ctx.col_motion is not None and ctx.col_is_short:
        cref0, cmv0, cref1, cmv1 = ctx.col_motion
        for j in range(2):
            for i in range(2):
                # direct_8x8_inference: corner 4x4 of each 8x8
                cy = by + (3 if j else 0)
                cx = bx + (3 if i else 0)
                cr = int(cref0[cy, cx])
                cmv = cmv0[cy, cx]
                if cr < 0:
                    cr = int(cref1[cy, cx])
                    cmv = cmv1[cy, cx]
                if cr == 0 and abs(int(cmv[0])) <= 1 and abs(int(cmv[1])) <= 1:
                    zero8[j, i] = True
    return ref0, ref1, mv0, mv1, zero8


def _cdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _temporal_8x8(ctx: DirectCtx, cy: int, cx: int):
    """Temporal direct for one 8x8 (corner cell (cy,cx), 8.4.1.2.3).
    Returns (ref0, ref1, mv0, mv1)."""
    cr = -1
    cmv = np.zeros(2, np.int32)
    crp = None
    if ctx.col_motion is not None:
        cref0, cmv0, cref1, cmv1 = ctx.col_motion
        rp0, rp1 = ctx.col_refpic
        cr = int(cref0[cy, cx])
        if cr >= 0:
            cmv = cmv0[cy, cx]
            crp = int(rp0[cy, cx])
        else:
            cr = int(cref1[cy, cx])
            if cr >= 0:
                cmv = cmv1[cy, cx]
                crp = int(rp1[cy, cx])
    if cr < 0:
        # colocated block intra (or colPic intra-only): refIdxL0 = 0 and
        # mvCol = 0 directly (8.4.1.2.3)
        ref0 = 0
    else:
        matches = np.nonzero(ctx.l0_pocs == crp)[0]
        # not present in the current list 0: decoders default to index 0
        ref0 = int(matches[0]) if len(matches) else 0
    poc0 = int(ctx.l0_pocs[ref0])
    col_poc = int(ctx.l1_pocs[0])
    tb = max(-128, min(127, ctx.cur_poc - poc0))
    td = max(-128, min(127, col_poc - poc0))
    if td == 0 or not ctx.col_is_short:
        mv0 = cmv.astype(np.int32).copy()
        mv1 = np.zeros(2, np.int32)
    else:
        tx = _cdiv(16384 + abs(td) // 2, td)
        dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
        mv0 = np.array([(dsf * int(cmv[0]) + 128) >> 8,
                        (dsf * int(cmv[1]) + 128) >> 8], np.int32)
        mv1 = mv0 - cmv.astype(np.int32)
    return ref0, 0, mv0, mv1


def direct_partitions(g: MB.MBGrids, m: MotionGrids, my: int, mx: int,
                      cur_slice: int, ctx: DirectCtx):
    """Derive the four 8x8 direct partitions: (by, bx, ref0, ref1, mv0, mv1)."""
    out = []
    if ctx.spatial:
        ref0, ref1, mv0, mv1, zero8 = spatial_direct(g, m, my, mx, cur_slice,
                                                     ctx)
        for j in range(2):
            for i in range(2):
                z = zero8[j, i]
                p0 = np.zeros(2, np.int32) if (z and ref0 == 0) else mv0
                p1 = np.zeros(2, np.int32) if (z and ref1 == 0) else mv1
                out.append((my * 4 + j * 2, mx * 4 + i * 2, ref0, ref1,
                            p0, p1))
    else:
        for j in range(2):
            for i in range(2):
                # corner cell of the 8x8 (direct_8x8_inference)
                cy = my * 4 + (3 if j else 0)
                cx = mx * 4 + (3 if i else 0)
                ref0, ref1, mv0, mv1 = _temporal_8x8(ctx, cy, cx)
                out.append((my * 4 + j * 2, mx * 4 + i * 2, ref0, ref1,
                            mv0, mv1))
    return out


def apply_direct(g: MB.MBGrids, m: MotionGrids, my: int, mx: int,
                 cur_slice: int, qp: int, ctx: DirectCtx,
                 skip: bool) -> BMBSymbols:
    """B_Skip / B_Direct_16x16: derive motion, write grids, build the four
    8x8 partitions."""
    s = BMBSymbols()
    s.mb_class = MB_B
    s.is_direct = True
    s.is_skip = skip
    s.qp = qp
    g.mb_class[my, mx] = MB_B
    g.slice_id[my, mx] = cur_slice
    g.qp[my, mx] = qp
    g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
    if skip:
        g.nz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        g.nz_chroma[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
    for (by, bx, ref0, ref1, p_mv0, p_mv1) in direct_partitions(
            g, m, my, mx, cur_slice, ctx):
        put_b_partition(m, by, bx, 2, 2, ref0, p_mv0, ref1, p_mv1,
                        ctx.l0_pocs, ctx.l1_pocs)
        s.partitions.append(InterPartition(
            by, bx, 2, 2, ref0, p_mv0.copy(), ref1,
            p_mv1.copy() if ref1 >= 0 else None))
    return s


def put_b_partition(m: MotionGrids, by, bx, w4, h4, ref0, mv0, ref1, mv1,
                    list0_pocs, list1_pocs) -> None:
    """Write one B partition's motion (both lists) into the grids."""
    sl = (slice(by, by + h4), slice(bx, bx + w4))
    if ref0 >= 0:
        m.mv[sl] = mv0
        m.ref[sl] = ref0
        m.refpic0[sl] = list0_pocs[ref0]
    else:
        m.mv[sl] = 0
        m.ref[sl] = -1
        m.refpic0[sl] = MotionGrids.NO_PIC
    if ref1 >= 0:
        m.mv1[sl] = mv1
        m.ref1[sl] = ref1
        m.refpic1[sl] = list1_pocs[ref1]
    else:
        m.mv1[sl] = 0
        m.ref1[sl] = -1
        m.refpic1[sl] = MotionGrids.NO_PIC
    m.done[sl] = 1


def parse_b_macroblock(r: BitReader, g: MB.MBGrids, m: MotionGrids,
                       my: int, mx: int, cur_slice: int, qp_prev: int,
                       mb_type: int, num_ref0: int, num_ref1: int,
                       direct_ctx: DirectCtx,
                       t8_allowed: bool = False) -> BMBSymbols:
    """Parse one non-skip B macroblock after its mb_type (CAVLC)."""
    if mb_type >= 23:
        s0 = MB.parse_i_macroblock(r, g, my, mx, cur_slice, qp_prev,
                                   mb_type - 23, t8_allowed)
        s = BMBSymbols(**{f: getattr(s0, f)
                          for f in MB.MBSymbols.__dataclass_fields__})
        sl = (slice(my * 4, my * 4 + 4), slice(mx * 4, mx * 4 + 4))
        m.ref[sl] = -1
        m.ref1[sl] = -1
        m.mv[sl] = 0
        m.mv1[sl] = 0
        m.refpic0[sl] = MotionGrids.NO_PIC
        m.refpic1[sl] = MotionGrids.NO_PIC
        m.done[sl] = 1
        return s

    if mb_type == 0:
        s = apply_direct(g, m, my, mx, cur_slice, qp_prev, direct_ctx, False)
        s.b_type = 0
        _parse_b_residual_tail(r, g, m, my, mx, cur_slice, qp_prev, s,
                               t8_allowed, sub8x8_ok=True)
        return s

    s = BMBSymbols()
    s.mb_class = MB_B
    s.b_type = mb_type
    s.qp = qp_prev
    g.mb_class[my, mx] = MB_B
    g.slice_id[my, mx] = cur_slice
    g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
    by0, bx0 = my * 4, mx * 4

    if mb_type == 22:        # B_8x8
        sub = [r.ue() for _ in range(4)]
        if any(t > 12 for t in sub):
            raise ValueError("bad B sub_mb_type")
        s.sub_types = sub
        parts = []           # (by,bx,w4,h4,pred,b8) in decode order
        for b8 in range(4):
            oy = by0 + (b8 // 2) * 2
            ox = bx0 + (b8 % 2) * 2
            if sub[b8] == 0:
                parts.append((oy, ox, 2, 2, "direct", b8))
                continue
            (w4, h4), pred = B_SUB_TABLE[sub[b8]]
            for py in range(0, 2, h4):
                for px in range(0, 2, w4):
                    parts.append((oy + py, ox + px, w4, h4, pred, b8))
        refs0 = {}
        refs1 = {}
        for b8 in range(4):
            if sub[b8] != 0 and B_SUB_TABLE[sub[b8]][1] in ("L0", "BI") \
                    and num_ref0 > 1:
                refs0[b8] = read_te(r, num_ref0 - 1)
        for b8 in range(4):
            if sub[b8] != 0 and B_SUB_TABLE[sub[b8]][1] in ("L1", "BI") \
                    and num_ref1 > 1:
                refs1[b8] = read_te(r, num_ref1 - 1)
        mvds0 = {}
        mvds1 = {}
        for p in parts:
            if p[4] in ("L0", "BI"):
                mvds0[(p[0], p[1])] = (r.se(), r.se())
        for p in parts:
            if p[4] in ("L1", "BI"):
                mvds1[(p[0], p[1])] = (r.se(), r.se())
        _apply_b_partitions(g, m, my, mx, cur_slice, s, parts, refs0, refs1,
                            mvds0, mvds1, direct_ctx)
        sub8_ok = all(t == 0 or B_SUB_TABLE[t][0] == (2, 2) for t in sub)
    else:
        shape = B_MB_TABLE[mb_type]
        preds = shape[1:]
        if shape[0] == "16x16":
            parts = [(by0, bx0, 4, 4, preds[0], None)]
        elif shape[0] == "16x8":
            parts = [(by0, bx0, 4, 2, preds[0], None),
                     (by0 + 2, bx0, 4, 2, preds[1], None)]
        else:
            parts = [(by0, bx0, 2, 4, preds[0], None),
                     (by0, bx0 + 2, 2, 4, preds[1], None)]
        refs0 = {}
        refs1 = {}
        for i, p in enumerate(parts):
            if p[4] in ("L0", "BI") and num_ref0 > 1:
                refs0[i] = read_te(r, num_ref0 - 1)
        for i, p in enumerate(parts):
            if p[4] in ("L1", "BI") and num_ref1 > 1:
                refs1[i] = read_te(r, num_ref1 - 1)
        mvds0 = {}
        mvds1 = {}
        for p in parts:
            if p[4] in ("L0", "BI"):
                mvds0[(p[0], p[1])] = (r.se(), r.se())
        for p in parts:
            if p[4] in ("L1", "BI"):
                mvds1[(p[0], p[1])] = (r.se(), r.se())
        refs0 = {i: refs0.get(i, 0) for i in range(len(parts))}
        refs1 = {i: refs1.get(i, 0) for i in range(len(parts))}
        _apply_b_mb_partitions(g, m, my, mx, cur_slice, s, parts, refs0,
                               refs1, mvds0, mvds1, direct_ctx, mb_type)
        sub8_ok = True

    _parse_b_residual_tail(r, g, m, my, mx, cur_slice, qp_prev, s,
                           t8_allowed, sub8x8_ok=sub8_ok)
    return s


def _b_part_kind(mb_type: int, idx: int) -> str:
    if mb_type in B_MB_TABLE and B_MB_TABLE[mb_type][0] == "16x8":
        return "16x8_top" if idx == 0 else "16x8_bot"
    if mb_type in B_MB_TABLE and B_MB_TABLE[mb_type][0] == "8x16":
        return "8x16_left" if idx == 0 else "8x16_right"
    return "other"


def _apply_b_mb_partitions(g, m, my, mx, cur_slice, s, parts, refs0, refs1,
                           mvds0, mvds1, direct_ctx, mb_type) -> None:
    """MB-level (16x16/16x8/8x16) B partitions: derive both lists per
    partition in partition order (8.4.1 is partition-major; the bitstream's
    list-major element order was already captured in refs*/mvds*)."""
    l0_pocs, l1_pocs = direct_ctx.l0_pocs, direct_ctx.l1_pocs
    for i, (by, bx, w4, h4, pred, _b8) in enumerate(parts):
        kind = _b_part_kind(mb_type, i)
        sl = (slice(by, by + h4), slice(bx, bx + w4))
        f = {}
        for lst, refs, mvds in ((0, refs0, mvds0), (1, refs1, mvds1)):
            use = pred in (("L0", "BI") if lst == 0 else ("L1", "BI"))
            if not use:
                continue
            mvp = predict_mv(g, m.lst(lst), by, bx, w4, h4, refs[i],
                             cur_slice, kind)
            mv = mvp + np.asarray(mvds[(by, bx)], np.int32)
            if lst == 0:
                m.mv[sl] = mv
                m.ref[sl] = refs[i]
                m.refpic0[sl] = l0_pocs[refs[i]]
            else:
                m.mv1[sl] = mv
                m.ref1[sl] = refs[i]
                m.refpic1[sl] = l1_pocs[refs[i]]
            f[lst] = (refs[i], mv)
        r0, mv0 = f.get(0, (-1, np.zeros(2, np.int32)))
        r1, mv1 = f.get(1, (-1, None))
        if 0 not in f:
            m.ref[sl] = -1
            m.refpic0[sl] = MotionGrids.NO_PIC
        if 1 not in f:
            m.ref1[sl] = -1
            m.refpic1[sl] = MotionGrids.NO_PIC
        m.done[sl] = 1
        s.partitions.append(InterPartition(by, bx, w4, h4, r0, mv0, r1, mv1))


def _apply_b_partitions(g, m, my, mx, cur_slice, s, parts, refs0, refs1,
                        mvds0, mvds1, direct_ctx) -> None:
    """B_8x8 sub-partitions (incl. per-8x8 direct)."""
    l0_pocs, l1_pocs = direct_ctx.l0_pocs, direct_ctx.l1_pocs
    direct = None
    for (by, bx, w4, h4, pred, b8) in parts:
        if pred == "direct":
            if direct is None:
                direct = {(p[0], p[1]): p for p in direct_partitions(
                    g, m, my, mx, cur_slice, direct_ctx)}
            _, _, ref0, ref1, p0, p1 = direct[(by, bx)]
            put_b_partition(m, by, bx, 2, 2, ref0, p0, ref1, p1,
                            l0_pocs, l1_pocs)
            s.partitions.append(InterPartition(
                by, bx, 2, 2, ref0, p0.copy(), ref1,
                p1.copy() if ref1 >= 0 else None))
            continue
        f = {}
        for lst, refs, mvds in ((0, refs0, mvds0), (1, refs1, mvds1)):
            use = pred in (("L0", "BI") if lst == 0 else ("L1", "BI"))
            if not use:
                continue
            ref = refs.get(b8, 0)
            mvp = predict_mv(g, m.lst(lst), by, bx, w4, h4, ref, cur_slice,
                             "other")
            mv = mvp + np.asarray(mvds[(by, bx)], np.int32)
            sl = (slice(by, by + h4), slice(bx, bx + w4))
            if lst == 0:
                m.mv[sl] = mv
                m.ref[sl] = ref
                m.refpic0[sl] = l0_pocs[ref]
            else:
                m.mv1[sl] = mv
                m.ref1[sl] = ref
                m.refpic1[sl] = l1_pocs[ref]
            m.done[sl] = 1
            f[lst] = (ref, mv)
        r0, mv0 = f.get(0, (-1, np.zeros(2, np.int32)))
        r1, mv1 = f.get(1, (-1, None))
        sl = (slice(by, by + h4), slice(bx, bx + w4))
        if 0 not in f:
            m.ref[sl] = -1
            m.refpic0[sl] = MotionGrids.NO_PIC
        if 1 not in f:
            m.ref1[sl] = -1
            m.refpic1[sl] = MotionGrids.NO_PIC
        m.done[sl] = 1
        s.partitions.append(InterPartition(by, bx, w4, h4, r0, mv0, r1, mv1))


def _parse_b_residual_tail(r, g, m, my, mx, cur_slice, qp_prev, s,
                           t8_allowed, sub8x8_ok) -> None:
    """cbp + optional transform flag + qp delta + residual for B MBs."""
    code = r.ue()
    if code > 47:
        raise ValueError("cbp code out of range")
    cbp = int(MB.CBP_INTER_FROM_CODE[code])
    s.cbp_luma = cbp & 15
    s.cbp_chroma = cbp >> 4
    if s.cbp_chroma == 3:
        raise ValueError("invalid cbp_chroma")
    if t8_allowed and s.cbp_luma and sub8x8_ok and not s.is_direct:
        if r.flag():
            s.transform8x8 = 1
            g.t8[my, mx] = 1
    elif t8_allowed and s.cbp_luma and s.is_direct:
        # B_Direct_16x16: flag present only when direct_8x8_inference (all
        # partitions then count as 8x8)
        if r.flag():
            s.transform8x8 = 1
            g.t8[my, mx] = 1
    if s.cbp_luma or s.cbp_chroma:
        dq = r.se()
        if dq < -26 or dq > 25:
            raise ValueError("mb_qp_delta out of range")
        s.qp = (qp_prev + dq + 52) % 52
    else:
        s.qp = qp_prev
    g.qp[my, mx] = s.qp
    MB._parse_residual(r, g, my, mx, cur_slice, s)
