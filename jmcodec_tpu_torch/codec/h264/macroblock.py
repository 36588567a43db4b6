"""H.264 macroblock-layer syntax (spec 7.3.5, 7.4.5): the parse, plus the
per-frame neighbor bookkeeping (nC prediction, intra-mode prediction) of the
host decoder.

Intra macroblocks here; inter.py extends it with the inter MB types. The
device path reads the block scan tables (BLK_X, BLK_Y,
TR_UNAVAILABLE_IN_MB).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ...utils.bits import BitReader
from . import cavlc

# Macroblock classes (internal enum, not bitstream values)
MB_I4x4 = 0
MB_I16x16 = 1
MB_IPCM = 2

# Table 9-4: codeNum <-> coded_block_pattern for me(v). Column ChromaArrayType
# 1..2. Values are permutations of 0..47 (validated below).
CBP_INTRA_FROM_CODE = np.array([
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41,
], dtype=np.int32)

CBP_INTER_FROM_CODE = np.array([
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
], dtype=np.int32)

for _t in (CBP_INTRA_FROM_CODE, CBP_INTER_FROM_CODE):
    assert sorted(_t.tolist()) == list(range(48)), "Table 9-4 transcription bug"


# 4x4 luma block decode order within an MB: 8x8 quadrant raster, then 4x4
# raster inside the quadrant. BLK_X/BLK_Y give pixel offsets per blkIdx.
BLK_X = np.array([(((i >> 2) & 1) << 3) + ((i & 1) << 2) for i in range(16)],
                 dtype=np.int32)
BLK_Y = np.array([((i >> 3) << 3) + (((i & 3) >> 1) << 2) for i in range(16)],
                 dtype=np.int32)
# inverse: blkIdx at 4x4 grid position (bx, by) in 0..3
BLK_IDX = np.zeros((4, 4), np.int32)  # [by, bx]
for _i in range(16):
    BLK_IDX[BLK_Y[_i] // 4, BLK_X[_i] // 4] = _i

# blkIdx whose top-right 4x4 neighbor is not yet decoded within the MB
# (derived from the decode order; spec neighbour availability process 6.4.11)
TR_UNAVAILABLE_IN_MB = frozenset({3, 7, 11, 13, 15})

# chroma 4x4 block order within the 8x8 plane: raster
CBLK_X = np.array([0, 4, 0, 4], dtype=np.int32)
CBLK_Y = np.array([0, 0, 4, 4], dtype=np.int32)


def i16_mb_type(pred_mode: int, cbp_luma: int, cbp_chroma: int) -> int:
    """mb_type value 1..24 for I_16x16 (Table 7-11)."""
    return 1 + pred_mode + 4 * cbp_chroma + (12 if cbp_luma else 0)


def parse_i16_mb_type(mb_type: int):
    """Inverse of i16_mb_type; mb_type in 1..24."""
    t = mb_type - 1
    cbp_luma = 15 if t >= 12 else 0
    t %= 12
    return t % 4, cbp_luma, t // 4  # pred_mode, cbp_luma, cbp_chroma


@dataclass
class MBGrids:
    """Per-frame neighbor state for entropy coding + intra mode prediction.

    All grids are indexed [row, col] in their own units. ``slice_id`` gates
    availability (neighbors in a different slice are unavailable for intra
    prediction and nC derivation)."""

    mb_width: int
    mb_height: int
    # per 4x4 luma block: TotalCoeff for nC; -1 = not yet decoded
    nz_luma: np.ndarray = field(default=None)
    # per chroma component, per 4x4 chroma block
    nz_chroma: np.ndarray = field(default=None)
    # per 4x4 luma block: intra4x4/8x8 mode (8x8 modes replicated into the
    # four covered cells, which makes cross-type mode prediction correct
    # both ways per 8.3.2.1/8.3.2.2); -1 if not intra-NxN
    i4_modes: np.ndarray = field(default=None)
    mb_class: np.ndarray = field(default=None)   # -1 undecoded / MB_* enum
    slice_id: np.ndarray = field(default=None)
    qp: np.ndarray = field(default=None)
    t8: np.ndarray = field(default=None)         # per-MB transform 8x8 flag

    def __post_init__(self):
        mw, mh = self.mb_width, self.mb_height
        self.nz_luma = np.full((mh * 4, mw * 4), -1, np.int32)
        self.nz_chroma = np.full((2, mh * 2, mw * 2), -1, np.int32)
        self.i4_modes = np.full((mh * 4, mw * 4), -1, np.int32)
        self.mb_class = np.full((mh, mw), -1, np.int32)
        self.slice_id = np.full((mh, mw), -1, np.int32)
        self.qp = np.zeros((mh, mw), np.int32)
        self.t8 = np.zeros((mh, mw), np.int32)  # transform_size_8x8_flag

    # ---- macroblock availability (spec 6.4.9) ----

    def mb_available(self, my: int, mx: int, cur_slice: int) -> bool:
        if mx < 0 or my < 0 or mx >= self.mb_width or my >= self.mb_height:
            return False
        return (self.mb_class[my, mx] >= 0
                and self.slice_id[my, mx] == cur_slice)

    # ---- nC derivation (spec 9.2.1) ----

    def luma_nc(self, by: int, bx: int, cur_slice: int) -> int:
        """nC for luma 4x4 block at grid (by, bx)."""
        na = self._blk_nz(self.nz_luma, by, bx - 1, cur_slice, 4)
        nb = self._blk_nz(self.nz_luma, by - 1, bx, cur_slice, 4)
        return self._combine_nc(na, nb)

    def chroma_nc(self, comp: int, by: int, bx: int, cur_slice: int) -> int:
        na = self._blk_nz(self.nz_chroma[comp], by, bx - 1, cur_slice, 2)
        nb = self._blk_nz(self.nz_chroma[comp], by - 1, bx, cur_slice, 2)
        return self._combine_nc(na, nb)

    def _blk_nz(self, grid, by, bx, cur_slice, blocks_per_mb) -> Optional[int]:
        if bx < 0 or by < 0 or bx >= grid.shape[1] or by >= grid.shape[0]:
            return None
        my, mx = by // blocks_per_mb, bx // blocks_per_mb
        if self.slice_id[my, mx] != cur_slice or self.mb_class[my, mx] < 0:
            return None
        v = grid[by, bx]
        return None if v < 0 else int(v)

    @staticmethod
    def _combine_nc(na: Optional[int], nb: Optional[int]) -> int:
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    # ---- intra 4x4 mode prediction (spec 8.3.1.1) ----

    def predict_i4_mode(self, by: int, bx: int, cur_slice: int) -> int:
        # spec 8.3.1.1.1: if EITHER neighbor block's MB is unavailable, the
        # predicted mode is DC outright (dcPredModePredictedFlag); only when
        # both are available does Min(modeA, modeB) apply, with non-I4x4
        # neighbors contributing DC.
        ma = self._i4_mode_at(by, bx - 1, cur_slice)
        mb = self._i4_mode_at(by - 1, bx, cur_slice)
        if ma is None or mb is None:
            return 2
        return min(ma, mb)

    def _i4_mode_at(self, by, bx, cur_slice) -> Optional[int]:
        """Neighbor block's mode; None if its MB is unavailable, DC(2) if it
        is available but not Intra_4x4-coded."""
        if bx < 0 or by < 0 or bx >= self.i4_modes.shape[1] \
                or by >= self.i4_modes.shape[0]:
            return None
        my, mx = by // 4, bx // 4
        if self.slice_id[my, mx] != cur_slice or self.mb_class[my, mx] < 0:
            return None
        m = self.i4_modes[by, bx]
        return 2 if m < 0 else int(m)  # non-I4x4 intra MB -> DC


@dataclass
class MBSymbols:
    """Decoded symbols of one intra macroblock."""
    mb_class: int = MB_I4x4
    i4_modes: List[int] = field(default_factory=lambda: [0] * 16)  # blkIdx order
    i16_mode: int = 0
    chroma_mode: int = 0
    cbp_luma: int = 0      # 4 bits, one per 8x8 quadrant
    cbp_chroma: int = 0    # 0/1/2
    qp: int = 26
    # High profile 8x8 transform (luma residual as 4 x 64 scan-order lists)
    transform8x8: int = 0
    i8_modes: List[int] = field(default_factory=lambda: [0] * 4)
    luma8x8: List[List[int]] = field(
        default_factory=lambda: [[0] * 64 for _ in range(4)])
    # coefficients in SCAN order (zigzag), as produced/consumed by CAVLC:
    luma_dc: List[int] = field(default_factory=lambda: [0] * 16)   # I16 only
    luma_ac: List[List[int]] = field(default_factory=lambda: [[0] * 16 for _ in range(16)])
    chroma_dc: List[List[int]] = field(default_factory=lambda: [[0] * 4 for _ in range(2)])
    chroma_ac: List[List[List[int]]] = field(
        default_factory=lambda: [[[0] * 15 for _ in range(4)] for _ in range(2)])
    pcm_luma: Optional[bytes] = None
    pcm_chroma: Optional[bytes] = None


def parse_i_macroblock(r: BitReader, g: MBGrids, my: int, mx: int,
                       cur_slice: int, qp_prev: int, mb_type: int,
                       t8_allowed: bool = False) -> MBSymbols:
    """Parse one I-slice macroblock (after its mb_type ue). Updates grids.
    t8_allowed = pps.transform_8x8_mode_flag (High profile)."""
    s = MBSymbols()
    if mb_type == 25:
        return _parse_ipcm(r, g, my, mx, cur_slice, qp_prev, s)
    if mb_type == 0:
        s.mb_class = MB_I4x4
        # mark early: within-MB neighbor lookups (mode prediction, nC) must
        # see this MB as present in the current slice
        g.mb_class[my, mx] = s.mb_class
        g.slice_id[my, mx] = cur_slice
        if t8_allowed and r.flag():
            s.transform8x8 = 1
            g.t8[my, mx] = 1
        n_pred = 4 if s.transform8x8 else 16
        pred_modes = []
        for i in range(n_pred):
            if r.flag():
                pred_modes.append(None)  # use predicted
            else:
                pred_modes.append(r.u(3))
        s.chroma_mode = r.ue()
        if s.chroma_mode > 3:
            raise ValueError("intra_chroma_pred_mode > 3")
        code = r.ue()
        if code > 47:
            raise ValueError("cbp code out of range")
        cbp = int(CBP_INTRA_FROM_CODE[code])
        s.cbp_luma = cbp & 15
        s.cbp_chroma = cbp >> 4
        if s.cbp_chroma == 3:
            raise ValueError("invalid cbp_chroma 3")
        if s.transform8x8:
            # resolve 8x8 modes (pred via the replicated 4x4 mode grid —
            # the top-left covered cell's neighbors are the spec's A/B)
            for b8 in range(4):
                by = my * 4 + (b8 >> 1) * 2
                bx = mx * 4 + (b8 & 1) * 2
                pred = g.predict_i4_mode(by, bx, cur_slice)
                rem = pred_modes[b8]
                mode = pred if rem is None else (
                    rem + 1 if rem >= pred else rem)
                s.i8_modes[b8] = mode
                g.i4_modes[by:by + 2, bx:bx + 2] = mode
        else:
            # resolve i4 modes in blk order (needs grid updates as we go)
            for i in range(16):
                by = my * 4 + int(BLK_Y[i]) // 4
                bx = mx * 4 + int(BLK_X[i]) // 4
                pred = g.predict_i4_mode(by, bx, cur_slice)
                rem = pred_modes[i]
                if rem is None:
                    mode = pred
                else:
                    mode = rem + 1 if rem >= pred else rem
                s.i4_modes[i] = mode
                g.i4_modes[by, bx] = mode
    elif 1 <= mb_type <= 24:
        s.mb_class = MB_I16x16
        s.i16_mode, s.cbp_luma, s.cbp_chroma = parse_i16_mb_type(mb_type)
        g.mb_class[my, mx] = s.mb_class
        g.slice_id[my, mx] = cur_slice
        s.chroma_mode = r.ue()
        if s.chroma_mode > 3:
            raise ValueError("intra_chroma_pred_mode > 3")
    else:
        raise ValueError(f"bad I mb_type {mb_type}")

    if s.cbp_luma or s.cbp_chroma or s.mb_class == MB_I16x16:
        dq = r.se()
        if dq < -26 or dq > 25:
            raise ValueError("mb_qp_delta out of range")
        s.qp = (qp_prev + dq + 52) % 52
    else:
        s.qp = qp_prev
    g.qp[my, mx] = s.qp

    _parse_residual(r, g, my, mx, cur_slice, s)
    return s


def _parse_ipcm(r, g, my, mx, cur_slice, qp_prev, s: MBSymbols) -> MBSymbols:
    s.mb_class = MB_IPCM
    while not r.byte_aligned():
        if r.u(1) != 0:
            raise ValueError("pcm_alignment_zero_bit not zero")
    s.pcm_luma = bytes(r.u(8) for _ in range(256))
    s.pcm_chroma = bytes(r.u(8) for _ in range(128))
    s.qp = qp_prev  # QPy unchanged by PCM (prev QP carried)
    g.mb_class[my, mx] = MB_IPCM
    g.slice_id[my, mx] = cur_slice
    g.qp[my, mx] = s.qp
    # PCM blocks count as 16 coefficients for nC purposes (spec 9.2.1)
    g.nz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 16
    g.nz_chroma[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
    return s


def _parse_residual(r, g, my, mx, cur_slice, s: MBSymbols) -> None:
    # luma DC for I16x16
    if s.mb_class == MB_I16x16:
        nc = g.luma_nc(my * 4, mx * 4, cur_slice)
        s.luma_dc, _ = cavlc.decode_residual_block(r, nc, 16)
    if s.transform8x8:
        # CAVLC 8x8 (7.3.5.3.2): each coded 8x8 block is sent as 4
        # interleaved 4x4 CAVLC blocks; 8x8 scan position 4*k + sub comes
        # from sub-block `sub` scan position k. Each sub-block keeps its own
        # TotalCoeff for nC prediction.
        for i8 in range(4):
            if s.cbp_luma & (1 << i8):
                for sub in range(4):
                    blk = i8 * 4 + sub
                    by = my * 4 + int(BLK_Y[blk]) // 4
                    bx = mx * 4 + int(BLK_X[blk]) // 4
                    nc = g.luma_nc(by, bx, cur_slice)
                    coeffs, tc = cavlc.decode_residual_block(r, nc, 16)
                    for k in range(16):
                        s.luma8x8[i8][4 * k + sub] = coeffs[k]
                    g.nz_luma[by, bx] = tc
            else:
                for sub in range(4):
                    blk = i8 * 4 + sub
                    by = my * 4 + int(BLK_Y[blk]) // 4
                    bx = mx * 4 + int(BLK_X[blk]) // 4
                    g.nz_luma[by, bx] = 0
        _parse_residual_chroma(r, g, my, mx, cur_slice, s)
        return
    # luma 4x4 (AC for I16, full for I4)
    n_ac = 15 if s.mb_class == MB_I16x16 else 16
    for i in range(16):
        by = my * 4 + int(BLK_Y[i]) // 4
        bx = mx * 4 + int(BLK_X[i]) // 4
        if s.cbp_luma & (1 << (i >> 2)):
            nc = g.luma_nc(by, bx, cur_slice)
            coeffs, tc = cavlc.decode_residual_block(r, nc, n_ac)
            s.luma_ac[i][:n_ac] = coeffs
            g.nz_luma[by, bx] = tc
        else:
            s.luma_ac[i] = [0] * 16
            g.nz_luma[by, bx] = 0
    _parse_residual_chroma(r, g, my, mx, cur_slice, s)


def _parse_residual_chroma(r, g, my, mx, cur_slice, s: MBSymbols) -> None:
    # chroma DC
    if s.cbp_chroma:
        for comp in range(2):
            s.chroma_dc[comp], _ = cavlc.decode_residual_block(r, -1, 4)
    # chroma AC
    for comp in range(2):
        for i in range(4):
            by = my * 2 + int(CBLK_Y[i]) // 4
            bx = mx * 2 + int(CBLK_X[i]) // 4
            if s.cbp_chroma == 2:
                nc = g.chroma_nc(comp, by, bx, cur_slice)
                coeffs, tc = cavlc.decode_residual_block(r, nc, 15)
                s.chroma_ac[comp][i] = coeffs
                g.nz_chroma[comp, by, bx] = tc
            else:
                s.chroma_ac[comp][i] = [0] * 15
                g.nz_chroma[comp, by, bx] = 0
