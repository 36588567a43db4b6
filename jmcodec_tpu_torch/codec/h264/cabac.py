"""H.264 CABAC entropy decoding (spec 9.3): arithmetic engine + syntax layer.

The Python path of the host decoder (refdec.py); the C++ parser in
native/src mirrors it for the device path's front end.

Tables come from cabac_tables.py (spec constants recovered from two
independent system codec libraries, cross-validated — see
native/gen_cabac_tables.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import macroblock as MB
from .cabac_tables import (CTX_INIT, LAST_COEFF_8X8, LPS_RANGE, SIG_COEFF_8X8,
                           TRANS_IDX_LPS, TRANS_IDX_MPS)

# Python-int copies for the hot loops (numpy scalar indexing is slow)
_LPS = [int(v) for v in LPS_RANGE.reshape(-1)]          # [state*4 + qIdx]
_TMPS = [int(v) for v in TRANS_IDX_MPS]
_TLPS = [int(v) for v in TRANS_IDX_LPS]
_SIG8 = [int(v) for v in SIG_COEFF_8X8]
_LAST8 = [int(v) for v in LAST_COEFF_8X8]

# residual ctx bases per ctxBlockCat (0 LumaDC, 1 LumaAC, 2 Luma4x4,
# 3 ChromaDC, 4 ChromaAC, 5 Luma8x8)
CBF_BASE = {0: 85, 1: 89, 2: 93, 3: 97, 4: 101}
SIG_BASE = {0: 105, 1: 120, 2: 134, 3: 149, 4: 152, 5: 402}
LAST_BASE = {0: 166, 1: 181, 2: 195, 3: 210, 4: 213, 5: 417}
ABS_BASE = {0: 227, 1: 237, 2: 247, 3: 257, 4: 266, 5: 426}


class CabacEngine:
    """Arithmetic decoding engine (spec 9.3.3.2), bit-sequential model: every
    consumed bit advances self.pos, so the rbsp position is exact at any bin
    (needed for I_PCM byte alignment and engine re-init, spec 9.3.1)."""

    __slots__ = ("data", "pos", "range", "offset", "state", "mps")

    def __init__(self, data: bytes, bit_pos: int, slice_qp: int,
                 table_idx: int):
        init = CTX_INIT[table_idx].astype(np.int32)
        qp = max(0, min(51, slice_qp))
        pre = np.clip(((init[:, 0] * qp) >> 4) + init[:, 1], 1, 126)
        mps = pre > 63
        state = np.where(mps, pre - 64, 63 - pre)
        self.state = [int(v) for v in state]
        self.mps = [int(v) for v in mps]
        self.data = data
        # cabac_alignment_one_bit: skip to the next byte boundary
        self.pos = ((bit_pos + 7) // 8) * 8
        self._engine_init()

    def _engine_init(self):
        """codIRange/codIOffset init (9.3.1.2); contexts untouched (used at
        slice start and after I_PCM samples)."""
        self.range = 510
        self.offset = self._bits(9)

    def _bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        i = p >> 3
        if i >= len(self.data):
            return 0
        return (self.data[i] >> (7 - (p & 7))) & 1

    def _bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self._bit()
        return v

    def decode(self, ctx: int) -> int:
        s = self.state[ctx]
        rng = self.range
        lps = _LPS[(s << 2) | ((rng >> 6) & 3)]
        rng -= lps
        if self.offset >= rng:
            b = 1 - self.mps[ctx]
            self.offset -= rng
            rng = lps
            if s == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = _TLPS[s]
        else:
            b = self.mps[ctx]
            self.state[ctx] = _TMPS[s]
        while rng < 256:
            rng <<= 1
            self.offset = (self.offset << 1) | self._bit()
        self.range = rng
        return b

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        rng = self.range
        while rng < 256:
            rng <<= 1
            self.offset = (self.offset << 1) | self._bit()
        self.range = rng
        return 0

    def eg_bypass(self, k: int) -> int:
        """k-th order Exp-Golomb suffix via bypass bins (9.3.2.3)."""
        v = 0
        while self.bypass():
            v += 1 << k
            k += 1
            if k > 30:
                raise ValueError("EGk runaway")
        while k:
            k -= 1
            v += self.bypass() << k
        return v


class CabacMBState:
    """Per-picture neighbor state the CABAC context models read (beyond what
    MBGrids already tracks for CAVLC/intra prediction)."""

    def __init__(self, mbw: int, mbh: int):
        z = lambda *s: np.zeros(s, np.int32)
        self.skip = z(mbh, mbw)
        self.t8 = z(mbh, mbw)               # transform_size_8x8_flag
        self.cbp_luma = z(mbh, mbw)         # derived (PCM=15)
        self.cbp_chroma = z(mbh, mbw)       # derived (PCM=2)
        self.chroma_mode = z(mbh, mbw)
        self.is_intra = z(mbh, mbw)
        self.direct16 = z(mbh, mbw)   # B_Skip / B_Direct_16x16
        self.direct_blk = z(mbh * 4, mbw * 4)  # per-4x4 direct-coded flag
        self.cbf_dc = z(mbh, mbw)           # luma DC (I16 only; PCM=1)
        self.cbf_luma = z(mbh * 4, mbw * 4)  # per 4x4 (8x8 MBs replicate)
        self.cbf_cdc = z(2, mbh, mbw)
        self.cbf_cac = z(2, mbh * 2, mbw * 2)
        self.mvd = z(2, mbh * 4, mbw * 4, 2)  # [list][by][bx][dx,dy]


class CabacSliceDecoder:
    """Slice-data parser: decodes one slice's macroblock layer, producing the
    same MBSymbols/PMBSymbols stream as the CAVLC parser so reconstruction
    and symbol-plane filling are shared."""

    def __init__(self, rbsp: bytes, bit_pos: int, hdr, sps, pps, g, m,
                 cs: CabacMBState, bctx=None):
        from .slicehdr import SLICE_I
        table = 0 if hdr.slice_type == SLICE_I else 1 + hdr.cabac_init_idc
        self.bctx = bctx
        self.e = CabacEngine(rbsp, bit_pos, hdr.qp(pps), table)
        self.hdr = hdr
        self.sps = sps
        self.pps = pps
        self.g = g
        self.m = m
        self.cs = cs
        self.qp = hdr.qp(pps)
        self.prev_dqp_nz = 0
        self.num_ref = hdr.num_ref_idx_active_l0

    # ---- neighbor helpers ----

    def _mb_avail(self, my, mx, cur_slice) -> bool:
        return self.g.mb_available(my, mx, cur_slice)

    def _prop(self, grid, my, mx, cur_slice, default=0):
        if not self._mb_avail(my, mx, cur_slice):
            return default
        return int(grid[my, mx])

    # ---- macroblock-level syntax elements ----

    def mb_skip_flag(self, my, mx, cur_slice, base=11) -> int:
        cs = self.cs
        inc = 0
        if self._mb_avail(my, mx - 1, cur_slice) and not cs.skip[my, mx - 1]:
            inc += 1
        if self._mb_avail(my - 1, mx, cur_slice) and not cs.skip[my - 1, mx]:
            inc += 1
        return self.e.decode(base + inc)

    def _intra_mbtype_tail(self, ctxs) -> int:
        """Bins after the leading '1' + terminate of an intra mb_type.
        ctxs = (cbp_luma, chroma_b0, chroma_b1, pred_b0, pred_b1) contexts —
        element-fixed per 9.3.3.1.2 (the pred bins keep their own ctx even
        when the chroma_b1 bin is absent). Returns mb_type 1..24."""
        e = self.e
        cbp_l = 15 if e.decode(ctxs[0]) else 0
        cbp_c = 0
        if e.decode(ctxs[1]):
            cbp_c = 2 if e.decode(ctxs[2]) else 1
        p0 = e.decode(ctxs[3])
        p1 = e.decode(ctxs[4])
        return MB.i16_mb_type(2 * p0 + p1, cbp_l, cbp_c)

    def i_mbtype(self, my, mx, cur_slice) -> int:
        """mb_type in I slices (ctx 3..10, Table 9-39 positional)."""
        cs = self.cs
        inc = 0
        for (ny, nx) in ((my, mx - 1), (my - 1, mx)):
            if self._mb_avail(ny, nx, cur_slice):
                # condTerm = 1 unless neighbor is I_NxN (I4x4 here)
                if not (cs.is_intra[ny, nx]
                        and self.g.mb_class[ny, nx] == MB.MB_I4x4):
                    inc += 1
        if not self.e.decode(3 + inc):
            return 0
        if self.e.terminate():
            return 25
        return self._intra_mbtype_tail((6, 7, 8, 9, 10))

    def p_mbtype(self) -> int:
        """mb_type in P slices (ctx 14..20)."""
        e = self.e
        if e.decode(14):
            # intra suffix, ctx base 17, positional map {0,·,1,2,2,3,3}
            if not e.decode(17):
                return 5 + 0
            if e.terminate():
                return 5 + 25
            return 5 + self._intra_mbtype_tail((18, 19, 19, 20, 20))
        if not e.decode(15):
            return 3 * e.decode(16)      # P_L0_16x16 / P_8x8
        return 2 - e.decode(17)          # P_8x16 / P_16x8

    def p_sub_mbtype(self) -> int:
        e = self.e
        if e.decode(21):
            return 0
        if not e.decode(22):
            return 1
        return 2 if e.decode(23) else 3

    def transform_8x8_flag(self, my, mx, cur_slice) -> int:
        inc = self._prop(self.cs.t8, my, mx - 1, cur_slice) + \
            self._prop(self.cs.t8, my - 1, mx, cur_slice)
        return self.e.decode(399 + inc)

    def intra4x4_pred_mode(self, pred: int) -> int:
        e = self.e
        if e.decode(68):
            return pred
        rem = e.decode(69)
        rem += 2 * e.decode(69)
        rem += 4 * e.decode(69)
        return rem + 1 if rem >= pred else rem

    def intra_chroma_pred_mode(self, my, mx, cur_slice) -> int:
        cs = self.cs
        inc = 0
        for (ny, nx) in ((my, mx - 1), (my - 1, mx)):
            if (self._mb_avail(ny, nx, cur_slice)
                    and cs.is_intra[ny, nx]
                    and self.g.mb_class[ny, nx] != MB.MB_IPCM
                    and cs.chroma_mode[ny, nx] != 0):
                inc += 1
        if not self.e.decode(64 + inc):
            return 0
        if not self.e.decode(67):
            return 1
        return 2 + self.e.decode(67)

    def coded_block_pattern(self, my, mx, cur_slice) -> Tuple[int, int]:
        e = self.e
        cs = self.cs
        cbp = 0

        def luma_bit(ny8, nx8):
            """cbp bit of the 8x8 block at global 8x8 coords; -1 if its MB is
            unavailable."""
            if nx8 < 0 or ny8 < 0:
                return -1
            nmy, nmx = ny8 >> 1, nx8 >> 1
            if (nmy, nmx) == (my, mx):
                b8 = (ny8 & 1) * 2 + (nx8 & 1)
                return (cbp >> b8) & 1
            if not self._mb_avail(nmy, nmx, cur_slice):
                return -1
            b8 = (ny8 & 1) * 2 + (nx8 & 1)
            return (int(cs.cbp_luma[nmy, nmx]) >> b8) & 1

        for b8 in range(4):
            y8 = my * 2 + (b8 >> 1)
            x8 = mx * 2 + (b8 & 1)
            a = luma_bit(y8, x8 - 1)
            b = luma_bit(y8 - 1, x8)
            # condTerm = 1 when the neighbour block exists and is NOT coded
            inc = (1 if a == 0 else 0) + 2 * (1 if b == 0 else 0)
            if e.decode(73 + inc):
                cbp |= 1 << b8

        ca = self._prop(cs.cbp_chroma, my, mx - 1, cur_slice)
        cb = self._prop(cs.cbp_chroma, my - 1, mx, cur_slice)
        inc = (1 if ca != 0 else 0) + 2 * (1 if cb != 0 else 0)
        cbp_c = 0
        if e.decode(77 + inc):
            inc = (1 if ca == 2 else 0) + 2 * (1 if cb == 2 else 0)
            cbp_c = 2 if e.decode(81 + inc) else 1
        return cbp, cbp_c

    def mb_qp_delta(self) -> int:
        e = self.e
        if not e.decode(60 + (1 if self.prev_dqp_nz else 0)):
            self.prev_dqp_nz = 0
            return 0
        k = 1
        while e.decode(62 if k == 1 else 63):
            k += 1
            if k > 52:
                raise ValueError("mb_qp_delta unary runaway")
        self.prev_dqp_nz = 1
        return (k + 1) // 2 if (k & 1) else -(k // 2)

    def _ref_cond(self, ny, nx, cur_slice, lst=0) -> int:
        """condTermFlag for the ref_idx ctx (9.3.3.1.1.6): neighbor 4x4
        block's ref > 0 in the same list, reading the ref grid directly —
        within-MB partitions whose ref_idx was just decoded (ref pre-written,
        mv pending) must count."""
        refg = self.m.ref if lst == 0 else self.m.ref1
        if nx < 0 or ny < 0 or nx >= refg.shape[1] or ny >= refg.shape[0]:
            return 0
        nmy, nmx = ny // 4, nx // 4
        if not self._mb_avail(nmy, nmx, cur_slice):
            return 0
        if self.cs.skip[nmy, nmx]:
            return 0
        if self.cs.direct_blk[ny, nx]:
            # direct-coded neighbor blocks never count toward the ref ctx
            return 0
        return 1 if refg[ny, nx] > 0 else 0

    def ref_idx(self, by, bx, cur_slice, lst=0) -> int:
        e = self.e
        inc = self._ref_cond(by, bx - 1, cur_slice, lst) + \
            2 * self._ref_cond(by - 1, bx, cur_slice, lst)
        if not e.decode(54 + inc):
            return 0
        k = 1
        while e.decode(58 if k == 1 else 59):
            k += 1
            if k > 32:
                raise ValueError("ref_idx unary runaway")
        return k

    def _abs_mvd_sum(self, by, bx, comp, cur_slice, lst) -> int:
        """absMvdComp(A) + absMvdComp(B) for the mvd ctx (9.3.3.1.1.7).

        The stored mvd plane is 0 for intra neighbors and unused lists (they
        never write it), so no predFlag gate is needed — and none may be
        used: during a B macroblock's mvd phase the list-1 refs of earlier
        partitions are not applied to the ref grid yet, so a ref-based gate
        would read stale state."""
        total = 0
        mvd = self.cs.mvd
        for (ny, nx) in ((by, bx - 1), (by - 1, bx)):
            if nx < 0 or ny < 0 or nx >= mvd.shape[2] or ny >= mvd.shape[1]:
                continue
            if not self._mb_avail(ny // 4, nx // 4, cur_slice):
                continue
            total += abs(int(mvd[lst, ny, nx, comp]))
        return total

    def mvd(self, by, bx, comp, cur_slice, lst=0) -> int:
        e = self.e
        s = self._abs_mvd_sum(by, bx, comp, cur_slice, lst)
        inc = 0 if s < 3 else (1 if s <= 32 else 2)
        base = 40 if comp == 0 else 47
        if not e.decode(base + inc):
            return 0
        k = 1
        while k < 9 and e.decode(base + min(k + 2, 6)):
            k += 1
        if k == 9:
            k += e.eg_bypass(3)
        return -k if e.bypass() else k

    # ---- residual blocks ----

    def _sig_inc(self, cat, i):
        if cat == 3:
            return min(i, 2)
        if cat == 5:
            return _SIG8[i]
        return i

    def _last_inc(self, cat, i):
        if cat == 3:
            return min(i, 2)
        if cat == 5:
            return _LAST8[i]
        return i

    def residual_block(self, cat: int, n: int,
                       cbf_inc: Optional[int]) -> Tuple[List[int], int]:
        """Decode one residual block (7.3.5.3.3). cbf_inc None => cbf not
        coded (8x8 luma; presence implied by cbp). Returns (scan-order levels
        list of length n, nonzero count)."""
        e = self.e
        if cbf_inc is not None:
            if not e.decode(CBF_BASE[cat] + cbf_inc):
                return [0] * n, 0
        sig_base = SIG_BASE[cat]
        last_base = LAST_BASE[cat]
        pos = []
        done = False
        for i in range(n - 1):
            if e.decode(sig_base + self._sig_inc(cat, i)):
                pos.append(i)
                if e.decode(last_base + self._last_inc(cat, i)):
                    done = True
                    break
        if not done:
            pos.append(n - 1)
        coeffs = [0] * n
        base = ABS_BASE[cat]
        eq1 = 0
        gt1 = 0
        for idx in reversed(pos):
            inc0 = 0 if gt1 else min(4, 1 + eq1)
            if not e.decode(base + inc0):
                level = 1
                eq1 += 1
            else:
                incn = 5 + min(4 - (1 if cat == 3 else 0), gt1)
                m1 = 1
                while m1 < 14 and e.decode(base + incn):
                    m1 += 1
                if m1 == 14:
                    m1 += e.eg_bypass(0)
                level = m1 + 1
                gt1 += 1
            if e.bypass():
                level = -level
            coeffs[idx] = level
        return coeffs, len(pos)

    def _cbf_inc(self, cat, my, mx, blk, comp, cur_slice, cur_intra) -> int:
        """ctxIdxInc for coded_block_flag (9.3.3.1.1.9): condA + 2*condB."""
        cs = self.cs
        g = self.g

        def cond(kind, ny, nx, nmy, nmx):
            # neighbor MB availability
            if nmx < 0 or nmy < 0 or nmx >= g.mb_width or nmy >= g.mb_height \
                    or not self._mb_avail(nmy, nmx, cur_slice):
                return 1 if cur_intra else 0
            if g.mb_class[nmy, nmx] == MB.MB_IPCM:
                return 1
            if kind == "dc":
                return int(cs.cbf_dc[nmy, nmx])
            if kind == "l":
                return int(cs.cbf_luma[ny, nx])
            if kind == "cdc":
                return int(cs.cbf_cdc[comp, nmy, nmx])
            return int(cs.cbf_cac[comp, ny, nx])

        if cat == 0:     # luma DC: neighbor MB's DC block
            a = cond("dc", 0, 0, my, mx - 1)
            b = cond("dc", 0, 0, my - 1, mx)
        elif cat in (1, 2, 5):
            by, bx = blk
            a = cond("l", by, bx - 1, by // 4, (bx - 1) // 4)
            b = cond("l", by - 1, bx, (by - 1) // 4, bx // 4)
        elif cat == 3:   # chroma DC per MB
            a = cond("cdc", 0, 0, my, mx - 1)
            b = cond("cdc", 0, 0, my - 1, mx)
        else:            # chroma AC per 4x4 chroma block
            by, bx = blk
            a = cond("cac", by, bx - 1, by // 2, (bx - 1) // 2)
            b = cond("cac", by - 1, bx, (by - 1) // 2, bx // 2)
        return a + 2 * b

    def parse_residual(self, my, mx, cur_slice, s: MB.MBSymbols) -> None:
        """CABAC twin of macroblock._parse_residual: fills s.* (scan order)
        and the nz/cbf neighbor grids."""
        g = self.g
        cs = self.cs
        cur_intra = s.mb_class not in (3, 5)  # MB_P / MB_B are inter
        if s.mb_class == MB.MB_I16x16:
            inc = self._cbf_inc(0, my, mx, None, None, cur_slice, cur_intra)
            s.luma_dc, ndc = self.residual_block(0, 16, inc)
            cs.cbf_dc[my, mx] = 1 if ndc else 0
        if s.transform8x8:
            # cat5: 64-coeff blocks, no coded_block_flag (presence == cbp
            # bit); replicate cbf/nz into the 4 covered 4x4 cells for
            # neighbor ctx + deblock derivation
            for i8 in range(4):
                by = my * 4 + (i8 >> 1) * 2
                bx = mx * 4 + (i8 & 1) * 2
                cells = (slice(by, by + 2), slice(bx, bx + 2))
                if s.cbp_luma & (1 << i8):
                    coeffs, tc = self.residual_block(5, 64, None)
                    s.luma8x8[i8] = coeffs
                    cs.cbf_luma[cells] = 1
                    g.nz_luma[cells] = tc
                else:
                    cs.cbf_luma[cells] = 0
                    g.nz_luma[cells] = 0
        else:
            n_ac = 15 if s.mb_class == MB.MB_I16x16 else 16
            cat = 1 if s.mb_class == MB.MB_I16x16 else 2
            for i in range(16):
                by = my * 4 + int(MB.BLK_Y[i]) // 4
                bx = mx * 4 + int(MB.BLK_X[i]) // 4
                if s.cbp_luma & (1 << (i >> 2)):
                    inc = self._cbf_inc(cat, my, mx, (by, bx), None,
                                        cur_slice, cur_intra)
                    coeffs, tc = self.residual_block(cat, n_ac, inc)
                    s.luma_ac[i][:n_ac] = coeffs
                    cs.cbf_luma[by, bx] = 1 if tc else 0
                    g.nz_luma[by, bx] = tc
                else:
                    s.luma_ac[i] = [0] * 16
                    cs.cbf_luma[by, bx] = 0
                    g.nz_luma[by, bx] = 0
        if s.cbp_chroma:
            for comp in range(2):
                inc = self._cbf_inc(3, my, mx, None, comp, cur_slice,
                                    cur_intra)
                s.chroma_dc[comp], ndc = self.residual_block(3, 4, inc)
                cs.cbf_cdc[comp, my, mx] = 1 if ndc else 0
        else:
            cs.cbf_cdc[:, my, mx] = 0
        for comp in range(2):
            for i in range(4):
                by = my * 2 + int(MB.CBLK_Y[i]) // 4
                bx = mx * 2 + int(MB.CBLK_X[i]) // 4
                if s.cbp_chroma == 2:
                    inc = self._cbf_inc(4, my, mx, (by, bx), comp, cur_slice,
                                        cur_intra)
                    coeffs, tc = self.residual_block(4, 15, inc)
                    s.chroma_ac[comp][i] = coeffs
                    cs.cbf_cac[comp, by, bx] = 1 if tc else 0
                    g.nz_chroma[comp, by, bx] = tc
                else:
                    s.chroma_ac[comp][i] = [0] * 15
                    cs.cbf_cac[comp, by, bx] = 0
                    g.nz_chroma[comp, by, bx] = 0

    # ---- macroblock layer ----

    def record_mb(self, my, mx, s, skip=False) -> None:
        """Post-parse bookkeeping shared by all MB kinds."""
        cs = self.cs
        cs.skip[my, mx] = 1 if skip else 0
        if s.mb_class == MB.MB_IPCM:
            cs.is_intra[my, mx] = 1
            cs.cbp_luma[my, mx] = 15
            cs.cbp_chroma[my, mx] = 2
            cs.cbf_dc[my, mx] = 1
            cs.cbf_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 1
            cs.cbf_cdc[:, my, mx] = 1
            cs.cbf_cac[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 1
            return
        cs.is_intra[my, mx] = 1 if s.mb_class not in (3, 5) else 0
        if getattr(s, "is_direct", False):
            cs.direct16[my, mx] = 1
            cs.direct_blk[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 1
        cs.cbp_luma[my, mx] = s.cbp_luma
        cs.cbp_chroma[my, mx] = s.cbp_chroma
        cs.chroma_mode[my, mx] = getattr(s, "chroma_mode", 0)
        cs.t8[my, mx] = getattr(s, "transform8x8", 0)

    def parse_intra_mb_body(self, my, mx, cur_slice, qp_prev,
                            mb_type) -> MB.MBSymbols:
        g = self.g
        s = MB.MBSymbols()
        if mb_type == 25:
            return self._parse_ipcm(my, mx, cur_slice, qp_prev, s)
        if mb_type == 0:
            s.mb_class = MB.MB_I4x4
            g.mb_class[my, mx] = s.mb_class
            g.slice_id[my, mx] = cur_slice
            if self.pps.transform_8x8_mode_flag:
                if self.transform_8x8_flag(my, mx, cur_slice):
                    s.transform8x8 = 1
                    g.t8[my, mx] = 1
            if s.transform8x8:
                for b8 in range(4):
                    by = my * 4 + (b8 >> 1) * 2
                    bx = mx * 4 + (b8 & 1) * 2
                    pred = g.predict_i4_mode(by, bx, cur_slice)
                    mode = self.intra4x4_pred_mode(pred)
                    s.i8_modes[b8] = mode
                    g.i4_modes[by:by + 2, bx:bx + 2] = mode
            else:
                for i in range(16):
                    by = my * 4 + int(MB.BLK_Y[i]) // 4
                    bx = mx * 4 + int(MB.BLK_X[i]) // 4
                    pred = g.predict_i4_mode(by, bx, cur_slice)
                    mode = self.intra4x4_pred_mode(pred)
                    s.i4_modes[i] = mode
                    g.i4_modes[by, bx] = mode
            s.chroma_mode = self.intra_chroma_pred_mode(my, mx, cur_slice)
            s.cbp_luma, s.cbp_chroma = self.coded_block_pattern(my, mx,
                                                                cur_slice)
        elif 1 <= mb_type <= 24:
            s.mb_class = MB.MB_I16x16
            s.i16_mode, s.cbp_luma, s.cbp_chroma = MB.parse_i16_mb_type(
                mb_type)
            g.mb_class[my, mx] = s.mb_class
            g.slice_id[my, mx] = cur_slice
            s.chroma_mode = self.intra_chroma_pred_mode(my, mx, cur_slice)
        else:
            raise ValueError(f"bad I mb_type {mb_type}")

        if s.cbp_luma or s.cbp_chroma or s.mb_class == MB.MB_I16x16:
            dq = self.mb_qp_delta()
            s.qp = (qp_prev + dq + 52) % 52
        else:
            self.prev_dqp_nz = 0
            s.qp = qp_prev
        g.qp[my, mx] = s.qp
        self.parse_residual(my, mx, cur_slice, s)
        self.record_mb(my, mx, s)
        return s

    def _parse_ipcm(self, my, mx, cur_slice, qp_prev, s) -> MB.MBSymbols:
        g = self.g
        s.mb_class = MB.MB_IPCM
        e = self.e
        # PCM samples are raw bytes at the next byte boundary of the rbsp;
        # afterwards the arithmetic engine re-inits (spec 9.3.1)
        e.pos = ((e.pos + 7) // 8) * 8
        data = e.data
        p = e.pos // 8
        if p + 384 > len(data):
            raise ValueError("truncated PCM macroblock")
        s.pcm_luma = bytes(data[p:p + 256])
        s.pcm_chroma = bytes(data[p + 256:p + 384])
        e.pos = (p + 384) * 8
        e._engine_init()
        s.qp = qp_prev
        self.prev_dqp_nz = 0
        g.mb_class[my, mx] = MB.MB_IPCM
        g.slice_id[my, mx] = cur_slice
        g.qp[my, mx] = s.qp
        g.nz_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 16
        g.nz_chroma[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 16
        self.record_mb(my, mx, s)
        return s

    def parse_p_mb_body(self, my, mx, cur_slice, qp_prev,
                        mb_type) -> "object":
        """One non-skip P macroblock after its mb_type (CABAC twin of
        INTER.parse_p_macroblock)."""
        from . import inter as INTER
        g = self.g
        m = self.m
        if mb_type >= 5:
            s0 = self.parse_intra_mb_body(my, mx, cur_slice, qp_prev,
                                          mb_type - 5)
            s = INTER.PMBSymbols(
                **{f: getattr(s0, f) for f in s0.__dataclass_fields__})
            m.ref[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
            m.mv[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
            m.done[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 1
            return s

        s = INTER.PMBSymbols()
        s.mb_class = INTER.MB_P
        s.p_type = mb_type
        g.mb_class[my, mx] = INTER.MB_P
        g.slice_id[my, mx] = cur_slice
        g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
        by0, bx0 = my * 4, mx * 4
        num_ref = self.num_ref

        def read_ref(by, bx, h4, w4):
            """ref_idx for a partition; its value is written into m.ref
            immediately so the NEXT partition's ref_idx ctx (within-MB
            neighbor) sees it (spec 9.3.3.1.1.6 uses decoded neighbors)."""
            ref = self.ref_idx(by, bx, cur_slice) if num_ref > 1 else 0
            m.ref[by:by + h4, bx:bx + w4] = ref
            return ref

        def put_partition(by, bx, w4, h4, ref_idx, kind):
            mvd_x = self.mvd(by, bx, 0, cur_slice)
            mvd_y = self.mvd(by, bx, 1, cur_slice)
            mvp = INTER.predict_mv(g, m, by, bx, w4, h4, ref_idx, cur_slice,
                                   kind)
            mv = mvp + np.array([mvd_x, mvd_y], np.int32)
            m.mv[by:by + h4, bx:bx + w4] = mv
            m.ref[by:by + h4, bx:bx + w4] = ref_idx
            m.done[by:by + h4, bx:bx + w4] = 1
            self.cs.mvd[0, by:by + h4, bx:bx + w4] = (mvd_x, mvd_y)
            s.partitions.append(
                INTER.InterPartition(by, bx, w4, h4, ref_idx, mv))

        if mb_type == INTER.P_16x16:
            ref = read_ref(by0, bx0, 4, 4)
            put_partition(by0, bx0, 4, 4, ref, "other")
        elif mb_type == INTER.P_16x8:
            r0 = read_ref(by0, bx0, 2, 4)
            r1 = read_ref(by0 + 2, bx0, 2, 4)
            put_partition(by0, bx0, 4, 2, r0, "16x8_top")
            put_partition(by0 + 2, bx0, 4, 2, r1, "16x8_bot")
        elif mb_type == INTER.P_8x16:
            r0 = read_ref(by0, bx0, 4, 2)
            r1 = read_ref(by0, bx0 + 2, 4, 2)
            put_partition(by0, bx0, 2, 4, r0, "8x16_left")
            put_partition(by0, bx0 + 2, 2, 4, r1, "8x16_right")
        elif mb_type in (INTER.P_8x8, INTER.P_8x8REF0):
            s.sub_types = [self.p_sub_mbtype() for _ in range(4)]
            refs = [0, 0, 0, 0]
            if mb_type == INTER.P_8x8 and num_ref > 1:
                for b8 in range(4):
                    oy = by0 + (b8 // 2) * 2
                    ox = bx0 + (b8 % 2) * 2
                    refs[b8] = read_ref(oy, ox, 2, 2)
            for b8 in range(4):
                n_parts, pw, ph = INTER.SUB_SHAPES[s.sub_types[b8]]
                oy = by0 + (b8 // 2) * 2
                ox = bx0 + (b8 % 2) * 2
                for p in range(n_parts):
                    if s.sub_types[b8] == 1:
                        py, px = oy + p, ox
                    elif s.sub_types[b8] == 2:
                        py, px = oy, ox + p
                    elif s.sub_types[b8] == 3:
                        py, px = oy + (p // 2), ox + (p % 2)
                    else:
                        py, px = oy, ox
                    put_partition(py, px, pw, ph, refs[b8], "other")
        else:
            raise ValueError(f"bad P mb_type {mb_type}")

        s.cbp_luma, s.cbp_chroma = self.coded_block_pattern(my, mx, cur_slice)
        if s.cbp_luma and self.pps.transform_8x8_mode_flag and (
                mb_type not in (INTER.P_8x8, INTER.P_8x8REF0)
                or all(t == 0 for t in s.sub_types)):
            if self.transform_8x8_flag(my, mx, cur_slice):
                s.transform8x8 = 1
                g.t8[my, mx] = 1
        if s.cbp_luma or s.cbp_chroma:
            dq = self.mb_qp_delta()
            s.qp = (qp_prev + dq + 52) % 52
        else:
            self.prev_dqp_nz = 0
            s.qp = qp_prev
        g.qp[my, mx] = s.qp
        self.parse_residual(my, mx, cur_slice, s)
        self.record_mb(my, mx, s)
        return s

    def apply_skip(self, my, mx, cur_slice, qp_prev):
        from . import inter as INTER
        s = INTER.apply_skip(self.g, self.m, my, mx, cur_slice, qp_prev)
        self.prev_dqp_nz = 0
        self.record_mb(my, mx, s, skip=True)
        self.cs.cbf_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self.cs.cbf_cdc[:, my, mx] = 0
        self.cs.cbf_cac[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
        return s

    # ---- B slices ----

    def apply_b_skip(self, my, mx, cur_slice, qp_prev):
        from . import inter as INTER
        _, _, dctx = self.bctx
        s = INTER.apply_direct(self.g, self.m, my, mx, cur_slice, qp_prev,
                               dctx, True)
        self.prev_dqp_nz = 0
        self.record_mb(my, mx, s, skip=True)
        self.cs.cbf_luma[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        self.cs.cbf_cdc[:, my, mx] = 0
        self.cs.cbf_cac[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
        return s

    def b_mbtype(self, my, mx, cur_slice) -> int:
        """mb_type in B slices (ctx 27..32 + intra suffix base 32)."""
        e = self.e
        cs = self.cs
        inc = 0
        for (ny, nx) in ((my, mx - 1), (my - 1, mx)):
            if self._mb_avail(ny, nx, cur_slice) \
                    and not cs.skip[ny, nx] and not cs.direct16[ny, nx]:
                inc += 1
        if not e.decode(27 + inc):
            return 0
        if not e.decode(30):
            return 1 + e.decode(32)
        bits = e.decode(31) << 3
        bits |= e.decode(32) << 2
        bits |= e.decode(32) << 1
        bits |= e.decode(32)
        if bits < 8:
            return bits + 3
        if bits == 13:
            # intra suffix, ctx base 32
            if not e.decode(32):
                return 23 + 0
            if e.terminate():
                return 23 + 25
            return 23 + self._intra_mbtype_tail((33, 34, 34, 35, 35))
        if bits == 14:
            return 11
        if bits == 15:
            return 22
        bits = (bits << 1) | e.decode(32)
        return bits - 4

    def b_sub_mbtype(self) -> int:
        e = self.e
        if not e.decode(36):
            return 0
        if not e.decode(37):
            return 1 + e.decode(39)
        t = 3
        if e.decode(38):
            if e.decode(39):
                return 11 + e.decode(39)
            t += 4
        t += 2 * e.decode(39)
        t += e.decode(39)
        return t

    def parse_b_mb_body(self, my, mx, cur_slice, qp_prev, mb_type):
        """One non-skip B macroblock after its mb_type (CABAC twin of
        INTER.parse_b_macroblock)."""
        from . import inter as INTER
        g = self.g
        m = self.m
        _, _, dctx = self.bctx
        hdr = self.hdr
        if mb_type >= 23:
            s0 = self.parse_intra_mb_body(my, mx, cur_slice, qp_prev,
                                          mb_type - 23)
            s = INTER.BMBSymbols(
                **{f: getattr(s0, f)
                   for f in MB.MBSymbols.__dataclass_fields__})
            sl = (slice(my * 4, my * 4 + 4), slice(mx * 4, mx * 4 + 4))
            m.ref[sl] = -1
            m.ref1[sl] = -1
            m.mv[sl] = 0
            m.mv1[sl] = 0
            m.refpic0[sl] = INTER.MotionGrids.NO_PIC
            m.refpic1[sl] = INTER.MotionGrids.NO_PIC
            m.done[sl] = 1
            return s

        if mb_type == 0:
            s = INTER.apply_direct(g, m, my, mx, cur_slice, qp_prev, dctx,
                                   False)
            s.b_type = 0
            self._parse_b_tail_cabac(my, mx, cur_slice, qp_prev, s,
                                     sub8x8_ok=True)
            return s

        s = INTER.BMBSymbols()
        s.mb_class = INTER.MB_B
        s.b_type = mb_type
        s.qp = qp_prev
        g.mb_class[my, mx] = INTER.MB_B
        g.slice_id[my, mx] = cur_slice
        g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
        by0, bx0 = my * 4, mx * 4
        num_ref0 = hdr.num_ref_idx_active_l0
        num_ref1 = hdr.num_ref_idx_active_l1

        if mb_type == 22:     # B_8x8
            sub = [self.b_sub_mbtype() for _ in range(4)]
            s.sub_types = sub
            parts = []
            for b8 in range(4):
                oy = by0 + (b8 // 2) * 2
                ox = bx0 + (b8 % 2) * 2
                if sub[b8] == 0:
                    parts.append((oy, ox, 2, 2, "direct", b8))
                    continue
                (w4, h4), pred = INTER.B_SUB_TABLE[sub[b8]]
                for py in range(0, 2, h4):
                    for px in range(0, 2, w4):
                        parts.append((oy + py, ox + px, w4, h4, pred, b8))
            for b8 in range(4):
                if sub[b8] == 0:
                    oy = by0 + (b8 // 2) * 2
                    ox = bx0 + (b8 % 2) * 2
                    self.cs.direct_blk[oy:oy + 2, ox:ox + 2] = 1
            refs0 = {}
            refs1 = {}
            for lst, refs, nr in ((0, refs0, num_ref0), (1, refs1, num_ref1)):
                for b8 in range(4):
                    use = sub[b8] != 0 and INTER.B_SUB_TABLE[sub[b8]][1] in (
                        ("L0", "BI") if lst == 0 else ("L1", "BI"))
                    if use and nr > 1:
                        oy = by0 + (b8 // 2) * 2
                        ox = bx0 + (b8 % 2) * 2
                        ref = self.ref_idx(oy, ox, cur_slice, lst)
                        refs[b8] = ref
                        refg = m.ref if lst == 0 else m.ref1
                        refg[oy:oy + 2, ox:ox + 2] = ref
            mvds0 = {}
            mvds1 = {}
            for lst, mvds in ((0, mvds0), (1, mvds1)):
                for p in parts:
                    if p[4] in (("L0", "BI") if lst == 0 else ("L1", "BI")):
                        mx_ = self.mvd(p[0], p[1], 0, cur_slice, lst)
                        my_ = self.mvd(p[0], p[1], 1, cur_slice, lst)
                        mvds[(p[0], p[1])] = (mx_, my_)
                        self.cs.mvd[lst, p[0]:p[0] + p[3], p[1]:p[1] + p[2]] \
                            = (mx_, my_)
            INTER._apply_b_partitions(g, m, my, mx, cur_slice, s, parts,
                                      refs0, refs1, mvds0, mvds1, dctx)
            sub8_ok = all(t == 0 or INTER.B_SUB_TABLE[t][0] == (2, 2)
                          for t in sub)
        else:
            shape = INTER.B_MB_TABLE[mb_type]
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
            for lst, refs, nr in ((0, refs0, num_ref0), (1, refs1, num_ref1)):
                for i, p in enumerate(parts):
                    if p[4] in (("L0", "BI") if lst == 0 else ("L1", "BI")) \
                            and nr > 1:
                        ref = self.ref_idx(p[0], p[1], cur_slice, lst)
                        refs[i] = ref
                        refg = m.ref if lst == 0 else m.ref1
                        refg[p[0]:p[0] + p[3], p[1]:p[1] + p[2]] = ref
            mvds0 = {}
            mvds1 = {}
            for lst, mvds in ((0, mvds0), (1, mvds1)):
                for p in parts:
                    if p[4] in (("L0", "BI") if lst == 0 else ("L1", "BI")):
                        mx_ = self.mvd(p[0], p[1], 0, cur_slice, lst)
                        my_ = self.mvd(p[0], p[1], 1, cur_slice, lst)
                        mvds[(p[0], p[1])] = (mx_, my_)
                        self.cs.mvd[lst, p[0]:p[0] + p[3], p[1]:p[1] + p[2]] \
                            = (mx_, my_)
            refs0 = {i: refs0.get(i, 0) for i in range(len(parts))}
            refs1 = {i: refs1.get(i, 0) for i in range(len(parts))}
            INTER._apply_b_mb_partitions(g, m, my, mx, cur_slice, s, parts,
                                         refs0, refs1, mvds0, mvds1, dctx,
                                         mb_type)
            sub8_ok = True

        self._parse_b_tail_cabac(my, mx, cur_slice, qp_prev, s,
                                 sub8x8_ok=sub8_ok)
        return s

    def _parse_b_tail_cabac(self, my, mx, cur_slice, qp_prev, s,
                            sub8x8_ok) -> None:
        g = self.g
        s.cbp_luma, s.cbp_chroma = self.coded_block_pattern(my, mx, cur_slice)
        if self.pps.transform_8x8_mode_flag and s.cbp_luma and (
                sub8x8_ok or s.is_direct):
            if self.transform_8x8_flag(my, mx, cur_slice):
                s.transform8x8 = 1
                g.t8[my, mx] = 1
        if s.cbp_luma or s.cbp_chroma:
            dq = self.mb_qp_delta()
            s.qp = (qp_prev + dq + 52) % 52
        else:
            self.prev_dqp_nz = 0
            s.qp = qp_prev
        g.qp[my, mx] = s.qp
        self.parse_residual(my, mx, cur_slice, s)
        self.record_mb(my, mx, s)

    def end_of_slice(self) -> int:
        return self.e.terminate()
