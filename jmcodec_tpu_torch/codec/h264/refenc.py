"""Pure-numpy H.264 reference encoder (intra/CAVLC, constant QP).

Produces spec-valid Annex-B streams and keeps an internal reconstruction that
is, by construction, bit-exact with what any conforming decoder outputs (it
reconstructs through the same dequant/IDCT/prediction/deblock code as the
reference decoder). This is the capability analog of the reference's QSV/NVENC
encode paths (intel_enc/intel_enc.cpp, nv_enc/nv_enc.cpp) with the codec math
in-tree instead of in vendor silicon.

Mode decision here is simple SAD-based (host oracle); the device encoder
(devenc.py) runs the P-frame motion search and transform on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ...ops import deblock as DB
from ...ops import intra as IP
from ...ops import mc as MC
from ...ops import transform as T
from ...utils.bits import BitWriter
from . import inter as INTER
from . import macroblock as MB
from . import nal
from .params import PPS, SPS
from .refdec import (RefPicture, compute_bs, recon_i4_block,
                     reconstruct_b_mb, reconstruct_inter_mb,
                     scan_to_raster4x4, _tr_available)
from .slicehdr import (SLICE_B, SLICE_I, SLICE_P, SliceHeader,
                       write_slice_header)


def raster_to_scan4x4(blk: np.ndarray, ac_only: bool = False) -> List[int]:
    flat = blk.reshape(16)[T.ZIGZAG4x4]
    return [int(v) for v in (flat[1:] if ac_only else flat)]


def _clampmv(c, rng):
    return (int(np.clip(c[0], -rng, rng)), int(np.clip(c[1], -rng, rng)))


@dataclass
class EncoderConfig:
    width: int
    height: int
    qp: int = 28
    level_idc: int = 40
    disable_deblock: bool = False
    # I_16x16 is tried when True (it usually wins on flat areas)
    enable_i16: bool = True
    gop_len: int = 1          # 1 = all-intra; >1 = IDR + P...P closed GOPs
    search_range: int = 16    # integer-pel ME range
    inter_partitions: bool = True  # try 16x8/8x16 splits in P MBs
    num_bframe: int = 0       # B pictures between anchors (frameIntervalP
    #                           parity, nv_enc/nv_enc.cpp:527-528)


class H264ReferenceEncoder:
    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        self.mbw = (cfg.width + 15) // 16
        self.mbh = (cfg.height + 15) // 16
        crop_r = (self.mbw * 16 - cfg.width)
        crop_b = (self.mbh * 16 - cfg.height)
        if crop_r % 2 or crop_b % 2:
            raise ValueError("width/height must be even (4:2:0)")
        if cfg.num_bframe:
            # B pictures need display reorder: Main profile, poc type 0,
            # two anchor references
            self.sps = SPS(
                profile_idc=77, constraint_set_flags=0,
                level_idc=cfg.level_idc,
                pic_width_in_mbs=self.mbw, pic_height_in_map_units=self.mbh,
                frame_cropping_flag=1 if (crop_r or crop_b) else 0,
                crop_right=crop_r // 2, crop_bottom=crop_b // 2,
                max_num_ref_frames=2, pic_order_cnt_type=0,
                log2_max_pic_order_cnt_lsb=8)
        else:
            self.sps = SPS(
                profile_idc=66, constraint_set_flags=0x40,
                level_idc=cfg.level_idc,
                pic_width_in_mbs=self.mbw, pic_height_in_map_units=self.mbh,
                frame_cropping_flag=1 if (crop_r or crop_b) else 0,
                crop_right=crop_r // 2, crop_bottom=crop_b // 2,
                max_num_ref_frames=1, pic_order_cnt_type=2)
        self.pps = PPS(pic_init_qp=cfg.qp,
                       deblocking_filter_control_present_flag=1)
        self.idr_count = 0
        self.frame_idx = 0
        self.frame_num = 0
        self.dpb: List[RefPicture] = []
        self.last_recon: Optional[Tuple[np.ndarray, ...]] = None
        # B-group state: buffered display-order frames awaiting their
        # forward anchor, and per-picture POC bookkeeping
        self._pending: List[tuple] = []
        self._disp_idx = 0          # display index of the NEXT input frame
        self._idr_disp = 0          # display index of the last IDR
        self._anchor_poc = 0

    # ------------------------------------------------------------------

    def encode_frame(self, Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                     qp: int = None) -> bytes:
        """Encode the next frame per the GOP structure (IDR, P or a
        buffered B group). Returns the bytes of every picture completed by
        this input (decode order; possibly empty while a B group fills,
        possibly several access units when an anchor closes a group).
        qp overrides cfg.qp for this frame (rate control hook)."""
        if self.cfg.num_bframe:
            return self._encode_frame_b(Y, U, V, qp)
        if self.cfg.gop_len <= 1 or self.frame_idx % self.cfg.gop_len == 0:
            out = self.encode_idr(Y, U, V, qp=qp)
        else:
            out = self.encode_p(Y, U, V, qp=qp)
        self.frame_idx += 1
        return out

    def _encode_frame_b(self, Y, U, V, qp) -> bytes:
        out = b""
        at_idr = self.cfg.gop_len <= 1 or \
            self.frame_idx % self.cfg.gop_len == 0
        if at_idr:
            out += self.flush()           # closed GOP: no B across the IDR
            self._idr_disp = self._disp_idx
            out += self.encode_idr(Y, U, V, qp=qp)
            self._anchor_poc = 0
            self._disp_idx += 1
            self.frame_idx += 1
            return out
        self._pending.append((Y, U, V, qp, self._disp_idx))
        self._disp_idx += 1
        self.frame_idx += 1
        if len(self._pending) == self.cfg.num_bframe + 1:
            out += self._encode_group()
        return out

    def flush(self) -> bytes:
        """Encode any buffered pictures (EOF / pre-IDR): the last buffered
        frame becomes a P anchor, earlier ones its B group."""
        if not self._pending:
            return b""
        return self._encode_group()

    def _poc_of(self, disp_idx: int) -> int:
        return 2 * (disp_idx - self._idr_disp)

    def _encode_group(self) -> bytes:
        """Pending frames [B..B, anchor] -> anchor P first (decode order),
        then the Bs referencing (previous anchor, new anchor)."""
        group = self._pending
        self._pending = []
        prev_anchor = self.dpb[0]
        prev_poc = self._anchor_poc
        Ya, Ua, Va, qpa, disp_a = group[-1]
        out = self.encode_p(Ya, Ua, Va, qp=qpa,
                            poc=self._poc_of(disp_a), keep_prev=True)
        new_anchor = self.dpb[0]
        self._anchor_poc = self._poc_of(disp_a)
        for (Yb, Ub, Vb, qpb, disp_b) in group[:-1]:
            out += self.encode_b(Yb, Ub, Vb, qp=qpb,
                                 poc=self._poc_of(disp_b),
                                 prev_anchor=prev_anchor, prev_poc=prev_poc,
                                 next_anchor=new_anchor,
                                 next_poc=self._anchor_poc)
        # sliding window: keep only the two newest anchors
        self.dpb = self.dpb[:2]
        return out

    # ------------------------------------------------------------------

    def headers_annexb(self) -> bytes:
        from .params import write_pps, write_sps
        return (nal.write_nal_unit(3, nal.NAL_SPS, write_sps(self.sps)) +
                nal.write_nal_unit(3, nal.NAL_PPS, write_pps(self.pps)))

    def encode_idr(self, Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                   qp: int = None) -> bytes:
        """Encode one IDR frame; returns the slice NAL (Annex-B)."""
        qp = self.cfg.qp if qp is None else int(qp)
        Yp, Up, Vp = self._pad(Y), self._pad(U, c=True), self._pad(V, c=True)
        w = BitWriter()
        hdr = SliceHeader(
            slice_type=SLICE_I, frame_num=0, is_idr=True,
            idr_pic_id=self.idr_count & 1, nal_ref_idc=3,
            slice_qp_delta=qp - self.pps.pic_init_qp,
            disable_deblocking_filter_idc=1 if self.cfg.disable_deblock else 0)
        self.idr_count += 1
        sw = write_slice_header(hdr, self.sps, self.pps)

        g = MB.MBGrids(self.mbw, self.mbh)
        Yr = np.zeros((self.mbh * 16, self.mbw * 16), np.int32)
        Ur = np.zeros((self.mbh * 8, self.mbw * 8), np.int32)
        Vr = np.zeros((self.mbh * 8, self.mbw * 8), np.int32)
        lam = max(1, 1 << max(0, (qp - 12) // 6))

        for my in range(self.mbh):
            for mx in range(self.mbw):
                s = self._encode_mb(g, my, mx, qp, lam, Yp, Up, Vp, Yr, Ur, Vr)
                MB.write_i_macroblock(sw, g, my, mx, 0, qp, s)

        sw.rbsp_trailing_bits()
        pre = (Yr.copy(), Ur.copy(), Vr.copy())
        if not self.cfg.disable_deblock:
            bs_v, bs_h = DB.intra_frame_bs(self.mbh, self.mbw)
            DB.deblock_frame(Yr, Ur, Vr, g.qp, bs_v, bs_h,
                             chroma_qp_off=self.pps.chroma_qp_index_offset)
        self.last_recon = (Yr.astype(np.uint8), Ur.astype(np.uint8),
                           Vr.astype(np.uint8))
        self.last_pre_deblock = pre
        self.frame_num = 0
        self.dpb = [RefPicture(0, Yr.copy(), Ur.copy(), Vr.copy())]
        return nal.write_nal_unit(3, nal.NAL_SLICE_IDR, sw.bytes())

    def encode_p(self, Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                 qp: int = None, poc: int = 0,
                 keep_prev: bool = False) -> bytes:
        """Encode one P frame (16x16 partitions + P_Skip + intra fallback).
        poc: display POC (poc type 0 streams); keep_prev keeps the previous
        anchor in the DPB (B groups need both anchors)."""
        qp = self.cfg.qp if qp is None else int(qp)
        Yp = self._pad(np.asarray(Y, np.int32))
        Up = self._pad(np.asarray(U, np.int32), c=True)
        Vp = self._pad(np.asarray(V, np.int32), c=True)
        self.frame_num = (self.frame_num + 1) % (1 << self.sps.log2_max_frame_num)
        hdr = SliceHeader(
            slice_type=SLICE_P, frame_num=self.frame_num, is_idr=False,
            nal_ref_idc=2, num_ref_idx_active_l0=1,
            pic_order_cnt_lsb=poc % (1 << self.sps.log2_max_pic_order_cnt_lsb),
            slice_qp_delta=qp - self.pps.pic_init_qp,
            disable_deblocking_filter_idc=1 if self.cfg.disable_deblock else 0)
        sw = write_slice_header(hdr, self.sps, self.pps)

        g = MB.MBGrids(self.mbw, self.mbh)
        m = INTER.MotionGrids(self.mbw, self.mbh)
        Yr = np.zeros((self.mbh * 16, self.mbw * 16), np.int32)
        Ur = np.zeros((self.mbh * 8, self.mbw * 8), np.int32)
        Vr = np.zeros((self.mbh * 8, self.mbw * 8), np.int32)
        lam = max(1, 1 << max(0, (qp - 12) // 6))
        refs = self.dpb[:1]
        refY, refU, refV = refs[0].padded()

        skip_run = 0
        for my in range(self.mbh):
            for mx in range(self.mbw):
                s, is_skip = self._encode_p_mb(
                    g, m, my, mx, qp, lam, Yp, Up, Vp, Yr, Ur, Vr, refs,
                    refY)
                if is_skip:
                    skip_run += 1
                    continue
                sw.ue(skip_run)
                skip_run = 0
                INTER.write_p_macroblock(sw, g, m, my, mx, 0, qp, s, 1)
        if skip_run:
            sw.ue(skip_run)
        sw.rbsp_trailing_bits()

        pre = (Yr.copy(), Ur.copy(), Vr.copy())
        # reference-picture identity per block (deblock bS + temporal
        # direct of later pictures, as the decoder records it)
        mask = m.ref >= 0
        m.refpic0[mask] = refs[0].poc
        if not self.cfg.disable_deblock:
            bs_v, bs_h = compute_bs(g, m)
            DB.deblock_frame(Yr, Ur, Vr, g.qp, bs_v, bs_h,
                             chroma_qp_off=self.pps.chroma_qp_index_offset)
        self.last_recon = (Yr.astype(np.uint8), Ur.astype(np.uint8),
                           Vr.astype(np.uint8))
        self.last_pre_deblock = pre
        new_ref = RefPicture(self.frame_num, Yr.copy(), Ur.copy(), Vr.copy(),
                             poc=poc,
                             mot_ref0=m.ref.copy(), mot_mv0=m.mv.copy(),
                             mot_ref1=m.ref1.copy(), mot_mv1=m.mv1.copy(),
                             mot_refpic0=m.refpic0.copy(),
                             mot_refpic1=m.refpic1.copy(),
                             own_l0_poc0=refs[0].poc)
        if keep_prev:
            # most-recent-first (list0 default order is PicNum descending)
            self.dpb = [new_ref] + self.dpb[:1]
        else:
            self.dpb = [new_ref]
        return nal.write_nal_unit(2, nal.NAL_SLICE_NON_IDR, sw.bytes())

    # ------------------------------------------------------------------

    def encode_b(self, Y, U, V, qp, poc, prev_anchor, prev_poc,
                 next_anchor, next_poc) -> bytes:
        """Encode one non-reference B picture between two anchors
        (B_Skip / B_Direct_16x16 / L0 / L1 / Bi 16x16 + intra fallback),
        reconstructed through the decoder path for bit-exactness."""
        qp = self.cfg.qp if qp is None else int(qp)
        Yp = self._pad(np.asarray(Y, np.int32))
        Up = self._pad(np.asarray(U, np.int32), c=True)
        Vp = self._pad(np.asarray(V, np.int32), c=True)
        # non-reference picture: frame_num = PrevRefFrameNum + 1 (7.4.3)
        bfn = (self.frame_num + 1) % (1 << self.sps.log2_max_frame_num)
        hdr = SliceHeader(
            slice_type=SLICE_B, frame_num=bfn, is_idr=False,
            nal_ref_idc=0, num_ref_idx_active_l0=1, num_ref_idx_active_l1=1,
            direct_spatial_mv_pred_flag=1,
            pic_order_cnt_lsb=poc % (1 << self.sps.log2_max_pic_order_cnt_lsb),
            slice_qp_delta=qp - self.pps.pic_init_qp,
            disable_deblocking_filter_idc=1 if self.cfg.disable_deblock else 0)
        sw = write_slice_header(hdr, self.sps, self.pps)

        l0, l1 = [prev_anchor], [next_anchor]
        l0_pocs = np.array([prev_poc], np.int32)
        l1_pocs = np.array([next_poc], np.int32)
        col = next_anchor
        dctx = INTER.DirectCtx(
            spatial=True,
            col_motion=(None if col.mot_ref0 is None else
                        (col.mot_ref0, col.mot_mv0, col.mot_ref1,
                         col.mot_mv1)),
            col_refpic=(None if col.mot_ref0 is None else
                        (col.mot_refpic0, col.mot_refpic1)),
            col_intra_refpoc=col.own_l0_poc0, cur_poc=poc,
            l0_pocs=l0_pocs, l1_pocs=l1_pocs)

        g = MB.MBGrids(self.mbw, self.mbh)
        m = INTER.MotionGrids(self.mbw, self.mbh)
        Yr = np.zeros((self.mbh * 16, self.mbw * 16), np.int32)
        Ur = np.zeros((self.mbh * 8, self.mbw * 8), np.int32)
        Vr = np.zeros((self.mbh * 8, self.mbw * 8), np.int32)
        lam = max(1, 1 << max(0, (qp - 12) // 6))

        skip_run = 0
        for my in range(self.mbh):
            for mx in range(self.mbw):
                s, is_skip = self._encode_b_mb(
                    g, m, my, mx, qp, lam, Yp, Up, Vp, Yr, Ur, Vr,
                    l0, l1, dctx, poc)
                if is_skip:
                    skip_run += 1
                    continue
                sw.ue(skip_run)
                skip_run = 0
                INTER.write_b_macroblock(sw, g, m, my, mx, 0, qp, s,
                                         l0_pocs, l1_pocs)
        if skip_run:
            sw.ue(skip_run)
        sw.rbsp_trailing_bits()

        if not self.cfg.disable_deblock:
            bs_v, bs_h = compute_bs(g, m, b_aware=True)
            DB.deblock_frame(Yr, Ur, Vr, g.qp, bs_v, bs_h,
                             chroma_qp_off=self.pps.chroma_qp_index_offset)
        self.last_recon = (Yr.astype(np.uint8), Ur.astype(np.uint8),
                           Vr.astype(np.uint8))
        return nal.write_nal_unit(0, nal.NAL_SLICE_NON_IDR, sw.bytes())

    def _pred_from_parts(self, parts, l0, l1, dctx):
        """Per-8x8-or-larger partitions -> (predY 16x16, predU, predV 8x8),
        uni/bi combined exactly as the decoder does (wbp 0)."""
        x0 = (min(p[1] for p in parts)) * 4 if False else None
        predY = np.zeros((16, 16), np.int32)
        predU = np.zeros((8, 8), np.int32)
        predV = np.zeros((8, 8), np.int32)
        by0 = min(p[0] for p in parts)
        bx0 = min(p[1] for p in parts)
        for (by, bx, ref0, ref1, mv0, mv1) in parts:
            w4 = h4 = 2 if len(parts) > 1 else 4
            blks = []
            for lst, ref, mv in ((0, ref0, mv0), (1, ref1, mv1)):
                if ref < 0:
                    continue
                pic = (l0 if lst == 0 else l1)[ref]
                pY, pU, pV = pic.padded()
                yb = MC.mc_luma_block(pY, bx * 4, by * 4, int(mv[0]),
                                      int(mv[1]), w4 * 4, h4 * 4)
                ub = MC.mc_chroma_block(pU, bx * 2, by * 2, int(mv[0]),
                                        int(mv[1]), w4 * 2, h4 * 2)
                vb = MC.mc_chroma_block(pV, bx * 2, by * 2, int(mv[0]),
                                        int(mv[1]), w4 * 2, h4 * 2)
                blks.append((yb, ub, vb))
            if len(blks) == 2:
                yb = (blks[0][0] + blks[1][0] + 1) >> 1
                ub = (blks[0][1] + blks[1][1] + 1) >> 1
                vb = (blks[0][2] + blks[1][2] + 1) >> 1
            else:
                yb, ub, vb = blks[0]
            ly, lx = (by - by0) * 4, (bx - bx0) * 4
            predY[ly:ly + h4 * 4, lx:lx + w4 * 4] = yb
            cy, cx = (by - by0) * 2, (bx - bx0) * 2
            predU[cy:cy + h4 * 2, cx:cx + w4 * 2] = ub
            predV[cy:cy + h4 * 2, cx:cx + w4 * 2] = vb
        return predY, predU, predV

    def _inter_residual(self, s, src, predY, Us, Vs, predU, predV,
                        my, mx, qp):
        """Quantized inter residual + cbp into s (shared by P/B shapes)."""
        resid = src - predY
        blocks = resid.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
        wall = T.np_forward_transform_4x4(blocks.reshape(16, 4, 4))
        z = T.np_quant_4x4(wall, qp, intra=False)
        cbp = 0
        for i in range(16):
            bx4, by4 = int(MB.BLK_X[i]), int(MB.BLK_Y[i])
            zb = z[(by4 // 4) * 4 + bx4 // 4]
            s.luma_ac[i] = raster_to_scan4x4(zb)
            if zb.any():
                cbp |= 1 << (i >> 2)
        s.cbp_luma = cbp
        for i in range(16):
            if not (cbp & (1 << (i >> 2))):
                s.luma_ac[i] = [0] * 16
        any_dc = any_ac = False
        for comp, plane_s in enumerate((Us, Vs)):
            qpc = int(T.chroma_qp(qp, self.pps.chroma_qp_offset(comp)))
            predC = predU if comp == 0 else predV
            residc = plane_s[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] - predC
            cblocks = residc.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
            wc = T.np_forward_transform_4x4(cblocks.reshape(4, 4, 4))
            dc = wc[:, 0, 0].reshape(2, 2)
            dch = T.np_hadamard_2x2(dc.astype(np.int32))
            zdc = T.np_quant_dc(dch, qpc)
            if zdc.any():
                any_dc = True
            s.chroma_dc[comp] = [int(v) for v in zdc.reshape(4)]
            zac = T.np_quant_4x4(wc, qpc, intra=False)
            for i in range(4):
                zb = zac[i].copy()
                zb[0, 0] = 0
                if zb.any():
                    any_ac = True
                s.chroma_ac[comp][i] = raster_to_scan4x4(zb, ac_only=True)
        s.cbp_chroma = 2 if any_ac else (1 if any_dc else 0)
        if s.cbp_chroma == 0:
            for comp in range(2):
                s.chroma_dc[comp] = [0] * 4
                for i in range(4):
                    s.chroma_ac[comp][i] = [0] * 15
        elif s.cbp_chroma == 1:
            for comp in range(2):
                for i in range(4):
                    s.chroma_ac[comp][i] = [0] * 15

    def _encode_b_mb(self, g, m, my, mx, qp, lam, Ys, Us, Vs, Yr, Ur, Vr,
                     l0, l1, dctx, poc):
        from ...utils.bits import se_len
        x0, y0 = mx * 16, my * 16
        src = Ys[y0:y0 + 16, x0:x0 + 16]
        by, bx = my * 4, mx * 4
        g.mb_class[my, mx] = INTER.MB_B
        g.slice_id[my, mx] = 0

        # direct candidate (no grid writes yet)
        dparts = INTER.direct_partitions(g, m, my, mx, 0, dctx)
        pdY, pdU, pdV = self._pred_from_parts(dparts, l0, l1, dctx)
        cost_d = int(np.abs(src - pdY).sum()) + lam

        # per-list 16x16 ME
        p0Y = l0[0].padded()[0]
        p1Y = l1[0].padded()[0]
        mvp0 = INTER.predict_mv(g, m.lst(0), by, bx, 4, 4, 0, 0)
        mvp1 = INTER.predict_mv(g, m.lst(1), by, bx, 4, 4, 0, 0)
        mv0, c0 = self._me_block(src, p0Y, x0, y0, 16, 16, mvp0, lam)
        mv1, c1 = self._me_block(src, p1Y, x0, y0, 16, 16, mvp1, lam)
        b0 = MC.mc_luma_block(p0Y, x0, y0, int(mv0[0]), int(mv0[1]), 16, 16)
        b1 = MC.mc_luma_block(p1Y, x0, y0, int(mv1[0]), int(mv1[1]), 16, 16)
        bi = (b0 + b1 + 1) >> 1
        cbi = int(np.abs(src - bi).sum()) + lam * (
            se_len(int(mv0[0] - mvp0[0])) + se_len(int(mv0[1] - mvp0[1])) +
            se_len(int(mv1[0] - mvp1[0])) + se_len(int(mv1[1] - mvp1[1])))

        best = min((cost_d, "direct"), (c0, "l0"), (c1, "l1"), (cbi, "bi"),
                   key=lambda t: t[0])

        if best[0] > 16 * 16 * 24:   # intra fallback
            s_intra = self._encode_mb(g, my, mx, qp, lam, Ys, Us, Vs,
                                      Yr, Ur, Vr)
            sl = (slice(by, by + 4), slice(bx, bx + 4))
            m.ref[sl] = -1
            m.ref1[sl] = -1
            m.mv[sl] = 0
            m.mv1[sl] = 0
            m.done[sl] = 1
            return s_intra, False

        if best[1] == "direct":
            s = INTER.apply_direct(g, m, my, mx, 0, qp, dctx, False)
            self._inter_residual(s, src, pdY, Us, Vs, pdU, pdV, my, mx, qp)
            if s.cbp_luma == 0 and s.cbp_chroma == 0:
                # B_Skip: same derivation, no residual, no syntax
                g.nz_luma[by:by + 4, bx:bx + 4] = 0
                g.nz_chroma[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
                s.is_skip = True
                reconstruct_b_mb(Yr, Ur, Vr, g, my, mx, 0, s, l0, l1,
                                 self.pps, poc, 0)
                return s, True
            g.qp[my, mx] = s.qp = qp
            reconstruct_b_mb(Yr, Ur, Vr, g, my, mx, 0, s, l0, l1,
                             self.pps, poc, 0)
            return s, False

        s = INTER.BMBSymbols()
        s.mb_class = INTER.MB_B
        s.qp = qp
        if best[1] == "l0":
            s.partitions = [INTER.InterPartition(by, bx, 4, 4, 0, mv0)]
            predY, predU, predV = self._pred_from_parts(
                [(by, bx, 0, -1, mv0, None)], l0, l1, dctx)
        elif best[1] == "l1":
            s.partitions = [INTER.InterPartition(by, bx, 4, 4, -1,
                                                 np.zeros(2, np.int32), 0,
                                                 mv1)]
            predY, predU, predV = self._pred_from_parts(
                [(by, bx, -1, 0, None, mv1)], l0, l1, dctx)
        else:
            s.partitions = [INTER.InterPartition(by, bx, 4, 4, 0, mv0, 0,
                                                 mv1)]
            predY, predU, predV = self._pred_from_parts(
                [(by, bx, 0, 0, mv0, mv1)], l0, l1, dctx)
        self._inter_residual(s, src, predY, Us, Vs, predU, predV, my, mx, qp)
        g.qp[my, mx] = qp
        reconstruct_b_mb(Yr, Ur, Vr, g, my, mx, 0, s, l0, l1, self.pps,
                         poc, 0)
        return s, False

    def _me_block(self, src, refY, x0, y0, w, h, mvp, lam):
        """Diamond integer-pel + quarter-pel refinement for a w x h block.
        Returns (mv, cost)."""
        from ...utils.bits import se_len
        rng = self.cfg.search_range
        pad = MC.REF_PAD

        def sad_full(dx, dy):
            win = refY[y0 + dy + pad:y0 + dy + h + pad,
                       x0 + dx + pad:x0 + dx + w + pad]
            return int(np.abs(src - win).sum())

        def cost_of(mvx, mvy, sad):
            return sad + lam * (se_len(int(mvx - mvp[0]))
                                + se_len(int(mvy - mvp[1])))

        # integer-pel diamond from both the predictor and (0,0)
        cands = {(int(mvp[0]) >> 2, int(mvp[1]) >> 2), (0, 0)}
        best = None
        for c in cands:
            sad = sad_full(*_clampmv(c, rng))
            cst = cost_of(c[0] * 4, c[1] * 4, sad)
            if best is None or cst < best[0]:
                best = (cst, _clampmv(c, rng))
        big = [(-2, 0), (2, 0), (0, -2), (0, 2), (-1, -1), (1, 1), (-1, 1), (1, -1)]
        small = [(-1, 0), (1, 0), (0, -1), (0, 1)]
        for pattern in (big, small):
            improved = True
            iters = 0
            while improved and iters < rng:
                improved = False
                iters += 1
                cx, cy = best[1]
                for dx, dy in pattern:
                    c = _clampmv((cx + dx, cy + dy), rng)
                    cst = cost_of(c[0] * 4, c[1] * 4, sad_full(*c))
                    if cst < best[0]:
                        best = (cst, c)
                        improved = True
        # sub-pel refinement (half then quarter)
        bq = (best[1][0] * 4, best[1][1] * 4)
        best_sub = (best[0], bq)
        for step in (2, 1):
            cx, cy = best_sub[1]
            for dx, dy in ((-step, 0), (step, 0), (0, -step), (0, step),
                           (-step, -step), (step, step), (-step, step),
                           (step, -step)):
                mv = (cx + dx, cy + dy)
                blk = MC.mc_luma_block(refY, x0, y0, mv[0], mv[1], w, h)
                sad = int(np.abs(src - blk).sum())
                cst = cost_of(mv[0], mv[1], sad)
                if cst < best_sub[0]:
                    best_sub = (cst, mv)
        return np.array(best_sub[1], np.int32), best_sub[0]

    def _encode_p_mb(self, g, m, my, mx, qp, lam, Ys, Us, Vs, Yr, Ur, Vr,
                     refs, refY):
        x0, y0 = mx * 16, my * 16
        src = Ys[y0:y0 + 16, x0:x0 + 16]
        # predictors need provisional availability marking
        g.mb_class[my, mx] = INTER.MB_P
        g.slice_id[my, mx] = 0
        skip_mv = INTER.pskip_mv(g, m, my, mx, 0)
        mvp = INTER.predict_mv(g, m, my * 4, mx * 4, 4, 4, 0, 0)
        mv, me_cost = self._me_block(src, refY, x0, y0, 16, 16, mvp, lam)

        # try split partitions (16x8 / 8x16): worthwhile when halves move
        # differently; small lambda penalty for the extra mvd+ref syntax
        p_type = INTER.P_16x16
        parts_mv = [mv]
        split_pen = 10 * lam
        if self.cfg.inter_partitions:
            mv_t, c_t = self._me_block(src[0:8, :], refY, x0, y0, 16, 8,
                                       mvp, lam)
            mv_b, c_b = self._me_block(src[8:16, :], refY, x0, y0 + 8, 16, 8,
                                       mvp, lam)
            mv_l, c_l = self._me_block(src[:, 0:8], refY, x0, y0, 8, 16,
                                       mvp, lam)
            mv_r, c_r = self._me_block(src[:, 8:16], refY, x0 + 8, y0, 8, 16,
                                       mvp, lam)
            options = [(me_cost, INTER.P_16x16, [mv]),
                       (c_t + c_b + split_pen, INTER.P_16x8, [mv_t, mv_b]),
                       (c_l + c_r + split_pen, INTER.P_8x16, [mv_l, mv_r])]
            me_cost, p_type, parts_mv = min(options, key=lambda o: o[0])

        # build the inter candidate
        s = INTER.PMBSymbols()
        s.mb_class = INTER.MB_P
        s.p_type = p_type
        s.qp = qp
        if p_type == INTER.P_16x16:
            s.partitions = [INTER.InterPartition(my * 4, mx * 4, 4, 4, 0,
                                                 parts_mv[0])]
        elif p_type == INTER.P_16x8:
            s.partitions = [
                INTER.InterPartition(my * 4, mx * 4, 4, 2, 0, parts_mv[0]),
                INTER.InterPartition(my * 4 + 2, mx * 4, 4, 2, 0, parts_mv[1])]
        else:
            s.partitions = [
                INTER.InterPartition(my * 4, mx * 4, 2, 4, 0, parts_mv[0]),
                INTER.InterPartition(my * 4, mx * 4 + 2, 2, 4, 0, parts_mv[1])]
        predY = np.zeros((16, 16), np.int32)
        for part in s.partitions:
            lx, ly = part.bx * 4 - x0, part.by * 4 - y0
            predY[ly:ly + part.h4 * 4, lx:lx + part.w4 * 4] = MC.mc_luma_block(
                refY, part.bx * 4, part.by * 4, int(part.mv[0]),
                int(part.mv[1]), part.w4 * 4, part.h4 * 4)
        resid = src - predY
        blocks = resid.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
        wall = T.np_forward_transform_4x4(blocks.reshape(16, 4, 4))
        z = T.np_quant_4x4(wall, qp, intra=False)
        cbp = 0
        for i in range(16):
            bx4, by4 = int(MB.BLK_X[i]), int(MB.BLK_Y[i])
            zb = z[(by4 // 4) * 4 + bx4 // 4]
            s.luma_ac[i] = raster_to_scan4x4(zb)
            if zb.any():
                cbp |= 1 << (i >> 2)
        s.cbp_luma = cbp
        for i in range(16):
            if not (cbp & (1 << (i >> 2))):
                s.luma_ac[i] = [0] * 16
        # chroma residual
        refUp, refVp = refs[0].padded()[1], refs[0].padded()[2]
        any_dc = any_ac = False
        for comp, (plane_s, refp) in enumerate(((Us, refUp), (Vs, refVp))):
            qpc = int(T.chroma_qp(qp, self.pps.chroma_qp_offset(comp)))
            predC = np.zeros((8, 8), np.int32)
            for part in s.partitions:
                cx, cy = part.bx * 2 - mx * 8, part.by * 2 - my * 8
                predC[cy:cy + part.h4 * 2, cx:cx + part.w4 * 2] = \
                    MC.mc_chroma_block(refp, part.bx * 2, part.by * 2,
                                       int(part.mv[0]), int(part.mv[1]),
                                       part.w4 * 2, part.h4 * 2)
            residc = plane_s[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] - predC
            cblocks = residc.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
            wc = T.np_forward_transform_4x4(cblocks.reshape(4, 4, 4))
            dc = wc[:, 0, 0].reshape(2, 2)
            dch = T.np_hadamard_2x2(dc.astype(np.int32))
            zdc = T.np_quant_dc(dch, qpc)
            if zdc.any():
                any_dc = True
            s.chroma_dc[comp] = [int(v) for v in zdc.reshape(4)]
            zac = T.np_quant_4x4(wc, qpc, intra=False)
            for i in range(4):
                zb = zac[i].copy()
                zb[0, 0] = 0
                if zb.any():
                    any_ac = True
                s.chroma_ac[comp][i] = raster_to_scan4x4(zb, ac_only=True)
        s.cbp_chroma = 2 if any_ac else (1 if any_dc else 0)
        if s.cbp_chroma == 0:
            for comp in range(2):
                s.chroma_dc[comp] = [0] * 4
                for i in range(4):
                    s.chroma_ac[comp][i] = [0] * 15
        elif s.cbp_chroma == 1:
            for comp in range(2):
                for i in range(4):
                    s.chroma_ac[comp][i] = [0] * 15
        # skip?
        if (p_type == INTER.P_16x16 and s.cbp_luma == 0 and s.cbp_chroma == 0
                and mv[0] == skip_mv[0] and mv[1] == skip_mv[1]):
            sk = INTER.apply_skip(g, m, my, mx, 0, qp)
            reconstruct_inter_mb(Yr, Ur, Vr, g, my, mx, 0, sk, refs, self.pps)
            return sk, True

        # inter vs intra decision (cheap): inter unless MC fails badly
        intra_thresh = 16 * 16 * 24
        if me_cost > intra_thresh:
            s_intra = self._encode_mb(g, my, mx, qp, lam, Ys, Us, Vs,
                                      Yr, Ur, Vr)
            m.ref[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
            m.mv[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
            return s_intra, False

        # commit grids happen in write_p_macroblock; recon through the decoder
        # path for bit-exactness
        g.qp[my, mx] = s.qp
        reconstruct_inter_mb(Yr, Ur, Vr, g, my, mx, 0, s, refs, self.pps)
        return s, False

    def recon_cropped(self):
        Yr, Ur, Vr = self.last_recon
        w, h = self.cfg.width, self.cfg.height
        return Yr[:h, :w], Ur[:h // 2, :w // 2], Vr[:h // 2, :w // 2]

    def _pad(self, P: np.ndarray, c: bool = False) -> np.ndarray:
        th = self.mbh * (8 if c else 16)
        tw = self.mbw * (8 if c else 16)
        out = np.zeros((th, tw), np.int32)
        h, w = P.shape
        out[:h, :w] = P
        if w < tw:
            out[:h, w:] = P[:, w - 1:w]
        if h < th:
            out[h:, :] = out[h - 1:h, :]
        return out

    # ------------------------------------------------------------------

    def _encode_mb(self, g, my, mx, qp, lam, Ys, Us, Vs, Yr, Ur, Vr) -> MB.MBSymbols:
        s = MB.MBSymbols()
        s.qp = qp
        x0, y0 = mx * 16, my * 16
        src = Ys[y0:y0 + 16, x0:x0 + 16]
        g.mb_class[my, mx] = MB.MB_I4x4  # provisional, for availability
        g.slice_id[my, mx] = 0
        avail_l = g.mb_available(my, mx - 1, 0)
        avail_t = g.mb_available(my - 1, mx, 0)

        # ---- I16x16 candidate (prediction SAD only, fast pre-check) ----
        i16_best = None
        if self.cfg.enable_i16:
            t16 = Yr[y0 - 1, x0:x0 + 16] if avail_t else None
            l16 = Yr[y0:y0 + 16, x0 - 1] if avail_l else None
            tl = int(Yr[y0 - 1, x0 - 1]) if (avail_t and avail_l) else 0
            for mode in range(4):
                if mode == IP.I16_V and not avail_t:
                    continue
                if mode == IP.I16_H and not avail_l:
                    continue
                if mode == IP.I16_PLANE and not (avail_t and avail_l):
                    continue
                pred = IP.pred16x16(
                    mode,
                    t16 if t16 is not None else np.zeros(16, np.int32),
                    l16 if l16 is not None else np.zeros(16, np.int32),
                    tl, avail_t, avail_l)
                sad = int(np.abs(src - pred).sum())
                if i16_best is None or sad < i16_best[0]:
                    i16_best = (sad, mode, pred)

        # ---- I4x4: sequential per-block decision with live recon ----
        # The I4 trial writes only inside this MB's 16x16 region of Yr; back it
        # up so an I16 win can roll it back.
        Yscratch = Yr
        mb_backup = Yr[y0:y0 + 16, x0:x0 + 16].copy()
        g_modes_backup = g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4].copy()
        i4_sad = 0
        i4_modes = [0] * 16
        i4_coeffs = [[0] * 16 for _ in range(16)]
        for i in range(16):
            bx4 = int(MB.BLK_X[i])
            by4 = int(MB.BLK_Y[i])
            by, bx = my * 4 + by4 // 4, mx * 4 + bx4 // 4
            x, y = x0 + bx4, y0 + by4
            bl = bx > 0 and (True if (bx - 1) // 4 == mx
                             else g.mb_available(my, mx - 1, 0))
            bt = by > 0 and (True if (by - 1) // 4 == my
                             else g.mb_available(my - 1, mx, 0))
            btr = _tr_available(g, my, mx, i, by, bx, 0)
            t8 = np.zeros(8, np.int32)
            l4 = np.zeros(4, np.int32)
            tl = 0
            if bt:
                t8[:4] = Yscratch[y - 1, x:x + 4]
                t8[4:] = Yscratch[y - 1, x + 4:x + 8] if btr else t8[3]
            if bl:
                l4[:] = Yscratch[y:y + 4, x - 1]
            if bt and bl:
                tl = int(Yscratch[y - 1, x - 1])
            pred_mode = g.predict_i4_mode(by, bx, 0)
            bsrc = Ys[y:y + 4, x:x + 4]
            best = None
            for mode in range(9):
                if mode in (IP.I4_V, IP.I4_DDL, IP.I4_VL) and not bt:
                    continue
                if mode in (IP.I4_H, IP.I4_HU) and not bl:
                    continue
                if mode in (IP.I4_DDR, IP.I4_VR, IP.I4_HD) and not (bt and bl):
                    continue
                pred = IP.pred4x4(mode, t8, l4, tl, bt, bl)
                cost = int(np.abs(bsrc - pred).sum())
                if mode != pred_mode:
                    cost += 4 * lam
                if best is None or cost < best[0]:
                    best = (cost, mode, pred)
            cost, mode, pred = best
            resid = bsrc - pred
            wcoef = T.np_forward_transform_4x4(resid)
            z = T.np_quant_4x4(wcoef, qp, intra=True)
            d = T.np_dequant_4x4(z, qp)
            rec_res = T.np_inverse_transform_4x4(d)
            rec = np.clip(pred + rec_res, 0, 255)
            Yscratch[y:y + 4, x:x + 4] = rec
            i4_sad += int(np.abs(bsrc - rec).sum())
            i4_modes[i] = mode
            i4_coeffs[i] = raster_to_scan4x4(z)
            g.i4_modes[by, bx] = mode

        # ---- choose I4 vs I16 ----
        use_i16 = False
        if i16_best is not None:
            # compare on reconstruction-error estimate: prediction SAD with a
            # lambda bonus for I16's much cheaper signaling
            use_i16 = i16_best[0] <= i4_sad + 24 * lam
        if use_i16:
            Yr[y0:y0 + 16, x0:x0 + 16] = mb_backup
            g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = g_modes_backup
            sad, mode, pred = i16_best
            s.mb_class = MB.MB_I16x16
            s.i16_mode = mode
            g.mb_class[my, mx] = MB.MB_I16x16
            g.i4_modes[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
            resid = src - pred
            blocks = resid.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)  # [by,bx,4,4]
            wall = T.np_forward_transform_4x4(blocks.reshape(16, 4, 4))
            wall = wall.reshape(4, 4, 4, 4)
            dc = wall[:, :, 0, 0]
            dch = T.np_hadamard_4x4(dc.astype(np.int32))
            zdc = T.np_quant_dc(dch, qp)
            s.luma_dc = raster_to_scan4x4(zdc)
            # AC quant (position 0 excluded)
            zac = T.np_quant_4x4(wall.reshape(16, 4, 4), qp, intra=True)
            any_ac = False
            dc_rec = T.np_luma_dc_decode(scan_to_raster4x4(s.luma_dc), qp)
            mbres = np.zeros((16, 16), np.int32)
            for i in range(16):
                bx4, by4 = int(MB.BLK_X[i]), int(MB.BLK_Y[i])
                zb = zac[(by4 // 4) * 4 + bx4 // 4].copy()
                zb[0, 0] = 0
                if zb.any():
                    any_ac = True
                s.luma_ac[i] = raster_to_scan4x4(zb, ac_only=True) + [0]
                d = T.np_dequant_4x4(zb, qp)
                d[0, 0] = dc_rec[by4 // 4, bx4 // 4]
                mbres[by4:by4 + 4, bx4:bx4 + 4] = T.np_inverse_transform_4x4(d)
            s.cbp_luma = 15 if any_ac else 0
            if not any_ac:
                for i in range(16):
                    s.luma_ac[i] = [0] * 16
            Yr[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + mbres, 0, 255)
        else:
            s.mb_class = MB.MB_I4x4
            s.i4_modes = i4_modes
            cbp = 0
            for i in range(16):
                if any(i4_coeffs[i]):
                    cbp |= 1 << (i >> 2)
            s.cbp_luma = cbp
            for i in range(16):
                if cbp & (1 << (i >> 2)):
                    s.luma_ac[i] = i4_coeffs[i]
                else:
                    s.luma_ac[i] = [0] * 16
            # Yr already holds the I4 recon (blocks inside zeroed 8x8 groups
            # had all-zero residuals, so recon is unchanged by cbp zeroing)

        # ---- chroma ----
        self._encode_chroma(g, s, my, mx, qp, Us, Vs, Ur, Vr, avail_l, avail_t)
        return s

    def _encode_chroma(self, g, s, my, mx, qp, Us, Vs, Ur, Vr, avail_l, avail_t):
        cx0, cy0 = mx * 8, my * 8
        # mode decision over both components jointly
        best = None
        for mode in range(4):
            if mode == IP.IC_H and not avail_l:
                continue
            if mode == IP.IC_V and not avail_t:
                continue
            if mode == IP.IC_PLANE and not (avail_t and avail_l):
                continue
            sad = 0
            preds = []
            for plane_s, plane_r in ((Us, Ur), (Vs, Vr)):
                t8 = plane_r[cy0 - 1, cx0:cx0 + 8] if avail_t else np.zeros(8, np.int32)
                l8 = plane_r[cy0:cy0 + 8, cx0 - 1] if avail_l else np.zeros(8, np.int32)
                tl = int(plane_r[cy0 - 1, cx0 - 1]) if (avail_t and avail_l) else 0
                pred = IP.pred_chroma8x8(mode, t8, l8, tl, avail_t, avail_l)
                sad += int(np.abs(plane_s[cy0:cy0 + 8, cx0:cx0 + 8] - pred).sum())
                preds.append(pred)
            if best is None or sad < best[0]:
                best = (sad, mode, preds)
        _, mode, preds = best
        s.chroma_mode = mode

        any_dc = False
        any_ac = False
        rec_data = []
        for comp, (plane_s, plane_r) in enumerate(((Us, Ur), (Vs, Vr))):
            qpc = int(T.chroma_qp(qp, self.pps.chroma_qp_offset(comp)))
            src = plane_s[cy0:cy0 + 8, cx0:cx0 + 8]
            resid = src - preds[comp]
            blocks = resid.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)  # [by,bx,4,4]
            wall = T.np_forward_transform_4x4(blocks.reshape(4, 4, 4))
            wall = wall.reshape(2, 2, 4, 4)
            dc = wall[:, :, 0, 0]
            dch = T.np_hadamard_2x2(dc.astype(np.int32))
            zdc = T.np_quant_dc(dch, qpc)
            if zdc.any():
                any_dc = True
            s.chroma_dc[comp] = [int(v) for v in zdc.reshape(4)]
            zac_all = T.np_quant_4x4(wall.reshape(4, 4, 4), qpc, intra=True)
            comp_ac = []
            for i in range(4):
                zb = zac_all[i].copy()
                zb[0, 0] = 0
                if zb.any():
                    any_ac = True
                comp_ac.append(zb)
                s.chroma_ac[comp][i] = raster_to_scan4x4(zb, ac_only=True)
            rec_data.append((qpc, zdc, comp_ac, preds[comp]))

        s.cbp_chroma = 2 if any_ac else (1 if any_dc else 0)
        # reconstruct through the decode path with the final cbp
        for comp, (plane_r,) in enumerate(((Ur,), (Vr,))):
            qpc, zdc, comp_ac, pred = rec_data[comp]
            if s.cbp_chroma == 0:
                s.chroma_dc[comp] = [0] * 4
                zdc = np.zeros((2, 2), np.int32)
            if s.cbp_chroma < 2:
                comp_ac = [np.zeros((4, 4), np.int32) for _ in range(4)]
                for i in range(4):
                    s.chroma_ac[comp][i] = [0] * 15
            dc_rec = T.np_chroma_dc_decode(zdc, qpc)
            res = np.zeros((8, 8), np.int32)
            for i in range(4):
                bx4, by4 = int(MB.CBLK_X[i]), int(MB.CBLK_Y[i])
                d = T.np_dequant_4x4(comp_ac[i], qpc)
                d[0, 0] = dc_rec[by4 // 4, bx4 // 4]
                res[by4:by4 + 4, bx4:bx4 + 4] = T.np_inverse_transform_4x4(d)
            plane_r[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred + res, 0, 255)


def encode_stream(frames, width, height, qp=28, disable_deblock=False) -> bytes:
    """Convenience: list of (Y,U,V) uint8 frames -> Annex-B IDR-only stream."""
    enc = H264ReferenceEncoder(EncoderConfig(width, height, qp=qp,
                                             disable_deblock=disable_deblock))
    out = enc.headers_annexb()
    recons = []
    for (Y, U, V) in frames:
        out += enc.encode_idr(np.asarray(Y, np.int32), np.asarray(U, np.int32),
                              np.asarray(V, np.int32))
        recons.append(enc.recon_cropped())
    return out, recons
