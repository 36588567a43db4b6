"""Pure-numpy H.264 decoder: the session's host path (api/session.py) for
the pictures the device path does not take (B slices, the 8x8 transform,
PCM, MMCO, reordered streams), and a CPU oracle.

Pipeline per frame: parse slice(s) -> per-MB recon on the *unfiltered*
frame -> deblocking pass -> output. Exposes decoded symbol planes
(FrameSymbols) filled by the same entropy front end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...ops import deblock as DB
from ...ops import intra as IP
from ...ops import transform as T
from ...utils.bits import BitReader
from ...ops import mc as MC
from . import inter as INTER
from . import macroblock as MB
from . import nal
from .params import PPS, SPS, parse_pps, parse_sps
from .slicehdr import SLICE_B, SLICE_I, SLICE_P, parse_slice_header
from .symbols import (MBCLASS_I4x4, MBCLASS_I16x16, MBCLASS_IPCM,
                      FrameSymbols)


def scan8x8_to_raster(scan: List[int]) -> np.ndarray:
    """64 scan-order levels -> 8x8 raster block."""
    flat = np.zeros(64, np.int32)
    flat[T.ZIGZAG8x8] = np.asarray(scan[:64], np.int32)
    return flat.reshape(8, 8)


def recon_i8_block(Y: np.ndarray, g: MB.MBGrids, my: int, mx: int,
                   b8: int, mode: int, resid: np.ndarray,
                   cur_slice: int) -> None:
    """Reconstruct one intra 8x8 luma block (High profile, spec 8.3.2.2)."""
    x = mx * 16 + (b8 & 1) * 8
    y = my * 16 + (b8 >> 1) * 8
    avail_l = True if (b8 & 1) else g.mb_available(my, mx - 1, cur_slice)
    avail_t = True if (b8 >> 1) else g.mb_available(my - 1, mx, cur_slice)
    if b8 == 0:
        avail_tl = g.mb_available(my - 1, mx - 1, cur_slice)
        avail_tr = g.mb_available(my - 1, mx, cur_slice)
    elif b8 == 1:
        avail_tl = g.mb_available(my - 1, mx, cur_slice)
        avail_tr = g.mb_available(my - 1, mx + 1, cur_slice)
    elif b8 == 2:
        avail_tl = g.mb_available(my, mx - 1, cur_slice)
        avail_tr = True       # bottom row of blk 1, already decoded
    else:
        avail_tl = True
        avail_tr = False      # right MB not yet decoded
    t16 = np.zeros(16, np.int32)
    l8 = np.zeros(8, np.int32)
    tl = 0
    if avail_t:
        t16[:8] = Y[y - 1, x:x + 8]
        if avail_tr:
            t16[8:] = Y[y - 1, x + 8:x + 16]
        else:
            t16[8:] = t16[7]
    if avail_l:
        l8[:] = Y[y:y + 8, x - 1]
    if avail_tl:
        tl = int(Y[y - 1, x - 1])
    pred = IP.pred8x8(mode, t16, l8, tl, avail_t, avail_l, avail_tl)
    Y[y:y + 8, x:x + 8] = np.clip(pred + resid, 0, 255)


def suppress_t8_inner_edges(bs_v: np.ndarray, bs_h: np.ndarray,
                            t8: np.ndarray) -> None:
    """Zero bS on the non-8x8-aligned internal luma edges of 8x8-transform
    MBs (8.7: no filtering of 4x4 boundaries inside an 8x8 transform)."""
    t8blk = np.repeat(np.repeat(t8.astype(bool), 4, 0), 4, 1)
    gh, gw = t8blk.shape
    coloff = (np.arange(gw) % 4) % 2 == 1
    rowoff = (np.arange(gh) % 4) % 2 == 1
    bs_v[t8blk & coloff[None, :]] = 0
    bs_h[t8blk & rowoff[:, None]] = 0


def scan_to_raster4x4(scan: List[int], dc: Optional[int] = None) -> np.ndarray:
    """Scan-order coefficient list -> 4x4 raster block. If dc is given, the
    list holds 15 AC coefficients for scan positions 1..15."""
    flat = np.zeros(16, np.int32)
    if dc is None:
        flat[T.ZIGZAG4x4] = np.asarray(scan[:16], np.int32)
    else:
        flat[T.ZIGZAG4x4[1:]] = np.asarray(scan[:15], np.int32)
        flat[0] = dc
    return flat.reshape(4, 4)


def _tr_available(g: MB.MBGrids, my: int, mx: int, blk_idx: int,
                  by: int, bx: int, cur_slice: int) -> bool:
    """Top-right availability of luma 4x4 block (by,bx) = block blk_idx of MB
    (my,mx), following decode order (spec 6.4.11)."""
    nbx, nby = bx + 1, by - 1
    if nby < 0 or nbx >= g.mb_width * 4:
        return False
    nmy, nmx = nby // 4, nbx // 4
    if (nmy, nmx) == (my, mx):
        return blk_idx not in MB.TR_UNAVAILABLE_IN_MB
    return g.mb_available(nmy, nmx, cur_slice)


def recon_i4_block(Y: np.ndarray, g: MB.MBGrids, my: int, mx: int,
                   blk_idx: int, mode: int, resid: np.ndarray,
                   cur_slice: int) -> None:
    """Reconstruct one intra 4x4 luma block in place on the unfiltered frame."""
    x = mx * 16 + int(MB.BLK_X[blk_idx])
    y = my * 16 + int(MB.BLK_Y[blk_idx])
    by, bx = y // 4, x // 4
    # left/top neighbors inside the current MB precede this block in decode
    # order, so they are always available; across MB boundaries availability
    # follows the slice/decoded state.
    if bx == 0:
        avail_l = False
    elif (bx - 1) // 4 == mx:
        avail_l = True
    else:
        avail_l = g.mb_available(my, mx - 1, cur_slice)
    if by == 0:
        avail_t = False
    elif (by - 1) // 4 == my:
        avail_t = True
    else:
        avail_t = g.mb_available(my - 1, mx, cur_slice)
    avail_tr = _tr_available(g, my, mx, blk_idx, by, bx, cur_slice)

    t8 = np.zeros(8, np.int32)
    l4 = np.zeros(4, np.int32)
    tl = 0
    if avail_t:
        t8[:4] = Y[y - 1, x:x + 4]
        if avail_tr:
            t8[4:] = Y[y - 1, x + 4:x + 8]
        else:
            t8[4:] = t8[3]
    if avail_l:
        l4[:] = Y[y:y + 4, x - 1]
    if avail_t and avail_l:
        tl = int(Y[y - 1, x - 1])
    pred = IP.pred4x4(mode, t8, l4, tl, avail_t, avail_l)
    Y[y:y + 4, x:x + 4] = np.clip(pred + resid, 0, 255)


@dataclass
class DecodedFrame:
    Y: np.ndarray
    U: np.ndarray
    V: np.ndarray
    poc: int = 0
    frame_num: int = 0
    is_idr: bool = True
    qp_mb: Optional[np.ndarray] = None
    pre_deblock: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    symbols: Optional["FrameSymbols"] = None

    def crop(self, sps: SPS):
        w, h = sps.width, sps.height
        return (self.Y[:h, :w], self.U[:h // 2, :w // 2], self.V[:h // 2, :w // 2])


@dataclass
class RefPicture:
    """One DPB entry: deblocked planes + lazily padded MC references, plus
    POC and motion state (needed for B ref lists, spatial direct colZero and
    implicit weighted prediction)."""
    frame_num: int
    Y: np.ndarray
    U: np.ndarray
    V: np.ndarray
    poc: int = 0
    # motion of this picture's own decode (None for intra-only pictures)
    mot_ref0: Optional[np.ndarray] = None
    mot_mv0: Optional[np.ndarray] = None
    mot_ref1: Optional[np.ndarray] = None
    mot_mv1: Optional[np.ndarray] = None
    # POC identity of the pictures each block referenced (temporal direct)
    mot_refpic0: Optional[np.ndarray] = None
    mot_refpic1: Optional[np.ndarray] = None
    own_l0_poc0: int = 0   # POC of this picture's own RefPicList0[0]
    _padded: Optional[Tuple[np.ndarray, ...]] = None

    def padded(self):
        if self._padded is None:
            self._padded = (MC.pad_ref(self.Y), MC.pad_ref(self.U),
                            MC.pad_ref(self.V))
        return self._padded


class DPB:
    """Decoded picture buffer with sliding-window marking (no MMCO).
    The reference's vendor parser handled this internally; the display-order
    queue analog is nv_dec.cpp:113-186."""

    def __init__(self, max_refs: int = 16):
        self.max_refs = max_refs
        self.refs: List[RefPicture] = []

    def clear(self):
        self.refs = []

    def add(self, pic: RefPicture):
        self.refs.append(pic)
        while len(self.refs) > self.max_refs:
            self.refs.pop(0)

    def list0(self, cur_frame_num: int, max_frame_num: int) -> List[RefPicture]:
        """P ref list: descending PicNum (most recent first, wrap-aware)."""
        def dist(r):
            return (cur_frame_num - r.frame_num) % max_frame_num
        return sorted(self.refs, key=dist)

    def b_lists(self, cur_poc: int):
        """B default ref lists by POC (8.2.4.2.3): list0 = past(desc POC) +
        future(asc); list1 = future(asc) + past(desc); if identical and >1
        entry, swap list1's first two."""
        past = sorted([r for r in self.refs if r.poc <= cur_poc],
                      key=lambda r: -r.poc)
        future = sorted([r for r in self.refs if r.poc > cur_poc],
                        key=lambda r: r.poc)
        l0 = past + future
        l1 = future + past
        if len(l1) > 1 and l0 == l1:
            l1 = [l1[1], l1[0]] + l1[2:]
        return l0, l1


class H264ReferenceDecoder:
    """Stateful Annex-B decoder (Baseline/Main/High progressive).

    decode_annexb emits frames in DISPLAY order: decoded pictures sit in a
    bounded reorder buffer (depth = VUI num_reorder_frames when signalled,
    else a safe default) and are bumped lowest-POC-first — the display-order
    queue the reference got from the vendor parser's display callback
    (nv_dec/nv_dec.cpp:44-52,113-186). Call flush() at end of stream. Each
    frame is returned once; the decoder keeps none."""

    def __init__(self):
        self.sps: Dict[int, SPS] = {}
        self.pps: Dict[int, PPS] = {}
        self.dpb = DPB()
        # POC state (8.2.1)
        self._prev_poc_msb = 0
        self._prev_poc_lsb = 0
        self._prev_frame_num = 0
        self._frame_num_offset = 0
        # display reorder
        self._pending: List[DecodedFrame] = []

    def _compute_poc(self, hdr, sps: SPS) -> int:
        if sps.pic_order_cnt_type == 0:
            max_lsb = 1 << sps.log2_max_pic_order_cnt_lsb
            if hdr.is_idr:
                self._prev_poc_msb = 0
                self._prev_poc_lsb = 0
            lsb = hdr.pic_order_cnt_lsb
            if lsb < self._prev_poc_lsb and \
                    self._prev_poc_lsb - lsb >= max_lsb // 2:
                msb = self._prev_poc_msb + max_lsb
            elif lsb > self._prev_poc_lsb and \
                    lsb - self._prev_poc_lsb > max_lsb // 2:
                msb = self._prev_poc_msb - max_lsb
            else:
                msb = self._prev_poc_msb
            if hdr.nal_ref_idc:
                self._prev_poc_msb = msb
                self._prev_poc_lsb = lsb
            return msb + lsb
        if sps.pic_order_cnt_type == 2:
            max_fn = 1 << sps.log2_max_frame_num
            if hdr.is_idr:
                self._frame_num_offset = 0
            elif self._prev_frame_num > hdr.frame_num:
                self._frame_num_offset += max_fn
            self._prev_frame_num = hdr.frame_num
            n = self._frame_num_offset + hdr.frame_num
            return 2 * n if hdr.nal_ref_idc else 2 * n - 1
        raise NotImplementedError("pic_order_cnt_type 1")

    def _reorder_depth(self, sps: SPS) -> int:
        if sps.num_reorder_frames is not None:
            return sps.num_reorder_frames
        if sps.pic_order_cnt_type == 2:
            return 0   # poc type 2 forbids reordering by construction
        return max(1, sps.max_num_ref_frames)

    def _emit(self, frame: DecodedFrame, sps: SPS,
              out: List[DecodedFrame]) -> None:
        if frame.is_idr and self._pending:
            self._pending.sort(key=lambda f: f.poc)
            out.extend(self._pending)
            self._pending = []
        self._pending.append(frame)
        depth = self._reorder_depth(sps)
        while len(self._pending) > depth:
            i = min(range(len(self._pending)),
                    key=lambda k: self._pending[k].poc)
            out.append(self._pending.pop(i))

    def flush(self) -> List[DecodedFrame]:
        """Drain the reorder buffer (end of stream)."""
        self._pending.sort(key=lambda f: f.poc)
        out, self._pending = self._pending, []
        return out

    def decode_annexb(self, data: bytes) -> List[DecodedFrame]:
        out: List[DecodedFrame] = []
        slices = []
        for u in nal.parse_nal_units(data):
            if u.nal_unit_type == nal.NAL_SPS:
                s = parse_sps(u.rbsp)
                self.sps[s.seq_parameter_set_id] = s
            elif u.nal_unit_type == nal.NAL_PPS:
                p = parse_pps(u.rbsp)
                self.pps[p.pic_parameter_set_id] = p
            elif u.is_slice:
                slices.append(u)
        # group slices into pictures by first_mb_in_slice == 0 boundaries
        cur: List[nal.NalUnit] = []
        pics: List[List[nal.NalUnit]] = []
        for u in slices:
            r = BitReader(u.rbsp)
            first_mb = r.ue()
            if first_mb == 0 and cur:
                pics.append(cur)
                cur = []
            cur.append(u)
        if cur:
            pics.append(cur)
        for pic in pics:
            frame, sps = self.decode_picture(pic)
            self._emit(frame, sps, out)
        return out

    def decode_picture(self, units: List[nal.NalUnit]) -> DecodedFrame:
        # parse first slice header to size the frame
        h0, _ = parse_slice_header(units[0].rbsp,
                                   self._sps_for(units[0]), self._pps_for(units[0]),
                                   units[0].nal_unit_type, units[0].nal_ref_idc)
        pps = self.pps[h0.pic_parameter_set_id]
        sps = self.sps[pps.seq_parameter_set_id]
        mbw, mbh = sps.mb_width, sps.mb_height
        Y = np.zeros((mbh * 16, mbw * 16), np.int32)
        U = np.zeros((mbh * 8, mbw * 8), np.int32)
        V = np.zeros((mbh * 8, mbw * 8), np.int32)
        g = MB.MBGrids(mbw, mbh)
        m = INTER.MotionGrids(mbw, mbh)
        fs = FrameSymbols(mbw, mbh)
        deblock_params = []
        has_inter = False

        if h0.is_idr:
            self.dpb.clear()
        self.dpb.max_refs = max(1, sps.max_num_ref_frames)
        cur_poc = self._compute_poc(h0, sps)
        ref_list = self.dpb.list0(h0.frame_num, 1 << sps.log2_max_frame_num)
        bl0, bl1 = self.dpb.b_lists(cur_poc)
        has_b = False

        cstate = None
        if pps.entropy_coding_mode_flag:
            from .cabac import CabacMBState
            cstate = CabacMBState(mbw, mbh)
        for slice_idx, u in enumerate(units):
            hdr, r = parse_slice_header(u.rbsp, sps, pps, u.nal_unit_type,
                                        u.nal_ref_idc)
            refs = []
            bctx = None
            max_fn = 1 << sps.log2_max_frame_num
            if hdr.slice_type == SLICE_P:
                has_inter = True
                refs = self._modified_list(ref_list, hdr.ref_mods_l0,
                                           h0.frame_num, max_fn,
                                           hdr.num_ref_idx_active_l0)
                if not refs:
                    raise ValueError("P slice with empty reference list")
            elif hdr.slice_type == SLICE_B:
                has_inter = True
                has_b = True
                l0 = self._modified_list(bl0, hdr.ref_mods_l0, h0.frame_num,
                                         max_fn, hdr.num_ref_idx_active_l0)
                l1 = self._modified_list(bl1, hdr.ref_mods_l1, h0.frame_num,
                                         max_fn, hdr.num_ref_idx_active_l1)
                if not l0 or not l1:
                    raise ValueError("B slice with empty reference list")
                col = l1[0]
                col_motion = None
                col_refpic = None
                if col.mot_ref0 is not None:
                    col_motion = (col.mot_ref0, col.mot_mv0,
                                  col.mot_ref1, col.mot_mv1)
                    col_refpic = (col.mot_refpic0, col.mot_refpic1)
                bctx = (l0, l1, INTER.DirectCtx(
                    spatial=bool(hdr.direct_spatial_mv_pred_flag),
                    col_motion=col_motion, col_refpic=col_refpic,
                    col_intra_refpoc=col.own_l0_poc0, cur_poc=cur_poc,
                    l0_pocs=np.array([x.poc for x in l0], np.int32),
                    l1_pocs=np.array([x.poc for x in l1], np.int32)))
            if pps.entropy_coding_mode_flag:
                self._decode_slice_data_cabac(u.rbsp, r.pos, hdr, sps, pps,
                                              g, m, Y, U, V, slice_idx, refs,
                                              fs, cstate, bctx, cur_poc)
            elif hdr.slice_type == SLICE_I:
                self._decode_slice_data(r, hdr, sps, pps, g, Y, U, V,
                                        slice_idx, fs)
            elif hdr.slice_type == SLICE_P:
                self._decode_p_slice_data(r, hdr, sps, pps, g, m, Y, U, V,
                                          slice_idx, refs, fs)
            else:
                self._decode_b_slice_data(r, hdr, sps, pps, g, m, Y, U, V,
                                          slice_idx, bctx, cur_poc, fs)
            if hdr.slice_type == SLICE_P:
                # reference identity for deblock bS + temporal direct of
                # later pictures: per-slice (list mods make indices
                # slice-local)
                pocs = np.array([x.poc for x in refs] + [0], np.int32)
                blk_in_slice = np.repeat(np.repeat(
                    g.slice_id == slice_idx, 4, 0), 4, 1)
                mask = (m.ref >= 0) & blk_in_slice
                m.refpic0[mask] = pocs[m.ref[mask]]
            deblock_params.append(hdr)

        if len(deblock_params) > 1:
            # frame-level deblock uses the first slice's params; refuse to
            # emit wrong pixels when slices disagree or use idc==2
            # (no-filter-across-slice-boundaries), which the bS planes do not
            # model
            p0 = (deblock_params[0].disable_deblocking_filter_idc,
                  deblock_params[0].slice_alpha_c0_offset_div2,
                  deblock_params[0].slice_beta_offset_div2)
            for h in deblock_params:
                if ((h.disable_deblocking_filter_idc,
                     h.slice_alpha_c0_offset_div2,
                     h.slice_beta_offset_div2) != p0
                        or h.disable_deblocking_filter_idc == 2):
                    raise NotImplementedError(
                        "per-slice deblock params differ (or idc==2)")
        pre = (Y.copy(), U.copy(), V.copy())
        hdr = deblock_params[0]
        fs.fill_availability(g.slice_id)
        fs.frame_num = hdr.frame_num
        fs.is_idr = hdr.is_idr
        fs.nal_ref_idc = units[0].nal_ref_idc
        fs.max_num_ref_frames = sps.max_num_ref_frames
        fs.log2_max_frame_num = sps.log2_max_frame_num
        fs.deblock_enabled = hdr.disable_deblocking_filter_idc != 1
        fs.alpha_off = hdr.slice_alpha_c0_offset_div2 * 2
        fs.beta_off = hdr.slice_beta_offset_div2 * 2
        fs.chroma_qp_off = pps.chroma_qp_index_offset
        fs.second_chroma_qp_off = (pps.second_chroma_qp_index_offset
                                   if pps.second_chroma_qp_index_offset is not None
                                   else pps.chroma_qp_index_offset)
        if fs.deblock_enabled:
            if has_inter:
                bs_v, bs_h = compute_bs(g, m, b_aware=has_b)
            else:
                bs_v, bs_h = DB.intra_frame_bs(mbh, mbw)
            if g.t8.any():
                suppress_t8_inner_edges(bs_v, bs_h, g.t8)
            DB.deblock_frame(Y, U, V, g.qp, bs_v, bs_h,
                             alpha_off=fs.alpha_off, beta_off=fs.beta_off,
                             chroma_qp_off=pps.chroma_qp_index_offset,
                             second_chroma_qp_off=pps.second_chroma_qp_index_offset)
        frame = DecodedFrame(
            Y=Y.astype(np.uint8), U=U.astype(np.uint8), V=V.astype(np.uint8),
            frame_num=hdr.frame_num, is_idr=hdr.is_idr, qp_mb=g.qp.copy(),
            pre_deblock=pre, symbols=fs, poc=cur_poc)
        if units[0].nal_ref_idc != 0:
            for (op, v1, v2) in h0.mmco_ops:
                if op == 1:
                    # mark short-term picture unused (8.2.5.4.1); PicNum of
                    # a stored frame wraps below CurrPicNum (= frame_num)
                    pic_num_x = h0.frame_num - (v1 + 1)
                    max_fn = 1 << sps.log2_max_frame_num
                    self.dpb.refs = [
                        p for p in self.dpb.refs
                        if (p.frame_num - max_fn
                            if p.frame_num > h0.frame_num
                            else p.frame_num) != pic_num_x]
                else:
                    raise NotImplementedError(f"MMCO op {op}")
            own_l0 = (bl0 if has_b else ref_list)
            self.dpb.add(RefPicture(
                hdr.frame_num, Y.copy(), U.copy(), V.copy(), poc=cur_poc,
                mot_ref0=m.ref.copy() if has_inter else None,
                mot_mv0=m.mv.copy() if has_inter else None,
                mot_ref1=m.ref1.copy() if has_inter else None,
                mot_mv1=m.mv1.copy() if has_inter else None,
                mot_refpic0=m.refpic0.copy() if has_inter else None,
                mot_refpic1=m.refpic1.copy() if has_inter else None,
                own_l0_poc0=own_l0[0].poc if own_l0 else 0))
        return frame, sps

    def _sps_for(self, u: nal.NalUnit) -> SPS:
        # slice header parsing needs sps/pps; peek pps id quickly
        r = BitReader(u.rbsp)
        r.ue()  # first_mb
        r.ue()  # slice_type
        pps_id = r.ue()
        return self.sps[self.pps[pps_id].seq_parameter_set_id]

    def _pps_for(self, u: nal.NalUnit) -> PPS:
        r = BitReader(u.rbsp)
        r.ue()
        r.ue()
        return self.pps[r.ue()]

    def _decode_slice_data(self, r: BitReader, hdr, sps: SPS, pps: PPS,
                           g: MB.MBGrids, Y, U, V, slice_idx: int,
                           fs: Optional[FrameSymbols] = None) -> None:
        mbw = sps.mb_width
        qp = pps.pic_init_qp + hdr.slice_qp_delta
        addr = hdr.first_mb_in_slice
        while True:
            my, mx = divmod(addr, mbw)
            if my >= sps.mb_height:
                raise ValueError("MB address out of range")
            mb_type = r.ue()
            s = MB.parse_i_macroblock(r, g, my, mx, slice_idx, qp, mb_type,
                                      bool(pps.transform_8x8_mode_flag))
            qp = s.qp
            reconstruct_intra_mb(Y, U, V, g, my, mx, slice_idx, s, pps)
            if fs is not None:
                fill_mb_symbols(fs, my, mx, s)
            addr += 1
            if not r.more_rbsp_data():
                break

    def _modified_list(self, default, ops, cur_frame_num: int, max_fn: int,
                       num_active: int):
        """Apply ref_pic_list_modification (8.2.4.3.1, short-term only) and
        trim to num_ref_idx_active."""
        lst = list(default)
        if ops:
            idx = 0
            pred = cur_frame_num
            for idc, val in ops:
                if idc == 2:
                    raise NotImplementedError("long-term ref modification")
                if idc == 0:
                    nw = pred - (val + 1)
                    if nw < 0:
                        nw += max_fn
                else:
                    nw = pred + (val + 1)
                    if nw >= max_fn:
                        nw -= max_fn
                pred = nw
                pic_num = nw - max_fn if nw > cur_frame_num else nw
                pic = None
                for p in self.dpb.refs:
                    pn = p.frame_num - max_fn \
                        if p.frame_num > cur_frame_num else p.frame_num
                    if pn == pic_num:
                        pic = p
                        break
                if pic is None:
                    raise ValueError("ref modification: picture not in DPB")
                lst.insert(idx, pic)
                idx += 1
                for i in range(idx, len(lst)):
                    if lst[i] is pic:
                        del lst[i]
                        break
        return lst[:num_active]

    def _decode_b_slice_data(self, r: BitReader, hdr, sps: SPS, pps: PPS,
                             g: MB.MBGrids, m: INTER.MotionGrids,
                             Y, U, V, slice_idx: int, bctx, cur_poc: int,
                             fs: Optional[FrameSymbols] = None) -> None:
        """B slice_data, CAVLC (7.3.4 with B_Skip runs)."""
        l0, l1, direct_ctx = bctx
        mbw = sps.mb_width
        n_mbs = mbw * sps.mb_height
        qp = pps.pic_init_qp + hdr.slice_qp_delta
        addr = hdr.first_mb_in_slice
        wbp = pps.weighted_bipred_idc
        wp = _hdr_weights(hdr)
        while True:
            skip_run = r.ue()
            for _ in range(skip_run):
                if addr >= n_mbs:
                    raise ValueError("skip run past end of picture")
                my, mx = divmod(addr, mbw)
                s = INTER.apply_direct(g, m, my, mx, slice_idx, qp,
                                       direct_ctx, True)
                reconstruct_b_mb(Y, U, V, g, my, mx, slice_idx, s, l0, l1,
                                 pps, cur_poc, wbp, wp=wp)
                if fs is not None:
                    fill_mb_symbols(fs, my, mx, s, motion=m)
                addr += 1
            if not r.more_rbsp_data():
                break
            my, mx = divmod(addr, mbw)
            mb_type = r.ue()
            s = INTER.parse_b_macroblock(r, g, m, my, mx, slice_idx, qp,
                                         mb_type,
                                         hdr.num_ref_idx_active_l0,
                                         hdr.num_ref_idx_active_l1,
                                         direct_ctx,
                                         bool(pps.transform_8x8_mode_flag))
            qp = s.qp
            if s.mb_class == INTER.MB_B:
                reconstruct_b_mb(Y, U, V, g, my, mx, slice_idx, s, l0, l1,
                                 pps, cur_poc, wbp, wp=wp)
            else:
                reconstruct_intra_mb(Y, U, V, g, my, mx, slice_idx, s, pps)
            if fs is not None:
                fill_mb_symbols(fs, my, mx, s,
                                motion=m if s.mb_class == INTER.MB_B else None)
            addr += 1
            if not r.more_rbsp_data():
                break

    def _decode_slice_data_cabac(self, rbsp: bytes, bit_pos: int, hdr,
                                 sps: SPS, pps: PPS, g: MB.MBGrids,
                                 m: "INTER.MotionGrids", Y, U, V,
                                 slice_idx: int, refs, fs, cstate,
                                 bctx=None, cur_poc: int = 0) -> None:
        """CABAC slice_data (7.3.4 ae(v) branch): per-MB mb_skip_flag (P),
        macroblock layer, end_of_slice_flag."""
        from .cabac import CabacSliceDecoder
        cd = CabacSliceDecoder(rbsp, bit_pos, hdr, sps, pps, g, m, cstate,
                               bctx=bctx)
        mbw = sps.mb_width
        n_mbs = mbw * sps.mb_height
        qp = pps.pic_init_qp + hdr.slice_qp_delta
        addr = hdr.first_mb_in_slice
        is_p = hdr.slice_type == SLICE_P
        is_b = hdr.slice_type == SLICE_B
        if is_b:
            l0, l1, direct_ctx = bctx
            wbp = pps.weighted_bipred_idc
        wp = _hdr_weights(hdr)
        while True:
            if addr >= n_mbs:
                raise ValueError("MB address out of range")
            my, mx = divmod(addr, mbw)
            if (is_p or is_b) and cd.mb_skip_flag(my, mx, slice_idx,
                                                  base=24 if is_b else 11):
                if is_b:
                    s = cd.apply_b_skip(my, mx, slice_idx, qp)
                else:
                    s = cd.apply_skip(my, mx, slice_idx, qp)
            elif is_b:
                s = cd.parse_b_mb_body(my, mx, slice_idx, qp, cd.b_mbtype(
                    my, mx, slice_idx))
                qp = s.qp
            elif is_p:
                s = cd.parse_p_mb_body(my, mx, slice_idx, qp, cd.p_mbtype())
                qp = s.qp
            else:
                s = cd.parse_intra_mb_body(my, mx, slice_idx, qp,
                                           cd.i_mbtype(my, mx, slice_idx))
                qp = s.qp
            if s.mb_class == INTER.MB_B:
                reconstruct_b_mb(Y, U, V, g, my, mx, slice_idx, s, l0, l1,
                                 pps, cur_poc, wbp, wp=wp)
            elif s.mb_class == INTER.MB_P:
                reconstruct_inter_mb(Y, U, V, g, my, mx, slice_idx, s, refs,
                                     pps, wp=wp)
            else:
                reconstruct_intra_mb(Y, U, V, g, my, mx, slice_idx, s, pps)
            if fs is not None:
                fill_mb_symbols(fs, my, mx, s,
                                motion=m if s.mb_class in (INTER.MB_P,
                                                           INTER.MB_B)
                                else None)
            addr += 1
            if cd.end_of_slice():
                break

    def _decode_p_slice_data(self, r: BitReader, hdr, sps: SPS, pps: PPS,
                             g: MB.MBGrids, m: INTER.MotionGrids,
                             Y, U, V, slice_idx: int, refs,
                             fs: Optional[FrameSymbols] = None) -> None:
        mbw = sps.mb_width
        n_mbs = mbw * sps.mb_height
        qp = pps.pic_init_qp + hdr.slice_qp_delta
        addr = hdr.first_mb_in_slice
        num_ref = hdr.num_ref_idx_active_l0
        wp = _hdr_weights(hdr)
        while True:
            skip_run = r.ue()
            for _ in range(skip_run):
                if addr >= n_mbs:
                    raise ValueError("skip run past end of picture")
                my, mx = divmod(addr, mbw)
                s = INTER.apply_skip(g, m, my, mx, slice_idx, qp)
                reconstruct_inter_mb(Y, U, V, g, my, mx, slice_idx, s, refs,
                                     pps, wp=wp)
                if fs is not None:
                    fill_mb_symbols(fs, my, mx, s, motion=m)
                addr += 1
            if not r.more_rbsp_data():
                break
            my, mx = divmod(addr, mbw)
            mb_type = r.ue()
            s = INTER.parse_p_macroblock(r, g, m, my, mx, slice_idx, qp,
                                         mb_type, num_ref,
                                         bool(pps.transform_8x8_mode_flag))
            qp = s.qp
            if s.mb_class == INTER.MB_P:
                reconstruct_inter_mb(Y, U, V, g, my, mx, slice_idx, s, refs,
                                     pps, wp=wp)
            else:
                reconstruct_intra_mb(Y, U, V, g, my, mx, slice_idx, s, pps)
            if fs is not None:
                fill_mb_symbols(fs, my, mx, s, motion=m)
            addr += 1
            if not r.more_rbsp_data():
                break


def fill_mb_symbols(fs: FrameSymbols, my: int, mx: int, s: MB.MBSymbols,
                    motion: Optional["INTER.MotionGrids"] = None) -> None:
    """Record one parsed MB into the dense symbol planes."""
    fs.qp[my, mx] = s.qp
    if getattr(s, "transform8x8", 0):
        # 8x8 residuals have no dense-plane form yet; flag the frame so the
        # device path defers to host recon
        fs.has_t8 = True
    if s.mb_class == INTER.MB_B:
        # bipred/two-list motion has no dense-plane form (the device path
        # has no B recon); record the class + flag and stop
        fs.mb_class[my, mx] = 4
        fs.has_b = True
        return
    if s.mb_class == INTER.MB_P:
        fs.mb_class[my, mx] = 3
        if fs.mv is None:
            fs.mv = np.zeros((fs.mb_height * 4, fs.mb_width * 4, 2), np.int32)
            fs.ref = np.full((fs.mb_height * 4, fs.mb_width * 4), -1, np.int32)
        sl = (slice(my * 4, my * 4 + 4), slice(mx * 4, mx * 4 + 4))
        fs.mv[sl] = motion.mv[sl]
        fs.ref[sl] = motion.ref[sl]
        for i in range(16):
            bx = mx * 4 + int(MB.BLK_X[i]) // 4
            by = my * 4 + int(MB.BLK_Y[i]) // 4
            fs.luma_coeffs[by, bx] = scan_to_raster4x4(s.luma_ac[i])
        for comp in range(2):
            fs.chroma_dc[comp, my, mx] = np.asarray(
                s.chroma_dc[comp], np.int32).reshape(2, 2)
            for i in range(4):
                bx = mx * 2 + int(MB.CBLK_X[i]) // 4
                by = my * 2 + int(MB.CBLK_Y[i]) // 4
                fs.chroma_coeffs[comp, by, bx] = scan_to_raster4x4(
                    list(s.chroma_ac[comp][i]), dc=0)
        return
    if s.mb_class == MB.MB_IPCM:
        fs.mb_class[my, mx] = MBCLASS_IPCM
        fs.has_pcm = True
        if fs.pcm_y is None:
            fs.pcm_y = np.zeros((fs.mb_height * 16, fs.mb_width * 16), np.int32)
            fs.pcm_u = np.zeros((fs.mb_height * 8, fs.mb_width * 8), np.int32)
            fs.pcm_v = np.zeros((fs.mb_height * 8, fs.mb_width * 8), np.int32)
        fs.pcm_y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = np.frombuffer(
            s.pcm_luma, np.uint8).reshape(16, 16)
        fs.pcm_u[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.frombuffer(
            s.pcm_chroma[:64], np.uint8).reshape(8, 8)
        fs.pcm_v[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.frombuffer(
            s.pcm_chroma[64:], np.uint8).reshape(8, 8)
        return
    is16 = s.mb_class == MB.MB_I16x16
    fs.mb_class[my, mx] = MBCLASS_I16x16 if is16 else MBCLASS_I4x4
    fs.i16_mode[my, mx] = s.i16_mode
    fs.chroma_mode[my, mx] = s.chroma_mode
    for i in range(16):
        bx = mx * 4 + int(MB.BLK_X[i]) // 4
        by = my * 4 + int(MB.BLK_Y[i]) // 4
        if is16:
            fs.luma_coeffs[by, bx] = scan_to_raster4x4(s.luma_ac[i], dc=0)
            fs.i4_modes[by, bx] = 0
        else:
            fs.luma_coeffs[by, bx] = scan_to_raster4x4(s.luma_ac[i])
            fs.i4_modes[by, bx] = s.i4_modes[i]
    if is16:
        fs.luma_dc[my, mx] = scan_to_raster4x4(s.luma_dc)
    for comp in range(2):
        fs.chroma_dc[comp, my, mx] = np.asarray(
            s.chroma_dc[comp], np.int32).reshape(2, 2)
        for i in range(4):
            bx = mx * 2 + int(MB.CBLK_X[i]) // 4
            by = my * 2 + int(MB.CBLK_Y[i]) // 4
            fs.chroma_coeffs[comp, by, bx] = scan_to_raster4x4(
                list(s.chroma_ac[comp][i]), dc=0)


def reconstruct_inter_mb(Y, U, V, g: MB.MBGrids, my: int, mx: int,
                         cur_slice: int, s, refs, pps: PPS,
                         wp=None) -> None:
    """Reconstruct one P macroblock: MC prediction + residual. wp is the
    _hdr_weights tuple when the slice uses explicit weighted prediction."""
    x0, y0 = mx * 16, my * 16
    predY = np.zeros((16, 16), np.int32)
    predU = np.zeros((8, 8), np.int32)
    predV = np.zeros((8, 8), np.int32)
    for part in s.partitions:
        ref = refs[part.ref_idx]
        pY, pU, pV = ref.padded()
        lx = part.bx * 4
        ly = part.by * 4
        w = part.w4 * 4
        h = part.h4 * 4
        blk = MC.mc_luma_block(pY, lx, ly, int(part.mv[0]), int(part.mv[1]),
                               w, h)
        cx, cy = part.bx * 2, part.by * 2
        cw, ch = part.w4 * 2, part.h4 * 2
        cu = MC.mc_chroma_block(pU, cx, cy, int(part.mv[0]), int(part.mv[1]),
                                cw, ch)
        cv = MC.mc_chroma_block(pV, cx, cy, int(part.mv[0]), int(part.mv[1]),
                                cw, ch)
        if wp is not None:
            ld, cd, wl0, _ = wp
            wy, oy, wcb, ocb, wcr, ocr = wl0[part.ref_idx]
            blk = _weight_block(blk, wy, oy, ld)
            cu = _weight_block(cu, wcb, ocb, cd)
            cv = _weight_block(cv, wcr, ocr, cd)
        predY[ly - y0:ly - y0 + h, lx - x0:lx - x0 + w] = blk
        predU[cy - my * 8:cy - my * 8 + ch, cx - mx * 8:cx - mx * 8 + cw] = cu
        predV[cy - my * 8:cy - my * 8 + ch, cx - mx * 8:cx - mx * 8 + cw] = cv

    qp = s.qp
    mbres = np.zeros((16, 16), np.int32)
    if s.cbp_luma and s.transform8x8:
        for b8 in range(4):
            if s.cbp_luma & (1 << b8):
                x8, y8 = (b8 & 1) * 8, (b8 >> 1) * 8
                d = T.np_dequant_8x8(scan8x8_to_raster(s.luma8x8[b8]), qp)
                mbres[y8:y8 + 8, x8:x8 + 8] = T.np_inverse_transform_8x8(d)
    elif s.cbp_luma:
        for i in range(16):
            if s.cbp_luma & (1 << (i >> 2)):
                bx4, by4 = int(MB.BLK_X[i]), int(MB.BLK_Y[i])
                blk = scan_to_raster4x4(s.luma_ac[i])
                d = T.np_dequant_4x4(blk, qp)
                mbres[by4:by4 + 4, bx4:bx4 + 4] = T.np_inverse_transform_4x4(d)
    Y[y0:y0 + 16, x0:x0 + 16] = np.clip(predY + mbres, 0, 255)

    for comp, (plane, pred) in ((0, (U, predU)), (1, (V, predV))):
        qpc = int(T.chroma_qp(qp, pps.chroma_qp_offset(comp)))
        res = np.zeros((8, 8), np.int32)
        if s.cbp_chroma:
            dc2 = np.asarray(s.chroma_dc[comp], np.int32).reshape(2, 2)
            dc_vals = T.np_chroma_dc_decode(dc2, qpc)
            for i in range(4):
                bx4, by4 = int(MB.CBLK_X[i]), int(MB.CBLK_Y[i])
                ac = scan_to_raster4x4(list(s.chroma_ac[comp][i]), dc=0)
                d = T.np_dequant_4x4(ac, qpc)
                d[0, 0] = dc_vals[by4 // 4, bx4 // 4]
                res[by4:by4 + 4, bx4:bx4 + 4] = T.np_inverse_transform_4x4(d)
        plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(pred + res, 0, 255)


def _cdiv(a: int, b: int) -> int:
    """C-style integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def implicit_weights(cur_poc: int, poc0: int, poc1: int):
    """Implicit weighted bipred factors (8.4.2.3.1, weighted_bipred_idc==2).
    Returns (w0, w1) with logWD=5 semantics: pred=(p0*w0+p1*w1+32)>>6."""
    if poc0 == poc1:
        return 32, 32
    tb = max(-128, min(127, cur_poc - poc0))
    td = max(-128, min(127, poc1 - poc0))
    tx = _cdiv(16384 + abs(td) // 2, td)
    dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
    w1 = dsf >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1


def _weight_block(blk, w: int, o: int, logwd: int):
    """Explicit uni-directional weighted sample (8.4.2.3.2)."""
    if logwd >= 1:
        v = ((blk * w + (1 << (logwd - 1))) >> logwd) + o
    else:
        v = blk * w + o
    return np.clip(v, 0, 255)


def _weight_bi(b0, b1, w0: int, o0: int, w1: int, o1: int, logwd: int):
    """Explicit bi-directional weighted sample (8.4.2.3.2)."""
    v = ((b0 * w0 + b1 * w1 + (1 << logwd)) >> (logwd + 1)) \
        + ((o0 + o1 + 1) >> 1)
    return np.clip(v, 0, 255)


def _hdr_weights(hdr):
    """(ld, cd, wl0, wl1) when the slice carries an explicit
    pred_weight_table, else None."""
    if hdr is None or hdr.weights_l0 is None:
        return None
    return (hdr.luma_log2_weight_denom, hdr.chroma_log2_weight_denom,
            hdr.weights_l0, hdr.weights_l1)


def _mc_part(part, refpic, use_l1: bool):
    """Motion-compensate one partition from one reference picture; returns
    (Yblk, Ublk, Vblk)."""
    pY, pU, pV = refpic.padded()
    mv = part.mv1 if use_l1 else part.mv
    lx, ly = part.bx * 4, part.by * 4
    w, h = part.w4 * 4, part.h4 * 4
    yb = MC.mc_luma_block(pY, lx, ly, int(mv[0]), int(mv[1]), w, h)
    cx, cy, cw, ch = part.bx * 2, part.by * 2, part.w4 * 2, part.h4 * 2
    ub = MC.mc_chroma_block(pU, cx, cy, int(mv[0]), int(mv[1]), cw, ch)
    vb = MC.mc_chroma_block(pV, cx, cy, int(mv[0]), int(mv[1]), cw, ch)
    return yb, ub, vb


def reconstruct_b_mb(Y, U, V, g: MB.MBGrids, my: int, mx: int,
                     cur_slice: int, s, list0, list1, pps: PPS,
                     cur_poc: int, weighted_bipred_idc: int,
                     wp=None) -> None:
    """Reconstruct one B macroblock: per-partition uni/bi prediction (with
    implicit or explicit weighting when configured) + shared residual
    path. wp is the _hdr_weights tuple for weighted_bipred_idc == 1."""
    x0, y0 = mx * 16, my * 16
    predY = np.zeros((16, 16), np.int32)
    predU = np.zeros((8, 8), np.int32)
    predV = np.zeros((8, 8), np.int32)
    for part in s.partitions:
        use0 = part.ref_idx >= 0
        use1 = part.ref_idx1 >= 0
        if use0:
            y0b, u0b, v0b = _mc_part(part, list0[part.ref_idx], False)
        if use1:
            y1b, u1b, v1b = _mc_part(part, list1[part.ref_idx1], True)
        if use0 and use1:
            if weighted_bipred_idc == 2:
                w0, w1 = implicit_weights(cur_poc, list0[part.ref_idx].poc,
                                          list1[part.ref_idx1].poc)
                yb = np.clip((y0b * w0 + y1b * w1 + 32) >> 6, 0, 255)
                ub = np.clip((u0b * w0 + u1b * w1 + 32) >> 6, 0, 255)
                vb = np.clip((v0b * w0 + v1b * w1 + 32) >> 6, 0, 255)
            elif weighted_bipred_idc == 1 and wp is not None:
                ld, cd, wl0, wl1 = wp
                e0 = wl0[part.ref_idx]
                e1 = wl1[part.ref_idx1]
                yb = _weight_bi(y0b, y1b, e0[0], e0[1], e1[0], e1[1], ld)
                ub = _weight_bi(u0b, u1b, e0[2], e0[3], e1[2], e1[3], cd)
                vb = _weight_bi(v0b, v1b, e0[4], e0[5], e1[4], e1[5], cd)
            else:
                yb = (y0b + y1b + 1) >> 1
                ub = (u0b + u1b + 1) >> 1
                vb = (v0b + v1b + 1) >> 1
        elif weighted_bipred_idc == 1 and wp is not None:
            ld, cd, wl0, wl1 = wp
            e = wl0[part.ref_idx] if use0 else wl1[part.ref_idx1]
            pb, cb_, cr_ = (y0b, u0b, v0b) if use0 else (y1b, u1b, v1b)
            yb = _weight_block(pb, e[0], e[1], ld)
            ub = _weight_block(cb_, e[2], e[3], cd)
            vb = _weight_block(cr_, e[4], e[5], cd)
        elif use0:
            yb, ub, vb = y0b, u0b, v0b
        else:
            yb, ub, vb = y1b, u1b, v1b
        ly, lx = part.by * 4 - y0, part.bx * 4 - x0
        predY[ly:ly + part.h4 * 4, lx:lx + part.w4 * 4] = yb
        cy, cx = part.by * 2 - my * 8, part.bx * 2 - mx * 8
        predU[cy:cy + part.h4 * 2, cx:cx + part.w4 * 2] = ub
        predV[cy:cy + part.h4 * 2, cx:cx + part.w4 * 2] = vb

    qp = s.qp
    mbres = np.zeros((16, 16), np.int32)
    if s.cbp_luma and s.transform8x8:
        for b8 in range(4):
            if s.cbp_luma & (1 << b8):
                x8, y8 = (b8 & 1) * 8, (b8 >> 1) * 8
                d = T.np_dequant_8x8(scan8x8_to_raster(s.luma8x8[b8]), qp)
                mbres[y8:y8 + 8, x8:x8 + 8] = T.np_inverse_transform_8x8(d)
    elif s.cbp_luma:
        for i in range(16):
            if s.cbp_luma & (1 << (i >> 2)):
                bx4, by4 = int(MB.BLK_X[i]), int(MB.BLK_Y[i])
                blk = scan_to_raster4x4(s.luma_ac[i])
                d = T.np_dequant_4x4(blk, qp)
                mbres[by4:by4 + 4, bx4:bx4 + 4] = T.np_inverse_transform_4x4(d)
    Y[y0:y0 + 16, x0:x0 + 16] = np.clip(predY + mbres, 0, 255)

    for comp, (plane, pred) in ((0, (U, predU)), (1, (V, predV))):
        qpc = int(T.chroma_qp(qp, pps.chroma_qp_offset(comp)))
        res = np.zeros((8, 8), np.int32)
        if s.cbp_chroma:
            dc2 = np.asarray(s.chroma_dc[comp], np.int32).reshape(2, 2)
            dc_vals = T.np_chroma_dc_decode(dc2, qpc)
            for i in range(4):
                bx4, by4 = int(MB.CBLK_X[i]), int(MB.CBLK_Y[i])
                ac = scan_to_raster4x4(list(s.chroma_ac[comp][i]), dc=0)
                d = T.np_dequant_4x4(ac, qpc)
                d[0, 0] = dc_vals[by4 // 4, bx4 // 4]
                res[by4:by4 + 4, bx4:bx4 + 4] = T.np_inverse_transform_4x4(d)
        plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(pred + res,
                                                              0, 255)


def compute_bs(g: MB.MBGrids, m: INTER.MotionGrids, b_aware: bool = False):
    """Boundary strengths for a frame with inter MBs (spec 8.7.2.1).

    Vectorized over the 4x4 grid: intra rules first, then coefficients, then
    motion differences. With b_aware, reference comparison is by PICTURE
    (refpic grids) over both lists, handling swapped-list equivalence."""
    gh, gw = g.nz_luma.shape
    mb_intra = (g.mb_class >= 0) & (g.mb_class != INTER.MB_P) & \
        (g.mb_class != INTER.MB_B)
    blk_intra = np.repeat(np.repeat(mb_intra, 4, 0), 4, 1)
    nzc = np.maximum(g.nz_luma, 0)
    if g.t8.any():
        # 8x8-transform MBs: "the 4x4 block has coefficients" means the
        # covering 8x8 block does (8.7.2.1 with transform_size_8x8_flag)
        agg = nzc.reshape(gh // 2, 2, gw // 2, 2).sum(axis=(1, 3))
        rep = np.repeat(np.repeat(agg, 2, 0), 2, 1)
        t8blk = np.repeat(np.repeat(g.t8.astype(bool), 4, 0), 4, 1)
        nzc = np.where(t8blk, rep, nzc)
    nz = nzc > 0

    def motion_differs(p_sl, q_sl):
        if not b_aware:
            mvd = (np.abs(m.mv[p_sl][..., 0] - m.mv[q_sl][..., 0]) >= 4) | \
                  (np.abs(m.mv[p_sl][..., 1] - m.mv[q_sl][..., 1]) >= 4)
            # compare reference PICTURES, not indices (8.7.2.1): x264's
            # weightp=2 duplicates a picture at two list indices
            refd = m.refpic0[p_sl] != m.refpic0[q_sl]
            return mvd | refd
        # B-aware: per block, used refs = {refpic0?, refpic1?}; compare as
        # picture sets, then mv per matched picture (either pairing when the
        # same picture is used twice)
        rp0, rp1 = m.refpic0[p_sl], m.refpic1[p_sl]
        rq0, rq1 = m.refpic0[q_sl], m.refpic1[q_sl]
        np0 = (rp0 != INTER.MotionGrids.NO_PIC).astype(np.int32) + \
              (rp1 != INTER.MotionGrids.NO_PIC).astype(np.int32)
        nq0 = (rq0 != INTER.MotionGrids.NO_PIC).astype(np.int32) + \
              (rq1 != INTER.MotionGrids.NO_PIC).astype(np.int32)
        count_diff = np0 != nq0
        # unordered set equality over (rp0, rp1) vs (rq0, rq1)
        same_straight = (rp0 == rq0) & (rp1 == rq1)
        same_cross = (rp0 == rq1) & (rp1 == rq0)
        set_diff = ~(same_straight | same_cross)

        mvp0, mvp1 = m.mv[p_sl], m.mv1[p_sl]
        mvq0, mvq1 = m.mv[q_sl], m.mv1[q_sl]

        def pair_far(a, b, used):
            d = (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
                (np.abs(a[..., 1] - b[..., 1]) >= 4)
            return d & used
        u0 = rp0 != INTER.MotionGrids.NO_PIC
        u1 = rp1 != INTER.MotionGrids.NO_PIC
        far_straight = pair_far(mvp0, mvq0, u0) | pair_far(mvp1, mvq1, u1)
        far_cross = pair_far(mvp0, mvq1, u0) | pair_far(mvp1, mvq0, u1)
        # spec: when both straight and cross picture-assignments are valid
        # (same picture twice), bS 1 only if BOTH pairings have a far mv
        mv_far = np.where(same_straight & same_cross,
                          far_straight & far_cross,
                          np.where(same_straight, far_straight, far_cross))
        return count_diff | set_diff | mv_far

    def edge_bs(p_sl, q_sl, mb_edge):
        intra_either = blk_intra[p_sl] | blk_intra[q_sl]
        bs = np.where(intra_either, np.where(mb_edge, 4, 3), 0)
        coeff = nz[p_sl] | nz[q_sl]
        inter_bs = np.where(coeff, 2,
                            np.where(motion_differs(p_sl, q_sl), 1, 0))
        return np.where(intra_either, bs, inter_bs)

    bs_v = np.zeros((gh, gw), np.int32)
    bs_h = np.zeros((gh, gw), np.int32)
    col_is_mb_edge = (np.arange(1, gw) % 4) == 0
    row_is_mb_edge = (np.arange(1, gh) % 4) == 0
    bs_v[:, 1:] = edge_bs((slice(None), slice(0, gw - 1)),
                          (slice(None), slice(1, gw)),
                          col_is_mb_edge[None, :])
    bs_h[1:, :] = edge_bs((slice(0, gh - 1), slice(None)),
                          (slice(1, gh), slice(None)),
                          row_is_mb_edge[:, None])
    return bs_v, bs_h


def reconstruct_intra_mb(Y, U, V, g: MB.MBGrids, my: int, mx: int,
                         cur_slice: int, s: MB.MBSymbols, pps: PPS) -> None:
    """Reconstruct one intra MB onto the unfiltered frame planes (int32)."""
    x0, y0 = mx * 16, my * 16
    if s.mb_class == MB.MB_IPCM:
        Y[y0:y0 + 16, x0:x0 + 16] = np.frombuffer(
            s.pcm_luma, np.uint8).reshape(16, 16)
        cb = np.frombuffer(s.pcm_chroma[:64], np.uint8).reshape(8, 8)
        cr = np.frombuffer(s.pcm_chroma[64:], np.uint8).reshape(8, 8)
        U[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = cb
        V[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = cr
        return

    qp = s.qp
    if s.mb_class == MB.MB_I4x4 and s.transform8x8:
        for b8 in range(4):
            if s.cbp_luma & (1 << b8):
                d = T.np_dequant_8x8(scan8x8_to_raster(s.luma8x8[b8]), qp)
                resid = T.np_inverse_transform_8x8(d)
            else:
                resid = np.zeros((8, 8), np.int32)
            recon_i8_block(Y, g, my, mx, b8, s.i8_modes[b8], resid, cur_slice)
    elif s.mb_class == MB.MB_I4x4:
        for i in range(16):
            blk = scan_to_raster4x4(s.luma_ac[i])
            d = T.np_dequant_4x4(blk, qp)
            resid = T.np_inverse_transform_4x4(d)
            recon_i4_block(Y, g, my, mx, i, s.i4_modes[i], resid, cur_slice)
    else:
        # I16x16: prediction over the whole MB from unfiltered neighbors
        avail_l = g.mb_available(my, mx - 1, cur_slice)
        avail_t = g.mb_available(my - 1, mx, cur_slice)
        t16 = Y[y0 - 1, x0:x0 + 16] if avail_t else np.zeros(16, np.int32)
        l16 = Y[y0:y0 + 16, x0 - 1] if avail_l else np.zeros(16, np.int32)
        tl = int(Y[y0 - 1, x0 - 1]) if (avail_t and avail_l) else 0
        pred = IP.pred16x16(s.i16_mode, t16, l16, tl, avail_t, avail_l)
        dc_blk = scan_to_raster4x4(s.luma_dc)
        dc_vals = T.np_luma_dc_decode(dc_blk, qp)  # [4,4] per-block DC
        mbres = np.zeros((16, 16), np.int32)
        for i in range(16):
            bx, by = int(MB.BLK_X[i]), int(MB.BLK_Y[i])
            ac = scan_to_raster4x4(s.luma_ac[i], dc=0)
            d = T.np_dequant_4x4(ac, qp)
            d[0, 0] = dc_vals[by // 4, bx // 4]
            mbres[by:by + 4, bx:bx + 4] = T.np_inverse_transform_4x4(d)
        Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + mbres, 0, 255)

    # chroma
    cx0, cy0 = mx * 8, my * 8
    avail_l = g.mb_available(my, mx - 1, cur_slice)
    avail_t = g.mb_available(my - 1, mx, cur_slice)
    for comp, plane in ((0, U), (1, V)):
        qpc = int(T.chroma_qp(qp, pps.chroma_qp_offset(comp)))
        t8 = plane[cy0 - 1, cx0:cx0 + 8] if avail_t else np.zeros(8, np.int32)
        l8 = plane[cy0:cy0 + 8, cx0 - 1] if avail_l else np.zeros(8, np.int32)
        tl = int(plane[cy0 - 1, cx0 - 1]) if (avail_t and avail_l) else 0
        pred = IP.pred_chroma8x8(s.chroma_mode, t8, l8, tl, avail_t, avail_l)
        dc2 = np.asarray(s.chroma_dc[comp], np.int32).reshape(2, 2)
        dc_vals = T.np_chroma_dc_decode(dc2, qpc)
        res = np.zeros((8, 8), np.int32)
        for i in range(4):
            bx, by = int(MB.CBLK_X[i]), int(MB.CBLK_Y[i])
            ac = scan_to_raster4x4(list(s.chroma_ac[comp][i]), dc=0)
            d = T.np_dequant_4x4(ac, qpc)
            d[0, 0] = dc_vals[by // 4, bx // 4]
            res[by:by + 4, bx:bx + 4] = T.np_inverse_transform_4x4(d)
        plane[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred + res, 0, 255)
