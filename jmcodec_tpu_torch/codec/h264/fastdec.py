"""Decode front end: Python header parsing + native (C++) slice-data
parsing -> FrameSymbols for the device reconstruction.

Covers I and P slices, CAVLC and CABAC; a P slice also fills the motion
grids (mv, ref), the explicit weights and the list-0 modifications. B
slices, the 8x8 transform, MMCO, per-slice deblocking control and slices
of one picture that differ in their reference lists or weights raise
NotImplementedError: the session (api/session.py) then decodes the
picture on the host (refdec.py), the stream entry points
(api/h264_intra.py, api/h264_inter.py) let it propagate.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ...utils.bits import BitReader
from ... import native
from . import nal
from .params import PPS, SPS, parse_pps, parse_sps
from .slicehdr import SLICE_I, SLICE_P, parse_slice_header
from .symbols import FrameSymbols


class FastH264Parser:
    """Annex-B -> FrameSymbols stream (I and P pictures), using the C++
    parser."""

    def __init__(self):
        self.sps: Dict[int, SPS] = {}
        self.pps: Dict[int, PPS] = {}
        native.get_lib()

    def parse_annexb(self, data: bytes) -> List[Tuple[FrameSymbols, SPS]]:
        pics: List[List[nal.NalUnit]] = []
        cur: List[nal.NalUnit] = []
        for u in nal.parse_nal_units(data):
            if u.nal_unit_type == nal.NAL_SPS:
                s = parse_sps(u.rbsp)
                self.sps[s.seq_parameter_set_id] = s
            elif u.nal_unit_type == nal.NAL_PPS:
                p = parse_pps(u.rbsp)
                self.pps[p.pic_parameter_set_id] = p
            elif u.is_slice:
                r = BitReader(u.rbsp)
                if r.ue() == 0 and cur:  # first_mb_in_slice == 0 -> new picture
                    pics.append(cur)
                    cur = []
                cur.append(u)
        if cur:
            pics.append(cur)
        return [self.parse_picture(p) for p in pics]

    def parse_picture(self, units: List[nal.NalUnit]) -> Tuple[FrameSymbols, SPS]:
        # headers via the Python syntax layer (tiny), slice_data via C++
        r0 = BitReader(units[0].rbsp)
        r0.ue()
        r0.ue()
        pps = self.pps[r0.ue()]
        sps = self.sps[pps.seq_parameter_set_id]
        mbw, mbh = sps.mb_width, sps.mb_height
        fs = FrameSymbols(mbw, mbh)
        parser = native.NativeSliceParser(mbw, mbh)
        hdr0 = wp0 = rm0 = None
        for slice_id, u in enumerate(units):
            hdr, r = parse_slice_header(u.rbsp, sps, pps, u.nal_unit_type,
                                        u.nal_ref_idc)
            if hdr.slice_type not in (SLICE_I, SLICE_P):
                raise NotImplementedError("B slices")
            cabac = bool(pps.entropy_coding_mode_flag)
            t8 = bool(pps.transform_8x8_mode_flag)
            if not cabac and hdr.slice_type == SLICE_I and t8:
                raise NotImplementedError("8x8 transform (native parser)")
            if hdr.mmco_ops or hdr.adaptive_ref_pic_marking_mode_flag:
                raise NotImplementedError("MMCO")
            if hdr0 is None:
                hdr0 = hdr
            elif len(units) > 1:
                # per-slice deblock control is not plumbed into the
                # frame-level deblock scan: decode it right or not at all
                cur = (hdr.disable_deblocking_filter_idc,
                       hdr.slice_alpha_c0_offset_div2,
                       hdr.slice_beta_offset_div2)
                ref = (hdr0.disable_deblocking_filter_idc,
                       hdr0.slice_alpha_c0_offset_div2,
                       hdr0.slice_beta_offset_div2)
                if cur != ref or hdr.disable_deblocking_filter_idc == 2:
                    raise NotImplementedError(
                        "per-slice deblock params differ (or idc==2)")
            if hdr.slice_type == SLICE_P:
                # the decode builds one reference list and one weight table
                # per picture: every P slice must carry the same
                rcur = (tuple(hdr.ref_mods_l0), hdr.num_ref_idx_active_l0)
                if rm0 is None:
                    rm0 = rcur
                elif rm0 != rcur:
                    raise NotImplementedError(
                        "per-slice ref list modifications differ")
                if hdr.weights_l0 is not None:
                    wcur = (hdr.luma_log2_weight_denom,
                            hdr.chroma_log2_weight_denom,
                            tuple(hdr.weights_l0))
                    if wp0 is None:
                        wp0 = wcur
                    elif wp0 != wcur:
                        raise NotImplementedError(
                            "per-slice pred_weight_tables differ")
                if cabac:
                    parser.parse_cabac_slice(
                        fs, u.rbsp, r.pos, hdr.first_mb_in_slice,
                        hdr.qp(pps), slice_id, True,
                        hdr.num_ref_idx_active_l0, t8, hdr.cabac_init_idc)
                else:
                    parser.parse_p_slice(
                        fs, u.rbsp, r.pos, hdr.first_mb_in_slice,
                        hdr.qp(pps), slice_id, hdr.num_ref_idx_active_l0, t8)
            elif cabac:
                parser.parse_cabac_slice(
                    fs, u.rbsp, r.pos, hdr.first_mb_in_slice, hdr.qp(pps),
                    slice_id, False, 1, t8, 0)
            else:
                parser.parse_slice(fs, u.rbsp, r.pos, hdr.first_mb_in_slice,
                                   hdr.qp(pps), slice_id)
        if rm0 is not None:
            fs.mv = parser.mv.copy()
            fs.ref = parser.ref.copy()
            if wp0 is not None:
                fs.wp = np.asarray(wp0[2], np.int32)
                fs.wp_logwd = (wp0[0], wp0[1])
            fs.ref_mods_l0 = list(rm0[0])
            fs.num_ref_l0 = rm0[1]
        fs.fill_availability(parser.slice_map)
        fs.frame_num = hdr0.frame_num
        fs.is_idr = hdr0.is_idr
        fs.nal_ref_idc = units[0].nal_ref_idc
        fs.max_num_ref_frames = sps.max_num_ref_frames
        fs.log2_max_frame_num = sps.log2_max_frame_num
        fs.deblock_enabled = hdr0.disable_deblocking_filter_idc != 1
        fs.alpha_off = hdr0.slice_alpha_c0_offset_div2 * 2
        fs.beta_off = hdr0.slice_beta_offset_div2 * 2
        fs.chroma_qp_off = pps.chroma_qp_index_offset
        fs.second_chroma_qp_off = (pps.second_chroma_qp_index_offset
                                   if pps.second_chroma_qp_index_offset is not None
                                   else pps.chroma_qp_index_offset)
        # decode order == display order is guaranteed for poc type 2
        fs.no_reorder = sps.pic_order_cnt_type == 2
        return fs, sps
