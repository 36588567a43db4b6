"""HEVC slice segment header (H.265 spec 7.3.6.1).

Covers I/P/B slices with short-term RPS (SPS-indexed or explicit),
ref-list counts, SAO/deblock controls, WPP entry points.  Host parse stage
of the decode pipeline (reference analog: the vendor parser's
picture-parameter callbacks, nv_dec/nv_dec.cpp:278-366).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...utils.bits import BitReader
from . import nal as HN
from .params import HevcPPS, HevcSPS, ShortTermRPS, parse_short_term_rps

B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


@dataclass
class HevcSliceHeader:
    nal_type: int = 0
    first_slice: int = 1
    dependent: int = 0
    segment_address: int = 0
    pps_id: int = 0
    slice_type: int = I_SLICE
    pic_output_flag: int = 1
    poc_lsb: int = 0
    rps: Optional[ShortTermRPS] = None
    num_ref_idx: List[int] = field(default_factory=lambda: [0, 0])
    ref_list_mod: List[Optional[List[int]]] = field(
        default_factory=lambda: [None, None])
    mvd_l1_zero: int = 0
    cabac_init_flag: int = 0
    collocated_from_l0: int = 1
    collocated_ref_idx: int = 0
    five_minus_max_num_merge_cand: int = 0
    # explicit weighted prediction (7.3.6.3); None = default prediction.
    # wp[lx][i] = (wY, oY, wCb, oCb, wCr, oCr); denoms in luma/chroma_denom
    luma_denom: int = 0
    chroma_denom: int = 0
    wp: Optional[List[List[tuple]]] = None
    qp: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    sao_luma: int = 0
    sao_chroma: int = 0
    temporal_mvp: int = 0
    deblocking_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: int = 1
    entry_points: List[int] = field(default_factory=list)
    data_bitpos: int = 0  # bit offset of slice data within the rbsp

    @property
    def is_irap(self) -> bool:
        return 16 <= self.nal_type <= 23

    @property
    def is_idr(self) -> bool:
        return self.nal_type in (HN.NAL_IDR_W_RADL, HN.NAL_IDR_N_LP)

    @property
    def init_type(self) -> int:
        """CABAC initType (9.3.2.2)."""
        if self.slice_type == I_SLICE:
            return 0
        if self.slice_type == P_SLICE:
            return 2 if self.cabac_init_flag else 1
        return 1 if self.cabac_init_flag else 2


def _parse_pred_weight_table(r: BitReader, h: HevcSliceHeader) -> None:
    """pred_weight_table (7.3.6.3), 4:2:0 (chroma always present)."""
    h.luma_denom = r.ue()
    h.chroma_denom = h.luma_denom + r.se()
    h.wp = [[], []]
    for lx in range(2 if h.slice_type == B_SLICE else 1):
        n = h.num_ref_idx[lx]
        lflags = [r.flag() for _ in range(n)]
        cflags = [r.flag() for _ in range(n)]
        for i in range(n):
            wy, oy = 1 << h.luma_denom, 0
            wcb = wcr = 1 << h.chroma_denom
            ocb = ocr = 0
            if lflags[i]:
                wy = (1 << h.luma_denom) + r.se()
                oy = r.se()
            if cflags[i]:
                out = []
                for _ in range(2):
                    w = (1 << h.chroma_denom) + r.se()
                    d = r.se()
                    o = max(-128, min(127, d - (
                        (128 * w) >> h.chroma_denom) + 128))
                    out.append((w, o))
                (wcb, ocb), (wcr, ocr) = out
            h.wp[lx].append((wy, oy, wcb, ocb, wcr, ocr))
    if h.slice_type != B_SLICE:
        h.wp.append([])


def parse_slice_header(rbsp: bytes, nal_type: int, sps: HevcSPS,
                       pps: HevcPPS) -> HevcSliceHeader:
    r = BitReader(rbsp)
    h = HevcSliceHeader(nal_type=nal_type)
    h.first_slice = r.flag()
    if 16 <= nal_type <= 23:  # IRAP
        r.flag()  # no_output_of_prior_pics
    h.pps_id = r.ue()
    ctb = 1 << sps.log2_ctb
    pic_w_ctbs = (sps.pic_width + ctb - 1) >> sps.log2_ctb
    pic_h_ctbs = (sps.pic_height + ctb - 1) >> sps.log2_ctb
    n_ctbs = pic_w_ctbs * pic_h_ctbs
    if not h.first_slice:
        if pps.dependent_slice_segments:
            h.dependent = r.flag()
        addr_bits = max(1, (n_ctbs - 1).bit_length())
        h.segment_address = r.u(addr_bits)
    if not h.dependent:
        for _ in range(pps.num_extra_slice_header_bits):
            r.flag()
        h.slice_type = r.ue()
        if pps.output_flag_present:
            h.pic_output_flag = r.flag()
        if sps.chroma_format_idc == 3:
            pass  # separate_colour_plane handled in SPS parse (rejected)
        if nal_type not in (HN.NAL_IDR_W_RADL, HN.NAL_IDR_N_LP):
            h.poc_lsb = r.u(sps.log2_max_poc_lsb)
            if r.flag():  # short_term_ref_pic_set_sps_flag
                if sps.num_short_term_rps > 1:
                    bits = (sps.num_short_term_rps - 1).bit_length()
                    idx = r.u(bits)
                else:
                    idx = 0
                h.rps = sps.short_term_rps[idx]
            else:
                h.rps = parse_short_term_rps(
                    r, sps.num_short_term_rps, sps.short_term_rps,
                    is_slice_header=True)
            if sps.long_term_ref_pics_present:
                raise NotImplementedError("HEVC long-term refs")
            if sps.temporal_mvp_enabled:
                h.temporal_mvp = r.flag()
        if sps.sao_enabled:
            h.sao_luma = r.flag()
            h.sao_chroma = r.flag()
        if h.slice_type in (P_SLICE, B_SLICE):
            h.num_ref_idx = [pps.num_ref_idx_l0_default,
                             pps.num_ref_idx_l1_default]
            if r.flag():  # num_ref_idx_active_override
                h.num_ref_idx[0] = r.ue() + 1
                if h.slice_type == B_SLICE:
                    h.num_ref_idx[1] = r.ue() + 1
            # ref_pic_lists_modification (7.3.6.2)
            npc = (sum(u for u in h.rps.used_s0) +
                   sum(u for u in h.rps.used_s1)) if h.rps else 0
            if getattr(pps, "lists_modification_present", 0) and npc > 1:
                for lx in range(2 if h.slice_type == B_SLICE else 1):
                    if r.flag():
                        bits = max(1, (npc - 1).bit_length())
                        h.ref_list_mod[lx] = [
                            r.u(bits) for _ in range(h.num_ref_idx[lx])]
            if h.slice_type == B_SLICE:
                h.mvd_l1_zero = r.flag()
            if pps.cabac_init_present:
                h.cabac_init_flag = r.flag()
            if h.temporal_mvp:
                if h.slice_type == B_SLICE:
                    h.collocated_from_l0 = r.flag()
                lx = 0 if h.collocated_from_l0 else 1
                if h.num_ref_idx[lx] > 1:
                    h.collocated_ref_idx = r.ue()
            if ((pps.weighted_pred and h.slice_type == P_SLICE) or
                    (pps.weighted_bipred and h.slice_type == B_SLICE)):
                _parse_pred_weight_table(r, h)
            h.five_minus_max_num_merge_cand = r.ue()
        h.qp = pps.init_qp + r.se()
        if pps.slice_chroma_qp_offsets_present:
            h.cb_qp_offset = r.se()
            h.cr_qp_offset = r.se()
        if pps.deblocking_filter_control_present and \
                pps.deblocking_filter_override_enabled and r.flag():
            h.deblocking_disabled = r.flag()
            if not h.deblocking_disabled:
                h.beta_offset_div2 = r.se()
                h.tc_offset_div2 = r.se()
        else:
            h.deblocking_disabled = pps.deblocking_filter_disabled
            h.beta_offset_div2 = pps.beta_offset_div2
            h.tc_offset_div2 = pps.tc_offset_div2
        if pps.loop_filter_across_slices and (
                h.sao_luma or h.sao_chroma or not h.deblocking_disabled):
            h.loop_filter_across_slices = r.flag()
        else:
            h.loop_filter_across_slices = pps.loop_filter_across_slices
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        n = r.ue()
        if n:
            ln = r.ue() + 1
            h.entry_points = [r.u(ln) + 1 for _ in range(n)]
            # store cumulative byte offsets into slice data
            for i in range(1, n):
                h.entry_points[i] += h.entry_points[i - 1]
    # no slice_segment_header_extension (pps flag parsed as 0)
    # byte_alignment()
    if not r.flag():
        raise ValueError("alignment_bit_equal_to_one missing")
    while not r.byte_aligned():
        if r.flag():
            raise ValueError("alignment_bit_equal_to_zero not zero")
    h.data_bitpos = (len(rbsp) * 8) - r.bits_left()
    return h
