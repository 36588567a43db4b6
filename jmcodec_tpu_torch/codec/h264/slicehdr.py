"""H.264 slice header parse/write (spec 7.3.3).

Scope: progressive frames, I/P/B slices, no FMO/ASO, no MMCO (sliding-window
ref marking), no ref-list modification beyond the default, no field coding.
These are exactly the operating points the reference's vendor paths exercised
(no-B default for QSV: intel_enc/intel_enc.cpp:533; NVENC allows B-frames via
frameIntervalP: nv_enc/nv_enc.cpp:527-528).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ...utils.bits import BitReader, BitWriter
from .params import PPS, SPS

SLICE_P = 0
SLICE_B = 1
SLICE_I = 2

_SLICE_NAME = {SLICE_P: "P", SLICE_B: "B", SLICE_I: "I"}


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = SLICE_I  # normalized to 0..4 range semantics (mod 5)
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    num_ref_idx_active_l0: int = 1
    num_ref_idx_active_l1: int = 1
    no_output_of_prior_pics_flag: int = 0
    long_term_reference_flag: int = 0
    adaptive_ref_pic_marking_mode_flag: int = 0
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    direct_spatial_mv_pred_flag: int = 1
    # ref_pic_list_modification ops: (idc, value) lists per list
    ref_mods_l0: List[Tuple[int, int]] = field(default_factory=list)
    ref_mods_l1: List[Tuple[int, int]] = field(default_factory=list)
    # MMCO ops: (op, val1, val2)
    mmco_ops: List[Tuple[int, int, int]] = field(default_factory=list)
    # explicit weighted prediction (pred_weight_table, 7.3.3.2); None when
    # the table is absent. weights_l*[i] = (wY, oY, wCb, oCb, wCr, oCr).
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    weights_l0: Optional[List[Tuple[int, int, int, int, int, int]]] = None
    weights_l1: Optional[List[Tuple[int, int, int, int, int, int]]] = None
    # derived / context
    is_idr: bool = False
    nal_ref_idc: int = 1

    @property
    def slice_type_name(self) -> str:
        return _SLICE_NAME[self.slice_type]

    def qp(self, pps: PPS) -> int:
        return pps.pic_init_qp + self.slice_qp_delta


def _parse_weight_list(r: BitReader, n: int, ld: int, cd: int):
    """One list's pred_weight_table entries (7.3.3.2)."""
    out = []
    for _ in range(n):
        wy, oy = 1 << ld, 0
        if r.flag():                       # luma_weight_lX_flag
            wy, oy = r.se(), r.se()
        wcb = wcr = 1 << cd
        ocb = ocr = 0
        if r.flag():                       # chroma_weight_lX_flag
            wcb, ocb = r.se(), r.se()
            wcr, ocr = r.se(), r.se()
        out.append((wy, oy, wcb, ocb, wcr, ocr))
    return out


def _write_weight_list(w: BitWriter, entries, ld: int, cd: int) -> None:
    for (wy, oy, wcb, ocb, wcr, ocr) in entries:
        explicit_y = not (wy == (1 << ld) and oy == 0)
        w.flag(explicit_y)
        if explicit_y:
            w.se(wy)
            w.se(oy)
        explicit_c = not (wcb == (1 << cd) and ocb == 0
                          and wcr == (1 << cd) and ocr == 0)
        w.flag(explicit_c)
        if explicit_c:
            w.se(wcb)
            w.se(ocb)
            w.se(wcr)
            w.se(ocr)


def _parse_ref_mods(r: BitReader):
    ops = []
    while True:
        idc = r.ue()
        if idc == 3:
            return ops
        if idc > 3:
            raise ValueError("bad modification_of_pic_nums_idc")
        ops.append((idc, r.ue()))
        if len(ops) > 64:
            raise ValueError("ref list modification runaway")


def parse_slice_header(rbsp: bytes, sps: SPS, pps: PPS, nal_unit_type: int,
                       nal_ref_idc: int) -> tuple:
    """Parse a slice header; returns (SliceHeader, BitReader positioned at slice_data)."""
    r = BitReader(rbsp)
    h = SliceHeader()
    h.is_idr = nal_unit_type == 5
    h.nal_ref_idc = nal_ref_idc
    h.first_mb_in_slice = r.ue()
    st = r.ue()
    h.slice_type = st % 5
    if h.slice_type not in (SLICE_P, SLICE_B, SLICE_I):
        raise NotImplementedError(f"slice_type {st} not supported")
    h.pic_parameter_set_id = r.ue()
    h.frame_num = r.u(sps.log2_max_frame_num)
    if not sps.frame_mbs_only_flag:
        raise NotImplementedError("field slices")
    if h.is_idr:
        h.idr_pic_id = r.ue()
    if sps.pic_order_cnt_type == 0:
        h.pic_order_cnt_lsb = r.u(sps.log2_max_pic_order_cnt_lsb)
        if pps.bottom_field_pic_order_in_frame_present_flag:
            r.se()  # delta_pic_order_cnt_bottom
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero_flag:
        r.se()
        if pps.bottom_field_pic_order_in_frame_present_flag:
            r.se()
    if pps.redundant_pic_cnt_present_flag:
        r.ue()
    if h.slice_type == SLICE_B:
        h.direct_spatial_mv_pred_flag = r.flag()
    if h.slice_type in (SLICE_P, SLICE_B):
        num_ref_idx_active_override_flag = r.flag()
        if num_ref_idx_active_override_flag:
            h.num_ref_idx_active_l0 = r.ue() + 1
            if h.slice_type == SLICE_B:
                h.num_ref_idx_active_l1 = r.ue() + 1
        else:
            h.num_ref_idx_active_l0 = pps.num_ref_idx_l0_default_active
            h.num_ref_idx_active_l1 = pps.num_ref_idx_l1_default_active
        # ref_pic_list_modification (7.3.3.1)
        if r.flag():  # ref_pic_list_modification_flag_l0
            h.ref_mods_l0 = _parse_ref_mods(r)
        if h.slice_type == SLICE_B and r.flag():
            h.ref_mods_l1 = _parse_ref_mods(r)
    if (pps.weighted_pred_flag and h.slice_type == SLICE_P) or (
            pps.weighted_bipred_idc == 1 and h.slice_type == SLICE_B):
        # pred_weight_table (7.3.3.2): x264 enables weightp by default,
        # so fades depend on it
        h.luma_log2_weight_denom = r.ue()
        h.chroma_log2_weight_denom = r.ue()   # 4:2:0 only in scope
        if h.luma_log2_weight_denom > 7 or h.chroma_log2_weight_denom > 7:
            raise ValueError("log2_weight_denom out of range")
        h.weights_l0 = _parse_weight_list(
            r, h.num_ref_idx_active_l0, h.luma_log2_weight_denom,
            h.chroma_log2_weight_denom)
        if h.slice_type == SLICE_B:
            h.weights_l1 = _parse_weight_list(
                r, h.num_ref_idx_active_l1, h.luma_log2_weight_denom,
                h.chroma_log2_weight_denom)
    if nal_ref_idc != 0:
        # dec_ref_pic_marking
        if h.is_idr:
            h.no_output_of_prior_pics_flag = r.flag()
            h.long_term_reference_flag = r.flag()
        else:
            h.adaptive_ref_pic_marking_mode_flag = r.flag()
            if h.adaptive_ref_pic_marking_mode_flag:
                # dec_ref_pic_marking MMCO ops (7.3.3.3)
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    if op > 6:
                        raise ValueError("bad MMCO op")
                    v1 = v2 = 0
                    if op in (1, 2, 3, 4):
                        v1 = r.ue()
                    if op in (3, 6):
                        v2 = r.ue()
                    h.mmco_ops.append((op, v1, v2))
                    if len(h.mmco_ops) > 64:
                        raise ValueError("MMCO runaway")
    if pps.entropy_coding_mode_flag and h.slice_type != SLICE_I:
        h.cabac_init_idc = r.ue()
    h.slice_qp_delta = r.se()
    if pps.deblocking_filter_control_present_flag:
        h.disable_deblocking_filter_idc = r.ue()
        if h.disable_deblocking_filter_idc != 1:
            h.slice_alpha_c0_offset_div2 = r.se()
            h.slice_beta_offset_div2 = r.se()
    return h, r


def write_slice_header(h: SliceHeader, sps: SPS, pps: PPS) -> BitWriter:
    """Serialize a slice header; returns the BitWriter (caller appends slice_data)."""
    w = BitWriter()
    w.ue(h.first_mb_in_slice)
    w.ue(h.slice_type)  # 0..4 form (per-slice type may vary within picture)
    w.ue(h.pic_parameter_set_id)
    w.u(h.frame_num, sps.log2_max_frame_num)
    if h.is_idr:
        w.ue(h.idr_pic_id)
    if sps.pic_order_cnt_type == 0:
        w.u(h.pic_order_cnt_lsb, sps.log2_max_pic_order_cnt_lsb)
        if pps.bottom_field_pic_order_in_frame_present_flag:
            w.se(0)
    if h.slice_type == SLICE_B:
        w.flag(h.direct_spatial_mv_pred_flag)
    if h.slice_type in (SLICE_P, SLICE_B):
        override = (h.num_ref_idx_active_l0 != pps.num_ref_idx_l0_default_active) or (
            h.slice_type == SLICE_B
            and h.num_ref_idx_active_l1 != pps.num_ref_idx_l1_default_active)
        w.flag(override)
        if override:
            w.ue(h.num_ref_idx_active_l0 - 1)
            if h.slice_type == SLICE_B:
                w.ue(h.num_ref_idx_active_l1 - 1)
        w.flag(0)  # ref_pic_list_modification_flag_l0
        if h.slice_type == SLICE_B:
            w.flag(0)  # ref_pic_list_modification_flag_l1
    if (pps.weighted_pred_flag and h.slice_type == SLICE_P) or (
            pps.weighted_bipred_idc == 1 and h.slice_type == SLICE_B):
        ld, cd = h.luma_log2_weight_denom, h.chroma_log2_weight_denom
        w.ue(ld)
        w.ue(cd)
        wl0 = h.weights_l0 or [(1 << ld, 0, 1 << cd, 0, 1 << cd, 0)
                               ] * h.num_ref_idx_active_l0
        _write_weight_list(w, wl0, ld, cd)
        if h.slice_type == SLICE_B:
            wl1 = h.weights_l1 or [(1 << ld, 0, 1 << cd, 0, 1 << cd, 0)
                                   ] * h.num_ref_idx_active_l1
            _write_weight_list(w, wl1, ld, cd)
    if h.nal_ref_idc != 0:
        if h.is_idr:
            w.flag(h.no_output_of_prior_pics_flag)
            w.flag(h.long_term_reference_flag)
        else:
            w.flag(0)  # adaptive_ref_pic_marking_mode_flag (sliding window)
    if pps.entropy_coding_mode_flag and h.slice_type != SLICE_I:
        w.ue(h.cabac_init_idc)
    w.se(h.slice_qp_delta)
    if pps.deblocking_filter_control_present_flag:
        w.ue(h.disable_deblocking_filter_idc)
        if h.disable_deblocking_filter_idc != 1:
            w.se(h.slice_alpha_c0_offset_div2)
            w.se(h.slice_beta_offset_div2)
    return w
