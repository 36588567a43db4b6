"""H.264 sequence/picture parameter sets: dataclasses + parse + write.

Capability parity: the reference exported SPS/PPS blobs from the vendor encoder
(intel_enc/intel_enc.cpp:582-622 enc_get_spspps; nv_enc/nv_enc.cpp:1168-1216)
and probed stream geometry via DecodeHeader (intel_dec/intel_dec.cpp:874-909).
Here the parameter sets are first-class parsed/serialized structures.

Scope: profiles we emit/decode (Baseline/Main/High 4:2:0 8-bit, frame_mbs_only).
Parsing accepts the common syntax and rejects the rest explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...utils.bits import BitReader, BitWriter

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_HIGH = 100


@dataclass
class SPS:
    profile_idc: int = PROFILE_BASELINE
    constraint_set_flags: int = 0  # 8 bits (constraint_set0..5 + reserved)
    level_idc: int = 40
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1  # 4:2:0
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    qpprime_y_zero_transform_bypass_flag: int = 0
    seq_scaling_matrix_present_flag: int = 0
    log2_max_frame_num: int = 8
    pic_order_cnt_type: int = 2
    log2_max_pic_order_cnt_lsb: int = 8  # used when poc type 0
    delta_pic_order_always_zero_flag: int = 0
    max_num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs: int = 0
    pic_height_in_map_units: int = 0
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 1
    frame_cropping_flag: int = 0
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    vui_parameters_present_flag: int = 0
    # from VUI bitstream_restriction (None = not signalled)
    num_reorder_frames: Optional[int] = None
    max_dec_frame_buffering: Optional[int] = None

    @property
    def width(self) -> int:
        return self.pic_width_in_mbs * 16 - 2 * (self.crop_left + self.crop_right)

    @property
    def height(self) -> int:
        return self.pic_height_in_map_units * 16 - 2 * (self.crop_top + self.crop_bottom)

    @property
    def mb_width(self) -> int:
        return self.pic_width_in_mbs

    @property
    def mb_height(self) -> int:
        return self.pic_height_in_map_units


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0  # 0 = CAVLC, 1 = CABAC
    bottom_field_pic_order_in_frame_present_flag: int = 0
    num_slice_groups: int = 1
    num_ref_idx_l0_default_active: int = 1
    num_ref_idx_l1_default_active: int = 1
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 1
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    # High-profile extension
    transform_8x8_mode_flag: int = 0
    pic_scaling_matrix_present_flag: int = 0
    second_chroma_qp_index_offset: Optional[int] = None

    def chroma_qp_offset(self, plane: int) -> int:
        if plane == 1 and self.second_chroma_qp_index_offset is not None:
            return self.second_chroma_qp_index_offset
        return self.chroma_qp_index_offset


def parse_sps(rbsp: bytes) -> SPS:
    r = BitReader(rbsp)
    s = SPS()
    s.profile_idc = r.u(8)
    s.constraint_set_flags = r.u(8)
    s.level_idc = r.u(8)
    s.seq_parameter_set_id = r.ue()
    if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        s.chroma_format_idc = r.ue()
        if s.chroma_format_idc == 3:
            r.flag()  # separate_colour_plane_flag
        s.bit_depth_luma = r.ue() + 8
        s.bit_depth_chroma = r.ue() + 8
        s.qpprime_y_zero_transform_bypass_flag = r.flag()
        s.seq_scaling_matrix_present_flag = r.flag()
        if s.seq_scaling_matrix_present_flag:
            raise NotImplementedError("seq scaling matrices not supported")
    s.log2_max_frame_num = r.ue() + 4
    s.pic_order_cnt_type = r.ue()
    if s.pic_order_cnt_type == 0:
        s.log2_max_pic_order_cnt_lsb = r.ue() + 4
    elif s.pic_order_cnt_type == 1:
        s.delta_pic_order_always_zero_flag = r.flag()
        r.se()  # offset_for_non_ref_pic
        r.se()  # offset_for_top_to_bottom_field
        n = r.ue()
        for _ in range(n):
            r.se()
    s.max_num_ref_frames = r.ue()
    s.gaps_in_frame_num_value_allowed_flag = r.flag()
    s.pic_width_in_mbs = r.ue() + 1
    s.pic_height_in_map_units = r.ue() + 1
    s.frame_mbs_only_flag = r.flag()
    if not s.frame_mbs_only_flag:
        s.mb_adaptive_frame_field_flag = r.flag()
        raise NotImplementedError("interlace (fields) not supported")
    s.direct_8x8_inference_flag = r.flag()
    s.frame_cropping_flag = r.flag()
    if s.frame_cropping_flag:
        s.crop_left = r.ue()
        s.crop_right = r.ue()
        s.crop_top = r.ue()
        s.crop_bottom = r.ue()
    s.vui_parameters_present_flag = r.flag()
    if s.vui_parameters_present_flag:
        try:
            _parse_vui(r, s)
        except EOFError:
            pass  # tolerate truncated/odd VUI; defaults stand
    if s.chroma_format_idc != 1 or s.bit_depth_luma != 8 or s.bit_depth_chroma != 8:
        raise NotImplementedError("only 4:2:0 8-bit supported")
    return s


def _parse_hrd(r: BitReader) -> None:
    cpb_cnt = r.ue() + 1
    r.u(4)  # bit_rate_scale
    r.u(4)  # cpb_size_scale
    for _ in range(cpb_cnt):
        r.ue()
        r.ue()
        r.flag()
    r.u(20)  # the four 5-bit delay length fields


def _parse_vui(r: BitReader, s: SPS) -> None:
    """VUI (Annex E): skip-parse, extracting the display-reorder bound the
    DPB output stage needs (analog of ulMaxDisplayDelay, nv_dec.cpp:341)."""
    if r.flag():                      # aspect_ratio_info
        if r.u(8) == 255:             # Extended_SAR
            r.u(32)
    if r.flag():                      # overscan_info
        r.flag()
    if r.flag():                      # video_signal_type
        r.u(4)                        # format(3) + full_range(1)
        if r.flag():                  # colour_description
            r.u(24)
    if r.flag():                      # chroma_loc_info
        r.ue()
        r.ue()
    if r.flag():                      # timing_info
        r.u(64)
        r.flag()
    nal_hrd = r.flag()
    if nal_hrd:
        _parse_hrd(r)
    vcl_hrd = r.flag()
    if vcl_hrd:
        _parse_hrd(r)
    if nal_hrd or vcl_hrd:
        r.flag()                      # low_delay_hrd
    r.flag()                          # pic_struct_present
    if r.flag():                      # bitstream_restriction
        r.flag()                      # motion_vectors_over_pic_boundaries
        r.ue()
        r.ue()
        r.ue()
        r.ue()
        s.num_reorder_frames = r.ue()
        s.max_dec_frame_buffering = r.ue()


def write_sps(s: SPS) -> bytes:
    w = BitWriter()
    w.u(s.profile_idc, 8)
    w.u(s.constraint_set_flags, 8)
    w.u(s.level_idc, 8)
    w.ue(s.seq_parameter_set_id)
    if s.profile_idc >= 100:
        w.ue(s.chroma_format_idc)
        w.ue(s.bit_depth_luma - 8)
        w.ue(s.bit_depth_chroma - 8)
        w.flag(s.qpprime_y_zero_transform_bypass_flag)
        w.flag(0)  # seq_scaling_matrix_present_flag
    w.ue(s.log2_max_frame_num - 4)
    w.ue(s.pic_order_cnt_type)
    if s.pic_order_cnt_type == 0:
        w.ue(s.log2_max_pic_order_cnt_lsb - 4)
    elif s.pic_order_cnt_type == 1:
        raise NotImplementedError
    w.ue(s.max_num_ref_frames)
    w.flag(s.gaps_in_frame_num_value_allowed_flag)
    w.ue(s.pic_width_in_mbs - 1)
    w.ue(s.pic_height_in_map_units - 1)
    w.flag(s.frame_mbs_only_flag)
    w.flag(s.direct_8x8_inference_flag)
    w.flag(s.frame_cropping_flag)
    if s.frame_cropping_flag:
        w.ue(s.crop_left)
        w.ue(s.crop_right)
        w.ue(s.crop_top)
        w.ue(s.crop_bottom)
    w.flag(0)  # vui_parameters_present_flag
    w.rbsp_trailing_bits()
    return w.bytes()


def parse_pps(rbsp: bytes) -> PPS:
    r = BitReader(rbsp)
    p = PPS()
    p.pic_parameter_set_id = r.ue()
    p.seq_parameter_set_id = r.ue()
    p.entropy_coding_mode_flag = r.flag()
    p.bottom_field_pic_order_in_frame_present_flag = r.flag()
    p.num_slice_groups = r.ue() + 1
    if p.num_slice_groups > 1:
        raise NotImplementedError("slice groups (FMO) not supported")
    p.num_ref_idx_l0_default_active = r.ue() + 1
    p.num_ref_idx_l1_default_active = r.ue() + 1
    p.weighted_pred_flag = r.flag()
    p.weighted_bipred_idc = r.u(2)
    p.pic_init_qp = r.se() + 26
    p.pic_init_qs = r.se() + 26
    p.chroma_qp_index_offset = r.se()
    p.deblocking_filter_control_present_flag = r.flag()
    p.constrained_intra_pred_flag = r.flag()
    p.redundant_pic_cnt_present_flag = r.flag()
    if r.more_rbsp_data():
        p.transform_8x8_mode_flag = r.flag()
        p.pic_scaling_matrix_present_flag = r.flag()
        if p.pic_scaling_matrix_present_flag:
            raise NotImplementedError("pic scaling matrices not supported")
        p.second_chroma_qp_index_offset = r.se()
    return p


def write_pps(p: PPS, high_profile: bool = False) -> bytes:
    w = BitWriter()
    w.ue(p.pic_parameter_set_id)
    w.ue(p.seq_parameter_set_id)
    w.flag(p.entropy_coding_mode_flag)
    w.flag(p.bottom_field_pic_order_in_frame_present_flag)
    w.ue(p.num_slice_groups - 1)
    w.ue(p.num_ref_idx_l0_default_active - 1)
    w.ue(p.num_ref_idx_l1_default_active - 1)
    w.flag(p.weighted_pred_flag)
    w.u(p.weighted_bipred_idc, 2)
    w.se(p.pic_init_qp - 26)
    w.se(p.pic_init_qs - 26)
    w.se(p.chroma_qp_index_offset)
    w.flag(p.deblocking_filter_control_present_flag)
    w.flag(p.constrained_intra_pred_flag)
    w.flag(p.redundant_pic_cnt_present_flag)
    if high_profile:
        w.flag(p.transform_8x8_mode_flag)
        w.flag(0)  # pic_scaling_matrix_present_flag
        w.se(p.second_chroma_qp_index_offset
             if p.second_chroma_qp_index_offset is not None
             else p.chroma_qp_index_offset)
    w.rbsp_trailing_bits()
    return w.bytes()
