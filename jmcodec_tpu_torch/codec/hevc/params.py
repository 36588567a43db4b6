"""HEVC parameter sets: SPS/PPS parsing (spec 7.3.2.2/7.3.2.3).

Round-1 scope: geometry + coding-tool flags needed for stream info and for
the decoder skeleton; scaling lists and long-term ref syntax are parsed
through (skipped exactly) so offsets stay correct.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ...utils.bits import BitReader


def _profile_tier_level(r: BitReader, max_sub_layers: int) -> dict:
    info = {}
    info["general_profile_space"] = r.u(2)
    info["general_tier_flag"] = r.u(1)
    info["general_profile_idc"] = r.u(5)
    r.u(32)  # profile compatibility flags
    r.u(4)   # progressive/interlaced/non-packed/frame-only source flags
    r.u(32)  # constraint flags (43 bits) part 1
    r.u(11)  # part 2
    r.u(1)   # general_inbld / reserved bit
    info["general_level_idc"] = r.u(8)
    sub_present = [(r.flag(), r.flag()) for _ in range(max_sub_layers - 1)]
    if max_sub_layers > 1:
        for _ in range(max_sub_layers - 1, 8):
            r.u(2)
    for (pp, lp) in sub_present:
        if pp:
            r.u(2 + 1 + 5)
            r.u(32)
            r.u(4)
            r.u(32)
            r.u(11)
            r.u(1)
        if lp:
            r.u(8)
    return info


@dataclass
class ShortTermRPS:
    """One st_ref_pic_set (7.4.8): delta POCs (negative then positive,
    each in derivation order) and used_by_curr flags."""
    delta_poc_s0: List[int] = field(default_factory=list)  # negative, desc
    used_s0: List[int] = field(default_factory=list)
    delta_poc_s1: List[int] = field(default_factory=list)  # positive, asc
    used_s1: List[int] = field(default_factory=list)

    @property
    def num_delta_pocs(self) -> int:
        return len(self.delta_poc_s0) + len(self.delta_poc_s1)


def parse_short_term_rps(r: BitReader, idx: int, rps_list,
                         is_slice_header: bool = False) -> "ShortTermRPS":
    """Parse one st_ref_pic_set (7.3.7 + 7.4.8 derivation), including the
    inter-RPS-prediction form."""
    rps = ShortTermRPS()
    inter_pred = r.flag() if idx != 0 else 0
    if inter_pred:
        d = r.ue() + 1 if is_slice_header else 1  # delta_idx_minus1 + 1
        ref = rps_list[idx - d]
        sign = r.flag()
        abs_delta = r.ue() + 1
        delta_rps = (1 - 2 * sign) * abs_delta
        n = ref.num_delta_pocs
        used = []
        flags = []
        for _ in range(n + 1):
            u = r.flag()
            f = 1 if u else r.flag()
            used.append(u)
            flags.append(f)
        # derivation (7.4.8): ref deltas in order S0 then S1
        ref_d = ref.delta_poc_s0 + ref.delta_poc_s1
        # S0 of new RPS
        for j in range(len(ref.delta_poc_s1) - 1, -1, -1):
            dpoc = ref.delta_poc_s1[j] + delta_rps
            if dpoc < 0 and flags[len(ref.delta_poc_s0) + j]:
                rps.delta_poc_s0.append(dpoc)
                rps.used_s0.append(used[len(ref.delta_poc_s0) + j])
        if delta_rps < 0 and flags[n]:
            rps.delta_poc_s0.append(delta_rps)
            rps.used_s0.append(used[n])
        for j in range(len(ref.delta_poc_s0)):
            dpoc = ref.delta_poc_s0[j] + delta_rps
            if dpoc < 0 and flags[j]:
                rps.delta_poc_s0.append(dpoc)
                rps.used_s0.append(used[j])
        # S1
        for j in range(len(ref.delta_poc_s0) - 1, -1, -1):
            dpoc = ref.delta_poc_s0[j] + delta_rps
            if dpoc > 0 and flags[j]:
                rps.delta_poc_s1.append(dpoc)
                rps.used_s1.append(used[j])
        if delta_rps > 0 and flags[n]:
            rps.delta_poc_s1.append(delta_rps)
            rps.used_s1.append(used[n])
        for j in range(len(ref.delta_poc_s1)):
            dpoc = ref.delta_poc_s1[j] + delta_rps
            if dpoc > 0 and flags[len(ref.delta_poc_s0) + j]:
                rps.delta_poc_s1.append(dpoc)
                rps.used_s1.append(used[len(ref.delta_poc_s0) + j])
        return rps
    neg = r.ue()
    pos = r.ue()
    acc = 0
    for _ in range(neg):
        acc -= r.ue() + 1
        rps.delta_poc_s0.append(acc)
        rps.used_s0.append(r.flag())
    acc = 0
    for _ in range(pos):
        acc += r.ue() + 1
        rps.delta_poc_s1.append(acc)
        rps.used_s1.append(r.flag())
    return rps


@dataclass
class HevcSPS:
    sps_id: int = 0
    vps_id: int = 0
    max_sub_layers: int = 1
    chroma_format_idc: int = 1
    pic_width: int = 0
    pic_height: int = 0
    conf_win: tuple = (0, 0, 0, 0)  # l, r, t, b (in chroma units)
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_poc_lsb: int = 8
    log2_min_cb: int = 3
    log2_ctb: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: int = 0
    amp_enabled: int = 0
    sao_enabled: int = 0
    pcm_enabled: int = 0
    num_short_term_rps: int = 0
    short_term_rps: List["ShortTermRPS"] = field(default_factory=list)
    long_term_ref_pics_present: int = 0
    lt_ref_pics: List[tuple] = field(default_factory=list)
    temporal_mvp_enabled: int = 0
    strong_intra_smoothing: int = 0
    max_dec_pic_buffering: int = 1
    num_reorder_pics: int = 0

    @property
    def width(self) -> int:
        sub = 2 if self.chroma_format_idc in (1, 2) else 1
        return self.pic_width - sub * (self.conf_win[0] + self.conf_win[1])

    @property
    def height(self) -> int:
        sub = 2 if self.chroma_format_idc == 1 else 1
        return self.pic_height - sub * (self.conf_win[2] + self.conf_win[3])

    @property
    def ctb_size(self) -> int:
        return 1 << self.log2_ctb


def parse_sps(rbsp: bytes) -> HevcSPS:
    r = BitReader(rbsp)
    s = HevcSPS()
    s.vps_id = r.u(4)
    s.max_sub_layers = r.u(3) + 1
    r.flag()  # sps_temporal_id_nesting_flag
    _profile_tier_level(r, s.max_sub_layers)
    s.sps_id = r.ue()
    s.chroma_format_idc = r.ue()
    if s.chroma_format_idc == 3:
        r.flag()
    s.pic_width = r.ue()
    s.pic_height = r.ue()
    if r.flag():  # conformance_window_flag
        s.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    s.bit_depth_luma = r.ue() + 8
    s.bit_depth_chroma = r.ue() + 8
    s.log2_max_poc_lsb = r.ue() + 4
    sub_layer_ordering = r.flag()
    lo = 0 if sub_layer_ordering else s.max_sub_layers - 1
    for _ in range(lo, s.max_sub_layers):
        s.max_dec_pic_buffering = r.ue() + 1
        s.num_reorder_pics = r.ue()
        r.ue()  # max_latency_increase
    s.log2_min_cb = r.ue() + 3
    s.log2_ctb = s.log2_min_cb + r.ue()
    s.log2_min_tb = r.ue() + 2
    s.log2_max_tb = s.log2_min_tb + r.ue()
    s.max_transform_hierarchy_depth_inter = r.ue()
    s.max_transform_hierarchy_depth_intra = r.ue()
    s.scaling_list_enabled = r.flag()
    if s.scaling_list_enabled:
        if r.flag():  # sps_scaling_list_data_present
            raise NotImplementedError("HEVC scaling list data")
    s.amp_enabled = r.flag()
    s.sao_enabled = r.flag()
    s.pcm_enabled = r.flag()
    if s.pcm_enabled:
        r.u(4)
        r.u(4)
        r.ue()
        r.ue()
        r.flag()
    s.num_short_term_rps = r.ue()
    for i in range(s.num_short_term_rps):
        s.short_term_rps.append(
            parse_short_term_rps(r, i, s.short_term_rps))
    s.long_term_ref_pics_present = r.flag()
    if s.long_term_ref_pics_present:
        n = r.ue()
        for _ in range(n):
            s.lt_ref_pics.append((r.u(s.log2_max_poc_lsb), r.flag()))
    s.temporal_mvp_enabled = r.flag()
    s.strong_intra_smoothing = r.flag()
    # vui / extensions ignored
    return s


@dataclass
class HevcPPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments: int = 0
    output_flag_present: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding: int = 0
    cabac_init_present: int = 0
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: int = 0
    transform_skip_enabled: int = 0
    cu_qp_delta_enabled: int = 0
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync_enabled: int = 0  # WPP
    num_tile_columns: int = 1
    num_tile_rows: int = 1
    uniform_spacing: int = 1
    loop_filter_across_tiles: int = 1
    loop_filter_across_slices: int = 1
    deblocking_filter_control_present: int = 0
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    slice_chroma_qp_offsets_present: int = 0
    lists_modification_present: int = 0
    log2_parallel_merge_level: int = 2
    slice_header_extension_present: int = 0


def parse_pps(rbsp: bytes) -> HevcPPS:
    r = BitReader(rbsp)
    p = HevcPPS()
    p.pps_id = r.ue()
    p.sps_id = r.ue()
    p.dependent_slice_segments = r.flag()
    p.output_flag_present = r.flag()
    p.num_extra_slice_header_bits = r.u(3)
    p.sign_data_hiding = r.flag()
    p.cabac_init_present = r.flag()
    p.num_ref_idx_l0_default = r.ue() + 1
    p.num_ref_idx_l1_default = r.ue() + 1
    p.init_qp = r.se() + 26
    p.constrained_intra_pred = r.flag()
    p.transform_skip_enabled = r.flag()
    p.cu_qp_delta_enabled = r.flag()
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets_present = r.flag()
    p.weighted_pred = r.flag()
    p.weighted_bipred = r.flag()
    p.transquant_bypass_enabled = r.flag()
    p.tiles_enabled = r.flag()
    p.entropy_coding_sync_enabled = r.flag()
    if p.tiles_enabled:
        p.num_tile_columns = r.ue() + 1
        p.num_tile_rows = r.ue() + 1
        p.uniform_spacing = r.flag()
        if not p.uniform_spacing:
            for _ in range(p.num_tile_columns - 1):
                r.ue()
            for _ in range(p.num_tile_rows - 1):
                r.ue()
        p.loop_filter_across_tiles = r.flag()
    p.loop_filter_across_slices = r.flag()
    p.deblocking_filter_control_present = r.flag()
    if p.deblocking_filter_control_present:
        p.deblocking_filter_override_enabled = r.flag()
        p.deblocking_filter_disabled = r.flag()
        if not p.deblocking_filter_disabled:
            p.beta_offset_div2 = r.se()
            p.tc_offset_div2 = r.se()
    if r.flag():  # pps_scaling_list_data_present
        raise NotImplementedError("HEVC PPS scaling list data")
    p.lists_modification_present = r.flag()
    p.log2_parallel_merge_level = r.ue() + 2
    p.slice_header_extension_present = r.flag()
    return p


def stream_info(data: bytes):
    """Probe an HEVC Annex-B stream for geometry (DecodeHeader parity)."""
    from . import nal as HN
    for u in HN.parse_nal_units(data):
        if u.nal_unit_type == HN.NAL_SPS:
            s = parse_sps(u.rbsp)
            return s
    return None
