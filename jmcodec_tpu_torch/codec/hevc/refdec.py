"""HEVC stream decoder: POC, RPS, reference lists and output order on the
host; each picture parsed into a HevcFramePlan and reconstructed by a
device_recon hook (api/hevc_inter.py), or decoded on the host in numpy.

The port's copy of jmcodec_tpu/codec/hevc/refdec.py: CTU quadtree syntax,
CABAC residual coding, intra and inter prediction, deblocking and SAO,
bit-exact against libavcodec. Scope: 4:2:0 8-bit, no tiles, no PCM, no
transquant bypass (those raise NotImplementedError); WPP supported.

Counters: plans_python (plans the Python parse filled), frames_host
(pictures reconstructed on the host). A picture is routed as the
reference routes it, by three scope tests:
- the native parser (C++) fills the plan of a single-slice picture; where
  it raises native.HevcNativeUnsupported (cu_qp_delta, transform skip,
  PCM, ...), the Python parse below fills it instead;
- a plan with plan.supported False (a multi-slice picture, motion past the
  device MC pad, transform skip), or with more than R_MAX unique reference
  POCs, is decoded on the host: parsed again, reconstructed in numpy;
- every other plan goes to device_recon.
Whatever device_recon raises propagates.

Where it differs from the reference: a block of an earlier slice is
unavailable to a later slice's parse and prediction (6.4.1), and the loop
filters keep to slice_loop_filter_across_slices_enabled_flag, so a picture
of several slices decodes as libavcodec decodes it (the reference loses
sync in one); and a native plan outside the device's scope goes straight
to the host decode, without the reference's Python parse of it in between
(the route is the same).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ... import native
from ...utils.bits import BitReader
from ...utils.metrics import counters, timers
from . import cabac_tables as CT
from . import inter as INT
from . import intra as IP
from . import nal as HN
from . import transform as TR
from .cabac import HevcCabac
from .inter import MotionCand, RefPic
from .params import HevcPPS, HevcSPS, parse_pps, parse_sps
from .plan import HevcFramePlan
from .slicehdr import (B_SLICE, I_SLICE, HevcSliceHeader,
                       parse_slice_header)

R_MAX = 4   # unique reference POCs the device decode's reference stack holds

MODE_INTER, MODE_INTRA = 0, 1
(PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN,
 PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N) = range(8)


def _wrap16(v: int) -> int:
    """MVs live in int16 with wraparound (8.5.3.2.1)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _substream_offsets(hdr: "HevcSliceHeader", emu) -> List[int]:
    """WPP substream start offsets in RBSP bytes, from entry points which
    count EBSP bytes from the start of slice data (spec 7.4.7.1)."""
    if not hdr.entry_points:
        return []
    emu = emu or []
    start_r = hdr.data_bitpos >> 3
    # ebsp offset of the slice-data start: i-th removed byte sits just
    # before rbsp index emu[i]
    start_e = start_r + sum(1 for p in emu if p <= start_r)
    return [HN.ebsp_offset_to_rbsp(start_e + e_off, emu)
            for e_off in hdr.entry_points]

# ---------------------------------------------------------------------------
# scan orders (spec 6.5.3-6.5.5); scanIdx: 0 diag(up-right), 1 hor, 2 ver
# ---------------------------------------------------------------------------


def _scan(n: int, idx: int) -> List[Tuple[int, int]]:
    if idx == 1:  # horizontal
        return [(x, y) for y in range(n) for x in range(n)]
    if idx == 2:  # vertical
        return [(x, y) for x in range(n) for y in range(n)]
    out = []
    for d in range(2 * n - 1):
        for x in range(d + 1):
            y = d - x
            if x < n and y < n:
                out.append((x, y))
    return out


_SCANS = {(n, i): _scan(n, i) for n in (1, 2, 4, 8) for i in (0, 1, 2)}

# 4x4 sig_coeff_flag ctx map (spec 9.3.4.2.5 ctxIdxMap)
_CTX_IDX_MAP = [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8]

# deblock tables (spec Tables 8-12): recovered from system libs alongside
# the CABAC tables (see native/gen_hevc_tables.py provenance notes)
_BETA = [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22,
                    24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50,
                    52, 54, 56, 58, 60, 62, 64]
_TC = [0] * 18 + [1] * 9 + [2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7,
                  8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24]

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2


@dataclass
class SaoParam:
    type_idx: List[int] = field(default_factory=lambda: [0, 0, 0])
    offsets: List[List[int]] = field(
        default_factory=lambda: [[0] * 4 for _ in range(3)])
    band_pos: List[int] = field(default_factory=lambda: [0, 0, 0])
    eo_class: List[int] = field(default_factory=lambda: [0, 0, 0])


def _unique_pocs(lists) -> list:
    """The POCs of the reference lists, each once, in list order: the
    device decode's reference slots."""
    pocs = []
    for lst in lists:
        for rp in lst:
            if rp.poc not in pocs:
                pocs.append(rp.poc)
    return pocs


def _host_planes(rp: RefPic) -> RefPic:
    """rp with numpy planes, for the host MC. A picture decoded on the
    device keeps its tensors in the DPB (its output and the device's
    references read them); the host copy is made once and kept beside
    them."""
    if isinstance(rp.y, np.ndarray):
        return rp
    if rp.host is None:
        rp.host = tuple(p.cpu().numpy() for p in (rp.y, rp.cb, rp.cr))
    return replace(rp, y=rp.host[0], cb=rp.host[1], cr=rp.host[2])


class HevcRefDecoder:
    """Streaming Annex-B HEVC decoder producing I420 frames.

    device_recon(plan, ref_pixels) reconstructs one picture: plan is its
    HevcFramePlan (inter fields enabled; an I picture carries zeroed
    motion), ref_pixels [(poc, y, cb, cr), ...] the coded-size planes of
    its references in plan.ref_pocs order (empty for an I picture), as the
    DPB holds them: tensors of a device-decoded picture, numpy uint8
    planes of a host-decoded one. It returns the picture's coded-size
    (Y, U, V), which go into the DPB as they are. With device_recon None
    every picture is decoded on the host. use_native=False skips the
    native parser: every plan comes from the Python parse.

    With plan_only=True the pixel math is skipped: each picture, which
    must be an I picture, is parsed in Python into a HevcFramePlan
    (without the inter fields) appended to self.plans, and nothing enters
    the DPB or the output.

    decode and flush return the frames output since the last call, in
    output order, cropped to the conformance window; the decoder keeps
    none of them."""

    def __init__(self, device_recon=None, use_native: bool = True,
                 plan_only: bool = False):
        self.sps: Dict[int, HevcSPS] = {}
        self.pps: Dict[int, HevcPPS] = {}
        self._out: List[tuple] = []     # output, not yet returned
        self.device_recon = device_recon
        self.use_native = use_native
        self.plan_only = plan_only
        self.plans: List[HevcFramePlan] = []
        # DPB + POC state (8.3.1 / 8.3.2)
        self.dpb: List[RefPic] = []
        self.prev_poc_lsb = 0
        self.prev_poc_msb = 0
        self.n_pictures = 0

    # -- POC / DPB ------------------------------------------------------------

    def _compute_poc(self, hdr: HevcSliceHeader, sps: HevcSPS) -> int:
        if hdr.is_idr:
            self.prev_poc_lsb = self.prev_poc_msb = 0
            return 0
        max_lsb = 1 << sps.log2_max_poc_lsb
        lsb = hdr.poc_lsb
        if self.n_pictures == 0:
            msb = 0  # first picture is an anchor (NoRaslOutputFlag)
        elif (lsb < self.prev_poc_lsb and
                self.prev_poc_lsb - lsb >= max_lsb // 2):
            msb = self.prev_poc_msb + max_lsb
        elif (lsb > self.prev_poc_lsb and
                lsb - self.prev_poc_lsb > max_lsb // 2):
            msb = self.prev_poc_msb - max_lsb
        else:
            msb = self.prev_poc_msb
        self.prev_poc_lsb, self.prev_poc_msb = lsb, msb
        return msb + lsb

    def _apply_rps(self, hdr: HevcSliceHeader, poc: int):
        """Mark DPB references per the RPS; return (st_before, st_after)
        POC lists for ref-list construction (8.3.2, short-term only)."""
        keep = set()
        before, after = [], []
        if hdr.rps is not None:
            for d, u in zip(hdr.rps.delta_poc_s0, hdr.rps.used_s0):
                keep.add(poc + d)
                if u:
                    before.append(poc + d)
            for d, u in zip(hdr.rps.delta_poc_s1, hdr.rps.used_s1):
                keep.add(poc + d)
                if u:
                    after.append(poc + d)
        for rp in self.dpb:
            if rp.poc not in keep:
                rp.is_reference = False
        return before, after

    def _pic_by_poc(self, poc: int) -> RefPic:
        for rp in self.dpb:
            if rp.poc == poc and rp.is_reference:
                return rp
        raise ValueError(f"reference POC {poc} missing from DPB")

    def _ref_lists(self, hdr: HevcSliceHeader, before, after):
        """RefPicList0/1 (8.3.4)."""
        lists = []
        npc = len(before) + len(after)
        if npc == 0 and hdr.slice_type != I_SLICE:
            raise ValueError("P/B slice with empty RPS")
        for lx in range(2 if hdr.slice_type == B_SLICE else 1):
            order = before + after if lx == 0 else after + before
            n = hdr.num_ref_idx[lx]
            tmp = [order[i % npc] for i in range(max(n, npc))]
            if hdr.ref_list_mod[lx] is not None:
                lst = [self._pic_by_poc(tmp[i])
                       for i in hdr.ref_list_mod[lx]]
            else:
                lst = [self._pic_by_poc(p) for p in tmp[:n]]
            lists.append(lst)
        if hdr.slice_type != B_SLICE:
            lists.append([])
        return lists

    def _emit(self, rp: RefPic) -> None:
        rp.output_needed = False
        w, h = rp.crop
        self._out.append((rp.y[:h, :w], rp.cb[:h // 2, :w // 2],
                          rp.cr[:h // 2, :w // 2]))

    def _bump(self, allowed: int) -> None:
        while True:
            pend = [rp for rp in self.dpb if rp.output_needed]
            if len(pend) <= allowed:
                break
            self._emit(min(pend, key=lambda rp: rp.poc))
            self.dpb = [rp for rp in self.dpb
                        if rp.output_needed or rp.is_reference]

    def flush(self) -> List[tuple]:
        """Drain the reorder buffer (EOF)."""
        self._bump(0)
        self.dpb = [rp for rp in self.dpb if rp.is_reference]
        return self._take()

    def _take(self) -> List[tuple]:
        out, self._out = self._out, []
        return out

    # -- top level ----------------------------------------------------------

    def decode(self, data: bytes, flush: bool = True) -> List[tuple]:
        """Decode an Annex-B chunk. With flush=True (one-shot use) the
        display-reorder buffer is drained at the end; streaming callers
        pass flush=False and call flush() themselves at EOF."""
        au: List = []
        for u in HN.parse_nal_units(data):
            if u.nal_unit_type == HN.NAL_SPS:
                s = parse_sps(u.rbsp)
                self.sps[s.sps_id] = s
            elif u.nal_unit_type == HN.NAL_PPS:
                p = parse_pps(u.rbsp)
                self.pps[p.pps_id] = p
            elif u.is_slice:
                hdr = parse_slice_header(
                    u.rbsp, u.nal_unit_type,
                    self._sps_for(u.rbsp, u.nal_unit_type), self._pps_probe(
                        u.rbsp, u.nal_unit_type))
                if hdr.first_slice and au:
                    self._decode_picture(au)
                    au = []
                au.append((hdr, u.rbsp, u.emu_positions))
        if au:
            self._decode_picture(au)
        return self.flush() if flush else self._take()

    def _pps_probe(self, rbsp: bytes, nal_type: int) -> HevcPPS:
        r = BitReader(rbsp)
        r.flag()
        if 16 <= nal_type <= 23:
            r.flag()
        return self.pps[r.ue()]

    def _sps_for(self, rbsp: bytes, nal_type: int) -> HevcSPS:
        return self.sps[self._pps_probe(rbsp, nal_type).sps_id]

    # -- picture ------------------------------------------------------------

    @staticmethod
    def _new_plan(sps: HevcSPS, poc: int, hdr0) -> HevcFramePlan:
        plan = HevcFramePlan.create(sps)
        plan.poc = poc
        plan.is_idr = bool(hdr0.is_idr)
        # intra pictures ride the inter entry with zeroed motion
        plan.enable_inter()
        return plan

    def _decode_picture(self, slices) -> None:
        hdr0 = slices[0][0]
        pps = self.pps[hdr0.pps_id]
        sps = self.sps[pps.sps_id]
        if sps.chroma_format_idc != 1 or sps.bit_depth_luma != 8:
            raise NotImplementedError("HEVC non-4:2:0/8-bit")
        if pps.tiles_enabled:
            raise NotImplementedError("HEVC tiles")
        if hdr0.slice_type != I_SLICE and self.plan_only:
            raise NotImplementedError("HEVC inter device plan")
        if hdr0.is_idr:
            # output everything pending, then an empty reference set
            self._bump(0)
            for rp in self.dpb:
                rp.is_reference = False
            self.dpb = []
        poc = self._compute_poc(hdr0, sps)
        self.n_pictures += 1
        if self.plan_only:
            self.plans.append(self._plan_picture(slices, sps, pps, poc))
            return
        plan = None
        if self.device_recon is not None:
            plan = self._new_plan(sps, poc, hdr0)
        before, after = self._apply_rps(hdr0, poc)
        planes, pic = self._decode_picture_slices(slices, sps, pps, poc,
                                                  before, after, plan)
        if planes is None:
            with timers.stage("host_decode"):
                pic.deblock()
                pic.sao()
            counters.add("frames_host")
            planes = (pic.y.astype(np.uint8), pic.cb.astype(np.uint8),
                      pic.cr.astype(np.uint8))
        # MC references use the full coded planes; output crops (conf window)
        rp = RefPic(
            poc=poc,
            y=planes[0], cb=planes[1], cr=planes[2],
            mv=pic.mv, ref_poc=pic.ref_poc, pred=pic.pred,
            intra=pic.intra4,
            output_needed=bool(hdr0.pic_output_flag))
        rp.crop = (sps.width, sps.height)
        self.dpb.append(rp)
        self._bump(sps.num_reorder_pics)

    def _plan_picture(self, slices, sps, pps, poc) -> HevcFramePlan:
        """plan_only: an I picture's slices parsed in Python into a new
        plan, with its bS and SAO parameters."""
        plan = HevcFramePlan.create(sps)
        plan.poc = poc
        plan.is_idr = bool(slices[0][0].is_idr)
        pic = _Picture(sps, pps, plan=plan)
        pic.poc = poc
        with timers.stage("host_parse"):
            for hdr, rbsp, emu in slices:
                self._decode_slice(pic, hdr, rbsp, emu)
            pic.finish_bs()
        ch, cw = pic.bs_ver.shape
        plan.bs_ver[:ch, :cw] = pic.bs_ver
        plan.bs_hor[:ch, :cw] = pic.bs_hor
        plan.record_sao(pic.sao_params, pic.ctb_w, pic.ctb_h)
        return plan

    @staticmethod
    def _device_takes(plan: HevcFramePlan) -> bool:
        """The device path's scope tests of a filled plan."""
        return plan.supported and len(plan.ref_pocs or []) <= R_MAX

    def _ref_pixels(self, plan: HevcFramePlan) -> list:
        out = []
        for p in (plan.ref_pocs or []):
            rp = self._pic_by_poc(p)
            out.append((p, rp.y, rp.cb, rp.cr))
        return out

    def _decode_picture_slices(self, slices, sps, pps, poc, before, after,
                               plan):
        """Parse + reconstruct one picture's slices. Returns (the
        device-reconstructed coded-size planes, or None when the
        reconstruction is the host's and still has its loop filters to
        run; the picture's _Picture state). plan None decodes on the host.
        A plan outside the device's scope is decoded again on the host
        (the slice bytes are still at hand; entropy state is per slice)."""
        hdr0 = slices[0][0]
        if plan is not None and len(slices) > 1:
            # the plan of a multi-slice picture is unsupported
            # (plan.record_slice): straight to the host
            plan = None
        if (plan is not None and self.use_native and hdr0.first_slice
                and not hdr0.dependent):
            try:
                planes, pic = self._decode_native(slices[0], sps, pps, poc,
                                                  before, after, plan)
            except native.HevcNativeUnsupported:
                # the native parse may have written into the plan's
                # tensors before it stopped: the Python parse starts anew
                plan = self._new_plan(sps, poc, hdr0)
            else:
                if planes is not None:
                    return planes, pic
                # parsed, but outside the device's scope: the Python
                # parse would find the same plan, so go to the host
                return self._decode_picture_slices(slices, sps, pps, poc,
                                                   before, after, None)
        pic = _Picture(sps, pps, plan=plan)
        pic.poc = poc
        with timers.stage("host_parse" if plan is not None
                          else "host_decode"):
            for hdr, rbsp, emu in slices:
                if hdr.slice_type != I_SLICE:
                    refs = self._ref_lists(hdr, before, after)
                    if plan is None:
                        refs = [[_host_planes(rp) for rp in lst]
                                for lst in refs]
                    pic.cur_refs = refs
                    pic.no_backward = all(
                        rp.poc <= poc for lst in refs for rp in lst)
                    if plan is not None:
                        plan.ref_pocs = _unique_pocs(refs)
                        pic.slot_of = {p: i for i, p in
                                       enumerate(plan.ref_pocs)}
                self._decode_slice(pic, hdr, rbsp, emu)
            pic.finish_bs()
        if plan is None:
            return None, pic
        counters.add("plans_python")
        # per-cell QP: the decoded qp_map (covers cu_qp_delta; equals the
        # slice QP everywhere otherwise). Deblock + inter dequant read it
        # per cell; padded plan cells keep the slice QP.
        plan.qp_y[:] = hdr0.qp
        ch, cw = pic.qp_map.shape
        plan.qp_y[:ch, :cw] = pic.qp_map
        plan.bs_ver[:ch, :cw] = pic.bs_ver
        plan.bs_hor[:ch, :cw] = pic.bs_hor
        plan.record_sao(pic.sao_params, pic.ctb_w, pic.ctb_h)
        if self._device_takes(plan):
            return self.device_recon(plan, self._ref_pixels(plan)), pic
        return self._decode_picture_slices(slices, sps, pps, poc,
                                           before, after, None)

    def _decode_native(self, slc, sps, pps, poc, before, after, plan):
        """One slice parsed by the native parser into plan: an I slice, or
        a P/B slice with the whole merge/AMVP/TMVP motion derivation in
        C++; Python keeps the headers, the bS post-pass and the DPB
        bookkeeping. Returns (device-reconstructed planes, or None when
        the plan is outside the device's scope; the _Picture state).
        Raises native.HevcNativeUnsupported outside the parser's scope."""
        hdr, rbsp, emu = slc
        plan.record_slice(hdr, pps)
        pic = _Picture(sps, pps, plan=plan)
        pic.poc = poc
        if hdr.slice_type == I_SLICE:
            with timers.stage("host_parse"):
                native.hevc_fill_plan(plan, hdr, sps, pps, rbsp,
                                      _substream_offsets(hdr, emu))
            pic.intra4[:] = 1  # all-intra picture (DPB metadata)
            return self.device_recon(plan, []), pic
        plan.set_wp(hdr)
        cur_refs = self._ref_lists(hdr, before, after)
        no_backward = all(rp.poc <= poc for lst in cur_refs for rp in lst)
        plan.ref_pocs = _unique_pocs(cur_refs)
        slot_of = {p_: i for i, p_ in enumerate(plan.ref_pocs)}
        col = None
        has_col = 0
        col_poc = 0
        if hdr.temporal_mvp:
            col_list = 0 if hdr.collocated_from_l0 else 1
            if cur_refs[col_list]:
                crp = cur_refs[col_list][hdr.collocated_ref_idx]
                if crp.pred is not None:
                    col = {"pred": crp.pred, "mv": crp.mv,
                           "ref_poc": crp.ref_poc, "intra": crp.intra}
                    has_col = 1
                    col_poc = crp.poc
        ictx = {
            "slice_type": hdr.slice_type,
            "num_ref": list(hdr.num_ref_idx),
            "max_merge": 5 - hdr.five_minus_max_num_merge_cand,
            "tmvp_on": int(hdr.temporal_mvp),
            "col_from_l0": int(hdr.collocated_from_l0),
            "col_ref_idx": int(hdr.collocated_ref_idx),
            "mvd_l1_zero": int(hdr.mvd_l1_zero),
            "no_backward": int(no_backward),
            "cur_poc": poc,
            "has_col": has_col, "col_poc": col_poc, "col": col,
            "refs": [[(rp.poc, slot_of[rp.poc]) for rp in lst]
                     for lst in cur_refs],
        }
        with timers.stage("host_parse"):
            st = native.hevc_fill_plan_inter(
                plan, hdr, sps, pps, rbsp, _substream_offsets(hdr, emu),
                ictx)
        pic.pred[:] = st["pred"]
        pic.mv[:] = st["mv"]
        pic.ref_idx[:] = st["refidx"]
        pic.ref_poc[:] = st["ref_poc"]
        pic.intra4[:] = st["intra4"]
        pic.skip4[:] = st["skip4"]
        pic.cbf4[:] = st["cbf4"]
        pic.mot_done[:] = st["mot_done"] != 0
        pic.tu_edge_ver[:] = st["tu_ev"] != 0
        pic.tu_edge_hor[:] = st["tu_eh"] != 0
        pic.pu_edge_ver[:] = st["pu_ev"] != 0
        pic.pu_edge_hor[:] = st["pu_eh"] != 0
        plan.fill_wp_cells(st["refidx"], st["pred"])
        with timers.stage("bs_post"):
            pic.finish_bs()
        plan.qp_y[:] = hdr.qp
        ch, cw = pic.bs_ver.shape
        plan.bs_ver[:ch, :cw] = pic.bs_ver
        plan.bs_hor[:ch, :cw] = pic.bs_hor
        if not self._device_takes(plan):
            return None, pic
        return self.device_recon(plan, self._ref_pixels(plan)), pic

    # -- slice --------------------------------------------------------------

    def _decode_slice(self, pic: "_Picture", hdr: HevcSliceHeader,
                      rbsp: bytes, emu) -> None:
        sps, pps = pic.sps, pic.pps
        pic.cur_hdr = hdr
        if not hdr.dependent:
            pic.start_slice()
        pic.lf_across.append(hdr.loop_filter_across_slices)
        if pic.plan is not None:
            pic.plan.record_slice(hdr, pps)
            if hdr.slice_type != I_SLICE:
                pic.plan.set_wp(hdr)
        c = HevcCabac(rbsp, hdr.data_bitpos, hdr.qp, hdr.init_type)
        # cu_qp_delta: qPY_PREV = SliceQpY at the first QG of the slice
        # (and of each CTB row under WPP, below) — 8.6.1
        pic.last_cu_qp = hdr.qp
        wpp = pps.entropy_coding_sync_enabled
        substream_rbsp = _substream_offsets(hdr, emu)
        ctb_w = pic.ctb_w
        addr = hdr.segment_address
        saved = None
        sub_idx = 0
        while True:
            xc, yc = addr % ctb_w, addr // ctb_w
            if wpp and xc == 0 and addr != hdr.segment_address:
                # row start: sync from storage after top-right CTB (9.3.1)
                if ctb_w > 1 and pic.slice_id[yc - 1, min(1, ctb_w - 1)] == \
                        pic.cur_slice and saved is not None:
                    c.load_states(saved)
                else:
                    c.init_contexts(hdr.qp, hdr.init_type)
                pic.last_cu_qp = hdr.qp
            pic.decode_ctu(c, xc, yc)
            if wpp and xc == 1:
                saved = c.save_states()
            end = c.terminate()
            addr += 1
            if end:
                break
            if addr >= pic.ctb_w * pic.ctb_h:
                raise ValueError("slice data overruns picture")
            if wpp and addr % ctb_w == 0:
                if not c.terminate():
                    raise ValueError("end_of_subset_one_bit not 1")
                if sub_idx < len(substream_rbsp):
                    c.reposition(substream_rbsp[sub_idx] * 8)
                    sub_idx += 1
                else:
                    c.align_and_reinit()
        pic.cur_slice += 1


def _ts_residual(d: np.ndarray) -> np.ndarray:
    """transform_skip residual (8.6.4.2, 8-bit): r = (d << tsShift +
    round) >> bdShift with tsShift = 7 (4x4), bdShift = 12."""
    return (d * 128 + 2048) >> 12


class _Picture:
    """Per-picture decode state and reconstruction."""

    def __init__(self, sps: HevcSPS, pps: HevcPPS, plan=None):
        self.sps, self.pps = sps, pps
        self.plan = plan
        w, h = sps.pic_width, sps.pic_height
        self.w, self.h = w, h
        self.ctb = 1 << sps.log2_ctb
        self.ctb_w = (w + self.ctb - 1) >> sps.log2_ctb
        self.ctb_h = (h + self.ctb - 1) >> sps.log2_ctb
        self.y = np.zeros((h, w), np.int32)
        self.cb = np.zeros((h // 2, w // 2), np.int32)
        self.cr = np.zeros((h // 2, w // 2), np.int32)
        g = 4
        self.avail_y = np.zeros(((h + g - 1) // g, (w + g - 1) // g), bool)
        self.avail_c = np.zeros(((h // 2 + g - 1) // g,
                                 (w // 2 + g - 1) // g), bool)
        self.mode_y = np.full(self.avail_y.shape, IP.DC, np.int32)
        # z-scan parse availability for MPM (6.4.1): marked as PU modes are
        # parsed, ahead of reconstruction (intra-CU neighbors count)
        self.mode_avail = np.zeros(self.avail_y.shape, bool)
        self.ct_depth = np.zeros(self.avail_y.shape, np.int32)
        self.qp_map = np.zeros(self.avail_y.shape, np.int32)
        # deblock edge bS maps at 4x4 granularity (luma coords)
        self.bs_ver = np.zeros(self.avail_y.shape, np.int8)
        self.bs_hor = np.zeros(self.avail_y.shape, np.int8)
        # inter state, per 4x4 luma cell
        cell = self.avail_y.shape
        self.poc = 0
        self.cur_refs: List[List] = [[], []]       # RefPicList0/1 per slice
        self.mv = np.zeros((2,) + cell + (2,), np.int32)
        self.ref_idx = np.full((2,) + cell, -1, np.int32)
        self.ref_poc = np.zeros((2,) + cell, np.int32)
        self.pred = np.zeros((2,) + cell, np.uint8)     # predFlagLX
        self.intra4 = np.zeros(cell, np.uint8)
        self.skip4 = np.zeros(cell, np.uint8)
        self.mot_done = np.zeros(cell, bool)      # PU motion parsed+stored
        self.cbf4 = np.zeros(cell, np.uint8)      # luma cbf of covering TU
        self.tu_edge_ver = np.zeros(cell, bool)   # TU left-edge at cell
        self.tu_edge_hor = np.zeros(cell, bool)
        self.pu_edge_ver = np.zeros(cell, bool)   # PU/CU left-edge at cell
        self.pu_edge_hor = np.zeros(cell, bool)
        self.no_backward = True                   # all refs POC <= curr
        self.slice_id = np.full((self.ctb_h, self.ctb_w), -1, np.int32)
        self.cur_slice = 0
        # slice_loop_filter_across_slices_enabled_flag of each slice
        self.lf_across: List[int] = []
        self.sao_params: List[Optional[SaoParam]] = [None] * (
            self.ctb_w * self.ctb_h)
        self.cur_hdr: Optional[HevcSliceHeader] = None
        # cu_qp_delta state (7.4.9.10 / 8.6.1): one quantization group's
        # predictor + coded delta; last_cu_qp feeds the next QG's qPY_PREV
        self.last_cu_qp = 0
        self.qg_pred = 0
        self.qg_delta = 0
        self.qg_coded = False

    def start_slice(self) -> None:
        """A new (independent) slice: what the earlier slices decoded is
        no longer available to its prediction, its CABAC contexts and its
        merge and AMVP candidates (6.4.1: a neighbour in another slice is
        unavailable). Slices cover CTBs in raster order, so every block
        decoded so far lies in an earlier slice."""
        for m in (self.avail_y, self.avail_c, self.mode_avail,
                  self.mot_done):
            m[:] = False

    # -- CTU ----------------------------------------------------------------

    def decode_ctu(self, c: HevcCabac, xc: int, yc: int) -> None:
        hdr = self.cur_hdr
        self.slice_id[yc, xc] = self.cur_slice
        if hdr.sao_luma or hdr.sao_chroma:
            self._sao_syntax(c, xc, yc)
        x0, y0 = xc << self.sps.log2_ctb, yc << self.sps.log2_ctb
        self._coding_quadtree(c, x0, y0, self.sps.log2_ctb, 0)

    def _sao_syntax(self, c: HevcCabac, xc: int, yc: int) -> None:
        hdr = self.cur_hdr
        idx = yc * self.ctb_w + xc
        merge = 0
        if xc > 0 and self.slice_id[yc, xc - 1] == self.cur_slice:
            if c.decode(CT.SAO_MERGE_FLAG):
                self.sao_params[idx] = self.sao_params[idx - 1]
                return
        if yc > 0 and self.slice_id[yc - 1, xc] == self.cur_slice:
            if c.decode(CT.SAO_MERGE_FLAG):
                self.sao_params[idx] = self.sao_params[idx - self.ctb_w]
                return
        p = SaoParam()
        for ci in range(3):
            if (ci == 0 and not hdr.sao_luma) or (
                    ci > 0 and not hdr.sao_chroma):
                continue
            if ci <= 1:
                # sao_type_idx: TR cMax=2, bin0 ctx, bin1 bypass
                if not c.decode(CT.SAO_TYPE_IDX):
                    t = SAO_OFF
                else:
                    t = SAO_EDGE if c.bypass() else SAO_BAND
                p.type_idx[ci] = t
            else:
                p.type_idx[2] = p.type_idx[1]
            if p.type_idx[ci] == SAO_OFF:
                continue
            absv = [c.tr_bypass(7) for _ in range(4)]
            if p.type_idx[ci] == SAO_BAND:
                offs = []
                for v in absv:
                    if v and c.bypass():
                        v = -v
                    offs.append(v)
                p.offsets[ci] = offs
                p.band_pos[ci] = (c.bypass() << 4 | c.bypass() << 3 |
                                  c.bypass() << 2 | c.bypass() << 1 |
                                  c.bypass())
            else:
                p.offsets[ci] = [absv[0], absv[1], -absv[2], -absv[3]]
                if ci == 0:
                    p.eo_class[0] = (c.bypass() << 1) | c.bypass()
                elif ci == 1:
                    p.eo_class[1] = (c.bypass() << 1) | c.bypass()
                    p.eo_class[2] = p.eo_class[1]
        self.sao_params[idx] = p

    # -- coding quadtree ----------------------------------------------------

    def _coding_quadtree(self, c: HevcCabac, x0: int, y0: int,
                         log2size: int, depth: int) -> None:
        sps = self.sps
        pps = self.pps
        if (pps.cu_qp_delta_enabled and
                log2size >= sps.log2_ctb - pps.diff_cu_qp_delta_depth):
            # new quantization group (7.4.9.10): reset the coded flag and
            # capture qPY_PRED for every CU inside this QG (8.6.1)
            self.qg_coded = False
            self.qg_delta = 0
            self.qg_pred = self._qp_pred(x0, y0)
        inside = (x0 + (1 << log2size) <= self.w and
                  y0 + (1 << log2size) <= self.h)
        if inside and log2size > sps.log2_min_cb:
            ctx = 0
            g = 4
            if x0 > 0 and self.avail_y[y0 // g, (x0 - 1) // g]:
                ctx += int(self.ct_depth[y0 // g, (x0 - 1) // g] > depth)
            if y0 > 0 and self.avail_y[(y0 - 1) // g, x0 // g]:
                ctx += int(self.ct_depth[(y0 - 1) // g, x0 // g] > depth)
            split = c.decode(CT.SPLIT_CU_FLAG + ctx)
        else:
            split = log2size > sps.log2_min_cb
        if split:
            half = 1 << (log2size - 1)
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                if x0 + dx < self.w and y0 + dy < self.h:
                    self._coding_quadtree(c, x0 + dx, y0 + dy,
                                          log2size - 1, depth + 1)
        else:
            self._coding_unit(c, x0, y0, log2size, depth)

    # -- coding unit -----------------------------------------------------------

    def _coding_unit(self, c: HevcCabac, x0: int, y0: int, log2size: int,
                     depth: int) -> None:
        sps, pps = self.sps, self.pps
        n = 1 << log2size
        g = 4
        ys = slice(y0 // g, (y0 + n) // g)
        xs = slice(x0 // g, (x0 + n) // g)
        self.ct_depth[ys, xs] = depth
        self.qp_map[ys, xs] = self.cur_qp()
        if pps.transquant_bypass_enabled:
            if c.decode(CT.CU_TRANSQUANT_BYPASS):
                raise NotImplementedError("transquant bypass")
        if self.cur_hdr.slice_type != I_SLICE:
            ctx = 0
            if x0 > 0 and self.avail_y[y0 // g, (x0 - 1) // g]:
                ctx += int(self.skip4[y0 // g, (x0 - 1) // g])
            if y0 > 0 and self.avail_y[(y0 - 1) // g, x0 // g]:
                ctx += int(self.skip4[(y0 - 1) // g, x0 // g])
            if c.decode(CT.SKIP_FLAG + ctx):
                self.skip4[ys, xs] = 1
                self.cu_pred_mode = MODE_INTER
                self._prediction_unit(c, x0, y0, n, x0, y0, n, n, 0,
                                      PART_2Nx2N, skip=True)
                self._mark_cu_edges(x0, y0, n)
                self._finish_cu_qp(x0, y0, n)
                if self.plan is not None:
                    self.plan.record_inter_cu_done(x0, y0, n)
                return
            if not c.decode(CT.PRED_MODE_FLAG):
                self._inter_cu(c, x0, y0, log2size, depth)
                self._finish_cu_qp(x0, y0, n)
                return
        self._intra_cu(c, x0, y0, log2size, depth)
        self._finish_cu_qp(x0, y0, n)

    def _qp_pred(self, xQg: int, yQg: int) -> int:
        """qPY_PRED (8.6.1): mean of the left/above QG neighbours when
        they lie in the SAME CTB, else the previous QG's last CU QP."""
        mask = self.ctb - 1
        prev = self.last_cu_qp
        g = 4
        qa = (int(self.qp_map[yQg // g, (xQg - 1) // g])
              if (xQg & mask) else prev)
        qb = (int(self.qp_map[(yQg - 1) // g, xQg // g])
              if (yQg & mask) else prev)
        return (qa + qb + 1) >> 1

    def cur_qp(self) -> int:
        """Current CU luma QP: slice QP, or the QG-derived value when
        cu_qp_delta is on (delta 0 until parsed; the parse precedes the
        first dequant in the TU syntax, 7.3.8.10)."""
        if not self.pps.cu_qp_delta_enabled:
            return self.cur_hdr.qp
        return (self.qg_pred + self.qg_delta + 52) % 52

    def _finish_cu_qp(self, x0: int, y0: int, n: int) -> None:
        """At CU end: pin the derived QP over the CU (deblock + the next
        QG's predictor read it) and remember it as qPY_PREV material."""
        g = 4
        qp = self.cur_qp()
        self.qp_map[y0 // g:(y0 + n) // g, x0 // g:(x0 + n) // g] = qp
        self.last_cu_qp = qp

    def _mark_cu_edges(self, x0: int, y0: int, n: int) -> None:
        g = 4
        self.pu_edge_ver[y0 // g:(y0 + n) // g, x0 // g] = True
        self.pu_edge_hor[y0 // g, x0 // g:(x0 + n) // g] = True
        # CB boundaries are transform-block edges for deblocking (8.7.2.2)
        # even when the CU codes no residual (rqt_root_cbf == 0)
        self.tu_edge_ver[y0 // g:(y0 + n) // g, x0 // g] = True
        self.tu_edge_hor[y0 // g, x0 // g:(x0 + n) // g] = True

    # -- inter coding unit (7.3.8.5 MODE_INTER path) ---------------------------

    def _part_mode_inter(self, c: HevcCabac, log2size: int) -> int:
        sps = self.sps
        if c.decode(CT.PART_MODE):
            return PART_2Nx2N
        at_min = log2size == sps.log2_min_cb
        hor = c.decode(CT.PART_MODE + 1)
        if at_min:
            if hor:
                return PART_2NxN
            if log2size == 3:
                return PART_Nx2N
            return PART_Nx2N if c.decode(CT.PART_MODE + 2) else PART_NxN
        if not sps.amp_enabled:
            return PART_2NxN if hor else PART_Nx2N
        if c.decode(CT.PART_MODE + 3):
            return PART_2NxN if hor else PART_Nx2N
        amp_second = c.bypass()
        if hor:
            return PART_2NxnD if amp_second else PART_2NxnU
        return PART_nRx2N if amp_second else PART_nLx2N

    @staticmethod
    def _pu_geometry(part: int, x0: int, y0: int, n: int):
        h, q = n >> 1, n >> 2
        if part == PART_2Nx2N:
            return [(x0, y0, n, n)]
        if part == PART_2NxN:
            return [(x0, y0, n, h), (x0, y0 + h, n, h)]
        if part == PART_Nx2N:
            return [(x0, y0, h, n), (x0 + h, y0, h, n)]
        if part == PART_NxN:
            return [(x0, y0, h, h), (x0 + h, y0, h, h),
                    (x0, y0 + h, h, h), (x0 + h, y0 + h, h, h)]
        if part == PART_2NxnU:
            return [(x0, y0, n, q), (x0, y0 + q, n, n - q)]
        if part == PART_2NxnD:
            return [(x0, y0, n, n - q), (x0, y0 + n - q, n, q)]
        if part == PART_nLx2N:
            return [(x0, y0, q, n), (x0 + q, y0, n - q, n)]
        return [(x0, y0, n - q, n), (x0 + n - q, y0, q, n)]

    def _inter_cu(self, c: HevcCabac, x0: int, y0: int, log2size: int,
                  depth: int) -> None:
        sps = self.sps
        n = 1 << log2size
        self.cu_pred_mode = MODE_INTER
        # part_mode is always coded for inter CUs (7.3.8.5)
        part = self._part_mode_inter(c, log2size)
        first_merge = False
        for idx, (xp, yp, w, h) in enumerate(self._pu_geometry(
                part, x0, y0, n)):
            m = self._prediction_unit(c, x0, y0, n, xp, yp, w, h, idx, part,
                                      skip=False)
            if idx == 0:
                first_merge = m
        self._mark_cu_edges(x0, y0, n)
        if part != PART_2Nx2N:
            g = 4
            for (xp, yp, w, h) in self._pu_geometry(part, x0, y0, n)[1:]:
                self.pu_edge_ver[yp // g:(yp + h) // g, xp // g] = True
                self.pu_edge_hor[yp // g, xp // g:(xp + w) // g] = True
        rqt_root_cbf = 1
        if not (part == PART_2Nx2N and first_merge):
            rqt_root_cbf = c.decode(CT.NO_RESIDUAL_DATA)
        if rqt_root_cbf:
            inter_split = (sps.max_transform_hierarchy_depth_inter == 0 and
                           part != PART_2Nx2N)
            self.cu_x0, self.cu_y0, self.cu_log2 = x0, y0, log2size
            self._transform_tree(
                c, x0, y0, x0, y0, log2size, 0, 0,
                sps.max_transform_hierarchy_depth_inter, inter_split, 1, 1)
        if self.plan is not None:
            self.plan.record_inter_cu_done(x0, y0, n)

    # -- prediction unit (7.3.8.6) ----------------------------------------------

    def _prediction_unit(self, c: HevcCabac, xcb: int, ycb: int, ncb: int,
                         xp: int, yp: int, w: int, h: int, part_idx: int,
                         part: int, skip: bool) -> bool:
        hdr = self.cur_hdr
        max_merge = 5 - hdr.five_minus_max_num_merge_cand
        is_b = hdr.slice_type == B_SLICE
        merge = True
        if not skip:
            merge = bool(c.decode(CT.MERGE_FLAG))
        if merge:
            midx = 0
            if max_merge > 1:
                if c.decode(CT.MERGE_IDX):
                    midx = 1
                    while midx < max_merge - 1 and c.bypass():
                        midx += 1
            cand = self._merge_cands(xcb, ycb, ncb, xp, yp, w, h,
                                     part_idx, part, midx)
            pred, mv = cand.pred, list(cand.mv)
            ref_idx = list(cand.ref_idx)
            if pred == INT.PRED_BI and w + h == 12:
                pred, ref_idx[1] = INT.PRED_L0, -1  # 8x4/4x8 can't bi-pred
        else:
            if is_b:
                if w + h != 12:
                    depth = int(self.ct_depth[yp // 4, xp // 4])
                    if c.decode(CT.INTER_PRED_IDC + depth):
                        pred = INT.PRED_BI
                    else:
                        pred = (INT.PRED_L1
                                if c.decode(CT.INTER_PRED_IDC + 4)
                                else INT.PRED_L0)
                else:
                    pred = (INT.PRED_L1 if c.decode(CT.INTER_PRED_IDC + 4)
                            else INT.PRED_L0)
            else:
                pred = INT.PRED_L0
            mv = [(0, 0), (0, 0)]
            ref_idx = [-1, -1]
            for lx in (0, 1):
                if not (pred & (1 << lx)):
                    continue
                nref = hdr.num_ref_idx[lx]
                ridx = 0
                if nref > 1:
                    # ref_idx contexts are shared between lists (spec 9.3.4.2
                    # Table 9-4: one ctx set for ref_idx_lX)
                    base = CT.REF_IDX_L0
                    if c.decode(base):
                        ridx = 1
                        if nref > 2 and c.decode(base + 1):
                            ridx = 2
                            while ridx < nref - 1 and c.bypass():
                                ridx += 1
                ref_idx[lx] = ridx
                if lx == 1 and hdr.mvd_l1_zero and pred == INT.PRED_BI:
                    mvd = (0, 0)
                else:
                    mvd = self._mvd_coding(c)
                mvp_flag = c.decode(CT.MVP_LX_FLAG)
                mvp = self._amvp(xcb, ycb, ncb, xp, yp, w, h, part_idx,
                                 part, lx, ridx)[mvp_flag]
                # 16-bit wraparound (spec 8.5.3.2.1)
                mv[lx] = (_wrap16(mvp[0] + mvd[0]), _wrap16(mvp[1] + mvd[1]))
        # store the motion field + reconstruct (MC)
        g = 4
        ys = slice(yp // g, (yp + h) // g)
        xs = slice(xp // g, (xp + w) // g)
        for lx in (0, 1):
            on = bool(pred & (1 << lx))
            self.pred[lx, ys, xs] = int(on)
            self.mv[lx, ys, xs] = mv[lx] if on else (0, 0)
            self.ref_idx[lx, ys, xs] = ref_idx[lx] if on else -1
            self.ref_poc[lx, ys, xs] = (
                self.cur_refs[lx][ref_idx[lx]].poc if on else 0)
        self.mot_done[ys, xs] = True
        self.intra4[ys, xs] = 0
        if self.plan is not None:
            # device path: record the derived motion; pixels on the TPU
            slots = [self.slot_of[self.cur_refs[lx][ref_idx[lx]].poc]
                     if (pred & (1 << lx)) else 0 for lx in (0, 1)]
            self.plan.record_pu(xp, yp, w, h, pred, mv, slots,
                                ref_idx=ref_idx)
        else:
            wp = None
            if hdr.wp is not None:
                wp = (hdr.wp, hdr.luma_denom, hdr.chroma_denom)
            py, pcb, pcr = INT.predict_pu(self.cur_refs, xp, yp, w, h, pred,
                                          mv, ref_idx, wp=wp)
            self.y[yp:yp + h, xp:xp + w] = py
            self.cb[yp >> 1:(yp + h) >> 1, xp >> 1:(xp + w) >> 1] = pcb
            self.cr[yp >> 1:(yp + h) >> 1, xp >> 1:(xp + w) >> 1] = pcr
        self.avail_y[ys, xs] = True
        self.avail_c[yp // (2 * g):(yp + h) // (2 * g),
                     xp // (2 * g):(xp + w) // (2 * g)] = True
        return merge

    def _mvd_coding(self, c: HevcCabac):
        # HM context organisation: greater0 at slot +0, greater1 at slot +1
        # (see native/gen_hevc_tables.py LAYOUT notes)
        g0x = c.decode(CT.ABS_MVD_GREATER0)
        g0y = c.decode(CT.ABS_MVD_GREATER0)
        g1x = c.decode(CT.ABS_MVD_GREATER1 + 1) if g0x else 0
        g1y = c.decode(CT.ABS_MVD_GREATER1 + 1) if g0y else 0
        out = []
        for g0, g1 in ((g0x, g1x), (g0y, g1y)):
            if not g0:
                out.append(0)
                continue
            v = 1
            if g1:
                v = 2 + self._eg_bypass(c, 1)
            out.append(-v if c.bypass() else v)
        return (out[0], out[1])

    @staticmethod
    def _eg_bypass(c: HevcCabac, k: int) -> int:
        prefix = 0
        while c.bypass():
            prefix += 1
        suf = 0
        for _ in range(prefix + k):
            suf = (suf << 1) | c.bypass()
        return (((1 << prefix) - 1) << k) + suf

    # -- motion candidate derivation -------------------------------------------

    def _cell_motion(self, cx: int, cy: int) -> MotionCand:
        m = MotionCand()
        for lx in (0, 1):
            if self.pred[lx, cy, cx]:
                m.pred |= 1 << lx
                m.mv[lx] = (int(self.mv[lx, cy, cx, 0]),
                            int(self.mv[lx, cy, cx, 1]))
                m.ref_idx[lx] = int(self.ref_idx[lx, cy, cx])
        return m

    def _pb_avail(self, x: int, y: int) -> bool:
        """Spatial neighbour availability for merge/AMVP: inside picture,
        motion parsed (z-scan earlier, 6.4.1/6.4.2), not intra."""
        if x < 0 or y < 0 or x >= self.w or y >= self.h:
            return False
        cx, cy = x // 4, y // 4
        return bool(self.mot_done[cy, cx]) and not self.intra4[cy, cx]

    def _merge_cands(self, xcb: int, ycb: int, ncb: int, xp: int, yp: int,
                     w: int, h: int, part_idx: int, part: int,
                     want_idx: int) -> MotionCand:
        hdr = self.cur_hdr
        max_merge = 5 - hdr.five_minus_max_num_merge_cand
        is_b = hdr.slice_type == B_SLICE
        cands: List[MotionCand] = []

        def done():
            return len(cands) > want_idx or len(cands) >= max_merge

        # A1 (xp-1, yp+h-1)
        a1 = None
        if not (part in (PART_Nx2N, PART_nLx2N, PART_nRx2N)
                and part_idx == 1):
            if self._pb_avail(xp - 1, yp + h - 1):
                a1 = self._cell_motion((xp - 1) // 4, (yp + h - 1) // 4)
                cands.append(a1)
        # B1 (xp+w-1, yp-1)
        b1 = None
        if not done() and not (part in (PART_2NxN, PART_2NxnU, PART_2NxnD)
                               and part_idx == 1):
            if self._pb_avail(xp + w - 1, yp - 1):
                b1 = self._cell_motion((xp + w - 1) // 4, (yp - 1) // 4)
                if a1 is None or not b1.same_motion(a1):
                    cands.append(b1)
        # B0 (xp+w, yp-1)
        if not done() and self._pb_avail(xp + w, yp - 1):
            b0 = self._cell_motion((xp + w) // 4, (yp - 1) // 4)
            if b1 is None or not b0.same_motion(b1):
                cands.append(b0)
        # A0 (xp-1, yp+h)
        if not done() and self._pb_avail(xp - 1, yp + h):
            a0 = self._cell_motion((xp - 1) // 4, (yp + h) // 4)
            if a1 is None or not a0.same_motion(a1):
                cands.append(a0)
        # B2 (xp-1, yp-1), only if fewer than 4 spatial so far
        if not done() and len(cands) < 4 and self._pb_avail(xp - 1, yp - 1):
            b2 = self._cell_motion((xp - 1) // 4, (yp - 1) // 4)
            if ((a1 is None or not b2.same_motion(a1)) and
                    (b1 is None or not b2.same_motion(b1))):
                cands.append(b2)
        # temporal (TMVP), ref idx 0
        if not done() and hdr.temporal_mvp:
            t = MotionCand()
            mv0, ok0 = self._tmvp(xcb, ycb, xp, yp, w, h, 0, 0)
            if ok0:
                t.pred |= 1
                t.mv[0] = mv0
                t.ref_idx[0] = 0
            if is_b:
                mv1, ok1 = self._tmvp(xcb, ycb, xp, yp, w, h, 1, 0)
                if ok1:
                    t.pred |= 2
                    t.mv[1] = mv1
                    t.ref_idx[1] = 0
            if t.pred:
                cands.append(t)
        # combined bi-predictive (B slices, 8.5.3.2.4)
        if is_b and not done() and len(cands) > 1:
            norig = len(cands)
            for k in range(norig * (norig - 1)):
                if done():
                    break
                i0, i1 = INT.COMB_L0[k], INT.COMB_L1[k]
                if i0 >= norig or i1 >= norig:
                    break
                c0, c1 = cands[i0], cands[i1]
                if not (c0.pred & 1) or not (c1.pred & 2):
                    continue
                p0 = self.cur_refs[0][c0.ref_idx[0]].poc
                p1 = self.cur_refs[1][c1.ref_idx[1]].poc
                if p0 == p1 and c0.mv[0] == c1.mv[1]:
                    continue
                m = MotionCand()
                m.pred = INT.PRED_BI
                m.mv = [c0.mv[0], c1.mv[1]]
                m.ref_idx = [c0.ref_idx[0], c1.ref_idx[1]]
                cands.append(m)
        # zero candidates
        nrefs = (min(hdr.num_ref_idx[0], hdr.num_ref_idx[1])
                 if is_b else hdr.num_ref_idx[0])
        zidx = 0
        while not done():
            m = MotionCand()
            r = zidx if zidx < nrefs else 0
            m.pred = INT.PRED_BI if is_b else INT.PRED_L0
            m.ref_idx = [r, r if is_b else -1]
            cands.append(m)
            zidx += 1
        return cands[want_idx]

    def _tmvp(self, xcb: int, ycb: int, xp: int, yp: int, w: int, h: int,
              lx: int, ref_idx: int):
        """Temporal MV prediction (8.5.3.2.7/8.5.3.2.8). Returns (mv, ok)."""
        hdr = self.cur_hdr
        col_list = 0 if hdr.collocated_from_l0 else 1
        if not self.cur_refs[col_list]:
            return (0, 0), False
        col = self.cur_refs[col_list][hdr.collocated_ref_idx]
        target_poc = self.cur_refs[lx][ref_idx].poc
        # bottom-right H position, then the centre fallback
        for which in ("br", "c"):
            if which == "br":
                xc, yc = xp + w, yp + h
                if (ycb >> self.sps.log2_ctb) != (yc >> self.sps.log2_ctb):
                    continue
                if xc >= self.w or yc >= self.h:
                    continue
            else:
                xc, yc = xp + (w >> 1), yp + (h >> 1)
            cx, cy = ((xc >> 4) << 4) // 4, ((yc >> 4) << 4) // 4
            if cy >= col.intra.shape[0] or cx >= col.intra.shape[1]:
                continue
            if col.intra[cy, cx]:
                continue
            p0, p1 = bool(col.pred[0, cy, cx]), bool(col.pred[1, cy, cx])
            if not (p0 or p1):
                continue
            if not p0:
                use = 1
            elif not p1:
                use = 0
            elif self.pic_no_backward():
                use = lx
            else:
                use = 1 if hdr.collocated_from_l0 else 0
            mv = (int(col.mv[use, cy, cx, 0]), int(col.mv[use, cy, cx, 1]))
            col_diff = col.poc - int(col.ref_poc[use, cy, cx])
            cur_diff = self.poc - target_poc
            if col_diff != cur_diff:
                mv = INT.scale_mv(mv, cur_diff, col_diff)
            return mv, True
        return (0, 0), False

    def pic_no_backward(self) -> bool:
        return self.no_backward

    def _amvp(self, xcb: int, ycb: int, ncb: int, xp: int, yp: int,
              w: int, h: int, part_idx: int, part: int, lx: int,
              ref_idx: int):
        """AMVP list (8.5.3.2.6): two MV predictors."""
        hdr = self.cur_hdr
        target_poc = self.cur_refs[lx][ref_idx].poc

        def cell_at(x, y):
            return x // 4, y // 4

        def same_ref_mv(x, y):
            cx, cy = cell_at(x, y)
            for ly in (lx, 1 - lx):
                if self.pred[ly, cy, cx] and \
                        int(self.ref_poc[ly, cy, cx]) == target_poc:
                    return (int(self.mv[ly, cy, cx, 0]),
                            int(self.mv[ly, cy, cx, 1]))
            return None

        def scaled_mv(x, y):
            cx, cy = cell_at(x, y)
            for ly in (lx, 1 - lx):
                if self.pred[ly, cy, cx]:
                    mv = (int(self.mv[ly, cy, cx, 0]),
                          int(self.mv[ly, cy, cx, 1]))
                    col_diff = self.poc - int(self.ref_poc[ly, cy, cx])
                    cur_diff = self.poc - target_poc
                    if col_diff != cur_diff:
                        mv = INT.scale_mv(mv, cur_diff, col_diff)
                    return mv
            return None

        pa0 = (xp - 1, yp + h)
        pa1 = (xp - 1, yp + h - 1)
        avail_a0 = self._pb_avail(*pa0)
        avail_a1 = self._pb_avail(*pa1)
        is_scaled = avail_a0 or avail_a1
        mv_a, avail_a = None, False
        for (x, y), ok in ((pa0, avail_a0), (pa1, avail_a1)):
            if not ok:
                continue
            mv = same_ref_mv(x, y)
            if mv is not None:
                mv_a, avail_a = mv, True
                break
        if not avail_a:
            for (x, y), ok in ((pa0, avail_a0), (pa1, avail_a1)):
                if not ok:
                    continue
                mv = scaled_mv(x, y)
                if mv is not None:
                    mv_a, avail_a = mv, True
                    break
        pbs = ((xp + w, yp - 1), (xp + w - 1, yp - 1), (xp - 1, yp - 1))
        mv_b, avail_b = None, False
        for (x, y) in pbs:
            if not self._pb_avail(x, y):
                continue
            mv = same_ref_mv(x, y)
            if mv is not None:
                mv_b, avail_b = mv, True
                break
        if not is_scaled:
            mv_a, avail_a = mv_b, avail_b
            mv_b, avail_b = None, False
            for (x, y) in pbs:
                if not self._pb_avail(x, y):
                    continue
                mv = scaled_mv(x, y)
                if mv is not None:
                    mv_b, avail_b = mv, True
                    break
        out = []
        if avail_a:
            out.append(mv_a)
        if avail_b and (not avail_a or mv_b != mv_a):
            out.append(mv_b)
        if len(out) < 2 and hdr.temporal_mvp:
            mv, ok = self._tmvp(xcb, ycb, xp, yp, w, h, lx, ref_idx)
            if ok:
                out.append(mv)
        while len(out) < 2:
            out.append((0, 0))
        return out[:2]

    # -- intra coding unit ------------------------------------------------------

    def _intra_cu(self, c: HevcCabac, x0: int, y0: int, log2size: int,
                  depth: int) -> None:
        sps, pps = self.sps, self.pps
        n = 1 << log2size
        g = 4
        self.cu_pred_mode = MODE_INTRA
        self.intra4[y0 // g:(y0 + n) // g, x0 // g:(x0 + n) // g] = 1
        # part_mode
        part_nxn = False
        if log2size == sps.log2_min_cb:
            if not c.decode(CT.PART_MODE):
                part_nxn = True
        if sps.pcm_enabled:
            raise NotImplementedError("PCM")
        # luma modes
        npu = 2 if part_nxn else 1
        pb = n >> (npu - 1)
        prev_flags = []
        for j in range(npu * npu):
            prev_flags.append(c.decode(CT.PREV_INTRA_LUMA_PRED))
        modes = []
        for j in range(npu * npu):
            px = x0 + (j & 1) * pb
            py = y0 + (j >> 1) * pb
            cands = self._mpm(px, py)
            if prev_flags[j]:
                mpm_idx = c.tr_bypass(2)
                mode = cands[mpm_idx]
            else:
                rem = 0
                for _ in range(5):
                    rem = (rem << 1) | c.bypass()
                mode = rem
                for cm in sorted(cands):
                    if mode >= cm:
                        mode += 1
            modes.append(mode)
            self.mode_y[py // g:(py + pb) // g, px // g:(px + pb) // g] = mode
            self.mode_avail[py // g:(py + pb) // g,
                            px // g:(px + pb) // g] = True
        # chroma mode (4:2:0: one per CU)
        if c.decode(CT.INTRA_CHROMA_PRED_MODE):
            idx = (c.bypass() << 1) | c.bypass()
            cand = (IP.PLANAR, IP.VER, IP.HOR, IP.DC)[idx]
            cmode = 34 if cand == modes[0] else cand
        else:
            cmode = modes[0]
        self.cu_cmode = cmode
        self.cu_modes = modes
        self.cu_part_nxn = part_nxn
        self.cu_x0, self.cu_y0, self.cu_log2 = x0, y0, log2size
        # transform tree
        max_depth = sps.max_transform_hierarchy_depth_intra + (
            1 if part_nxn else 0)
        self._transform_tree(c, x0, y0, x0, y0, log2size, 0, 0,
                             max_depth, part_nxn, 1, 1)
        # CU boundary edges for deblock (TU edges are marked per-leaf; CU
        # edge == outer TU edge so nothing extra needed for intra)

    def _mpm(self, px: int, py: int) -> List[int]:
        g = 4
        # candA: left (px-1, py); candB: above (px, py-1), forced DC if
        # outside current CTB row (spec 8.4.2)
        a = IP.DC
        if px > 0 and self.mode_avail[py // g, (px - 1) // g]:
            a = int(self.mode_y[py // g, (px - 1) // g])
        b = IP.DC
        if py > 0 and self.mode_avail[(py - 1) // g, px // g] and \
                (py % self.ctb) != 0:
            b = int(self.mode_y[(py - 1) // g, px // g])
        if a == b:
            if a < 2:
                return [IP.PLANAR, IP.DC, IP.VER]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        lst = [a, b]
        if IP.PLANAR not in lst:
            lst.append(IP.PLANAR)
        elif IP.DC not in lst:
            lst.append(IP.DC)
        else:
            lst.append(IP.VER)
        return lst

    # -- transform tree ------------------------------------------------------

    def _transform_tree(self, c: HevcCabac, x0: int, y0: int, x_base: int,
                        y_base: int, log2size: int, depth: int, blk_idx: int,
                        max_depth: int, intra_split: bool,
                        parent_cbf_cb: int, parent_cbf_cr: int) -> None:
        sps = self.sps
        if (log2size <= sps.log2_max_tb and log2size > sps.log2_min_tb and
                depth < max_depth and not (intra_split and depth == 0)):
            split = c.decode(CT.SPLIT_TRANSFORM_FLAG + 5 - log2size)
        else:
            split = (log2size > sps.log2_max_tb or
                     (intra_split and depth == 0))
            if log2size <= sps.log2_min_tb:
                split = False
        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2size > 2:
            if depth == 0 or parent_cbf_cb:
                cbf_cb = c.decode(CT.CBF_CB_CR + depth)
            else:
                cbf_cb = 0
            if depth == 0 or parent_cbf_cr:
                cbf_cr = c.decode(CT.CBF_CB_CR + depth)
            else:
                cbf_cr = 0
        if split:
            half = 1 << (log2size - 1)
            for i, (dx, dy) in enumerate(
                    ((0, 0), (half, 0), (0, half), (half, half))):
                self._transform_tree(c, x0 + dx, y0 + dy, x0, y0,
                                     log2size - 1, depth + 1, i, max_depth,
                                     intra_split, cbf_cb, cbf_cr)
            return
        # leaf
        if self.cu_pred_mode == MODE_INTRA or depth != 0 or cbf_cb or cbf_cr:
            cbf_luma = c.decode(CT.CBF_LUMA + (1 if depth == 0 else 0))
        else:
            cbf_luma = 1  # inferred for an inter CU with rqt_root_cbf
        self._transform_unit(c, x0, y0, x_base, y_base, log2size, depth,
                             blk_idx, cbf_luma, cbf_cb, cbf_cr)

    def _transform_unit(self, c: HevcCabac, x0: int, y0: int, x_base: int,
                        y_base: int, log2size: int, depth: int, blk_idx: int,
                        cbf_luma: int, cbf_cb: int, cbf_cr: int) -> None:
        pps = self.pps
        if (pps.cu_qp_delta_enabled and not self.qg_coded and
                (cbf_luma or cbf_cb or cbf_cr)):
            # cu_qp_delta_abs: TR cMax=5 (bin0 its own ctx, bins 1..4 a
            # shared ctx), EG0 bypass suffix; sign bypass (9.3.3 / 7.3.8.10)
            v = 0
            if c.decode(CT.CU_QP_DELTA):
                v = 1
                while v < 5 and c.decode(CT.CU_QP_DELTA + 1):
                    v += 1
                if v == 5:
                    k = 0
                    while c.bypass():
                        k += 1
                    suf = 0
                    for _ in range(k):
                        suf = (suf << 1) | c.bypass()
                    v += (1 << k) - 1 + suf
            if v and c.bypass():
                v = -v
            self.qg_delta = v
            self.qg_coded = True
        qp = self.cur_qp()
        n = 1 << log2size
        # mark TU edges + the luma-cbf map for deblock bS (finish_bs)
        g = 4
        self.tu_edge_ver[y0 // g:(y0 + n) // g, x0 // g] = True
        self.tu_edge_hor[y0 // g, x0 // g:(x0 + n) // g] = True
        self.cbf4[y0 // g:(y0 + n) // g, x0 // g:(x0 + n) // g] = cbf_luma
        if self.cu_pred_mode == MODE_INTER:
            if cbf_luma:
                coeffs = self._residual(c, log2size, 0, 0)
                ts = self._tskip
                if self.plan is not None:
                    if ts:
                        # device residual path is DCT/DST-only so far:
                        # this picture re-decodes on the host below
                        self.plan.supported = False
                        self.plan.reason = "transform_skip"
                    self.plan.record_inter_luma_tu(x0, y0, n, coeffs)
                else:
                    d = TR.dequant(coeffs, qp, log2size)
                    res = (_ts_residual(d) if ts else
                           TR.inverse_transform(d, log2size, dst=False))
                    blk = self.y[y0:y0 + n, x0:x0 + n]
                    self.y[y0:y0 + n, x0:x0 + n] = np.clip(blk + res, 0, 255)
            if log2size > 2:
                self._chroma_unit(c, x0 >> 1, y0 >> 1, log2size - 1,
                                  cbf_cb, cbf_cr)
            elif blk_idx == 3:
                self._chroma_unit(c, x_base >> 1, y_base >> 1, 2,
                                  cbf_cb, cbf_cr)
            return
        # luma prediction + residual
        mode = self._luma_mode_at(x0, y0)
        res = None
        coeffs = None
        if cbf_luma:
            scan = self._scan_idx(mode, log2size, 0)
            coeffs = self._residual(c, log2size, 0, scan)
            if self._tskip and self.plan is not None:
                self.plan.supported = False
                self.plan.reason = "transform_skip"
            if self.plan is None:
                d = TR.dequant(coeffs, qp, log2size)
                res = (_ts_residual(d) if self._tskip else
                       TR.inverse_transform(d, log2size,
                                            dst=(log2size == 2)))
        if self.plan is not None:
            self.plan.record_luma_tu(x0, y0, n, mode, qp, coeffs)
        self._recon_intra(self.y, self.avail_y, x0, y0, n, mode, 0, res)
        # chroma at this node?
        if log2size > 2:
            self._chroma_unit(c, x0 >> 1, y0 >> 1, log2size - 1,
                              cbf_cb, cbf_cr)
        elif blk_idx == 3:
            self._chroma_unit(c, x_base >> 1, y_base >> 1, 2,
                              cbf_cb, cbf_cr)

    def _chroma_unit(self, c: HevcCabac, xc: int, yc: int, log2size: int,
                     cbf_cb: int, cbf_cr: int) -> None:
        qp = self.cur_qp()
        pps = self.pps
        hdr = self.cur_hdr
        n = 1 << log2size
        if self.cu_pred_mode == MODE_INTER:
            plan_c = [None, None]
            for cidx, (plane, cbf, off) in enumerate((
                    (self.cb, cbf_cb, pps.cb_qp_offset + hdr.cb_qp_offset),
                    (self.cr, cbf_cr, pps.cr_qp_offset + hdr.cr_qp_offset)),
                    start=1):
                if not cbf:
                    continue
                coeffs = self._residual(c, log2size, cidx, 0)
                if self.plan is not None:
                    if self._tskip:
                        self.plan.supported = False
                        self.plan.reason = "transform_skip"
                    plan_c[cidx - 1] = coeffs
                    continue
                qpc = TR.chroma_qp(qp, off)
                d = TR.dequant(coeffs, qpc, log2size)
                res = (_ts_residual(d) if self._tskip else
                       TR.inverse_transform(d, log2size, dst=False))
                blk = plane[yc:yc + n, xc:xc + n]
                plane[yc:yc + n, xc:xc + n] = np.clip(blk + res, 0, 255)
            if self.plan is not None and (cbf_cb or cbf_cr):
                self.plan.record_inter_chroma_tu(xc, yc, n, *plan_c)
            return
        mode = self.cu_cmode
        plan_coeffs = [None, None]
        for cidx, (plane, cbf, off) in enumerate((
                (self.cb, cbf_cb, pps.cb_qp_offset + hdr.cb_qp_offset),
                (self.cr, cbf_cr, pps.cr_qp_offset + hdr.cr_qp_offset)),
                start=1):
            res = None
            if cbf:
                scan = self._scan_idx(mode, log2size, cidx)
                coeffs = self._residual(c, log2size, cidx, scan)
                plan_coeffs[cidx - 1] = coeffs
                if self._tskip and self.plan is not None:
                    self.plan.supported = False
                    self.plan.reason = "transform_skip"
                if self.plan is None:
                    qpc = TR.chroma_qp(qp, off)
                    d = TR.dequant(coeffs, qpc, log2size)
                    res = (_ts_residual(d) if self._tskip else
                           TR.inverse_transform(d, log2size, dst=False))
            # cb and cr share one availability map: mark after cr only
            self._recon_intra(plane, self.avail_c, xc, yc, n, mode, cidx,
                              res, mark=(cidx == 2))
        if self.plan is not None:
            self.plan.record_chroma_tu(xc, yc, n, mode, *plan_coeffs)

    def _luma_mode_at(self, x0: int, y0: int) -> int:
        if not self.cu_part_nxn:
            return self.cu_modes[0]
        half = 1 << (self.cu_log2 - 1)
        j = ((y0 - self.cu_y0) >= half) * 2 + ((x0 - self.cu_x0) >= half)
        return self.cu_modes[j]

    @staticmethod
    def _scan_idx(mode: int, log2size: int, cidx: int) -> int:
        if log2size == 2 or (log2size == 3 and cidx == 0):
            if 6 <= mode <= 14:
                return 2
            if 22 <= mode <= 30:
                return 1
        return 0

    def _recon_intra(self, plane, avail, x0, y0, n, mode, cidx, res,
                     mark=True):
        sps = self.sps
        if self.plan is not None:
            # plan mode: parse-state bookkeeping only, pixels on the device
            if mark:
                g = 4
                avail[y0 // g:(y0 + n) // g, x0 // g:(x0 + n) // g] = True
            return
        left, tl, top = IP.gather_references(plane, avail, x0, y0, n)
        if cidx == 0:
            left, tl, top = IP.filter_references(
                left, tl, top, n, mode, sps.strong_intra_smoothing)
        pred = IP.predict(mode, left, tl, top, n, cidx)
        if res is not None:
            pred = pred + res
        plane[y0:y0 + n, x0:x0 + n] = np.clip(pred, 0, 255)
        if mark:
            g = 4
            avail[y0 // g:(y0 + n) // g, x0 // g:(x0 + n) // g] = True

    # -- residual coding (7.3.8.11) ------------------------------------------

    def _residual(self, c: HevcCabac, log2size: int, cidx: int,
                  scan_idx: int) -> np.ndarray:
        pps = self.pps
        n = 1 << log2size
        block = np.zeros((n, n), np.int32)
        tskip = False
        if pps.transform_skip_enabled and log2size == 2:
            tskip = bool(c.decode(CT.TRANSFORM_SKIP + (1 if cidx else 0)))
        # remembered for the caller's recon: TS blocks share this exact
        # residual_coding syntax, only the inverse transform differs
        self._tskip = tskip
        # last significant coeff position
        lx = self._last_prefix(c, CT.LAST_SIG_X_PREFIX, log2size, cidx)
        ly = self._last_prefix(c, CT.LAST_SIG_Y_PREFIX, log2size, cidx)
        lx = self._last_suffix(c, lx)
        ly = self._last_suffix(c, ly)
        if scan_idx == 2:
            lx, ly = ly, lx
        sb_n = max(1, n >> 2)
        sb_scan = _SCANS[(sb_n, scan_idx)]
        in_scan = _SCANS[(4, scan_idx)]
        sb_pos = {p: i for i, p in enumerate(sb_scan)}
        in_pos = {p: i for i, p in enumerate(in_scan)}
        i_last = sb_pos[(lx >> 2, ly >> 2)]
        k_last = in_pos[(lx & 3, ly & 3)]
        csbf = np.zeros((sb_n, sb_n), np.int8)
        c1 = 1
        sdh = pps.sign_data_hiding
        for i in range(i_last, -1, -1):
            sx, sy = sb_scan[i]
            if i == i_last or i == 0:
                coded = 1
                infer_dc = 0
            else:
                right = csbf[sy, sx + 1] if sx + 1 < sb_n else 0
                below = csbf[sy + 1, sx] if sy + 1 < sb_n else 0
                ctx = min(int(right) + int(below), 1) + (2 if cidx else 0)
                coded = c.decode(CT.SIG_COEFF_GROUP + ctx)
                infer_dc = 1
            csbf[sy, sx] = coded
            if not coded:
                continue
            # sig_coeff_flags
            sig = []  # inner scan indices with sig, descending
            start = k_last - 1 if i == i_last else 15
            if i == i_last:
                sig.append(k_last)
            found = bool(sig)
            for k in range(start, -1, -1):
                if k == 0 and infer_dc and not found:
                    sig.append(0)
                    break
                xin, yin = in_scan[k]
                xc_, yc_ = (sx << 2) + xin, (sy << 2) + yin
                ctx = self._sig_ctx(xc_, yc_, sx, sy, csbf, sb_n, log2size,
                                    cidx, scan_idx)
                if c.decode(CT.SIG_COEFF_FLAG + ctx):
                    sig.append(k)
                    found = True
            nsig = len(sig)
            if not nsig:
                continue
            # greater1 / greater2
            ctx_set = 0 if (i == 0 or cidx > 0) else 2
            if c1 == 0:
                ctx_set += 1
            c1 = 1
            base_g1 = CT.COEFF_ABS_GREATER1 + (16 if cidx else 0) + \
                4 * ctx_set
            g1 = []
            first_g1 = -1
            for j in range(min(nsig, 8)):
                b = c.decode(base_g1 + c1)
                g1.append(b)
                if b:
                    if first_g1 < 0:
                        first_g1 = j
                    c1 = 0
                elif 0 < c1 < 3:
                    c1 += 1
            g2 = 0
            if first_g1 >= 0:
                g2 = c.decode(CT.COEFF_ABS_GREATER2 + (4 if cidx else 0)
                              + ctx_set)
            # signs
            hidden = sdh and (sig[0] - sig[-1] > 3)
            nsigns = nsig - 1 if hidden else nsig
            signs = [c.bypass() for _ in range(nsigns)]
            # levels
            rice = 0
            total = 0
            levels = []
            for j, k in enumerate(sig):
                base = 1
                if j < 8:
                    base += g1[j]
                    if j == first_g1:
                        base += g2
                    thresh = 3 if j == first_g1 else 2
                else:
                    thresh = 1
                level = base
                if base == thresh:
                    rem = self._abs_remaining(c, rice)
                    level += rem
                    if level > 3 << rice:
                        rice = min(rice + 1, 4)
                total += level
                levels.append(level)
            for j, k in enumerate(sig):
                xin, yin = in_scan[k]
                xc_, yc_ = (sx << 2) + xin, (sy << 2) + yin
                if j < nsigns:
                    v = -levels[j] if signs[j] else levels[j]
                else:  # hidden sign from parity
                    v = -levels[j] if (total & 1) else levels[j]
                block[yc_, xc_] = v
        return block

    def _last_prefix(self, c: HevcCabac, base: int, log2size: int,
                     cidx: int) -> int:
        if cidx == 0:
            off = 3 * (log2size - 2) + ((log2size - 1) >> 2)
            shift = (log2size + 1) >> 2
        else:
            off = 15
            shift = log2size - 2
        cmax = (log2size << 1) - 1
        v = 0
        while v < cmax and c.decode(base + off + (v >> shift)):
            v += 1
        return v

    def _last_suffix(self, c: HevcCabac, prefix: int) -> int:
        if prefix <= 3:
            return prefix
        nbits = (prefix >> 1) - 1
        suf = 0
        for _ in range(nbits):
            suf = (suf << 1) | c.bypass()
        return ((2 + (prefix & 1)) << nbits) + suf

    @staticmethod
    def _abs_remaining(c: HevcCabac, rice: int) -> int:
        prefix = 0
        while prefix < 32 and c.bypass():
            prefix += 1
        if prefix <= 3:
            suf = 0
            for _ in range(rice):
                suf = (suf << 1) | c.bypass()
            return (prefix << rice) + suf
        nbits = prefix - 3 + rice
        suf = 0
        for _ in range(nbits):
            suf = (suf << 1) | c.bypass()
        return (((1 << (prefix - 3)) + 3 - 1) << rice) + suf

    def _sig_ctx(self, xc: int, yc: int, sx: int, sy: int, csbf, sb_n: int,
                 log2size: int, cidx: int, scan_idx: int) -> int:
        if log2size == 2:
            sig = _CTX_IDX_MAP[(yc << 2) + xc]
        elif xc + yc == 0:
            sig = 0
        else:
            right = int(csbf[sy, sx + 1]) if sx + 1 < sb_n else 0
            below = int(csbf[sy + 1, sx]) if sy + 1 < sb_n else 0
            prev = right | (below << 1)
            xp, yp = xc & 3, yc & 3
            if prev == 0:
                sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
            elif prev == 1:
                sig = 2 if yp == 0 else (1 if yp == 1 else 0)
            elif prev == 2:
                sig = 2 if xp == 0 else (1 if xp == 1 else 0)
            else:
                sig = 2
            if cidx == 0:
                if (sx, sy) != (0, 0):
                    sig += 3
                sig += (9 if scan_idx == 0 else 15) if log2size == 3 else 21
            else:
                sig += 9 if log2size == 3 else 12
        return sig + (27 if cidx else 0)

    # -- in-loop filters -----------------------------------------------------

    def finish_bs(self) -> None:
        """Derive deblock boundary strengths (8.7.2.4) from the recorded
        TU/PU edge masks + per-cell prediction data, vectorized over the
        4x4 cell grid. All-intra pictures reduce to bS=2 at TU edges."""
        BIG = 1 << 30
        for axis in ("v", "h"):
            if axis == "v":
                tu_e = self.tu_edge_ver[:, 1:]
                pu_e = self.pu_edge_ver[:, 1:]
                sl_p = (slice(None), slice(None, -1))
                sl_q = (slice(None), slice(1, None))
                out = self.bs_ver
            else:
                tu_e = self.tu_edge_hor[1:, :]
                pu_e = self.pu_edge_hor[1:, :]
                sl_p = (slice(None, -1), slice(None))
                sl_q = (slice(1, None), slice(None))
                out = self.bs_hor
            edge = tu_e | pu_e
            bs2 = self.intra4[sl_p].astype(bool) | \
                self.intra4[sl_q].astype(bool)
            cbf_any = (self.cbf4[sl_p] | self.cbf4[sl_q]).astype(bool)
            lsl = (slice(None),)
            predP = self.pred[lsl + sl_p].astype(np.int32)
            predQ = self.pred[lsl + sl_q].astype(np.int32)
            nP, nQ = predP[0] + predP[1], predQ[0] + predQ[1]
            mvP, mvQ = self.mv[lsl + sl_p], self.mv[lsl + sl_q]
            rP = np.where(predP > 0, self.ref_poc[lsl + sl_p], BIG)
            rQ = np.where(predQ > 0, self.ref_poc[lsl + sl_q], BIG)
            refs_differ = (
                (np.minimum(rP[0], rP[1]) != np.minimum(rQ[0], rQ[1])) |
                (np.maximum(rP[0], rP[1]) != np.maximum(rQ[0], rQ[1])))
            mm = lambda a, b: np.any(np.abs(a - b) >= 4, axis=-1)
            mvP_uni = np.where(predP[0][..., None] == 1, mvP[0], mvP[1])
            mvQ_uni = np.where(predQ[0][..., None] == 1, mvQ[0], mvQ[1])
            uni = mm(mvP_uni, mvQ_uni)
            straight = mm(mvP[0], mvQ[0]) | mm(mvP[1], mvQ[1])
            crossed = mm(mvP[0], mvQ[1]) | mm(mvP[1], mvQ[0])
            mapped = np.where(rP[0] == rQ[0], straight, crossed)
            bi = np.where(rP[0] == rP[1], straight & crossed, mapped)
            mv_mismatch = np.where(nP == 1, uni, bi)
            bs1 = (tu_e & cbf_any) | (nP != nQ) | refs_differ | mv_mismatch
            bs = np.where(edge, np.where(bs2, 2, np.where(bs1, 1, 0)), 0)
            out[:] = 0
            out[sl_q] = bs.astype(out.dtype)

    def _cell_slices(self) -> np.ndarray:
        """The slice of each 4x4 luma cell."""
        k = 1 << (self.sps.log2_ctb - 2)
        ch, cw = self.bs_ver.shape
        return np.kron(self.slice_id, np.ones((k, k), np.int32))[:ch, :cw]

    def _filter_blocked(self, nb, cur) -> np.ndarray:
        """Whether the in-loop filters may not reach from a sample in slice
        cur to one in slice nb (arrays of slice ids): across the left and
        upper boundary of a slice whose
        slice_loop_filter_across_slices_enabled_flag is 0 (7.4.7.1,
        8.7.2.3, 8.7.3.2)."""
        across = np.asarray(self.lf_across, bool)
        return (((nb < cur) & ~across[cur]) |
                ((nb > cur) & ~across[np.maximum(nb, 0)]))

    def deblock(self) -> None:
        hdr = self.cur_hdr
        if hdr.deblocking_disabled:
            return
        if self.cur_slice > 1:
            # no edge filtered across a slice boundary that forbids it
            sl = self._cell_slices()
            self.bs_ver[:, 1:][self._filter_blocked(sl[:, :-1],
                                                    sl[:, 1:])] = 0
            self.bs_hor[1:, :][self._filter_blocked(sl[:-1, :],
                                                    sl[1:, :])] = 0
        for plane_pass in ("v", "h"):
            self._deblock_luma(plane_pass)
            self._deblock_chroma(plane_pass)

    def _deblock_luma(self, direction: str) -> None:
        hdr = self.cur_hdr
        y = self.y
        h, w = y.shape
        beta_off = hdr.beta_offset_div2 * 2
        tc_off = hdr.tc_offset_div2 * 2
        bs_map = self.bs_ver if direction == "v" else self.bs_hor
        edge_step = 8
        if direction == "v":
            xs = range(8, w, edge_step)
        else:
            xs = range(8, h, edge_step)
        for e in xs:
            if direction == "v":
                nseg = h // 4
                bss = bs_map[:, e // 4]
            else:
                nseg = w // 4
                bss = bs_map[e // 4, :]
            for s in range(nseg):
                bs = int(bss[s])
                if bs == 0:
                    continue
                if direction == "v":
                    rows = slice(s * 4, s * 4 + 4)
                    q = y[rows, e:e + 4]
                    p = y[rows, e - 4:e][:, ::-1]
                    qp_p = int(self.qp_map[s, (e - 1) // 4])
                    qp_q = int(self.qp_map[s, e // 4])
                else:
                    cols = slice(s * 4, s * 4 + 4)
                    q = y[e:e + 4, cols].T
                    p = y[e - 4:e, cols][::-1].T
                    qp_p = int(self.qp_map[(e - 1) // 4, s])
                    qp_q = int(self.qp_map[e // 4, s])
                qpl = (qp_p + qp_q + 1) >> 1
                beta = _BETA[min(max(qpl + beta_off, 0), 51)]
                tc = _TC[min(max(qpl + 2 * (bs - 1) + tc_off, 0), 53)]
                np_, nq = self._filter_luma_segment(p.copy(), q.copy(),
                                                    beta, tc)
                if np_ is None:
                    continue
                if direction == "v":
                    y[rows, e - 4:e] = np_[:, ::-1]
                    y[rows, e:e + 4] = nq
                else:
                    y[e - 4:e, cols] = np_.T[::-1]
                    y[e:e + 4, cols] = nq.T

    @staticmethod
    def _filter_luma_segment(p, q, beta, tc):
        """p/q: [4 lines][4 samples], p[:,0] nearest the edge. 8.7.2.5."""
        if tc == 0 and beta == 0:
            return None, None
        dp0 = abs(int(p[0, 2]) - 2 * int(p[0, 1]) + int(p[0, 0]))
        dp3 = abs(int(p[3, 2]) - 2 * int(p[3, 1]) + int(p[3, 0]))
        dq0 = abs(int(q[0, 2]) - 2 * int(q[0, 1]) + int(q[0, 0]))
        dq3 = abs(int(q[3, 2]) - 2 * int(q[3, 1]) + int(q[3, 0]))
        dpq0, dpq3 = dp0 + dq0, dp3 + dq3
        d = dpq0 + dpq3
        if d >= beta:
            return None, None
        strong = True
        for i in (0, 3):
            dpq = dpq0 if i == 0 else dpq3
            if not (2 * dpq < (beta >> 2) and
                    abs(int(p[i, 3]) - int(p[i, 0])) +
                    abs(int(q[i, 0]) - int(q[i, 3])) < (beta >> 3) and
                    abs(int(p[i, 0]) - int(q[i, 0])) < ((5 * tc + 1) >> 1)):
                strong = False
                break
        P = p.astype(np.int32)
        Q = q.astype(np.int32)
        if strong:
            np_, nq = P.copy(), Q.copy()
            for i in range(4):
                p0, p1, p2, p3 = (int(P[i, 0]), int(P[i, 1]), int(P[i, 2]),
                                  int(P[i, 3]))
                q0, q1, q2, q3 = (int(Q[i, 0]), int(Q[i, 1]), int(Q[i, 2]),
                                  int(Q[i, 3]))
                cl = lambda v, r: max(r - 2 * tc, min(r + 2 * tc, v))
                np_[i, 0] = cl((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                               p0)
                np_[i, 1] = cl((p2 + p1 + p0 + q0 + 2) >> 2, p1)
                np_[i, 2] = cl((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
                nq[i, 0] = cl((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                              q0)
                nq[i, 1] = cl((p0 + q0 + q1 + q2 + 2) >> 2, q1)
                nq[i, 2] = cl((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)
            return np_, nq
        # weak
        dep = int(dp0 + dp3 < ((beta + (beta >> 1)) >> 3))
        deq = int(dq0 + dq3 < ((beta + (beta >> 1)) >> 3))
        np_, nq = P.copy(), Q.copy()
        for i in range(4):
            p0, p1, p2 = int(P[i, 0]), int(P[i, 1]), int(P[i, 2])
            q0, q1, q2 = int(Q[i, 0]), int(Q[i, 1]), int(Q[i, 2])
            delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
            if abs(delta) >= tc * 10:
                continue
            delta = max(-tc, min(tc, delta))
            np_[i, 0] = min(255, max(0, p0 + delta))
            nq[i, 0] = min(255, max(0, q0 - delta))
            if dep:
                dp = max(-(tc >> 1), min(tc >> 1,
                         (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1))
                np_[i, 1] = min(255, max(0, p1 + dp))
            if deq:
                dq = max(-(tc >> 1), min(tc >> 1,
                         (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1))
                nq[i, 1] = min(255, max(0, q1 + dq))
        return np_, nq

    def _deblock_chroma(self, direction: str) -> None:
        hdr = self.cur_hdr
        pps = self.pps
        tc_off = hdr.tc_offset_div2 * 2
        for plane, qpoff in ((self.cb, pps.cb_qp_offset + hdr.cb_qp_offset),
                             (self.cr, pps.cr_qp_offset + hdr.cr_qp_offset)):
            h, w = plane.shape
            bs_map = self.bs_ver if direction == "v" else self.bs_hor
            if direction == "v":
                edges = range(8, w, 8)
            else:
                edges = range(8, h, 8)
            for e in edges:
                le = e * 2  # luma coordinate of the edge
                nseg = (h if direction == "v" else w) // 4
                for s in range(nseg):
                    # chroma 4-sample segment at chroma rows s*4..; bS from
                    # luma map (must be 2)
                    ly4 = (s * 4 * 2) // 4
                    if direction == "v":
                        bs = int(self.bs_ver[ly4, le // 4])
                    else:
                        bs = int(self.bs_hor[le // 4, ly4])
                    if bs < 2:
                        continue
                    if direction == "v":
                        rows = slice(s * 4, s * 4 + 4)
                        qq = plane[rows, e:e + 2]
                        pp = plane[rows, e - 2:e][:, ::-1]
                        qp_p = int(self.qp_map[(s * 4 * 2) // 4,
                                               (le - 1) // 4])
                        qp_q = int(self.qp_map[(s * 4 * 2) // 4, le // 4])
                    else:
                        cols = slice(s * 4, s * 4 + 4)
                        qq = plane[e:e + 2, cols].T
                        pp = plane[e - 2:e, cols][::-1].T
                        qp_p = int(self.qp_map[(le - 1) // 4,
                                               (s * 4 * 2) // 4])
                        qp_q = int(self.qp_map[le // 4, (s * 4 * 2) // 4])
                    qpl = (qp_p + qp_q + 1) >> 1
                    qpc = TR.chroma_qp(qpl, qpoff)
                    tc = _TC[min(max(qpc + 2 + tc_off, 0), 53)]
                    if tc == 0:
                        continue
                    np_ = pp.astype(np.int32).copy()
                    nq = qq.astype(np.int32).copy()
                    for i in range(4):
                        p0, p1 = int(pp[i, 0]), int(pp[i, 1])
                        q0, q1 = int(qq[i, 0]), int(qq[i, 1])
                        delta = max(-tc, min(tc,
                                    ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3)))
                        np_[i, 0] = min(255, max(0, p0 + delta))
                        nq[i, 0] = min(255, max(0, q0 - delta))
                    if direction == "v":
                        plane[rows, e - 2:e] = np_[:, ::-1]
                        plane[rows, e:e + 2] = nq
                    else:
                        plane[e - 2:e, cols] = np_.T[::-1]
                        plane[e:e + 2, cols] = nq.T

    # -- SAO ------------------------------------------------------------------

    def sao(self) -> None:
        hdr = self.cur_hdr
        if not (hdr.sao_luma or hdr.sao_chroma):
            return
        pre = (self.y.copy(), self.cb.copy(), self.cr.copy())
        for yc in range(self.ctb_h):
            for xc in range(self.ctb_w):
                p = self.sao_params[yc * self.ctb_w + xc]
                if p is None:
                    continue
                for ci, (plane, src) in enumerate(
                        ((self.y, pre[0]), (self.cb, pre[1]),
                         (self.cr, pre[2]))):
                    if p.type_idx[ci] == SAO_OFF:
                        continue
                    sh = 0 if ci == 0 else 1
                    x0 = (xc << self.sps.log2_ctb) >> sh
                    y0 = (yc << self.sps.log2_ctb) >> sh
                    n = self.ctb >> sh
                    h, w = plane.shape
                    x1, y1 = min(x0 + n, w), min(y0 + n, h)
                    blk = src[y0:y1, x0:x1].astype(np.int32)
                    if p.type_idx[ci] == SAO_BAND:
                        band = blk >> 3
                        out = blk.copy()
                        for k in range(4):
                            b = (p.band_pos[ci] + k) & 31
                            out[band == b] += p.offsets[ci][k]
                        plane[y0:y1, x0:x1] = np.clip(out, 0, 255)
                    else:
                        eo = p.eo_class[ci]
                        dx, dy = ((1, 0), (0, 1), (1, 1), (-1, 1))[eo]
                        xa, ya = x0 - dx, y0 - dy
                        xb, yb = x0 + dx, y0 + dy
                        # neighbor windows (clamped; boundary samples are
                        # excluded below)
                        pad = np.pad(src, 1, mode="edge")
                        na = pad[y0 - dy + 1:y1 - dy + 1,
                                 x0 - dx + 1:x1 - dx + 1].astype(np.int32)
                        nb = pad[y0 + dy + 1:y1 + dy + 1,
                                 x0 + dx + 1:x1 + dx + 1].astype(np.int32)
                        sgn = np.sign(blk - na) + np.sign(blk - nb)
                        cat = np.array([1, 2, 0, 3, 4])[sgn + 2]
                        offv = np.array([0] + p.offsets[ci], np.int32)
                        out = blk + offv[cat]
                        # exclude picture-boundary samples for this class
                        ys, xs_ = np.mgrid[y0:y1, x0:x1]
                        valid = ((xs_ + dx >= 0) & (xs_ + dx < w) &
                                 (xs_ - dx >= 0) & (xs_ - dx < w) &
                                 (ys + dy >= 0) & (ys + dy < h) &
                                 (ys - dy >= 0) & (ys - dy < h))
                        if self.cur_slice > 1:
                            # and samples across a slice boundary that
                            # forbids it
                            k = self.sps.log2_ctb - sh
                            cur = self.slice_id[yc, xc]
                            for yy, xx in ((ys + dy, xs_ + dx),
                                           (ys - dy, xs_ - dx)):
                                nb = self.slice_id[
                                    np.clip(yy, 0, h - 1) >> k,
                                    np.clip(xx, 0, w - 1) >> k]
                                valid &= ~self._filter_blocked(nb, cur)
                        out = np.where(valid, out, blk)
                        plane[y0:y1, x0:x1] = np.clip(out, 0, 255)

    # -- output ---------------------------------------------------------------

    def output(self, sps: HevcSPS):
        w, h = sps.width, sps.height
        return (self.y[:h, :w].astype(np.uint8),
                self.cb[:h // 2, :w // 2].astype(np.uint8),
                self.cr[:h // 2, :w // 2].astype(np.uint8))
