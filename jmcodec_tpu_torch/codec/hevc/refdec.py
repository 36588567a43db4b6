"""HEVC stream decoder for the device path: POC, RPS, reference lists,
output order and the deblocking boundary strengths on the host; every
picture parsed by the native parser into a HevcFramePlan and reconstructed
by a device_recon hook (api/hevc_inter.py).

The port's copy of jmcodec_tpu/codec/hevc/refdec.py's stream machinery and
of its two native branches (I slices; P/B slices with the merge/AMVP/TMVP
motion derivation in C++). Not copied: the Python CABAC parser and the host
pixel path (decode_ctu and what follows, host deblock/SAO). Where the
reference falls back to them, this decoder raises NotImplementedError with
the reason: a picture outside the native parser's scope, a multi-slice
picture, a plan the device cannot take (motion beyond the MC pad).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ... import native
from ...utils.bits import BitReader
from . import nal as HN
from .inter import RefPic
from .params import HevcPPS, HevcSPS, parse_pps, parse_sps
from .plan import HevcFramePlan
from .slicehdr import B_SLICE, I_SLICE, HevcSliceHeader, parse_slice_header

_HOST_PATH = "the host decode path is not ported"


def _substream_offsets(hdr: HevcSliceHeader, emu) -> List[int]:
    """WPP substream start offsets in RBSP bytes, from entry points which
    count EBSP bytes from the start of slice data (spec 7.4.7.1)."""
    if not hdr.entry_points:
        return []
    emu = emu or []
    start_r = hdr.data_bitpos >> 3
    # ebsp offset of the slice-data start: the i-th removed byte sits just
    # before rbsp index emu[i]
    start_e = start_r + sum(1 for p in emu if p <= start_r)
    return [HN.ebsp_offset_to_rbsp(start_e + e_off, emu)
            for e_off in hdr.entry_points]


class HevcRefDecoder:
    """Streaming Annex-B HEVC decoder over the native parser.

    device_recon(plan, ref_pixels) reconstructs one picture: plan is its
    HevcFramePlan (inter fields enabled; an I picture carries zeroed
    motion), ref_pixels [(poc, y, cb, cr), ...] the coded-size planes of
    its references in plan.ref_pocs order (empty for an I picture); it
    returns the picture's coded-size (Y, U, V). Those planes go into the
    DPB as they are, so they stay wherever the hook put them. decode and
    flush return the frames output since the last call, in output order,
    cropped to the conformance window; the decoder keeps none of them."""

    def __init__(self, device_recon):
        self.sps: Dict[int, HevcSPS] = {}
        self.pps: Dict[int, HevcPPS] = {}
        self._out: List[tuple] = []     # output, not yet returned
        self.device_recon = device_recon
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

    def _decode_picture(self, slices) -> None:
        hdr0 = slices[0][0]
        pps = self.pps[hdr0.pps_id]
        sps = self.sps[pps.sps_id]
        if sps.chroma_format_idc != 1 or sps.bit_depth_luma != 8:
            raise NotImplementedError("HEVC non-4:2:0/8-bit")
        if pps.tiles_enabled:
            raise NotImplementedError("HEVC tiles")
        if hdr0.is_idr:
            # output everything pending, then an empty reference set
            self._bump(0)
            for rp in self.dpb:
                rp.is_reference = False
            self.dpb = []
        poc = self._compute_poc(hdr0, sps)
        self.n_pictures += 1
        plan = HevcFramePlan.create(sps)
        plan.poc = poc
        plan.is_idr = bool(hdr0.is_idr)
        # intra pictures ride the inter entry with zeroed motion
        plan.enable_inter()
        before, after = self._apply_rps(hdr0, poc)
        planes, pic = self._decode_picture_slices(slices, sps, pps, poc,
                                                  before, after, plan)
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

    def _decode_picture_slices(self, slices, sps, pps, poc, before, after,
                               plan):
        """Parse one picture natively and reconstruct it through
        device_recon. Returns (coded-size planes, the picture's _Picture
        state)."""
        hdr0 = slices[0][0]
        if len(slices) != 1 or not hdr0.first_slice or hdr0.dependent:
            raise NotImplementedError(f"multi-slice picture: {_HOST_PATH}")
        hdr, rbsp, emu = slices[0]
        pic = _Picture(sps)
        try:
            if hdr0.slice_type == I_SLICE:
                plan.record_slice(hdr, pps)
                native.hevc_fill_plan(plan, hdr, sps, pps, rbsp,
                                      _substream_offsets(hdr, emu))
                pic.intra4[:] = 1  # all-intra picture (DPB metadata)
                return self.device_recon(plan, []), pic
            # P/B: C++ CABAC/syntax incl. the full merge/AMVP/TMVP motion
            # derivation; Python keeps headers, the bS post-pass and DPB
            # bookkeeping
            plan.record_slice(hdr, pps)
            plan.enable_inter()
            plan.set_wp(hdr)
            cur_refs = self._ref_lists(hdr, before, after)
            no_backward = all(rp.poc <= poc for lst in cur_refs
                              for rp in lst)
            pocs = []
            for lst in cur_refs:
                for rp in lst:
                    if rp.poc not in pocs:
                        pocs.append(rp.poc)
            slot_of = {p_: i for i, p_ in enumerate(pocs)}
            plan.ref_pocs = pocs
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
            st = native.hevc_fill_plan_inter(
                plan, hdr, sps, pps, rbsp, _substream_offsets(hdr, emu), ictx)
        except native.HevcNativeUnsupported as e:
            raise NotImplementedError(
                f"picture outside the native parser's scope ({e}): "
                f"{_HOST_PATH}") from e
        pic.pred[:] = st["pred"]
        pic.mv[:] = st["mv"]
        pic.ref_poc[:] = st["ref_poc"]
        pic.intra4[:] = st["intra4"]
        pic.cbf4[:] = st["cbf4"]
        pic.tu_edge_ver[:] = st["tu_ev"] != 0
        pic.tu_edge_hor[:] = st["tu_eh"] != 0
        pic.pu_edge_ver[:] = st["pu_ev"] != 0
        pic.pu_edge_hor[:] = st["pu_eh"] != 0
        plan.fill_wp_cells(st["refidx"], st["pred"])
        pic.finish_bs()
        plan.qp_y[:] = hdr.qp
        ch, cw = pic.bs_ver.shape
        plan.bs_ver[:ch, :cw] = pic.bs_ver
        plan.bs_hor[:ch, :cw] = pic.bs_hor
        if not plan.supported:
            raise NotImplementedError(
                f"plan unsupported ({plan.reason}): {_HOST_PATH}")
        ref_pixels = []
        for p_ in pocs:
            rp = self._pic_by_poc(p_)
            ref_pixels.append((p_, rp.y, rp.cb, rp.cr))
        return self.device_recon(plan, ref_pixels), pic


class _Picture:
    """Per-picture inter state on the 4x4 luma cell grid: what the DPB
    keeps for TMVP and what the bS derivation reads."""

    def __init__(self, sps: HevcSPS):
        cell = ((sps.pic_height + 3) // 4, (sps.pic_width + 3) // 4)
        self.mv = np.zeros((2,) + cell + (2,), np.int32)
        self.ref_poc = np.zeros((2,) + cell, np.int32)
        self.pred = np.zeros((2,) + cell, np.uint8)     # predFlagLX
        self.intra4 = np.zeros(cell, np.uint8)
        self.cbf4 = np.zeros(cell, np.uint8)      # luma cbf of covering TU
        self.tu_edge_ver = np.zeros(cell, bool)   # TU left-edge at cell
        self.tu_edge_hor = np.zeros(cell, bool)
        self.pu_edge_ver = np.zeros(cell, bool)   # PU/CU left-edge at cell
        self.pu_edge_hor = np.zeros(cell, bool)
        # deblock edge bS maps at 4x4 granularity (luma coords)
        self.bs_ver = np.zeros(cell, np.int8)
        self.bs_hor = np.zeros(cell, np.int8)

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
