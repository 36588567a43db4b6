"""HEVC intra encoder (host oracle): CTB-16 all-intra Main-profile streams
with CABAC entropy coding, constant QP per frame (rate-control hookable).

Capability match: the reference encodes HEVC through vendor silicon
(intel_enc codec id MFX_CODEC_HEVC path, intel_enc/intel_enc.cpp:501-580;
NVENC HEVC GUID, nv_enc/nv_enc.cpp:610-651); here the full encode math is
in-tree. Decoder parity: reconstruction goes through the SAME dequant /
inverse-transform / prediction code as refdec.py, so the encoder's recon is
bit-exact with any conformant decoder by construction (tests assert it
against both our decoder and libavcodec).

v1 scope: 4:2:0 8-bit, one slice per picture, CU=CTB=16 (no quadtree
coding), one 16x16 luma TU + 8x8 chroma TUs per CU, deblocking and SAO
off, mode decision = best-SAD over {planar, DC, hor, ver} + MPMs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ...utils.bits import BitWriter
from . import intra as IP
from . import nal as HN
from . import transform as TR
from . import cabac_tables as CT
from .cabac_enc import HevcCabacEncoder

# HM forward-quant scales (inverse companions of TR.LEVEL_SCALE)
QUANT_SCALES = [26214, 23302, 20560, 18396, 16404, 14564]

_DIAG4 = [(x, d - x) for d in range(7) for x in range(d + 1)
          if x < 4 and d - x < 4]


def _diag_scan(n: int) -> List[Tuple[int, int]]:
    out = []
    for d in range(2 * n - 1):
        for x in range(d + 1):
            y = d - x
            if x < n and y < n:
                out.append((x, y))
    return out


_SCANS = {n: _diag_scan(n) for n in (2, 4)}


def forward_transform(x: np.ndarray, log2_size: int,
                      bit_depth: int = 8) -> np.ndarray:
    """Forward DCT-II (HM partialButterfly scaling): the exact companion of
    TR.inverse_transform for sizes 4..32 (DST not used: TUs here are >4)."""
    n = 1 << log2_size
    m = TR.DCT[n].astype(np.int64)
    s1 = log2_size - 1 + bit_depth - 8          # stage 1 shift
    s2 = log2_size + 6
    t = (m @ x.astype(np.int64) + (1 << (s1 - 1))) >> s1
    w = (t @ m.T + (1 << (s2 - 1))) >> s2
    return np.clip(w, -32768, 32767).astype(np.int32)


def quantize(w: np.ndarray, qp: int, log2_size: int, intra: bool = True,
             bit_depth: int = 8) -> np.ndarray:
    """Forward quantisation (HM-style; non-normative)."""
    qbits = 21 + qp // 6 - log2_size + (8 - bit_depth)
    scale = QUANT_SCALES[qp % 6]
    off = (171 if intra else 85) << (qbits - 9)
    aw = np.abs(w.astype(np.int64))
    z = (aw * scale + off) >> qbits
    z = np.clip(z, 0, 32767)
    return np.where(w < 0, -z, z).astype(np.int32)


# ---------------------------------------------------------------------------
# parameter-set writers (syntax mirrors params.parse_sps/parse_pps)
# ---------------------------------------------------------------------------


def _write_ptl(w: BitWriter) -> None:
    w.u(0, 2)            # profile_space
    w.u(0, 1)            # tier
    w.u(1, 5)            # profile_idc = Main
    w.u(0x60000000, 32)  # compatibility: Main + Main10
    w.u(0b1001, 4)       # progressive, !interlaced, !non_packed, frame_only
    w.u(0, 32)           # constraint bits
    w.u(0, 11)
    w.u(0, 1)
    w.u(120, 8)          # level 4.0


def write_vps() -> bytes:
    w = BitWriter()
    w.u(0, 4)    # vps_id
    w.u(3, 2)    # base_layer_internal/available (reserved 11)
    w.u(0, 6)    # max_layers - 1
    w.u(0, 3)    # max_sub_layers - 1
    w.flag(1)    # temporal_id_nesting
    w.u(0xFFFF, 16)  # reserved
    _write_ptl(w)
    w.flag(1)    # sub_layer_ordering_info_present
    w.ue(1)      # max_dec_pic_buffering - 1
    w.ue(0)      # num_reorder_pics
    w.ue(0)      # max_latency
    w.u(0, 6)    # max_layer_id
    w.ue(0)      # num_layer_sets - 1
    w.flag(0)    # timing_info_present
    w.flag(0)    # extension
    w.rbsp_trailing_bits()
    return w.bytes()


def write_sps(pic_w: int, pic_h: int, conf_win) -> bytes:
    w = BitWriter()
    w.u(0, 4)    # vps_id
    w.u(0, 3)    # max_sub_layers - 1
    w.flag(1)    # temporal_id_nesting
    _write_ptl(w)
    w.ue(0)      # sps_id
    w.ue(1)      # chroma_format_idc 4:2:0
    w.ue(pic_w)
    w.ue(pic_h)
    if any(conf_win):
        w.flag(1)
        for v in conf_win:
            w.ue(v)
    else:
        w.flag(0)
    w.ue(0)      # bit_depth_luma - 8
    w.ue(0)      # bit_depth_chroma - 8
    w.ue(4)      # log2_max_poc_lsb - 4
    w.flag(1)    # sub_layer_ordering_info_present
    w.ue(1)      # max_dec_pic_buffering - 1
    w.ue(0)      # num_reorder
    w.ue(0)      # max_latency
    w.ue(1)      # log2_min_cb - 3  -> 16
    w.ue(0)      # diff max/min cb  -> CTB 16
    w.ue(0)      # log2_min_tb - 2  -> 4
    w.ue(2)      # diff max/min tb  -> 16
    w.ue(0)      # max_transform_hierarchy_depth_inter
    w.ue(0)      # max_transform_hierarchy_depth_intra
    w.flag(0)    # scaling_list_enabled
    w.flag(0)    # amp
    w.flag(0)    # sao
    w.flag(0)    # pcm
    w.ue(0)      # num_short_term_rps
    w.flag(0)    # long_term_ref_pics_present
    w.flag(0)    # temporal_mvp
    w.flag(0)    # strong_intra_smoothing
    w.flag(0)    # vui
    w.flag(0)    # sps_extension
    w.rbsp_trailing_bits()
    return w.bytes()


def write_pps(init_qp: int = 26) -> bytes:
    w = BitWriter()
    w.ue(0)      # pps_id
    w.ue(0)      # sps_id
    w.flag(0)    # dependent_slice_segments
    w.flag(0)    # output_flag_present
    w.u(0, 3)    # extra slice header bits
    w.flag(0)    # sign_data_hiding
    w.flag(0)    # cabac_init_present
    w.ue(0)      # num_ref_idx_l0_default - 1
    w.ue(0)      # num_ref_idx_l1_default - 1
    w.se(init_qp - 26)
    w.flag(0)    # constrained_intra_pred
    w.flag(0)    # transform_skip
    w.flag(0)    # cu_qp_delta
    w.se(0)      # cb_qp_offset
    w.se(0)      # cr_qp_offset
    w.flag(0)    # slice_chroma_qp_offsets_present
    w.flag(0)    # weighted_pred
    w.flag(0)    # weighted_bipred
    w.flag(0)    # transquant_bypass
    w.flag(0)    # tiles
    w.flag(0)    # entropy_coding_sync (WPP)
    w.flag(1)    # loop_filter_across_slices
    w.flag(1)    # deblocking_filter_control_present
    w.flag(0)    # deblocking_filter_override_enabled
    w.flag(1)    # pps_deblocking_filter_disabled (v1: recon == pre-filter)
    w.flag(0)    # pps_scaling_list_data_present
    w.flag(0)    # lists_modification_present
    w.ue(0)      # log2_parallel_merge_level - 2
    w.flag(0)    # slice_segment_header_extension
    w.flag(0)    # pps_extension_present
    w.rbsp_trailing_bits()
    return w.bytes()


def write_idr_slice_header(qp: int, init_qp: int = 26) -> BitWriter:
    w = BitWriter()
    w.flag(1)    # first_slice_segment_in_pic
    w.flag(0)    # no_output_of_prior_pics (IRAP)
    w.ue(0)      # pps_id
    w.ue(2)      # slice_type I
    # sps sao off -> no sao flags; IDR -> no poc/rps
    w.se(qp - init_qp)
    # pps deblock override disabled -> no deblock syntax
    # loop_filter_across_slices flag: gated off (sao off + deblock disabled)
    # no tiles/wpp -> no entry points
    w.flag(1)    # alignment_bit_equal_to_one
    w.align()
    return w


# ---------------------------------------------------------------------------
# residual coding writer (inverse of refdec._residual, diag scan, no SDH)
# ---------------------------------------------------------------------------


def write_residual(c: HevcCabacEncoder, block: np.ndarray, log2size: int,
                   cidx: int) -> None:
    n = 1 << log2size
    sb_n = n >> 2
    sb_scan = _SCANS[sb_n] if sb_n > 1 else [(0, 0)]
    in_scan = _SCANS[4]
    # last significant coefficient in scan order
    sb_pos = {p: i for i, p in enumerate(sb_scan)}
    in_pos = {p: i for i, p in enumerate(in_scan)}
    last_i = last_k = -1
    for i in range(len(sb_scan) - 1, -1, -1):
        sx, sy = sb_scan[i]
        sub = block[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
        if not sub.any():
            continue
        for k in range(15, -1, -1):
            xin, yin = in_scan[k]
            if sub[yin, xin]:
                if last_i < 0:
                    last_i, last_k = i, k
                break
        if last_i >= 0:
            break
    assert last_i >= 0, "write_residual called on a zero block"
    sx, sy = sb_scan[last_i]
    xin, yin = in_scan[last_k]
    lx, ly = (sx << 2) + xin, (sy << 2) + yin
    # both prefixes first, then both suffixes (7.3.8.11 order; the decoder
    # mirrors this in _residual)
    _write_last_prefix(c, lx, CT.LAST_SIG_X_PREFIX, log2size, cidx)
    _write_last_prefix(c, ly, CT.LAST_SIG_Y_PREFIX, log2size, cidx)
    _write_last_suffix(c, lx)
    _write_last_suffix(c, ly)

    csbf = np.zeros((sb_n, sb_n), np.int8)
    # precompute coded flags (needed for sig ctx of earlier subblocks)
    for i in range(last_i, -1, -1):
        sx, sy = sb_scan[i]
        sub = block[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
        csbf[sy, sx] = 1 if (i in (last_i, 0) or sub.any()) else 0
    # NOTE: decoder reads csbf progressively; right/below neighbors are in
    # LATER scan positions... (higher i), which are written EARLIER. The
    # decode-order state therefore matches this precomputed map.
    c1 = 1
    for i in range(last_i, -1, -1):
        sx, sy = sb_scan[i]
        sub = block[sy * 4:sy * 4 + 4, sx * 4:sx * 4 + 4]
        if i not in (last_i, 0):
            right = csbf[sy, sx + 1] if sx + 1 < sb_n else 0
            below = csbf[sy + 1, sx] if sy + 1 < sb_n else 0
            ctx = min(int(right) + int(below), 1) + (2 if cidx else 0)
            c.encode(CT.SIG_COEFF_GROUP + ctx, int(csbf[sy, sx]))
            infer_dc = 1
        else:
            infer_dc = 0
        if not csbf[sy, sx]:
            continue
        # significance flags
        sig = []
        start = last_k - 1 if i == last_i else 15
        if i == last_i:
            sig.append(last_k)
        found = bool(sig)
        for k in range(start, -1, -1):
            xin, yin = in_scan[k]
            v = int(sub[yin, xin])
            if k == 0 and infer_dc and not found:
                # inferred significant: must be nonzero by construction
                # (csbf set only when sub.any(); if all others were zero
                # the DC must be the nonzero one)
                sig.append(0)
                break
            ctx = _sig_ctx_enc(
                (sx << 2) + xin, (sy << 2) + yin, sx, sy, csbf, sb_n,
                log2size, cidx)
            c.encode(CT.SIG_COEFF_FLAG + ctx, 1 if v else 0)
            if v:
                sig.append(k)
                found = True
        if not sig:
            continue  # decoder touches no c1/ctx state for empty subblocks
        nsig = len(sig)
        levels = []
        for k in sig:
            xin, yin = in_scan[k]
            levels.append(int(sub[yin, xin]))
        # greater1/greater2
        ctx_set = 0 if (i == 0 or cidx > 0) else 2
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        base_g1 = CT.COEFF_ABS_GREATER1 + (16 if cidx else 0) + 4 * ctx_set
        g1 = []
        first_g1 = -1
        for j in range(min(nsig, 8)):
            b = 1 if abs(levels[j]) > 1 else 0
            c.encode(base_g1 + c1, b)
            g1.append(b)
            if b:
                if first_g1 < 0:
                    first_g1 = j
                c1 = 0
            elif 0 < c1 < 3:
                c1 += 1
        g2 = 0
        if first_g1 >= 0:
            g2 = 1 if abs(levels[first_g1]) > 2 else 0
            c.encode(CT.COEFF_ABS_GREATER2 + (4 if cidx else 0) + ctx_set,
                     g2)
        # signs (sign data hiding off in our PPS)
        for j in range(nsig):
            c.bypass(1 if levels[j] < 0 else 0)
        # remaining levels
        rice = 0
        for j in range(nsig):
            base = 1
            if j < 8:
                base += g1[j]
                if j == first_g1:
                    base += g2
                thresh = 3 if j == first_g1 else 2
            else:
                thresh = 1
            level = abs(levels[j])
            if base == thresh:
                # coeff_abs_level_remaining (mirror of _abs_remaining)
                _write_abs_remaining(c, level - base, rice)
                if level > (3 << rice):
                    rice = min(rice + 1, 4)
            elif level != base:
                raise AssertionError("level/base mismatch in writer")


def _write_abs_remaining(c: HevcCabacEncoder, v: int, rice: int) -> None:
    """Inverse of refdec._abs_remaining."""
    prefix = v >> rice
    if prefix <= 3:
        for _ in range(prefix):
            c.bypass(1)
        c.bypass(0)
        c.bypass_bits(v & ((1 << rice) - 1), rice)
        return
    # escape: prefix run of p ones (p>=4, stops by length not a 0-bit when
    # p reaches the decoder's cap? the decoder reads 1s until a 0) —
    # decoder: prefix ones then 0; value = ((1<<(p-3)) + 2) << rice? mirror:
    p = 3
    while True:
        p += 1
        base = (((1 << (p - 3)) + 3 - 1) << rice)
        span = 1 << (p - 3 + rice)
        if base <= v < base + span:
            break
        if p > 32:
            raise AssertionError("remaining level too large")
    for _ in range(p):
        c.bypass(1)
    c.bypass(0)
    c.bypass_bits(v - base, p - 3 + rice)


def _last_split(v: int):
    """Coordinate -> (prefix, suffix_bits, suffix); inverse of
    refdec._last_suffix."""
    if v <= 3:
        return v, 0, 0
    nb = v.bit_length() - 2
    prefix = 2 * (v.bit_length() - 1) + ((v >> nb) & 1)
    return prefix, nb, v & ((1 << nb) - 1)


def _write_last_prefix(c: HevcCabacEncoder, v: int, base: int,
                       log2size: int, cidx: int) -> None:
    prefix, _, _ = _last_split(v)
    if cidx == 0:
        off = 3 * (log2size - 2) + ((log2size - 1) >> 2)
        shift = (log2size + 1) >> 2
    else:
        off = 15
        shift = log2size - 2
    cmax = (log2size << 1) - 1
    for k in range(prefix):
        c.encode(base + off + (k >> shift), 1)
    if prefix < cmax:
        c.encode(base + off + (prefix >> shift), 0)


def _write_last_suffix(c: HevcCabacEncoder, v: int) -> None:
    _, nbits, suf = _last_split(v)
    if nbits:
        c.bypass_bits(suf, nbits)


def _sig_ctx_enc(xc, yc, sx, sy, csbf, sb_n, log2size, cidx):
    """Clone of refdec._sig_ctx (scan_idx always 0 here)."""
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
            sig += 9 if log2size == 3 else 21
        else:
            sig += 9 if log2size == 3 else 12
    return sig + (27 if cidx else 0)


_CTX_IDX_MAP = [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8]


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------


class HevcIntraEncoder:
    """All-intra HEVC encoder (every frame IDR_W_RADL)."""

    CU = 16

    def __init__(self, width: int, height: int, qp: int = 30):
        if width % 2 or height % 2:
            raise ValueError("width/height must be even (4:2:0)")
        self.width, self.height = width, height
        cu = self.CU
        self.pw = (width + cu - 1) // cu * cu
        self.ph = (height + cu - 1) // cu * cu
        # conformance window (right/bottom crop, chroma units)
        self.conf_win = (0, (self.pw - width) // 2,
                         0, (self.ph - height) // 2)
        self.qp = qp
        self.frames = 0

    def headers_annexb(self) -> bytes:
        return (HN.write_nal_unit(HN.NAL_VPS, write_vps()) +
                HN.write_nal_unit(HN.NAL_SPS, write_sps(
                    self.pw, self.ph, self.conf_win)) +
                HN.write_nal_unit(HN.NAL_PPS, write_pps()))

    def encode_frame(self, Y, U, V, qp: int = None) -> bytes:
        qp = self.qp if qp is None else int(qp)
        qp = max(0, min(51, qp))
        pw, ph = self.pw, self.ph
        Ys = np.full((ph, pw), 0, np.int32)
        Us = np.full((ph // 2, pw // 2), 0, np.int32)
        Vs = np.full((ph // 2, pw // 2), 0, np.int32)
        Ys[:self.height, :self.width] = np.asarray(Y, np.int32)
        Us[:self.height // 2, :self.width // 2] = np.asarray(U, np.int32)
        Vs[:self.height // 2, :self.width // 2] = np.asarray(V, np.int32)
        # edge-pad the coded-but-cropped band (better prediction there)
        if pw > self.width:
            Ys[:, self.width:] = Ys[:, self.width - 1:self.width]
            Us[:, self.width // 2:] = Us[:, self.width // 2 - 1:
                                         self.width // 2]
            Vs[:, self.width // 2:] = Vs[:, self.width // 2 - 1:
                                         self.width // 2]
        if ph > self.height:
            Ys[self.height:, :] = Ys[self.height - 1:self.height, :]
            Us[self.height // 2:, :] = Us[self.height // 2 - 1:
                                          self.height // 2, :]
            Vs[self.height // 2:, :] = Vs[self.height // 2 - 1:
                                          self.height // 2, :]

        recon_y = np.zeros_like(Ys)
        recon_cb = np.zeros_like(Us)
        recon_cr = np.zeros_like(Vs)
        g = 4
        avail_y = np.zeros((ph // g, pw // g), bool)
        avail_c = np.zeros((ph // 2 // g, pw // 2 // g), bool)
        mode_map = np.full((ph // g, pw // g), IP.DC, np.int32)
        mode_avail = np.zeros((ph // g, pw // g), bool)

        hw = write_idr_slice_header(qp)
        c = HevcCabacEncoder(qp, init_type=0)
        cu = self.CU
        n_ctb_x, n_ctb_y = pw // cu, ph // cu
        last = n_ctb_y * n_ctb_x - 1
        for idx in range(last + 1):
            yc, xc = divmod(idx, n_ctb_x)
            self._encode_cu(c, xc * cu, yc * cu, qp, Ys, Us, Vs,
                            recon_y, recon_cb, recon_cr,
                            avail_y, avail_c, mode_map, mode_avail)
            c.terminate(1 if idx == last else 0)
        payload = hw.bytes() + c.finish()
        self._last_coded = (recon_y.astype(np.uint8),
                            recon_cb.astype(np.uint8),
                            recon_cr.astype(np.uint8))
        self.last_recon = (recon_y[:self.height, :self.width]
                           .astype(np.uint8),
                           recon_cb[:self.height // 2, :self.width // 2]
                           .astype(np.uint8),
                           recon_cr[:self.height // 2, :self.width // 2]
                           .astype(np.uint8))
        self.frames += 1
        return HN.write_nal_unit(HN.NAL_IDR_W_RADL, payload)

    # -- one 16x16 CU ---------------------------------------------------------

    def _mpm(self, mode_map, mode_avail, px: int, py: int) -> List[int]:
        g = 4
        a = IP.DC
        if px > 0 and mode_avail[py // g, (px - 1) // g]:
            a = int(mode_map[py // g, (px - 1) // g])
        b = IP.DC
        if py > 0 and mode_avail[(py - 1) // g, px // g] and \
                (py % self.CU) != 0:
            b = int(mode_map[(py - 1) // g, px // g])
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

    def _encode_cu(self, c, x0, y0, qp, Ys, Us, Vs, ry, rcb, rcr,
                   avail_y, avail_c, mode_map, mode_avail) -> None:
        n = self.CU
        g = 4
        # part_mode: 2Nx2N (CU is at min size so the flag is coded)
        c.encode(CT.PART_MODE, 1)
        # luma mode decision: SAD over candidates on the true references
        cands = self._mpm(mode_map, mode_avail, x0, y0)
        left, tl, top = IP.gather_references(ry, avail_y, x0, y0, n)
        src = Ys[y0:y0 + n, x0:x0 + n]
        best = None
        for mode in sorted(set(cands + [IP.PLANAR, IP.DC, IP.HOR, IP.VER])):
            fl, ftl, ft = IP.filter_references(left, tl, top, n, mode, False)
            pred = IP.predict(mode, fl, ftl, ft, n, 0)
            sad = int(np.abs(src - pred).sum())
            if best is None or sad < best[0]:
                best = (sad, mode, pred)
        _, mode, pred = best
        # prev_intra_luma_pred + mpm_idx / rem
        if mode in cands:
            c.encode(CT.PREV_INTRA_LUMA_PRED, 1)
            idx = cands.index(mode)
            for _ in range(idx):
                c.bypass(1)
            if idx < 2:
                c.bypass(0)
        else:
            c.encode(CT.PREV_INTRA_LUMA_PRED, 0)
            rem = None
            for r in range(32):
                m = r
                for cm in sorted(cands):
                    if m >= cm:
                        m += 1
                if m == mode:
                    rem = r
                    break
            c.bypass_bits(rem, 5)
        mode_map[y0 // g:(y0 + n) // g, x0 // g:(x0 + n) // g] = mode
        mode_avail[y0 // g:(y0 + n) // g, x0 // g:(x0 + n) // g] = True
        # chroma mode: derived (DM) -> one 0 bin
        c.encode(CT.INTRA_CHROMA_PRED_MODE, 0)
        cmode = mode

        # ---- residuals (compute before cbf syntax) ----
        resid = src - pred
        w = forward_transform(resid, 4)
        z = quantize(w, qp, 4)
        cbf_luma = 1 if z.any() else 0
        rec = pred
        if cbf_luma:
            d = TR.dequant(z, qp, 4)
            rec = pred + TR.inverse_transform(d, 4, dst=False)
        ry[y0:y0 + n, x0:x0 + n] = np.clip(rec, 0, 255)
        avail_y[y0 // g:(y0 + n) // g, x0 // g:(x0 + n) // g] = True

        xc, yc, nc = x0 >> 1, y0 >> 1, n >> 1
        qpc = TR.chroma_qp(qp, 0)
        zc = []
        preds_c = []
        for plane, srcp in ((rcb, Us), (rcr, Vs)):
            lc, tlc, tc_ = IP.gather_references(plane, avail_c, xc, yc, nc)
            pc = IP.predict(cmode, lc, tlc, tc_, nc, 1)
            preds_c.append(pc)
            wc = forward_transform(srcp[yc:yc + nc, xc:xc + nc] - pc, 3)
            zc.append(quantize(wc, qpc, 3))
        cbf_cb = 1 if zc[0].any() else 0
        cbf_cr = 1 if zc[1].any() else 0

        # ---- transform tree syntax: cbf_cb, cbf_cr (depth 0), cbf_luma ----
        c.encode(CT.CBF_CB_CR + 0, cbf_cb)
        c.encode(CT.CBF_CB_CR + 0, cbf_cr)
        c.encode(CT.CBF_LUMA + 1, cbf_luma)
        if cbf_luma:
            write_residual(c, z, 4, 0)
        for cidx, (plane, cbf, zb, pc) in enumerate(
                ((rcb, cbf_cb, zc[0], preds_c[0]),
                 (rcr, cbf_cr, zc[1], preds_c[1])), start=1):
            recc = pc
            if cbf:
                write_residual(c, zb, 3, cidx)
                dc = TR.dequant(zb, qpc, 3)
                recc = pc + TR.inverse_transform(dc, 3, dst=False)
            plane[yc:yc + nc, xc:xc + nc] = np.clip(recc, 0, 255)
        avail_c[yc // g:(yc + nc) // g, xc // g:(xc + nc) // g] = True


def encode_stream_hevc(frames, width, height, qp=30) -> bytes:
    """Convenience: all-intra HEVC Annex-B stream."""
    enc = HevcIntraEncoder(width, height, qp=qp)
    out = [enc.headers_annexb()]
    for (Y, U, V) in frames:
        out.append(enc.encode_frame(Y, U, V))
    return b"".join(out)


# ---------------------------------------------------------------------------
# P-frame encoding (VERDICT r4: HEVC inter encode). v1 scope: CU=CTB=16,
# 2Nx2N, one reference (previous frame), TMVP off, merge list of 1 (skip /
# merge use candidate 0), AMVP 16x16 ME with quarter-pel refinement, intra
# fallback. Reconstruction shares the decoder's MC + transforms, so recon
# is bit-exact with any conformant decoder by construction.
# ---------------------------------------------------------------------------

from . import inter as INT  # noqa: E402  (after-intra import keeps diffs local)


def write_p_slice_header(qp: int, poc_lsb: int, delta_poc: int,
                         init_qp: int = 26) -> BitWriter:
    """P slice header against write_sps/write_pps's minimal flags (sao off,
    tmvp off, deblock disabled): one negative reference at -delta_poc,
    merge list size 1 (five_minus_max_num_merge_cand = 4)."""
    w = BitWriter()
    w.flag(1)            # first_slice_segment_in_pic
    w.ue(0)              # pps_id
    w.ue(1)              # slice_type P
    w.u(poc_lsb, 8)      # log2_max_poc_lsb = 8 (sps: 4 + 4)
    w.flag(0)            # short_term_ref_pic_set_sps_flag -> inline RPS
    w.ue(1)              # num_negative_pics
    w.ue(0)              # num_positive_pics
    w.ue(delta_poc - 1)  # delta_poc_s0_minus1
    w.flag(1)            # used_by_curr_pic_s0
    w.flag(0)            # num_ref_idx_active_override (default 1)
    w.ue(4)              # five_minus_max_num_merge_cand -> max_merge 1
    w.se(qp - init_qp)
    w.flag(1)            # alignment_bit_equal_to_one
    w.align()
    return w


def _write_eg1(c: HevcCabacEncoder, u: int) -> None:
    """k=1 Exp-Golomb bypass writer (inverse of refdec._eg_bypass k=1)."""
    p = 0
    while (((1 << (p + 1)) - 1) << 1) <= u:
        p += 1
    for _ in range(p):
        c.bypass(1)
    c.bypass(0)
    c.bypass_bits(u - (((1 << p) - 1) << 1), p + 1)


def _write_mvd(c: HevcCabacEncoder, dx: int, dy: int) -> None:
    g0 = (int(abs(dx) > 0), int(abs(dy) > 0))
    g1 = (int(abs(dx) > 1), int(abs(dy) > 1))
    c.encode(CT.ABS_MVD_GREATER0, g0[0])
    c.encode(CT.ABS_MVD_GREATER0, g0[1])
    if g0[0]:
        c.encode(CT.ABS_MVD_GREATER1 + 1, g1[0])
    if g0[1]:
        c.encode(CT.ABS_MVD_GREATER1 + 1, g1[1])
    for v, gg0, gg1 in ((dx, g0[0], g1[0]), (dy, g0[1], g1[1])):
        if not gg0:
            continue
        if gg1:
            _write_eg1(c, abs(v) - 2)
        c.bypass(1 if v < 0 else 0)


class HevcEncoder(HevcIntraEncoder):
    """GOP encoder: IDR + P...P (closed GOPs), single reference."""

    def __init__(self, width: int, height: int, qp: int = 30,
                 gop_len: int = 1):
        super().__init__(width, height, qp=qp)
        self.gop_len = max(1, gop_len)
        self.frame_idx = 0
        self.poc = 0
        self.ref: Optional[INT.RefPic] = None

    def encode_frame(self, Y, U, V, qp: int = None) -> bytes:
        is_idr = (self.gop_len <= 1
                  or self.frame_idx % self.gop_len == 0
                  or self.ref is None)
        self.frame_idx += 1
        if is_idr:
            out = super().encode_frame(Y, U, V, qp=qp)
            self.poc = 0
            self._store_ref(intra=True)
            return out
        self.poc += 1
        return self._encode_p(Y, U, V, qp)

    def _store_ref(self, intra: bool, mvg=None, predg=None) -> None:
        ry, rcb, rcr = self._last_coded
        h4, w4 = self.ph // 4, self.pw // 4
        mv = np.zeros((2, h4, w4, 2), np.int32)
        pred = np.zeros((2, h4, w4), np.uint8)
        intra4 = np.ones((h4, w4), np.uint8)
        if not intra and mvg is not None:
            mv[0] = mvg
            pred[0] = predg
            intra4 = (predg == 0).astype(np.uint8)
        self.ref = INT.RefPic(
            poc=self.poc, y=ry, cb=rcb, cr=rcr, mv=mv,
            ref_poc=np.zeros((2, h4, w4), np.int32), pred=pred,
            intra=intra4)

    # -- inter helpers (mirror the decoder's derivations, single list) ----

    def _nbr_first(self, predg, mvg, intra4, done, xp, yp, w, h):
        """First available merge candidate (A1,B1,B0,A0,B2; TMVP off).
        Returns (mv, ok)."""
        for (x, y) in ((xp - 1, yp + h - 1), (xp + w - 1, yp - 1),
                       (xp + w, yp - 1), (xp - 1, yp + h),
                       (xp - 1, yp - 1)):
            if x < 0 or y < 0 or x >= self.pw or y >= self.ph:
                continue
            cx, cy = x // 4, y // 4
            if done[cy, cx] and not intra4[cy, cx] and predg[cy, cx]:
                return mvg[cy, cx].copy(), True
        return np.zeros(2, np.int32), False

    def _amvp0(self, predg, mvg, intra4, done, xp, yp, w, h):
        """AMVP list (two spatial groups; single ref, same POC -> no
        scaling; TMVP off). Returns [mvp0, mvp1]."""
        def avail(x, y):
            if x < 0 or y < 0 or x >= self.pw or y >= self.ph:
                return False
            cx, cy = x // 4, y // 4
            return bool(done[cy, cx]) and not intra4[cy, cx] and \
                bool(predg[cy, cx])

        out = []
        for (x, y) in ((xp - 1, yp + h), (xp - 1, yp + h - 1)):
            if avail(x, y):
                out.append(mvg[y // 4, x // 4].copy())
                break
        for (x, y) in ((xp + w, yp - 1), (xp + w - 1, yp - 1),
                       (xp - 1, yp - 1)):
            if avail(x, y):
                mv = mvg[y // 4, x // 4].copy()
                if not out or (mv != out[0]).any():
                    out.append(mv)
                break
        while len(out) < 2:
            out.append(np.zeros(2, np.int32))
        return out[:2]

    def _me(self, src, refY, xp, yp, lam, mvp):
        """16x16 full-pel diamond + quarter-pel refinement vs the single
        reference; cost = SAD + lam * mvd bits (approx)."""
        from ...utils.bits import se_len
        H, W = refY.shape
        rng_ = 16

        def sad_at(mvq):
            # mc_luma returns 14-bit pre-weighting samples: convert to
            # 8-bit (default weighted-sample stage) before the SAD
            blk = (INT.mc_luma(refY, xp, yp, 16, 16, int(mvq[0]),
                               int(mvq[1])) + 32) >> 6
            return int(np.abs(src - np.clip(blk, 0, 255)).sum())

        def cost(mvq, sad):
            return sad + lam * (se_len(int(mvq[0] - mvp[0])) +
                                se_len(int(mvq[1] - mvp[1])))

        best_mv = np.array([int(mvp[0]) >> 2 << 2,
                            int(mvp[1]) >> 2 << 2], np.int32)
        cands = {(int(best_mv[0]), int(best_mv[1])), (0, 0)}
        best = None
        for cd in cands:
            mvq = np.array(cd, np.int32)
            cst = cost(mvq, sad_at(mvq))
            if best is None or cst < best[0]:
                best = (cst, mvq)
        for step_px in (2, 1):
            improved = True
            iters = 0
            while improved and iters < rng_:
                improved = False
                iters += 1
                bx, by = int(best[1][0]), int(best[1][1])
                for dx, dy in ((-4 * step_px, 0), (4 * step_px, 0),
                               (0, -4 * step_px), (0, 4 * step_px)):
                    mvq = np.array([np.clip(bx + dx, -4 * rng_, 4 * rng_),
                                    np.clip(by + dy, -4 * rng_, 4 * rng_)],
                                   np.int32)
                    cst = cost(mvq, sad_at(mvq))
                    if cst < best[0]:
                        best = (cst, mvq)
                        improved = True
        for sub in (2, 1):
            bx, by = int(best[1][0]), int(best[1][1])
            for dx, dy in ((-sub, 0), (sub, 0), (0, -sub), (0, sub),
                           (-sub, -sub), (sub, sub), (-sub, sub),
                           (sub, -sub)):
                mvq = np.array([np.clip(bx + dx, -4 * rng_, 4 * rng_),
                                np.clip(by + dy, -4 * rng_, 4 * rng_)],
                               np.int32)
                cst = cost(mvq, sad_at(mvq))
                if cst < best[0]:
                    best = (cst, mvq)
        return best[1], best[0]

    def _quant_tu(self, resid, qp, log2, cidx):
        w = forward_transform(resid, log2)
        return quantize(w, qp if cidx == 0 else
                        int(TR.chroma_qp(qp, 0)), log2, intra=False)

    def _recon_inter(self, z, qp, log2, cidx):
        qpc = qp if cidx == 0 else int(TR.chroma_qp(qp, 0))
        d = TR.dequant(z, qpc, log2)
        return TR.inverse_transform(d, log2, dst=False)

    def _encode_p(self, Y, U, V, qp) -> bytes:
        qp = self.qp if qp is None else int(qp)
        qp = max(0, min(51, qp))
        pw, ph = self.pw, self.ph
        Ys = np.zeros((ph, pw), np.int32)
        Us = np.zeros((ph // 2, pw // 2), np.int32)
        Vs = np.zeros((ph // 2, pw // 2), np.int32)
        Ys[:self.height, :self.width] = np.asarray(Y, np.int32)
        Us[:self.height // 2, :self.width // 2] = np.asarray(U, np.int32)
        Vs[:self.height // 2, :self.width // 2] = np.asarray(V, np.int32)
        if pw > self.width:
            Ys[:, self.width:] = Ys[:, self.width - 1:self.width]
            Us[:, self.width // 2:] = Us[:, self.width // 2 - 1:
                                         self.width // 2]
            Vs[:, self.width // 2:] = Vs[:, self.width // 2 - 1:
                                         self.width // 2]
        if ph > self.height:
            Ys[self.height:, :] = Ys[self.height - 1:self.height, :]
            Us[self.height // 2:, :] = Us[self.height // 2 - 1:
                                          self.height // 2, :]
            Vs[self.height // 2:, :] = Vs[self.height // 2 - 1:
                                          self.height // 2, :]

        recon_y = np.zeros_like(Ys)
        recon_cb = np.zeros_like(Us)
        recon_cr = np.zeros_like(Vs)
        g = 4
        h4, w4 = ph // g, pw // g
        avail_y = np.zeros((h4, w4), bool)
        avail_c = np.zeros((ph // 2 // g, pw // 2 // g), bool)
        mode_map = np.full((h4, w4), IP.DC, np.int32)
        mode_avail = np.zeros((h4, w4), bool)
        predg = np.zeros((h4, w4), np.uint8)
        mvg = np.zeros((h4, w4, 2), np.int32)
        intra4 = np.zeros((h4, w4), np.uint8)
        skip4 = np.zeros((h4, w4), np.uint8)
        done = np.zeros((h4, w4), bool)
        refs = [[self.ref], []]
        lam = max(1, 1 << max(0, (qp - 12) // 6))

        hw = write_p_slice_header(qp, self.poc & 0xFF, 1)
        c = HevcCabacEncoder(qp, init_type=1)   # P, cabac_init_flag 0
        cu = self.CU
        n_ctb_x, n_ctb_y = pw // cu, ph // cu
        last = n_ctb_y * n_ctb_x - 1
        for idx in range(last + 1):
            yc, xc = divmod(idx, n_ctb_x)
            self._encode_p_cu(c, xc * cu, yc * cu, qp, lam, Ys, Us, Vs,
                              recon_y, recon_cb, recon_cr,
                              avail_y, avail_c, mode_map, mode_avail,
                              predg, mvg, intra4, skip4, done, refs)
            c.terminate(1 if idx == last else 0)
        payload = hw.bytes() + c.finish()
        self._last_coded = (recon_y.astype(np.uint8),
                            recon_cb.astype(np.uint8),
                            recon_cr.astype(np.uint8))
        self.last_recon = (recon_y[:self.height, :self.width]
                           .astype(np.uint8),
                           recon_cb[:self.height // 2, :self.width // 2]
                           .astype(np.uint8),
                           recon_cr[:self.height // 2, :self.width // 2]
                           .astype(np.uint8))
        self._store_ref(intra=False, mvg=mvg, predg=predg)
        self.frames += 1
        return HN.write_nal_unit(HN.NAL_TRAIL_R, payload)

    def _encode_p_cu(self, c, x0, y0, qp, lam, Ys, Us, Vs,
                     ry, rcb, rcr, avail_y, avail_c, mode_map, mode_avail,
                     predg, mvg, intra4, skip4, done, refs):
        cu = self.CU
        g = 4
        cx0, cy0, nc = x0 // g, y0 // g, cu // g
        src = Ys[y0:y0 + cu, x0:x0 + cu]
        srcU = Us[y0 // 2:(y0 + cu) // 2, x0 // 2:(x0 + cu) // 2]
        srcV = Vs[y0 // 2:(y0 + cu) // 2, x0 // 2:(x0 + cu) // 2]

        # candidates
        mv_merge, merge_ok = self._nbr_first(predg, mvg, intra4, done,
                                             x0, y0, cu, cu)
        mvps = self._amvp0(predg, mvg, intra4, done, x0, y0, cu, cu)
        mv_me, cost_me = self._me(src, self.ref.y.astype(np.int32),
                                  x0, y0, lam, mvps[0])
        clamp = 4 * 48
        mv_me = np.clip(mv_me, -clamp, clamp)
        mv_merge = np.clip(mv_merge, -clamp, clamp)

        def pred_of(mv):
            return INT.predict_pu(refs, x0, y0, cu, cu, 1,
                                  [(int(mv[0]), int(mv[1])), (0, 0)],
                                  [0, -1])

        pm_y, pm_cb, pm_cr = pred_of(mv_merge)
        cost_merge = int(np.abs(src - pm_y).sum()) + lam
        pa_y, pa_cb, pa_cr = pred_of(mv_me)
        intra_thresh = 16 * 16 * 20

        use_merge = cost_merge <= cost_me
        best_cost = min(cost_merge, cost_me)
        if best_cost > intra_thresh:
            # intra fallback: skip_flag 0, pred_mode 1, then the intra CU
            ctx = 0
            if x0 > 0 and avail_y[cy0, cx0 - 1]:
                ctx += int(skip4[cy0, cx0 - 1])
            if y0 > 0 and avail_y[cy0 - 1, cx0]:
                ctx += int(skip4[cy0 - 1, cx0])
            c.encode(CT.SKIP_FLAG + ctx, 0)
            c.encode(CT.PRED_MODE_FLAG, 1)
            self._encode_cu(c, x0, y0, qp, Ys, Us, Vs, ry, rcb, rcr,
                            avail_y, avail_c, mode_map, mode_avail)
            intra4[cy0:cy0 + nc, cx0:cx0 + nc] = 1
            done[cy0:cy0 + nc, cx0:cx0 + nc] = True
            skip4[cy0:cy0 + nc, cx0:cx0 + nc] = 0
            return

        mv = mv_merge if use_merge else mv_me
        py, pcb, pcr = (pm_y, pm_cb, pm_cr) if use_merge else \
            (pa_y, pa_cb, pa_cr)
        zl = self._quant_tu(src - py, qp, 4, 0)
        zcb = self._quant_tu(srcU - pcb, qp, 3, 1)
        zcr = self._quant_tu(srcV - pcr, qp, 3, 2)
        cbf_l, cbf_cb, cbf_cr = (int(zl.any()), int(zcb.any()),
                                 int(zcr.any()))
        all_zero = not (cbf_l or cbf_cb or cbf_cr)

        ctx = 0
        if x0 > 0 and avail_y[cy0, cx0 - 1]:
            ctx += int(skip4[cy0, cx0 - 1])
        if y0 > 0 and avail_y[cy0 - 1, cx0]:
            ctx += int(skip4[cy0 - 1, cx0])

        del merge_ok
        if use_merge and all_zero:
            # SKIP CU (merge cand 0, no residual)
            c.encode(CT.SKIP_FLAG + ctx, 1)
            skip4[cy0:cy0 + nc, cx0:cx0 + nc] = 1
        else:
            c.encode(CT.SKIP_FLAG + ctx, 0)
            c.encode(CT.PRED_MODE_FLAG, 0)
            c.encode(CT.PART_MODE, 1)            # 2Nx2N
            c.encode(CT.MERGE_FLAG, 1 if use_merge else 0)
            if not use_merge:
                # P slice, nref 1: no inter_pred_idc, no ref_idx
                mvd = (int(mv[0] - mvps[0][0]), int(mv[1] - mvps[0][1]))
                mvd1 = (int(mv[0] - mvps[1][0]), int(mv[1] - mvps[1][1]))
                from ...utils.bits import se_len
                flag = 0
                if (se_len(mvd1[0]) + se_len(mvd1[1])
                        < se_len(mvd[0]) + se_len(mvd[1])):
                    flag, mvd = 1, mvd1
                _write_mvd(c, mvd[0], mvd[1])
                c.encode(CT.MVP_LX_FLAG, flag)
            if not use_merge:
                c.encode(CT.NO_RESIDUAL_DATA, 0 if all_zero else 1)
            if use_merge and all_zero:
                # merge 2Nx2N infers rqt_root_cbf=1: must code cbf flags
                pass
            if not all_zero or use_merge:
                # transform tree leaf at depth 0 (CTB16, no split)
                c.encode(CT.CBF_CB_CR + 0, cbf_cb)
                c.encode(CT.CBF_CB_CR + 0, cbf_cr)
                if cbf_cb or cbf_cr:
                    c.encode(CT.CBF_LUMA + 1, cbf_l)
                else:
                    # cbf_luma inferred 1: force a coded luma residual
                    if not cbf_l:
                        zl[0, 0] = 1
                        cbf_l = 1
                if cbf_l:
                    write_residual(c, zl, 4, 0)
                if cbf_cb:
                    write_residual(c, zcb, 3, 1)
                if cbf_cr:
                    write_residual(c, zcr, 3, 2)
            skip4[cy0:cy0 + nc, cx0:cx0 + nc] = 0

        # reconstruction (decoder-identical)
        rl = self._recon_inter(zl, qp, 4, 0) if cbf_l else 0
        rb = self._recon_inter(zcb, qp, 3, 1) if cbf_cb else 0
        rr = self._recon_inter(zcr, qp, 3, 2) if cbf_cr else 0
        ry[y0:y0 + cu, x0:x0 + cu] = np.clip(py + rl, 0, 255)
        rcb[y0 // 2:(y0 + cu) // 2, x0 // 2:(x0 + cu) // 2] = np.clip(
            pcb + rb, 0, 255)
        rcr[y0 // 2:(y0 + cu) // 2, x0 // 2:(x0 + cu) // 2] = np.clip(
            pcr + rr, 0, 255)

        predg[cy0:cy0 + nc, cx0:cx0 + nc] = 1
        mvg[cy0:cy0 + nc, cx0:cx0 + nc] = mv
        intra4[cy0:cy0 + nc, cx0:cx0 + nc] = 0
        done[cy0:cy0 + nc, cx0:cx0 + nc] = True
        avail_y[cy0:cy0 + nc, cx0:cx0 + nc] = True
        avail_c[y0 // 8:(y0 + cu) // 8, x0 // 8:(x0 + cu) // 8] = True
