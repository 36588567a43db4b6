"""HEVC frame plan: the host-parse -> device-recon interface.

The entropy stage (CABAC, quadtree syntax) is bit-serial and lives on the
host; everything after it is pixel math and lives on the device
(kernels/hevc_tiles.py). This module defines the tensors the host emits per
picture — all frame-shaped with static geometry, so the device program
compiles once per stream geometry:

  coeff planes   raw (pre-dequant) transform levels, each TU's NxN block
                 stored at its pixel position
  tu_log2 maps   per-4x4-cell log2 size of the covering TU leaf (0 = none)
  mode maps      per-cell intra prediction mode of the covering PU
  zidx maps      per-cell decode-order index of the covering recon event;
                 reference-sample availability on the device is exactly
                 "zidx[neighbor] < zidx[me]" (z-scan availability, 6.4.1)
  qp map         per-cell luma QP (dequant + deblock)
  bs maps        per-4x4-edge deblock boundary strengths
  sao tensors    per-CTB SAO type/offsets/band/class

The "picture parameters + slice data" payload that a hardware decoder
takes in one call is here an explicit tensor set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

ZIDX_NONE = 1 << 30  # zidx for never-reconstructed cells (always unavailable)


@dataclass
class HevcFramePlan:
    # geometry (static per stream)
    width: int          # cropped output
    height: int
    pw: int             # coded picture size (pic_width_in_luma_samples)
    ph: int
    Hp: int             # CTB-padded luma plane size
    Wp: int
    log2_ctb: int
    log2_max_tb: int
    strong_smoothing: bool
    supported: bool = True
    reason: str = ""

    # luma (cell grid = 4x4 px)
    coeff_y: Optional[np.ndarray] = None     # [Hp, Wp] int32
    tu_log2_y: Optional[np.ndarray] = None   # [Hp//4, Wp//4] int32 (0 or 2..5)
    mode_y: Optional[np.ndarray] = None      # [Hp//4, Wp//4] int32
    zidx_y: Optional[np.ndarray] = None      # [Hp//4, Wp//4] int32
    qp_y: Optional[np.ndarray] = None        # [Hp//4, Wp//4] int32

    # chroma (cell grid = 4x4 chroma px)
    coeff_cb: Optional[np.ndarray] = None    # [Hp//2, Wp//2] int32
    coeff_cr: Optional[np.ndarray] = None
    tu_log2_c: Optional[np.ndarray] = None   # [Hp//8, Wp//8] int32 (0 or 2..4)
    mode_c: Optional[np.ndarray] = None
    zidx_c: Optional[np.ndarray] = None
    cb_qp_off: int = 0
    cr_qp_off: int = 0

    # deblock
    deblock_disabled: bool = False
    beta_off: int = 0
    tc_off: int = 0
    bs_ver: Optional[np.ndarray] = None      # [Hp//4, Wp//4] int32
    bs_hor: Optional[np.ndarray] = None

    # SAO, per CTB
    sao_type: Optional[np.ndarray] = None    # [ctb_h, ctb_w, 3] int32
    sao_offsets: Optional[np.ndarray] = None # [ctb_h, ctb_w, 3, 4] int32
    sao_band: Optional[np.ndarray] = None    # [ctb_h, ctb_w, 3] int32
    sao_eo: Optional[np.ndarray] = None      # [ctb_h, ctb_w, 3] int32

    # inter prediction (None for all-intra pictures): per-4x4-cell motion
    # against a DPB slot stack; inter TUs carry their own size map (DCT
    # residuals added before the intra wavefront runs)
    inter4: Optional[np.ndarray] = None       # [Hp//4, Wp//4] uint8
    mv: Optional[np.ndarray] = None           # [2, Hp//4, Wp//4, 2] int32
    ref_slot: Optional[np.ndarray] = None     # [2, Hp//4, Wp//4] int32
    pred_fl: Optional[np.ndarray] = None      # [2, Hp//4, Wp//4] uint8
    tu_log2_inter_y: Optional[np.ndarray] = None  # [Hp//4, Wp//4]
    tu_log2_inter_c: Optional[np.ndarray] = None  # [Hp//8, Wp//8]
    # explicit weighted prediction (8.5.4.2.3.3): per-cell resolved
    # (w, o) per list per component; identity (w=1, o=0, denom=0) when the
    # slice has no pred_weight_table, so the device combine is ONE uniform
    # formula (default == explicit with the identity weights)
    wp_w: Optional[np.ndarray] = None         # [2, Hp//4, Wp//4, 6] int32
    luma_log2wd: int = 0
    chroma_log2wd: int = 0
    _wp_tab: Optional[list] = None            # hdr.wp while recording
    ref_pocs: Optional[list] = None           # POC per slot
    poc: int = 0
    is_idr: bool = False
    is_reference: bool = True

    n_slices: int = 0
    _zctr: int = 0

    MAX_ABS_MV_PX = 56  # device MC pad budget; larger motion -> host path

    def enable_inter(self) -> None:
        cell = (self.Hp // 4, self.Wp // 4)
        self.inter4 = np.zeros(cell, np.uint8)
        self.mv = np.zeros((2,) + cell + (2,), np.int32)
        self.ref_slot = np.zeros((2,) + cell, np.int32)
        self.pred_fl = np.zeros((2,) + cell, np.uint8)
        self.tu_log2_inter_y = np.zeros(cell, np.int32)
        self.tu_log2_inter_c = np.zeros((self.Hp // 8, self.Wp // 8),
                                        np.int32)
        # identity weights: w=1, o=0 for every component/list
        self.wp_w = np.zeros((2,) + cell + (6,), np.int32)
        self.wp_w[..., 0::2] = 1

    def set_wp(self, hdr) -> None:
        """Arm explicit weighted prediction from the slice header: cells
        recorded after this resolve (w, o) from the header's table (device
        analog of inter.predict_pu's wp argument)."""
        if hdr.wp is None:
            return
        if self.wp_w is None:
            self.enable_inter()
        self.luma_log2wd = int(hdr.luma_denom)
        self.chroma_log2wd = int(hdr.chroma_denom)
        self._wp_tab = hdr.wp

    def fill_wp_cells(self, ref_idx: np.ndarray,
                      pred_fl: np.ndarray) -> None:
        """Vectorized per-cell weight fill from a [2, H4, W4] ref_idx
        plane (the native parser's output path; record_pu does the same
        per PU for the Python parser)."""
        if self._wp_tab is None:
            return
        # parse-state grids cover the PICTURE cell grid; wp_w covers the
        # CTB-padded plan grid — fill the overlapping region
        ch, cw = ref_idx.shape[1], ref_idx.shape[2]
        for lx in (0, 1):
            tab = self._wp_tab[lx]
            if not tab:
                continue
            t = np.asarray(tab, np.int32)         # [nref, 6]
            idx = np.clip(ref_idx[lx], 0, len(tab) - 1)
            cells = t[idx]                        # [ch, cw, 6]
            on = pred_fl[lx].astype(bool)
            sub = self.wp_w[lx, :ch, :cw]
            sub[on] = cells[on]

    def record_pu(self, xp: int, yp: int, w: int, h: int, pred: int,
                  mv, ref_slot, ref_idx=(0, 0)) -> None:
        ys = slice(yp // 4, (yp + h) // 4)
        xs = slice(xp // 4, (xp + w) // 4)
        self.inter4[ys, xs] = 1
        for lx in (0, 1):
            if not (pred & (1 << lx)):
                continue
            mvx, mvy = int(mv[lx][0]), int(mv[lx][1])
            if (abs(mvx) > 4 * self.MAX_ABS_MV_PX or
                    abs(mvy) > 4 * self.MAX_ABS_MV_PX):
                self.supported = False
                self.reason = "MV beyond device MC pad"
            self.pred_fl[lx, ys, xs] = 1
            self.mv[lx, ys, xs] = (mvx, mvy)
            self.ref_slot[lx, ys, xs] = ref_slot[lx]
            if self._wp_tab is not None and self._wp_tab[lx]:
                self.wp_w[lx, ys, xs] = self._wp_tab[lx][ref_idx[lx]]

    def record_inter_cu_done(self, x0: int, y0: int, n: int) -> None:
        """Assign the CU's z-scan index AFTER its prediction+residual: a
        later intra TU may reference these cells, an earlier one may not
        (6.4.1 z-scan availability, mirrored by the device zidx compare)."""
        ys, xs = slice(y0 // 4, (y0 + n) // 4), slice(x0 // 4, (x0 + n) // 4)
        self.zidx_y[ys, xs] = self.next_zidx()
        cys = slice(y0 // 8, (y0 + n) // 8)
        cxs = slice(x0 // 8, (x0 + n) // 8)
        self.zidx_c[cys, cxs] = self.next_zidx()

    def record_inter_luma_tu(self, x0: int, y0: int, n: int,
                             coeffs: Optional[np.ndarray]) -> None:
        log2 = n.bit_length() - 1
        ys, xs = slice(y0 // 4, (y0 + n) // 4), slice(x0 // 4, (x0 + n) // 4)
        self.tu_log2_inter_y[ys, xs] = log2
        if coeffs is not None:
            self.coeff_y[y0:y0 + n, x0:x0 + n] = coeffs

    def record_inter_chroma_tu(self, xc: int, yc: int, n: int,
                               coeffs_cb, coeffs_cr) -> None:
        log2 = n.bit_length() - 1
        ys, xs = slice(yc // 4, (yc + n) // 4), slice(xc // 4, (xc + n) // 4)
        self.tu_log2_inter_c[ys, xs] = log2
        if coeffs_cb is not None:
            self.coeff_cb[yc:yc + n, xc:xc + n] = coeffs_cb
        if coeffs_cr is not None:
            self.coeff_cr[yc:yc + n, xc:xc + n] = coeffs_cr

    @classmethod
    def create(cls, sps) -> "HevcFramePlan":
        ctb = 1 << sps.log2_ctb
        ctb_w = (sps.pic_width + ctb - 1) >> sps.log2_ctb
        ctb_h = (sps.pic_height + ctb - 1) >> sps.log2_ctb
        Hp, Wp = ctb_h * ctb, ctb_w * ctb
        p = cls(width=sps.width, height=sps.height,
                pw=sps.pic_width, ph=sps.pic_height, Hp=Hp, Wp=Wp,
                log2_ctb=sps.log2_ctb, log2_max_tb=sps.log2_max_tb,
                strong_smoothing=bool(sps.strong_intra_smoothing))
        p.coeff_y = np.zeros((Hp, Wp), np.int32)
        cell = (Hp // 4, Wp // 4)
        p.tu_log2_y = np.zeros(cell, np.int32)
        p.mode_y = np.zeros(cell, np.int32)
        p.zidx_y = np.full(cell, ZIDX_NONE, np.int32)
        p.qp_y = np.zeros(cell, np.int32)
        p.coeff_cb = np.zeros((Hp // 2, Wp // 2), np.int32)
        p.coeff_cr = np.zeros((Hp // 2, Wp // 2), np.int32)
        ccell = (Hp // 8, Wp // 8)
        p.tu_log2_c = np.zeros(ccell, np.int32)
        p.mode_c = np.zeros(ccell, np.int32)
        p.zidx_c = np.full(ccell, ZIDX_NONE, np.int32)
        p.bs_ver = np.zeros(cell, np.int32)
        p.bs_hor = np.zeros(cell, np.int32)
        p.sao_type = np.zeros((ctb_h, ctb_w, 3), np.int32)
        p.sao_offsets = np.zeros((ctb_h, ctb_w, 3, 4), np.int32)
        p.sao_band = np.zeros((ctb_h, ctb_w, 3), np.int32)
        p.sao_eo = np.zeros((ctb_h, ctb_w, 3), np.int32)
        return p

    # -- recording hooks (called by the host parser) -------------------------

    def next_zidx(self) -> int:
        z = self._zctr
        self._zctr += 1
        return z

    def record_luma_tu(self, x0: int, y0: int, n: int, mode: int, qp: int,
                       coeffs: Optional[np.ndarray]) -> None:
        g = 4
        log2 = n.bit_length() - 1
        ys, xs = slice(y0 // g, (y0 + n) // g), slice(x0 // g, (x0 + n) // g)
        self.tu_log2_y[ys, xs] = log2
        self.mode_y[ys, xs] = mode
        self.zidx_y[ys, xs] = self.next_zidx()
        self.qp_y[ys, xs] = qp
        if coeffs is not None:
            self.coeff_y[y0:y0 + n, x0:x0 + n] = coeffs

    def record_chroma_tu(self, xc: int, yc: int, n: int, mode: int,
                         coeffs_cb: Optional[np.ndarray],
                         coeffs_cr: Optional[np.ndarray]) -> None:
        g = 4
        log2 = n.bit_length() - 1
        ys, xs = slice(yc // g, (yc + n) // g), slice(xc // g, (xc + n) // g)
        self.tu_log2_c[ys, xs] = log2
        self.mode_c[ys, xs] = mode
        self.zidx_c[ys, xs] = self.next_zidx()
        if coeffs_cb is not None:
            self.coeff_cb[yc:yc + n, xc:xc + n] = coeffs_cb
        if coeffs_cr is not None:
            self.coeff_cr[yc:yc + n, xc:xc + n] = coeffs_cr

    def record_slice(self, hdr, pps) -> None:
        self.n_slices += 1
        if self.n_slices == 1:
            self.deblock_disabled = bool(hdr.deblocking_disabled)
            self.beta_off = hdr.beta_offset_div2 * 2
            self.tc_off = hdr.tc_offset_div2 * 2
            self.cb_qp_off = pps.cb_qp_offset + hdr.cb_qp_offset
            self.cr_qp_off = pps.cr_qp_offset + hdr.cr_qp_offset
        else:
            # cross-slice prediction availability + per-slice filter params
            # are host-path territory for now
            self.supported = False
            self.reason = "multi-slice picture"

    def record_sao(self, sao_params: List, ctb_w: int, ctb_h: int) -> None:
        for yc in range(ctb_h):
            for xc in range(ctb_w):
                p = sao_params[yc * ctb_w + xc]
                if p is None:
                    continue
                self.sao_type[yc, xc] = p.type_idx
                self.sao_offsets[yc, xc] = p.offsets
                self.sao_band[yc, xc] = p.band_pos
                self.sao_eo[yc, xc] = p.eo_class
