"""Dense per-frame symbol planes: the host->device interface.

The entropy front-end (Python reference parser or the C++ fast parser) fills
these arrays; the device reconstruction consumes them: entropy decoding on
the host, everything after it on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MBCLASS_I4x4 = 0
MBCLASS_I16x16 = 1
MBCLASS_IPCM = 2
MBCLASS_P = 3       # reserved for inter 


@dataclass
class FrameSymbols:
    """All decoded symbols of one frame in dense numpy arrays.

    Layout notes:
    - luma_coeffs holds *raster-order* (de-zigzagged) quantized levels per 4x4
      block; for I16x16 MBs the [0,0] position is 0 (DC travels in luma_dc).
    - luma_dc[my, mx] is the 4x4 Hadamard-domain DC block (raster), zeros for
      non-I16 MBs.
    - chroma arrays likewise.
    """

    mb_width: int
    mb_height: int
    mb_class: np.ndarray = None      # [mbh, mbw] int32
    qp: np.ndarray = None            # [mbh, mbw] int32 (luma QP per MB)
    i4_modes: np.ndarray = None      # [mbh*4, mbw*4] int32 (0..8; 0 elsewhere)
    i16_mode: np.ndarray = None      # [mbh, mbw] int32
    chroma_mode: np.ndarray = None   # [mbh, mbw] int32
    luma_coeffs: np.ndarray = None   # [mbh*4, mbw*4, 4, 4] int32
    luma_dc: np.ndarray = None       # [mbh, mbw, 4, 4] int32
    chroma_coeffs: np.ndarray = None  # [2, mbh*2, mbw*2, 4, 4] int32
    chroma_dc: np.ndarray = None     # [2, mbh, mbw, 2, 2] int32
    # availability masks (slice-aware): 1 if neighbor MB usable for intra pred
    avail_left: np.ndarray = None    # [mbh, mbw] int32
    avail_top: np.ndarray = None     # [mbh, mbw] int32
    avail_topright: np.ndarray = None  # [mbh, mbw]
    avail_topleft: np.ndarray = None   # [mbh, mbw]
    has_pcm: bool = False
    has_t8: bool = False   # frame uses 8x8 transform (host recon path only
    #                        until the device kernel learns 8x8 residuals)
    has_b: bool = False    # frame has B-predicted MBs (host recon path)
    pcm_y: np.ndarray = None         # [mbh*16, mbw*16] int32 overlay (or None)
    pcm_u: np.ndarray = None
    pcm_v: np.ndarray = None
    # inter motion planes (None for all-intra frames)
    mv: np.ndarray = None            # [mbh*4, mbw*4, 2] int32 quarter-pel
    ref: np.ndarray = None           # [mbh*4, mbw*4] int32; -1 = intra
    # explicit weighted prediction (pred_weight_table): per-list-0-index
    # LUT [R, 6] int32 (wY, oY, wCb, oCb, wCr, oCr), or None when absent
    wp: np.ndarray = None
    wp_logwd: tuple = (0, 0)         # (luma, chroma) log2 weight denom
    # ref_pic_list_modification ops for list 0 ((idc, value) pairs) and the
    # slice's num_ref_idx_active_l0; the caller applies 8.2.4.3.1 when
    # building the device reference stack
    ref_mods_l0: list = None
    num_ref_l0: int = 0
    # picture identity (for DPB management by the caller)
    frame_num: int = 0
    is_idr: bool = False
    nal_ref_idc: int = 1
    max_num_ref_frames: int = 1
    log2_max_frame_num: int = 4
    # deblock control (from the picture's slice headers)
    deblock_enabled: bool = True
    alpha_off: int = 0
    beta_off: int = 0
    chroma_qp_off: int = 0
    second_chroma_qp_off: int = 0

    def __post_init__(self):
        mh, mw = self.mb_height, self.mb_width
        z = lambda *s: np.zeros(s, np.int32)
        if self.mb_class is None:
            self.mb_class = z(mh, mw)
            self.qp = z(mh, mw)
            self.i4_modes = z(mh * 4, mw * 4)
            self.i16_mode = z(mh, mw)
            self.chroma_mode = z(mh, mw)
            self.luma_coeffs = z(mh * 4, mw * 4, 4, 4)
            self.luma_dc = z(mh, mw, 4, 4)
            self.chroma_coeffs = z(2, mh * 2, mw * 2, 4, 4)
            self.chroma_dc = z(2, mh, mw, 2, 2)
            self.avail_left = z(mh, mw)
            self.avail_top = z(mh, mw)
            self.avail_topright = z(mh, mw)
            self.avail_topleft = z(mh, mw)

    def fill_availability(self, slice_id: np.ndarray) -> None:
        """Derive MB availability masks from the per-MB slice map (raster
        decode order assumed)."""
        mh, mw = self.mb_height, self.mb_width
        s = slice_id
        self.avail_left[:, 1:] = (s[:, 1:] == s[:, :-1]).astype(np.int32)
        self.avail_top[1:, :] = (s[1:, :] == s[:-1, :]).astype(np.int32)
        self.avail_topright[1:, :-1] = (s[1:, :-1] == s[:-1, 1:]).astype(np.int32)
        self.avail_topleft[1:, 1:] = (s[1:, 1:] == s[:-1, :-1]).astype(np.int32)
