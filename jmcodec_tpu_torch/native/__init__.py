"""Native (C++) host parsers: H.264 CAVLC/CABAC slice data into
FrameSymbols, HEVC CABAC slice data (I, P and B slices, the P/B parse with
its merge/AMVP/TMVP motion derivation) into HevcFramePlan tensors.

The sources under src/ (the table headers included, as committed files)
are compiled with g++ into one shared library under the package's build/
directory at first use and bound with ctypes. A build or load failure
raises: there is no Python parser to fall back to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_BUILD = os.path.join(os.path.dirname(_DIR), "build")
LIB = os.path.join(_BUILD, "libjmx_native.so")
SOURCES = ("h264_parse.cc", "h264_cabac.cc", "hevc_parse.cc")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def build(force: bool = False) -> str:
    """Compile the library if it is missing or older than a source or
    header; returns its path."""
    srcs = [os.path.join(_SRC, s) for s in SOURCES]
    deps = [os.path.join(_SRC, f) for f in sorted(os.listdir(_SRC))]
    if (not force and os.path.exists(LIB) and all(
            os.path.getmtime(LIB) >= os.path.getmtime(d) for d in deps)):
        return LIB
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                          "-o", tmp, *srcs], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, LIB)
    return LIB


def get_lib():
    """The loaded library, built on first use. Raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            head = [_P, _L, _L]
            lib.jmx_parse_i_slice.argtypes = head + [_I] * 5 + [_P] * 15
            lib.jmx_parse_i_slice.restype = _I
            lib.jmx_parse_p_slice.argtypes = head + [_I] * 7 + [_P] * 18
            lib.jmx_parse_p_slice.restype = _I
            lib.jmx_parse_cabac_slice.argtypes = (head + [_I] * 9
                                                  + [_P] * 27)
            lib.jmx_parse_cabac_slice.restype = _I
            lib.jmx_hevc_parse_i_slice.argtypes = head + [_P] * 19
            lib.jmx_hevc_parse_i_slice.restype = _I
            lib.jmx_hevc_parse_pb_slice.argtypes = head + [_P] * 51
            lib.jmx_hevc_parse_pb_slice.restype = _I
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeSliceParser:
    """Per-picture H.264 parse context (neighbour grids and the slice map),
    backed by the C++ parsers; each call parses one slice's slice_data into
    the picture's FrameSymbols."""

    def __init__(self, mbw: int, mbh: int):
        self.lib = get_lib()
        self.mbw, self.mbh = mbw, mbh
        self.nz_luma = np.full((mbh * 4, mbw * 4), -1, np.int32)
        self.nz_chroma = np.full((2, mbh * 2, mbw * 2), -1, np.int32)
        self.i4_grid = np.full((mbh * 4, mbw * 4), -1, np.int32)
        self.slice_map = np.full((mbh, mbw), -1, np.int32)
        self.mv = self.ref = self.done = None
        self._cabac = None

    def _motion_ptrs(self):
        """The picture's motion grids, made at the first P slice and
        shared by every slice of the picture, CAVLC or CABAC: mv [mbh*4,
        mbw*4, 2] quarter-pel, ref [mbh*4, mbw*4] (-1 intra), done."""
        if self.mv is None:
            mh, mw = self.mbh, self.mbw
            self.mv = np.zeros((mh * 4, mw * 4, 2), np.int32)
            self.ref = np.full((mh * 4, mw * 4), -1, np.int32)
            self.done = np.zeros((mh * 4, mw * 4), np.uint8)
        return [_ptr(a) for a in (self.mv, self.ref, self.done)]

    def _pcm_planes(self, fs):
        if fs.pcm_y is None:
            return (np.zeros((self.mbh * 16, self.mbw * 16), np.uint8),
                    np.zeros((2, self.mbh * 8, self.mbw * 8), np.uint8))
        return (fs.pcm_y.astype(np.uint8),
                np.stack([fs.pcm_u, fs.pcm_v]).astype(np.uint8))

    def _symbol_ptrs(self, fs, pcm_y, pcm_c):
        return [_ptr(a) for a in (
            self.nz_luma, self.nz_chroma, self.i4_grid, self.slice_map,
            fs.mb_class, fs.qp, fs.i4_modes, fs.i16_mode, fs.chroma_mode,
            fs.luma_coeffs, fs.luma_dc, fs.chroma_coeffs, fs.chroma_dc,
            pcm_y, pcm_c)]

    @staticmethod
    def _keep_pcm(fs, pcm_y, pcm_c):
        if (fs.mb_class == 2).any():
            fs.has_pcm = True
            fs.pcm_y = pcm_y.astype(np.int32)
            fs.pcm_u = pcm_c[0].astype(np.int32)
            fs.pcm_v = pcm_c[1].astype(np.int32)

    def parse_slice(self, fs, rbsp: bytes, bit_offset: int, first_mb: int,
                    slice_qp: int, slice_id: int) -> int:
        """Parse a CAVLC I slice's slice_data into fs. Returns the number
        of macroblocks parsed."""
        buf = np.frombuffer(rbsp, np.uint8)
        pcm_y, pcm_c = self._pcm_planes(fs)
        n = self.lib.jmx_parse_i_slice(
            _ptr(buf), len(rbsp), bit_offset, self.mbw, self.mbh, first_mb,
            slice_qp, slice_id, *self._symbol_ptrs(fs, pcm_y, pcm_c))
        if n < 0:
            raise ValueError(f"native slice parse error {n}")
        self._keep_pcm(fs, pcm_y, pcm_c)
        return n

    def parse_p_slice(self, fs, rbsp: bytes, bit_offset: int, first_mb: int,
                      slice_qp: int, slice_id: int, num_ref: int,
                      t8_allowed: bool) -> int:
        """Parse a CAVLC P slice's slice_data into fs and the motion grids
        self.mv / self.ref. Returns the number of macroblocks parsed;
        raises NotImplementedError for the 8x8 transform."""
        buf = np.frombuffer(rbsp, np.uint8)
        pcm_y, pcm_c = self._pcm_planes(fs)
        n = self.lib.jmx_parse_p_slice(
            _ptr(buf), len(rbsp), bit_offset, self.mbw, self.mbh, first_mb,
            slice_qp, slice_id, int(num_ref), int(t8_allowed),
            *self._symbol_ptrs(fs, pcm_y, pcm_c), *self._motion_ptrs())
        if n == -21:
            raise NotImplementedError("8x8 transform (native P parser)")
        if n < 0:
            raise ValueError(f"native P slice parse error {n}")
        self._keep_pcm(fs, pcm_y, pcm_c)
        return n

    def parse_cabac_slice(self, fs, rbsp: bytes, bit_offset: int,
                          first_mb: int, slice_qp: int, slice_id: int,
                          is_p: bool, num_ref: int, t8_allowed: bool,
                          cabac_init_idc: int) -> int:
        """Parse one CABAC slice's slice_data into fs (and the motion grids
        self.mv / self.ref for a P slice). Raises NotImplementedError for
        the 8x8 transform."""
        mh, mw = self.mbh, self.mbw
        if self._cabac is None:
            z = lambda *s: np.zeros(s, np.int32)
            # skip, t8, cbp luma/chroma, cbf dc/luma/chroma dc/chroma ac, mvd
            self._cabac = (z(mh, mw), z(mh, mw), z(mh, mw), z(mh, mw),
                           z(mh, mw), z(mh * 4, mw * 4), z(2, mh, mw),
                           z(2, mh * 2, mw * 2), z(mh * 4, mw * 4, 2))
        buf = np.frombuffer(rbsp, np.uint8)
        pcm_y, pcm_c = self._pcm_planes(fs)
        n = self.lib.jmx_parse_cabac_slice(
            _ptr(buf), len(rbsp), bit_offset, mw, mh, first_mb, slice_qp,
            slice_id, int(is_p), int(num_ref), int(t8_allowed),
            int(cabac_init_idc), *self._symbol_ptrs(fs, pcm_y, pcm_c),
            *self._motion_ptrs(), *[_ptr(a) for a in self._cabac])
        if n == -21:
            raise NotImplementedError("8x8 transform (native CABAC path)")
        if n < 0:
            raise ValueError(f"native CABAC slice parse error {n}")
        self._keep_pcm(fs, pcm_y, pcm_c)
        return n


class HevcNativeUnsupported(NotImplementedError):
    """The picture uses a feature the native HEVC parser does not cover."""


def hevc_fill_plan(plan, hdr, sps, pps, rbsp: bytes,
                   substream_rbsp) -> None:
    """Fill a HevcFramePlan's tensors by parsing one I slice natively.

    Raises HevcNativeUnsupported when the stream uses a feature the C++
    parser does not cover (PCM, cu_qp_delta, transquant bypass,
    transform_skip, ...); ValueError on a corrupt bitstream.
    """
    lib = get_lib()
    if sps.pcm_enabled:
        raise HevcNativeUnsupported("PCM")
    if pps.cu_qp_delta_enabled:
        raise HevcNativeUnsupported("cu_qp_delta")
    buf = np.frombuffer(rbsp, np.uint8)
    iparams = _hevc_iparams(hdr, sps, pps, len(substream_rbsp))
    subs = np.asarray(substream_rbsp or [0], np.int64)
    cw = (sps.pic_width + 3) // 4
    ch = (sps.pic_height + 3) // 4
    scratch = np.zeros(5 * cw * ch, np.uint8)
    n = lib.jmx_hevc_parse_i_slice(
        _ptr(buf), len(rbsp), hdr.data_bitpos, _ptr(iparams), _ptr(subs),
        _ptr(plan.coeff_y), _ptr(plan.tu_log2_y), _ptr(plan.mode_y),
        _ptr(plan.zidx_y), _ptr(plan.qp_y),
        _ptr(plan.coeff_cb), _ptr(plan.coeff_cr),
        _ptr(plan.tu_log2_c), _ptr(plan.mode_c), _ptr(plan.zidx_c),
        _ptr(plan.bs_ver), _ptr(plan.bs_hor),
        _ptr(plan.sao_type), _ptr(plan.sao_offsets), _ptr(plan.sao_band),
        _ptr(plan.sao_eo), _ptr(scratch))
    if n in (-2, -3, -4, -7):
        raise HevcNativeUnsupported(f"native HEVC parser: code {n}")
    if n <= 0:
        raise ValueError(f"native HEVC slice parse error {n}")


def _hevc_iparams(hdr, sps, pps, n_substreams: int) -> np.ndarray:
    return np.array([
        sps.pic_width, sps.pic_height, sps.log2_ctb, sps.log2_min_cb,
        sps.log2_min_tb, sps.log2_max_tb,
        sps.max_transform_hierarchy_depth_intra,
        hdr.qp, hdr.init_type, hdr.sao_luma, hdr.sao_chroma,
        pps.entropy_coding_sync_enabled, pps.sign_data_hiding,
        pps.transform_skip_enabled, pps.transquant_bypass_enabled,
        sps.pcm_enabled, hdr.segment_address, n_substreams,
    ], np.int32)


def hevc_fill_plan_inter(plan, hdr, sps, pps, rbsp: bytes, substream_rbsp,
                         ictx) -> dict:
    """Fill an inter (P/B) HevcFramePlan natively (plan.enable_inter() done).
    ictx: the slice's motion context, a dict with slice_type, num_ref,
    max_merge, tmvp_on, col_from_l0, col_ref_idx, mvd_l1_zero, no_backward,
    cur_poc, has_col, col_poc, col (the collocated picture's pred, mv,
    ref_poc and intra cell grids, or None) and refs (per list, (POC, slot)
    of each entry). Returns the parse-state cell grids (pred, mv, refidx,
    ref_poc, mot_done, intra4, skip4, cbf4 and the TU/PU edge masks
    tu_ev/tu_eh/pu_ev/pu_eh) that feed the bS derivation and the DPB.

    Weighted prediction needs nothing here: its table is in the slice
    header and the plan resolves it per cell (fill_wp_cells). Raises
    HevcNativeUnsupported outside the parser's scope (PCM, cu_qp_delta,
    ...), ValueError on a corrupt stream. Return code -40 (motion beyond
    the device MC pad) sets plan.supported = False; the state returned is
    complete all the same."""
    lib = get_lib()
    if sps.pcm_enabled:
        raise HevcNativeUnsupported("PCM")
    if pps.cu_qp_delta_enabled:
        raise HevcNativeUnsupported("cu_qp_delta")
    buf = np.frombuffer(rbsp, np.uint8)
    iparams = _hevc_iparams(hdr, sps, pps, len(substream_rbsp))
    ip2 = np.array([
        ictx["slice_type"], ictx["num_ref"][0], ictx["num_ref"][1],
        ictx["max_merge"], ictx["tmvp_on"], ictx["col_from_l0"],
        ictx["col_ref_idx"], ictx["mvd_l1_zero"], ictx["no_backward"],
        ictx["cur_poc"], sps.max_transform_hierarchy_depth_inter,
        sps.amp_enabled, ictx["has_col"], ictx["col_poc"],
    ], np.int32)
    ref_poc = np.zeros((2, 16), np.int32)
    ref_slot = np.zeros((2, 16), np.int32)
    for lx in (0, 1):
        for k, (pc, sl) in enumerate(ictx["refs"][lx][:16]):
            ref_poc[lx, k] = pc
            ref_slot[lx, k] = sl
    subs = np.asarray(substream_rbsp or [0], np.int64)
    cw = (sps.pic_width + 3) // 4
    ch = (sps.pic_height + 3) // 4
    cell = (ch, cw)
    z8 = lambda *s: np.zeros(s, np.uint8)
    z32 = lambda *s: np.zeros(s, np.int32)
    st = {
        "pred": z8(2, *cell), "mv": z32(2, *cell, 2),
        "refidx": np.full((2,) + cell, -1, np.int32),
        "ref_poc": z32(2, *cell), "mot_done": z8(*cell),
        "intra4": z8(*cell), "skip4": z8(*cell), "cbf4": z8(*cell),
        "tu_ev": z8(*cell), "tu_eh": z8(*cell),
        "pu_ev": z8(*cell), "pu_eh": z8(*cell),
    }
    col = ictx.get("col")
    if col is None:
        colp = (z8(*cell), z8(*cell), z8(*cell), z32(*cell, 2),
                z32(*cell, 2), z32(*cell), z32(*cell))
    else:
        colp = tuple(np.ascontiguousarray(a) for a in (
            col["pred"][0], col["pred"][1], col["intra"], col["mv"][0],
            col["mv"][1], col["ref_poc"][0], col["ref_poc"][1]))
    scratch = np.zeros(5 * cw * ch, np.uint8)
    n = lib.jmx_hevc_parse_pb_slice(
        _ptr(buf), len(rbsp), hdr.data_bitpos, _ptr(iparams), _ptr(subs),
        _ptr(plan.coeff_y), _ptr(plan.tu_log2_y), _ptr(plan.mode_y),
        _ptr(plan.zidx_y), _ptr(plan.qp_y),
        _ptr(plan.coeff_cb), _ptr(plan.coeff_cr),
        _ptr(plan.tu_log2_c), _ptr(plan.mode_c), _ptr(plan.zidx_c),
        _ptr(plan.bs_ver), _ptr(plan.bs_hor),
        _ptr(plan.sao_type), _ptr(plan.sao_offsets), _ptr(plan.sao_band),
        _ptr(plan.sao_eo), _ptr(scratch),
        _ptr(ip2), _ptr(ref_poc), _ptr(ref_slot),
        *[_ptr(a) for a in colp],
        _ptr(st["pred"][0]), _ptr(st["pred"][1]),
        _ptr(st["mv"][0]), _ptr(st["mv"][1]),
        _ptr(st["refidx"][0]), _ptr(st["refidx"][1]),
        _ptr(st["ref_poc"][0]), _ptr(st["ref_poc"][1]),
        _ptr(st["mot_done"]), _ptr(st["intra4"]), _ptr(st["skip4"]),
        _ptr(st["cbf4"]),
        _ptr(st["tu_ev"]), _ptr(st["tu_eh"]),
        _ptr(st["pu_ev"]), _ptr(st["pu_eh"]),
        _ptr(plan.inter4), _ptr(plan.mv), _ptr(plan.ref_slot),
        _ptr(plan.pred_fl), _ptr(plan.tu_log2_inter_y),
        _ptr(plan.tu_log2_inter_c))
    if n == -40:
        plan.supported = False
        plan.reason = "MV beyond device MC pad"
        return st
    if n in (-2, -3, -4, -7):
        raise HevcNativeUnsupported(f"native HEVC parser: code {n}")
    if n <= 0:
        raise ValueError(f"native HEVC P/B slice parse error {n}")
    return st
