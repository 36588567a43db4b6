"""H.264 encoder with its P frames on the device, the port of
jmcodec_tpu/codec/h264/devenc.py.

The IDR is encoded on the host (refenc.py). A P frame runs the batched
exhaustive motion search, the 4x4 transform, quantisation and the RD
threshold on the device (kernels/encode_tiles.py), comes down to the host
in one copy for the skip derivation and CAVLC writing, and is
reconstructed through the device decode (recon_tiles, with the CUDA
dequant+IDCT on the card) from the very symbols written, so the
encoder's reconstruction is the decoder's by construction. The reference
chain stays on the device: only an IDR uploads one.
"""

from __future__ import annotations

import numpy as np
import torch

from ...kernels import recon_tiles as RT
from ...kernels.encode_tiles import SEARCH_RANGE, encode_p_frame
from ...ops import transform as T
from ...utils.device import require_cuda
from ...utils.metrics import timers
from . import inter as INTER
from . import macroblock as MB
from . import nal
from .refdec import RefPicture
from .refenc import EncoderConfig, H264ReferenceEncoder, raster_to_scan4x4
from .slicehdr import SLICE_P, SliceHeader, write_slice_header
from .symbols import FrameSymbols


class DeviceH264Encoder(H264ReferenceEncoder):
    """H264ReferenceEncoder with the P-frame pixel math on the device
    (None: the card, which must be there; the tests pass "cpu").

    After a P frame the DPB and last_recon hold the device's uint8 planes
    (whole macroblocks); recon_cropped() copies them down once. Stage
    timers: enc_idr (the host IDR), enc_search (the host's issue of the
    search and transform), enc_pull (the copy down, which waits for
    them), enc_pack (the host's CAVLC pack), enc_recon (the host's issue
    of the reconstruction)."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__(cfg)
        self.device = require_cuda() if device is None else torch.device(
            device)
        self._dev_ref = None  # (Y, U, V) padded by pad_ref_device

    def encode_idr(self, Y, U, V, qp=None) -> bytes:
        with timers.stage("enc_idr"):
            out = super().encode_idr(Y, U, V, qp=qp)
        r = self.dpb[0]
        up = lambda a: torch.from_numpy(a.astype(np.uint8)).to(self.device)
        self._dev_ref = RT.pad_ref_device(up(r.Y), up(r.U), up(r.V))
        return out

    def encode_p(self, Y, U, V, qp=None) -> bytes:
        qp = self.cfg.qp if qp is None else int(qp)
        up = lambda a, c=False: torch.from_numpy(
            self._pad(np.asarray(a, np.int32), c=c)).to(self.device)
        lam = max(1, 1 << max(0, (qp - 12) // 6))
        qpc_cb = int(T.chroma_qp(qp, self.pps.chroma_qp_offset(0)))
        qpc_cr = int(T.chroma_qp(qp, self.pps.chroma_qp_offset(1)))
        rng = min(SEARCH_RANGE, self.cfg.search_range)

        with timers.stage("enc_search"):
            planes = encode_p_frame(rng, up(Y), up(U, True), up(V, True),
                                    *self._dev_ref, qp, qpc_cb, qpc_cr,
                                    lam)[:4]
        with timers.stage("enc_pull"):
            # one copy down of the four symbol planes
            flat = torch.cat([p.reshape(-1) for p in planes]).cpu().numpy()
        ends = np.cumsum([p.numel() for p in planes])[:-1]
        mv, luma_z, chroma_ac, chroma_dc = (
            a.reshape(p.shape) for a, p in zip(np.split(flat, ends), planes))

        # ---- host entropy pack (skip-run + CAVLC slice writing) ----
        with timers.stage("enc_pack"):
            self.frame_num = (self.frame_num + 1) % (
                1 << self.sps.log2_max_frame_num)
            hdr = SliceHeader(
                slice_type=SLICE_P, frame_num=self.frame_num, is_idr=False,
                nal_ref_idc=2, num_ref_idx_active_l0=1,
                slice_qp_delta=qp - self.pps.pic_init_qp,
                disable_deblocking_filter_idc=(
                    1 if self.cfg.disable_deblock else 0))
            sw = write_slice_header(hdr, self.sps, self.pps)
            g = MB.MBGrids(self.mbw, self.mbh)
            m = INTER.MotionGrids(self.mbw, self.mbh)
            skip_run = 0
            for my in range(self.mbh):
                for mx in range(self.mbw):
                    s, is_skip = self._pack_p_mb(g, m, my, mx, qp, mv,
                                                 luma_z, chroma_ac,
                                                 chroma_dc)
                    if is_skip:
                        skip_run += 1
                        continue
                    sw.ue(skip_run)
                    skip_run = 0
                    INTER.write_p_macroblock(sw, g, m, my, mx, 0, qp, s, 1)
            if skip_run:
                sw.ue(skip_run)
            sw.rbsp_trailing_bits()

        # ---- reconstruction through the device decode ----
        fs = FrameSymbols(self.mbw, self.mbh)
        fs.mb_class[:] = INTER.MB_P
        fs.qp[:] = qp
        fs.luma_coeffs = luma_z
        fs.chroma_coeffs = chroma_ac
        fs.chroma_dc[:] = chroma_dc
        fs.mv = np.repeat(np.repeat(mv, 4, 0), 4, 1)
        fs.ref = np.zeros((self.mbh * 4, self.mbw * 4), np.int32)
        fs.fill_availability(np.zeros((self.mbh, self.mbw), np.int32))
        fs.deblock_enabled = not self.cfg.disable_deblock
        fs.chroma_qp_off = self.pps.chroma_qp_index_offset
        fs.second_chroma_qp_off = fs.chroma_qp_off
        with timers.stage("enc_recon"):
            # one reference, its own identity for bS; every macroblock is
            # inter, so the intra scan walks no diagonal
            Yd, Ud, Vd = RT.decode_frame_symbols_inter(fs, [self._dev_ref],
                                                       [0])
            self._dev_ref = RT.pad_ref_device(Yd, Ud, Vd)
        self.last_recon = (Yd, Ud, Vd)
        self.dpb = [RefPicture(self.frame_num, Yd, Ud, Vd)]
        return nal.write_nal_unit(2, nal.NAL_SLICE_NON_IDR, sw.bytes())

    def recon_cropped(self):
        if isinstance(self.last_recon[0], torch.Tensor):
            self.last_recon = tuple(p.cpu().numpy() for p in self.last_recon)
        return super().recon_cropped()

    def _pack_p_mb(self, g, m, my, mx, qp, mv, luma_z, chroma_ac, chroma_dc):
        """Build PMBSymbols for one MB from the device symbol planes."""
        s = INTER.PMBSymbols()
        s.mb_class = INTER.MB_P
        s.p_type = INTER.P_16x16
        s.qp = qp
        mbmv = np.array([int(mv[my, mx, 0]), int(mv[my, mx, 1])], np.int32)
        s.partitions = [INTER.InterPartition(my * 4, mx * 4, 4, 4, 0, mbmv)]
        cbp = 0
        for i in range(16):
            bx4, by4 = int(MB.BLK_X[i]) // 4, int(MB.BLK_Y[i]) // 4
            zb = luma_z[my * 4 + by4, mx * 4 + bx4]
            s.luma_ac[i] = raster_to_scan4x4(zb)
            if zb.any():
                cbp |= 1 << (i >> 2)
        s.cbp_luma = cbp
        any_dc = any_ac = False
        for comp in range(2):
            zdc = chroma_dc[comp, my, mx]
            if zdc.any():
                any_dc = True
            s.chroma_dc[comp] = [int(v) for v in zdc.reshape(4)]
            for i in range(4):
                zb = chroma_ac[comp, my * 2 + i // 2, mx * 2 + i % 2]
                if zb.any():
                    any_ac = True
                s.chroma_ac[comp][i] = raster_to_scan4x4(zb, ac_only=True)
        s.cbp_chroma = 2 if any_ac else (1 if any_dc else 0)
        # provisional marking so skip/mv prediction sees this MB as inter
        g.mb_class[my, mx] = INTER.MB_P
        g.slice_id[my, mx] = 0
        if (s.cbp_luma == 0 and s.cbp_chroma == 0):
            skip_mv = INTER.pskip_mv(g, m, my, mx, 0)
            if mbmv[0] == skip_mv[0] and mbmv[1] == skip_mv[1]:
                INTER.apply_skip(g, m, my, mx, 0, qp)
                return s, True
        g.qp[my, mx] = qp
        return s, False


def encode_stream_device(frames, width, height, qp=28, gop_len=8,
                         disable_deblock=False, device=None) -> bytes:
    """Encode frames with the device encoder (None: the card) ->
    Annex-B."""
    cfg = EncoderConfig(width=width, height=height, qp=qp, gop_len=gop_len,
                        disable_deblock=disable_deblock)
    enc = DeviceH264Encoder(cfg, device)
    out = [enc.headers_annexb()]
    for (Y, U, V) in frames:
        out.append(enc.encode_frame(Y, U, V))
    return b"".join(out)
