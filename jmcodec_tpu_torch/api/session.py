"""Streaming decoder and encoder sessions: bytes in with backpressure,
frames out in display order, the EOF drain; frames in, Annex-B packets
out. The port of jmcodec_tpu's api/session.py, over the port's device
paths.

  DecoderSession(codec, out_fmt)   create a decoder (device=None: the card)
  input_data / need_more_data      feed bytes; 0 accepted when the ring is full
  free_buf_len / set_eof           free ring space; end of stream, drain
  get_frame / output_frame         pop a frame: numpy planes / repacked bytes
  get_frame_device                 pop a frame without copying it to the host
  decode_frame                     feed (None: EOF) and pop one frame
  is_exit / info / get_stream_info / is_hw_support / set_yuv_callback

  EncoderSession(params)           create an encoder (device=None: the card)
  encode_frame / output_bitstream  feed a frame; pop (packet, is_keyframe)
  more_data / set_eof / is_exit    backpressure, end of stream (B flush)
  get_spspps / info                parameter sets, status line

H.264: the native parser turns each picture into FrameSymbols; an I or P
picture within the device path's scope is decoded on the device (the
all-intra decode, or the inter decode against DeviceDPB), anything else
(B slices, the 8x8 transform, PCM, MMCO, reordered streams, a P picture
after a host-decoded one) on the host by the numpy H264ReferenceDecoder,
whose DPB is primed with the device-decoded references first (the
mirror). A picture that fails to parse or decode as corrupt is dropped
and counted; the stream resyncs at the next picture.

HEVC: every picture goes through HevcRefDecoder with DeviceRecon: parsed
natively or, outside the native parser's scope (cu_qp_delta, transform
skip, ...), in Python, and reconstructed on the device; a plan outside the
device's scope (a multi-slice or transform-skip picture, motion past the
MC pad, more than four references) is decoded on the host in numpy. With
use_device=False every picture is decoded on the host. A picture the host
decoder does not support (PCM, transquant bypass, tiles, not 4:2:0 8-bit)
is dropped and counted, as a corrupt one is.

Encoding: H.264 runs on DeviceH264Encoder (engine "device", which "auto"
means: the P frames' search, transform and reconstruction on the device,
the IDR and the CAVLC pack on the host) or on the numpy
H264ReferenceEncoder (engine "host", and B groups, which the device
engine does not encode); HEVC on the numpy HevcEncoder. CBR and VBR pick
each frame's QP with the RateController.
"""

from __future__ import annotations

import enum
import math
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..codec.h264 import nal as NAL
from ..codec.h264.fastdec import FastH264Parser
from ..codec.h264.refdec import H264ReferenceDecoder, RefPicture
from ..codec.hevc.refdec import HevcRefDecoder
from ..kernels import recon_tiles as RT
from ..utils.device import require_cuda
from ..utils.metrics import counters, logger, timers
from .h264_inter import DeviceDPB
from .hevc_inter import DeviceRecon

# a 10 MB input ring that asks for more data while over 5 MB are free
INPUT_BUF_SIZE = 10 * 1024 * 1024
NEED_MORE_THRESHOLD = 5 * 1024 * 1024


class Codec(enum.IntEnum):
    H264 = 0
    HEVC = 1


class PixFmt(enum.IntEnum):
    YV12 = 0   # planar Y, V, U
    NV12 = 1   # planar Y + interleaved UV
    I420 = 2   # planar Y, U, V


def repack(Y: np.ndarray, U: np.ndarray, V: np.ndarray, fmt: PixFmt) -> bytes:
    """Cropped (Y, U, V) uint8 planes -> one frame's bytes in fmt."""
    if fmt == PixFmt.I420:
        return Y.tobytes() + U.tobytes() + V.tobytes()
    if fmt == PixFmt.YV12:
        return Y.tobytes() + V.tobytes() + U.tobytes()
    if fmt == PixFmt.NV12:
        uv = np.empty((U.shape[0], U.shape[1] * 2), np.uint8)
        uv[:, 0::2] = U
        uv[:, 1::2] = V
        return Y.tobytes() + uv.tobytes()
    raise ValueError(fmt)


def _host(a) -> np.ndarray:
    """A plane as a numpy array: tensors (on any device) are copied down."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@contextmanager
def _dropping_unsupported(pic: bytes):
    """A NotImplementedError of a host decode drops the picture, counted."""
    try:
        yield
    except NotImplementedError as e:
        counters.add("unsupported_pictures")
        logger.warning("dropping unsupported picture (%d bytes): %s",
                       len(pic), e)


class _FpsMeter:
    """Frames and bytes taken, and the frame rate since the first frame."""

    def __init__(self):
        self.start: Optional[float] = None
        self.frames = 0
        self.bytes_in = 0

    def tick_frame(self, n=1):
        if self.start is None:
            self.start = time.monotonic()
        self.frames += n

    def fps(self) -> float:
        if not self.start or not self.frames:
            return 0.0
        dt = time.monotonic() - self.start
        return self.frames / dt if dt > 0 else 0.0


class DecoderSession:
    """Streaming decoder: bytes in (with backpressure), YUV out in display
    order, EOF drain.

    use_device=False decodes on the host only, either codec. device: where
    the device path runs (None: the card, which must be there; the tests
    pass "cpu"). A native parser that fails to build raises here: the
    session never routes a stream off the device path for that."""

    def __init__(self, codec: Codec = Codec.H264,
                 out_fmt: PixFmt = PixFmt.I420, use_device: bool = True,
                 use_native_parser: bool = True, device=None):
        self.codec = codec
        self.out_fmt = out_fmt
        self._buf = bytearray()
        self._frames: deque = deque()
        self._eof = False
        self._drained = False
        self._meter = _FpsMeter()
        self._yuv_callback: Optional[Callable] = None
        self._stream_info: Optional[Tuple[int, int]] = None
        self._use_device = use_device
        self._device = None
        if use_device:
            self._device = (require_cuda() if device is None
                            else torch.device(device))
        self._parser = None
        self._refdec = None
        # picture decoded on the host since the last IDR: the device DPB
        # lacks it, so P pictures stay on the host until the next IDR
        self._fast_dirty = False
        # device-decoded reference pictures not yet copied to the host DPB
        self._pending_mirror: list = []
        # parameter sets / SEI seen before any picture
        self._pending_prefix = b""
        self._dev_dpb = DeviceDPB()
        self._hdr_cache: dict = {}
        if codec == Codec.H264:
            if use_native_parser:
                self._parser = FastH264Parser()
            else:
                self._refdec = H264ReferenceDecoder()

    # ---- input side ----

    def need_more_data(self) -> bool:
        return self.free_buf_len() > NEED_MORE_THRESHOLD and not self._eof

    def free_buf_len(self) -> int:
        return max(0, INPUT_BUF_SIZE - len(self._buf))

    def input_data(self, data: bytes) -> int:
        """Returns bytes accepted (0 if the ring is full)."""
        if self._eof:
            return 0
        take = min(len(data), self.free_buf_len())
        self._buf += data[:take]
        self._meter.bytes_in += take
        counters.add("bytes_in", take)
        self._try_decode(flush=False)
        return take

    def set_eof(self) -> None:
        self._eof = True
        self._try_decode(flush=True)
        if self._refdec is not None:
            # drain the display-reorder buffer (B streams)
            if self.codec == Codec.HEVC:
                for fr in self._refdec.flush():
                    self._frames.append(fr)
                    self._meter.tick_frame()
            else:
                for fr in self._refdec.flush():
                    sps = list(self._refdec.sps.values())[0]
                    self._frames.append(fr.crop(sps))
                    self._meter.tick_frame()
        self._drained = True

    # ---- output side ----

    def output_frame(self) -> Optional[bytes]:
        """Pop one frame in display order, repacked to out_fmt."""
        fr = self.get_frame()
        if fr is None:
            return None
        return repack(*fr, self.out_fmt)

    def get_frame(self):
        """Pop one frame as (Y, U, V) numpy planes. Device-decoded frames
        are copied to the host here, the session's one device-to-host copy:
        the parse of later pictures overlaps the device's work until a
        caller asks for the pixels."""
        if not self._frames:
            return None
        fr = self._frames.popleft()
        with timers.stage("d2h"):
            fr = tuple(_host(p) for p in fr)
        if self._yuv_callback is not None:
            self._yuv_callback(*fr)
        return fr

    def get_frame_device(self):
        """Pop one frame without copying it to the host: device-decoded
        pictures come back as tensors on the session's device, host-decoded
        ones as numpy arrays (a consumer on the device takes them from
        here)."""
        if not self._frames:
            return None
        fr = self._frames.popleft()
        if self._yuv_callback is not None:
            self._yuv_callback(*(_host(p) for p in fr))
        return fr

    def is_exit(self) -> bool:
        return self._drained and not self._frames

    def set_yuv_callback(self, cb: Callable) -> None:
        self._yuv_callback = cb

    def decode_frame(self, data: Optional[bytes]):
        """Push bytes (None or empty: EOF) and pop one frame if ready.
        Returns (frame_or_None, got_frame)."""
        if data:
            self.input_data(data)
        else:
            self.set_eof()
        fr = self.get_frame()
        return fr, fr is not None

    # ---- queries ----

    def get_stream_info(self) -> Optional[Tuple[int, int]]:
        return self._stream_info

    def info(self) -> str:
        return (f"jmcodec-tpu-torch decode | codec={self.codec.name} "
                f"frames={self._meter.frames} bytes={self._meter.bytes_in} "
                f"fps={self._meter.fps():.1f}")

    @staticmethod
    def is_hw_support() -> bool:
        """Whether a CUDA device is there for the device path."""
        return torch.cuda.is_available()

    # ---- internals ----

    def _try_decode(self, flush: bool) -> None:
        """Decode the complete pictures in the buffer. A picture is complete
        when the next picture's first slice (or EOF) is seen: without flush
        the last picture's bytes stay buffered."""
        data = bytes(self._buf)
        if not data:
            return
        cut = self._last_picture_start(data) if not flush else len(data)
        if cut <= 0:
            return
        chunk, rest = data[:cut], data[cut:]
        self._buf = bytearray(rest)
        self._decode_chunk(chunk)

    def _last_picture_start(self, data: bytes) -> int:
        """Byte offset of the start code of the LAST picture-initial slice
        NAL; the bytes before it form complete access units."""
        starts = self._picture_starts(data)
        return starts[-1] if starts else -1

    def _picture_starts(self, data: bytes) -> List[int]:
        """Start-code offsets of every picture-initial slice NAL
        (H.264: first_mb_in_slice == 0; HEVC: first_slice_segment_in_pic)."""
        starts: List[int] = []
        for s, e in NAL.split_annexb(data):
            if self.codec == Codec.HEVC:
                typ = (data[s] >> 1) & 0x3F
                # slice NAL with first_slice_segment_in_pic_flag == 1 (the
                # first RBSP bit after the 2-byte header)
                if not (typ < 32 and s + 2 < len(data)
                        and (data[s + 2] & 0x80)):
                    continue
            else:
                typ = data[s] & 0x1F
                # first_mb_in_slice == 0 <=> first ue bit pattern "1"
                if not (typ in (1, 5) and s + 1 < len(data)
                        and (data[s + 1] & 0x80)):
                    continue
            sc = s - 3
            if sc > 0 and data[sc - 1] == 0:
                sc -= 1
            starts.append(sc)
        return starts

    def _decode_chunk(self, chunk: bytes) -> None:
        """Decode a chunk picture by picture, so that a host fallback or a
        corrupt picture in the middle neither repeats nor drops the
        pictures around it."""
        chunk = self._pending_prefix + chunk
        self._pending_prefix = b""
        self._cache_headers(chunk)
        starts = self._picture_starts(chunk)
        if not starts:
            # parameter sets / SEI only so far: keep them for the picture
            # that follows (they must reach the entropy parser, not just the
            # header cache)
            self._pending_prefix = chunk
            return
        cuts = [0] + starts[1:] + [len(chunk)]
        for i in range(len(cuts) - 1):
            self._decode_picture(chunk[cuts[i]:cuts[i + 1]])

    def _decode_picture(self, pic: bytes) -> None:
        """Decode one picture's bytes (leading SPS/PPS/SEI included): on the
        device path when its scope tests take the picture, else on the
        host. A corrupt picture is dropped and counted; a picture that the
        host decoder does not support too. Any error of the device decode
        itself propagates: only the scope tests route a picture."""
        try:
            if self.codec == Codec.HEVC:
                # the device_recon hook raises no NotImplementedError
                with _dropping_unsupported(pic):
                    self._decode_picture_hevc(pic)
                return
            pics = self._device_pictures(pic)
            if pics is not None:
                self._decode_device(pics)
                return
            # the device DPB does not get host-decoded pictures: park the
            # device inter path until the next IDR re-anchors it
            self._fast_dirty = True
            with _dropping_unsupported(pic):
                self._decode_picture_host(pic)
        except (ValueError, EOFError, KeyError, IndexError) as e:
            # corrupt bitstream: drop the broken picture and resync at the
            # next one that decodes
            counters.add("corrupt_chunks")
            logger.warning("dropping corrupt picture (%d bytes): %s",
                           len(pic), e)

    def _device_pictures(self, pic: bytes):
        """pic parsed into [(FrameSymbols, SPS)] when the device path takes
        every picture in it; None sends pic to the host decoder (no native
        parser, B slices, PCM, the 8x8 transform, MMCO, a reordered inter
        stream, a P picture after a host-decoded one, a long-term list
        modification)."""
        if self._parser is None:
            return None
        try:
            with timers.stage("host_parse"):
                pics = self._parser.parse_annexb(pic)
        except NotImplementedError:
            return None     # outside the native parser's scope
        dirty = self._fast_dirty
        for fs, sps in pics:
            self._stream_info = (sps.width, sps.height)
            if (not self._use_device or fs.has_pcm or fs.has_t8
                    or fs.has_b):
                return None
            # a P picture is emitted without a reorder buffer, which needs
            # decode order == output order (POC type 2), and takes its
            # references from the device DPB, which lacks host pictures
            if fs.mv is not None and (
                    not fs.no_reorder or dirty
                    or any(idc == 2 for idc, _ in fs.ref_mods_l0 or ())):
                return None
            dirty = dirty and not fs.is_idr
        return pics

    def _decode_device(self, pics) -> None:
        for fs, sps in pics:
            if fs.mv is None:
                with timers.stage("device_recon"):
                    Y, U, V = RT.decode_frame_symbols_device(
                        fs, device=self._device)
            else:
                refs, ref_ids = self._dev_dpb.list0(fs)
                with timers.stage("device_recon"):
                    Y, U, V = RT.decode_frame_symbols_inter(fs, refs, ref_ids)
            counters.add("frames_device")
            if fs.is_idr:
                self._fast_dirty = False
                # the host DPB starts over at the IDR: what it was not given
                # yet is moot, and it drops what it holds now
                self._pending_mirror = []
                if self._refdec is not None:
                    self._refdec.dpb.clear()
            if fs.nal_ref_idc != 0:
                # the host DPB gets this picture when a host decode needs it
                # (_flush_mirrors): copying it down now would wait for the
                # device here. Its sliding window keeps the newest
                # max(1, max_num_ref_frames) pictures: no more are kept here
                self._pending_mirror.append((fs, Y, U, V))
                del self._pending_mirror[:-max(1, fs.max_num_ref_frames)]
                self._dev_dpb.add(fs, Y, U, V)
            w, h = sps.width, sps.height
            self._frames.append((Y[:h, :w], U[:h // 2, :w // 2],
                                 V[:h // 2, :w // 2]))
            self._meter.tick_frame()

    def _flush_mirrors(self) -> None:
        """Copy the device-decoded reference pictures into the host DPB,
        whole-macroblock planes as int32 like its own pictures."""
        dpb = self._refdec.dpb
        for (fs, Y, U, V) in self._pending_mirror:
            dpb.max_refs = max(1, fs.max_num_ref_frames)
            dpb.add(RefPicture(fs.frame_num, *(_host(p).astype(np.int32)
                                               for p in (Y, U, V))))
        self._pending_mirror = []

    def _decode_picture_host(self, pic: bytes) -> None:
        """H.264 on the numpy decoder, whose DPB first gets the device
        pictures it lacks."""
        if self._refdec is None:
            self._refdec = H264ReferenceDecoder()
        self._flush_mirrors()
        dec = self._refdec
        if not dec.sps and self._hdr_cache:
            pic = b"".join(self._hdr_cache.get(t, b"") for t in (7, 8)) + pic
        out = dec.decode_annexb(pic)
        for fr in out:
            sps = list(dec.sps.values())[0]
            self._stream_info = (sps.width, sps.height)
            self._frames.append(fr.crop(sps))
            self._meter.tick_frame()

    def _hevc_device_recon(self):
        """The device_recon hook of HevcRefDecoder: DeviceRecon, counted
        and timed (the host's issue of the launches). Its errors leave the
        session as RuntimeError: the session's containment must not take
        them for a fault of the stream."""
        recon = DeviceRecon(self._device)

        def device_recon(plan, ref_pixels):
            try:
                with timers.stage("device_recon"):
                    planes = recon(plan, ref_pixels)
            except (NotImplementedError, ValueError, EOFError, KeyError,
                    IndexError) as e:
                raise RuntimeError(
                    f"HEVC device decode of POC {plan.poc} failed: "
                    f"{type(e).__name__}: {e}") from e
            counters.add("frames_device")
            return planes

        return device_recon

    def _decode_picture_hevc(self, pic: bytes) -> None:
        """HEVC: the parse on the host, the reconstruction on the device or
        the host as HevcRefDecoder routes it (on the host only without the
        device); one DPB/POC/reorder machinery for the stream."""
        if self._refdec is None:
            self._refdec = HevcRefDecoder(
                self._hevc_device_recon() if self._use_device else None)
        dec = self._refdec
        if not dec.sps and self._hdr_cache:
            pic = b"".join(self._hdr_cache.get(t, b"")
                           for t in (32, 33, 34)) + pic
        for fr in dec.decode(pic, flush=False):
            sps = list(dec.sps.values())[0]
            self._stream_info = (sps.width, sps.height)
            self._frames.append(fr)
            self._meter.tick_frame()

    def _cache_headers(self, chunk: bytes) -> None:
        """Remember raw parameter-set NALs so that a decoder created in the
        middle of the stream can be given the parameter sets it never
        saw."""
        for s, e in NAL.split_annexb(chunk):
            if self.codec == Codec.HEVC:
                typ = (chunk[s] >> 1) & 0x3F
                if typ not in (32, 33, 34):  # VPS/SPS/PPS
                    continue
            else:
                typ = chunk[s] & 0x1F
                if typ not in (7, 8):
                    continue
            sc = s - 3
            if sc > 0 and chunk[sc - 1] == 0:
                sc -= 1
            self._hdr_cache[typ] = chunk[sc:e]


class EncoderParams:
    """Defaults-then-override config struct: 1080p30, 2 Mb/s VBR,
    balanced preset, GOP 30, no B frames."""

    def __init__(self, width=1920, height=1080, fps=30, bitrate_kb=2000,
                 gop_len=30, num_bframe=0, codec: Codec = Codec.H264,
                 qp: Optional[int] = None, preset: str = "balanced",
                 rc_mode: str = "vbr", vbv_buffer_ms: int = 0,
                 engine: str = "auto"):
        self.width = width
        self.height = height
        self.fps = fps
        self.bitrate_kb = bitrate_kb
        self.gop_len = gop_len
        self.num_bframe = num_bframe
        self.codec = codec
        self.qp = qp
        self.preset = preset
        # "device": DeviceH264Encoder (kernels/encode_tiles.py); "host":
        # the numpy H264ReferenceEncoder; "auto": the device
        self.engine = engine
        # rate control: "vbr", "cbr", or "cqp" (fixed qp)
        self.rc_mode = "cqp" if qp is not None else rc_mode
        self.vbv_buffer_ms = vbv_buffer_ms

    def effective_qp(self) -> int:
        if self.qp is not None:
            return self.qp
        # bits/pixel -> the first frame's QP (rate control moves it)
        bpp = (self.bitrate_kb * 1000.0) / max(
            1.0, self.fps * self.width * self.height)
        qp = int(round(34 - 6 * math.log2(max(bpp, 1e-4) / 0.1)))
        return int(np.clip(qp, 10, 48))


class _HevcEncAdapter:
    """Gives the HEVC encoder the H264ReferenceEncoder session interface."""

    class _Cfg:
        def __init__(self, qp, gop_len):
            self.qp = qp
            self.gop_len = gop_len

    def __init__(self, enc):
        self._e = enc
        self.cfg = self._Cfg(enc.qp, getattr(enc, "gop_len", 1))
        self.frame_idx = 0

    def headers_annexb(self) -> bytes:
        return self._e.headers_annexb()

    def encode_frame(self, Y, U, V, qp=None) -> bytes:
        out = self._e.encode_frame(Y, U, V, qp=qp)
        self.frame_idx += 1
        return out

    def spspps(self):
        from ..codec.hevc import nal as HN
        from ..codec.hevc.refenc import write_pps, write_sps
        e = self._e
        sps = HN.write_nal_unit(HN.NAL_SPS,
                                write_sps(e.pw, e.ph, e.conf_win))
        pps = HN.write_nal_unit(HN.NAL_PPS, write_pps())
        return sps, pps


# speed presets trade search range and partition evaluation for
# throughput
_PRESET_KNOBS = {
    "fast": dict(search_range=8, inter_partitions=False),
    "hp": dict(search_range=8, inter_partitions=False),
    "balanced": dict(search_range=16, inter_partitions=True),
    "default": dict(search_range=16, inter_partitions=True),
    "quality": dict(search_range=24, inter_partitions=True),
    "hq": dict(search_range=24, inter_partitions=True),
}


class EncoderSession:
    """YUV in -> Annex-B bitstream out with keyframe flags + SPS/PPS
    export.

    device: where the device engine runs (None: the card, which must be
    there; the tests pass "cpu"). The host engine and HEVC never touch
    torch's devices."""

    MAX_QUEUED = 30  # packets queued before more_data() asks for no more

    def __init__(self, params: Optional[EncoderParams] = None, device=None):
        self.params = params or EncoderParams()
        engine = self.params.engine
        if engine == "auto":
            engine = "device"
        if self.params.num_bframe and self.params.codec != Codec.H264:
            raise NotImplementedError("B-frames: H.264 only")
        if self.params.num_bframe and engine == "device":
            # the device engine's batched ME is P-only: B groups run on
            # the host engine, as in jmcodec_tpu
            logger.info("num_bframe>0: using the host encode engine")
            engine = "host"
        if self.params.codec == Codec.HEVC:
            # HEVC encode: IDR + P...P closed GOPs (single reference)
            from ..codec.hevc.refenc import HevcEncoder
            self._enc = _HevcEncAdapter(HevcEncoder(
                self.params.width, self.params.height,
                qp=self.params.effective_qp(),
                gop_len=max(1, self.params.gop_len)))
        else:
            from ..codec.h264.refenc import (EncoderConfig,
                                             H264ReferenceEncoder)
            knobs = _PRESET_KNOBS.get(self.params.preset)
            if knobs is None:
                raise ValueError(f"preset {self.params.preset!r}")
            cfg = EncoderConfig(
                self.params.width, self.params.height,
                qp=self.params.effective_qp(),
                gop_len=max(1, self.params.gop_len),
                num_bframe=int(self.params.num_bframe), **knobs)
            if engine == "device":
                from ..codec.h264.devenc import DeviceH264Encoder
                self._enc = DeviceH264Encoder(cfg, device)
            elif engine == "host":
                self._enc = H264ReferenceEncoder(cfg)
            else:
                raise ValueError(f"engine {engine!r}")
        self._rc = None
        if self.params.rc_mode in ("cbr", "vbr"):
            from ..pipeline.ratecontrol import (RateControlConfig,
                                                RateController)
            self._rc = RateController(RateControlConfig(
                bitrate_kbps=self.params.bitrate_kb,
                fps=float(self.params.fps), mode=self.params.rc_mode,
                buffer_ms=self.params.vbv_buffer_ms,
                gop_len=max(1, self.params.gop_len),
                init_qp=self.params.effective_qp()))
        elif self.params.rc_mode != "cqp":
            raise ValueError(f"rc_mode {self.params.rc_mode!r}")
        self._out: deque = deque()
        self._eof = False
        self._meter = _FpsMeter()
        self._headers_sent = False

    def more_data(self) -> bool:
        return len(self._out) < self.MAX_QUEUED and not self._eof

    need_more_data = more_data

    def encode_frame(self, yuv, fmt: PixFmt = PixFmt.I420) -> None:
        """Encode one frame. yuv: (Y, U, V) planes or packed bytes."""
        Y, U, V = self._unpack(yuv, fmt)
        payload = b""
        if not self._headers_sent:
            payload += self._enc.headers_annexb()
            self._headers_sent = True
        is_key = (self._enc.cfg.gop_len <= 1
                  or self._enc.frame_idx % self._enc.cfg.gop_len == 0)
        qp = None
        if self._rc is not None:
            qp = self._rc.frame_qp("I" if is_key else "P")
        nal = self._enc.encode_frame(np.asarray(Y, np.int32),
                                     np.asarray(U, np.int32),
                                     np.asarray(V, np.int32), qp=qp)
        if self._rc is not None:
            self._rc.update("I" if is_key else "P", qp, len(nal) * 8)
        if nal:
            # B groups emit several access units at once (decode order);
            # an empty return means the picture is buffered in its group
            self._out.append((payload + nal, is_key))
        elif payload:
            self._out.append((payload, is_key))
        self._meter.tick_frame()

    def output_bitstream(self) -> Optional[Tuple[bytes, bool]]:
        """Pop (bytes, is_keyframe)."""
        if not self._out:
            return None
        return self._out.popleft()

    def set_eof(self) -> None:
        if not self._eof and hasattr(self._enc, "flush"):
            tail = self._enc.flush()
            if tail:
                self._out.append((tail, False))
        self._eof = True

    def is_exit(self) -> bool:
        return self._eof and not self._out

    def get_spspps(self) -> Tuple[bytes, bytes]:
        """The SPS and PPS NAL units (Annex-B)."""
        if isinstance(self._enc, _HevcEncAdapter):
            return self._enc.spspps()
        from ..codec.h264.params import write_pps, write_sps
        sps = NAL.write_nal_unit(3, NAL.NAL_SPS, write_sps(self._enc.sps))
        pps = NAL.write_nal_unit(3, NAL.NAL_PPS, write_pps(self._enc.pps))
        return sps, pps

    def info(self) -> str:
        return (f"jmcodec-tpu encode | {self.params.width}x{self.params.height}"
                f" qp={self._enc.cfg.qp} frames={self._meter.frames}"
                f" fps={self._meter.fps():.1f}")

    def _unpack(self, yuv, fmt: PixFmt):
        if isinstance(yuv, tuple):
            return yuv
        w, h = self.params.width, self.params.height
        buf = np.frombuffer(yuv, np.uint8)
        Y = buf[:w * h].reshape(h, w)
        if fmt == PixFmt.I420:
            U = buf[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
            V = buf[w * h + w * h // 4:w * h * 3 // 2].reshape(h // 2, w // 2)
        elif fmt == PixFmt.YV12:
            V = buf[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
            U = buf[w * h + w * h // 4:w * h * 3 // 2].reshape(h // 2, w // 2)
        elif fmt == PixFmt.NV12:
            uv = buf[w * h:w * h * 3 // 2].reshape(h // 2, w)
            U = uv[:, 0::2]
            V = uv[:, 1::2]
        else:
            raise ValueError(fmt)
        return Y, U, V
