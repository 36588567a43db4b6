"""Stream entry point of the H.264 decode on the device: an Annex-B stream
of I and P pictures -> its frames in output order.

The counterpart of jmcodec_tpu's session fast path for H.264
(api/session.py, _decode_picture_fast with _dev_dpb_add and _dev_list0):
the native parser turns each picture into FrameSymbols on the host; an I
picture takes the all-intra decode, a P picture the inter decode
(recon_tiles.decode_frame_symbols_inter) against DeviceDPB, whose padded
reference planes never leave the device. Pictures are decoded one by one
in decode order, which is output order only under POC type 2; B slices,
MMCO, the 8x8 transform, PCM and reordered streams raise
NotImplementedError naming the reason.
"""

from __future__ import annotations

from ..codec.h264.fastdec import FastH264Parser
from ..kernels import recon_tiles as RT
from ..utils.device import require_cuda
from .h264_intra import _picture_chunks


class DeviceDPB:
    """The reference pictures of a P picture, padded on the device
    (recon_tiles.pad_ref_device), newest first: a sliding window of
    max(1, max_num_ref_frames) pictures, cleared by an IDR picture. The
    caller adds only reference pictures (nal_ref_idc != 0)."""

    def __init__(self):
        self.pics = []          # [(frame_num, (Y, U, V) padded)]

    def add(self, fs, Y, U, V):
        """Take a decoded picture's planes (whole macroblocks, uint8)."""
        if fs.is_idr:
            self.pics = []
        self.pics.insert(0, (fs.frame_num, RT.pad_ref_device(Y, U, V)))
        del self.pics[max(1, fs.max_num_ref_frames):]

    def list0(self, fs):
        """fs's list 0 (8.2.4.2.1: descending PicNum, wrap-aware), with
        its short-term ref_pic_list_modification (8.2.4.3.1, duplicates
        allowed: x264's weightp=2 puts one picture at two indices) and the
        num_ref_idx_active_l0 trim. Returns (the padded planes per index,
        their frame_num: the picture identity that bS compares)."""
        max_fn = 1 << fs.log2_max_frame_num
        order = sorted(self.pics, key=lambda e: (fs.frame_num - e[0]) % max_fn)
        idx, pred = 0, fs.frame_num
        for idc, val in fs.ref_mods_l0 or ():
            if idc == 2:
                raise NotImplementedError("long-term ref list modification")
            pred = ((pred - (val + 1)) if idc == 0 else (pred + (val + 1))) \
                % max_fn
            pic = next((e for e in self.pics if e[0] % max_fn == pred), None)
            if pic is None:
                raise ValueError("ref list modification: picture not in "
                                 "the DPB")
            order.insert(idx, pic)
            idx += 1
            for i in range(idx, len(order)):
                if order[i] is pic:
                    del order[i]
                    break
        order = order[:fs.num_ref_l0 or len(order)]
        if not order:
            raise ValueError("P picture without a reference in the DPB")
        return [planes for _, planes in order], [fn for fn, _ in order]


def parse_h264(stream: bytes):
    """The stream's pictures as (FrameSymbols, SPS), one at a time in
    decode order (a generator: the native parser reads a picture when the
    caller asks for it). Parameter sets must precede the first picture."""
    head, chunks = _picture_chunks(stream)
    parser = FastH264Parser()
    parser.parse_annexb(head)
    for chunk in chunks:
        yield from parser.parse_annexb(chunk)


def decode_symbols(pics, device=None, *, dpb=None) -> list:
    """The device half of decode_h264: pictures [(FrameSymbols, SPS), ...]
    in decode order (parse_h264) -> [(Y, U, V), ...] uint8 tensors on
    `device` (None: the card) in output order, cropped to the SPS size.
    An I picture takes the all-intra decode, a P picture the inter decode
    against dpb (a new DeviceDPB when None; a caller that passes its own
    can go on from where the pictures left it)."""
    if device is None:
        device = require_cuda()
    dpb = DeviceDPB() if dpb is None else dpb
    out = []
    for fs, sps in pics:
        if not fs.no_reorder:
            raise NotImplementedError("output order differs from decode "
                                      "order (POC type 0 or 1)")
        if fs.mv is None:
            Y, U, V = RT.decode_frame_symbols_device(fs, device=device)
        else:
            Y, U, V = RT.decode_frame_symbols_inter(fs, *dpb.list0(fs))
        if fs.nal_ref_idc != 0:
            dpb.add(fs, Y, U, V)
        w, h = sps.width, sps.height
        out.append((Y[:h, :w], U[:h // 2, :w // 2], V[:h // 2, :w // 2]))
    return out


def decode_h264(stream: bytes, device=None) -> list:
    """Decode an Annex-B H.264 stream of I and P pictures on `device`
    (None: the card, which must be there): parse_h264 then
    decode_symbols, picture by picture. Returns [(Y, U, V), ...] uint8
    tensors on that device in output order, cropped to the SPS size."""
    if device is None:
        device = require_cuda()
    return decode_symbols(parse_h264(stream), device)
